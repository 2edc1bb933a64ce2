"""PyTorch port, generic lattices: the gather layout (relabelling, band,
window offsets) against ``bodge_tpu``'s plan, the plain versions of the gather
kernels against the reference's XLA gather product in x64 and against its
Pallas gather kernel in interpret mode, the moment sweep in relabelled order,
the façade and a gradient on a ring.  The port runs its plain versions on the
CPU; the CUDA kernels themselves are held against these on the card by
``chip_smoke.py``."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.models import selfconsistency as jsc
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu.ops import pallas_gather as jpg
from bodge_tpu.ops.blocksparse import dense_to_ell as j_dense_to_ell
from bodge_tpu.ops.blocksparse import skeleton_from_lattice as j_skeleton_from_lattice
from bodge_tpu.ops.spmm import spmm as jspmm
from bodge_tpu_torch.models import selfconsistency as tsc
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_gather as cg
from bodge_tpu_torch.ops import cuda_spmm as ck
from bodge_tpu_torch.ops.spmm import spmm as tspmm
from bodge_tpu_torch.utils.convert import gather_layout_from_numpy, tensor_from_numpy
from tests.test_torch_banded import ring_lattice
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def build_ring(pkg, n, mu=0.4, delta=0.3, **kw):
    lattice = ring_lattice(pkg, n)
    system = pkg.Hamiltonian(lattice, **kw)
    system.assemble(
        onsite=lambda ci: -mu * pkg.σ0 - 0.002 * ci[:, 0, None, None] * pkg.σ3,
        pairing_onsite=lambda ci: delta * pkg.jσ2,
        hopping=lambda ci, cj: -1.0 * pkg.σ0,
    )
    return system


def build_generic_2d(L, W):
    """A 2D lattice on the generic skeleton (both packages build the same one
    from the lattice's traversal), data re-expressed through the dense matrix."""
    sj = J.Hamiltonian(J.CubicLattice((L, W, 1)))
    sj.assemble(
        onsite=lambda ci: -0.6 * J.σ0,
        pairing_onsite=lambda ci: 0.35 * J.jσ2,
        hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * J.σ0, 0),
    )
    sk_j = j_skeleton_from_lattice(J.CubicLattice((L, W, 1)))
    sk_t = tbs.skeleton_from_lattice(T.CubicLattice((L, W, 1)))  # the vectorised branch
    assert np.array_equal(sk_t.cols, sk_j.cols) and np.array_equal(sk_t.trans_slot, sk_j.trans_slot)
    return sk_j, sk_t, j_dense_to_ell(sj.matrix("dense"), sk_j)


def _vector(N, K, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))


def _case(name):
    if name == "ring300":
        st, sj = build_ring(T, 300, device="cpu"), build_ring(J, 300)
        assert np.array_equal(st.host_data(), np.asarray(sj.host_data()))
        return sj.skeleton, st.skeleton, st.host_data()
    return build_generic_2d(10, 40)


@pytest.mark.parametrize("name,K", [("ring300", 4), ("generic10x40", 2)])
def test_layout_matches_reference_plan(name, K):
    """Same relabelling and band as ``plan_gather`` of the reference; the
    window offsets are the reference's packed offsets less each lane's own
    position in its window (its tiles hold 128 sites and its window starts
    ``h`` tiles before the tile; the port's offsets are relative to the row)."""
    sk_j, sk_t, _ = _case(name)
    gl_j = jpg.plan_gather(sk_j, K)
    gl = cg.plan_gather(sk_t, K)
    assert gl is not None and cg.plan_gather(sk_t, K) is gl  # cached
    assert cg.plan_gather(sk_t, K + 1).sk is gl.sk  # one relabelled skeleton per skeleton
    assert gl.bwb == gl_j.bwb and np.array_equal(gl.rank, gl_j.rank)
    assert np.array_equal(gl.inv_rank[gl.rank], np.arange(sk_t.n_sites))
    N, S = sk_t.cols.shape
    off = np.asarray(jpg.pack_gather_offsets(sk_j, gl_j))  # [n_tiles, S, 128]
    own = np.arange(jpg.TILE) + gl_j.h * jpg.TILE
    rel_j = (off - own[None, None, :]).transpose(0, 2, 1).reshape(-1, S)[:N]
    valid = gl.sk.cols >= 0
    assert np.array_equal(gl.rel[valid], rel_j[valid])
    assert (gl.rel[~valid] == cg.PAD_REL).all() and (rel_j[~valid] == 0).all()
    assert np.abs(gl.rel[valid]).max() == gl.bwb
    # The relabelled skeleton is the same matrix pattern: the mirror of every block is where trans_slot says.
    rows, slots = np.nonzero(valid)
    partner = gl.sk.cols[rows, slots]
    assert np.array_equal(gl.sk.cols[partner, gl.sk.trans_slot[rows, slots]], rows)
    # A layout built from the reference's numbers is the same layout.
    handed = gather_layout_from_numpy(sk_t, gl_j.rank, gl_j.bwb, K)
    assert np.array_equal(handed.rel, gl.rel) and (handed.T, handed.TK) == (gl.T, gl.TK)
    with pytest.raises(ValueError, match="within bwb"):
        gather_layout_from_numpy(sk_t, gl_j.rank, max(gl_j.bwb - 1, 0), K)
    # The launch plan: the ring (the window and the tiles in flight) fits shared
    # memory, TK covers min(K, 8), a thread takes one site of a tile, and the
    # blocks' runs cover every row once.
    site = (4 * gl.TK + (2 if gl.TK % 2 == 0 and K % 2 == 0 else 1)) * 8
    assert gl.ring == 2 * gl.bwb + (gl.depth + 1) * gl.T and gl.ring * site == gl.smem_bytes <= cg.SMEM_LIMIT
    assert gl.TK == ce.probe_tile(K) and min(gl.T * gl.TK, cg.THREADS) <= gl.threads <= cg.THREADS
    assert gl.run >= gl.T and gl.ctas == -(-N // gl.run)


@pytest.mark.parametrize("name,K,seed", [("ring300", 4, 1), ("generic10x40", 2, 5)])
def test_gather_plain_matches_reference_products(name, K, seed):
    """``ell_gather_spmm_plain`` in relabelled order, brought back: 1e-12 against
    the reference's XLA gather product in complex128 (the same sums in another
    order), 2e-4 against its Pallas gather kernel in interpret mode (float32;
    the tolerance that kernel's own tests use)."""
    sk_j, sk_t, data = _case(name)
    gl = cg.plan_gather(sk_t, K)
    v = _vector(sk_t.n_sites, K, seed)
    d_t, v_t = torch.as_tensor(data), torch.as_tensor(v)
    y = gl.restore(cg.ell_gather_spmm(gl.relabel(d_t), gl, gl.relabel(v_t))).numpy()
    want = np.asarray(jspmm(jnp.asarray(data), sk_j, jnp.asarray(v), impl="gather"))
    np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)
    kernel = np.asarray(jpg.spmm_gather_pallas(data.astype(np.complex64), sk_j, v.astype(np.complex64)))
    np.testing.assert_allclose(y, kernel, atol=2e-4, rtol=2e-4)
    # Every way to the same product in the port.
    for impl in (None, "plain_gather", "plain", "gather"):
        np.testing.assert_allclose(tspmm(d_t, sk_t, v_t, impl=impl).numpy(), want, atol=1e-12, rtol=0)
    # The step in relabelled order equals the general step on the relabelled skeleton.
    t_prev = gl.relabel(torch.as_tensor(_vector(sk_t.n_sites, K, seed + 1)))
    a, pa = cg.ell_gather_cheb_step(gl.relabel(d_t), gl, gl.relabel(v_t), t_prev, 0.2)
    b, pb = ce.ell_cheb_step(gl.relabel(d_t), gl.sk, gl.relabel(v_t), t_prev, 0.2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-12)


def test_moments_gather_match_reference_scan():
    """The moment sweep in relabelled order against ``moments_gather_packed``
    (the reference's scan over its gather kernel, interpret mode, float32):
    2e-4 absolute on moments of unit probes, the tolerance of the reference's
    own gather-moment test; and 1e-10 against the port's general sweep."""
    st, sj = build_ring(T, 40, device="cpu"), build_ring(J, 40)
    sk_j, sk_t = sj.skeleton, st.skeleton
    N, K, order, scale = sk_t.n_sites, 4, 16, 3.1
    v0 = np.zeros((N, 4, K), dtype=np.complex128)
    v0[7] = np.eye(4)
    gl_j = jpg.plan_gather(sk_j, K)
    data32 = np.asarray(sj.host_data()).astype(np.complex64)
    mu_j = np.asarray(jpg.moments_gather_packed(
        jpg.pack_gather_operator(data32, sk_j, gl_j), jpg.pack_gather_offsets(sk_j, gl_j),
        jpg.pack_gather_vector(v0.astype(np.complex64), sk_j, gl_j), sk_j, gl_j,
        jnp.float32(1.0 / scale), order, K,
    ))
    mu = ck.moments_gather(st.data, sk_t, torch.as_tensor(v0), 1.0 / scale, order).numpy()
    assert mu.shape == (order, K)
    np.testing.assert_allclose(mu, mu_j, atol=2e-4, rtol=0)
    general = ck.moments_fused(st.data, sk_t, torch.as_tensor(v0), 1.0 / scale, order, impl="plain").numpy()
    np.testing.assert_allclose(mu, general, atol=1e-10, rtol=0)
    # impl=None on a generic skeleton with a feasible plan is this path.
    assert ck.resolve_path(None, st.data, sk_t, K) == "plain_gather"
    np.testing.assert_array_equal(tkpm.moments(st.data, sk_t, v0, order, scale).numpy(), mu)


def test_facade_on_ring_matches_reference():
    """free_energy / ldos / dos through the façade's default dispatch (the gather
    path on this skeleton) at 1e-9 with a shared scale: complex128 sums in
    another order on both sides."""
    st, sj = build_ring(T, 48, device="cpu"), build_ring(J, 48)
    scale = float(jkpm.spectral_bound(jnp.asarray(sj.data), sj.skeleton, impl="gather"))
    assert tkpm.spectral_bound(st.data, st.skeleton) == pytest.approx(scale, rel=0.03)
    energies = np.linspace(-1.5, 1.5, 13)
    kw = dict(order=48, scale=scale)
    F_t = st.free_energy(0.05, method="kpm", samples=None, **kw)
    F_j = sj.free_energy(0.05, method="kpm", samples=None, impl="gather", **kw)
    assert F_t == pytest.approx(F_j, rel=1e-9)
    np.testing.assert_allclose(
        st.ldos((5, 0, 0), energies, method="kpm", **kw),
        np.asarray(sj.ldos((5, 0, 0), energies, method="kpm", impl="gather", **kw)), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        st.ldos_map([(5, 0, 0), (40, 0, 0)], energies, method="kpm", **kw),
        np.asarray(sj.ldos_map([(5, 0, 0), (40, 0, 0)], energies, method="kpm", impl="gather", **kw)),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        st.dos(energies, samples=None, **kw), np.asarray(sj.dos(energies, samples=None, impl="gather", **kw)),
        rtol=1e-9, atol=1e-12)
    v = _vector(48, 3, 2)
    np.testing.assert_allclose(st.apply(v).numpy(), np.asarray(sj.apply(jnp.asarray(v), impl="gather")), atol=1e-12)


def test_gradient_on_ring_matches_jax():
    """d(Σ_m w_m Σ_k μ_m[k]) / d(data) and / d(v0) on a ring through the gather
    path (gather step forward; the adjoint and block-outer products on the
    relabelled skeleton backward; the relabelling itself differentiated by
    autograd) against ``jax.grad`` through the reference's moments over its
    XLA gather product: 1e-8 of the largest entry, complex128 on both sides.
    For a real loss ``g_torch = conj(g_jax)``."""
    st, sj = build_ring(T, 24, device="cpu"), build_ring(J, 24)
    sk_j, sk_t = sj.skeleton, st.skeleton
    N, K, order, scale = sk_t.n_sites, 3, 12, 3.3
    data, v0 = np.array(st.host_data()), _vector(N, K, 4)
    w = np.linspace(1.0, 0.3, order)

    def loss_j(d, v):
        return jnp.sum(jnp.asarray(w)[:, None] * jkpm.moments(d, sk_j, v, order, scale, impl="gather"))

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(v0))
    d = torch.as_tensor(data).requires_grad_(True)
    v = torch.as_tensor(v0).requires_grad_(True)
    mu = ck.moments_gather_ad(d, sk_t, v, 1.0 / scale, order)
    got = torch.autograd.grad((torch.as_tensor(w)[:, None] * mu).sum(), (d, v))
    valid = torch.as_tensor(sk_t.valid)[..., None, None]
    for g, wj, mask in zip(got, want, (valid, True)):
        wj = np.conj(np.asarray(wj))  # JAX's convention → PyTorch's
        assert np.abs((g * mask).numpy() - wj * np.asarray(mask)).max() <= 1e-8 * np.abs(wj).max()
        assert np.abs(wj).max() > 1e-3


def test_total_free_energy_on_ring():
    """``F_total(Δ)`` and its gradient on a generic lattice.  The port writes the
    on-site field into each row's diagonal block, found through the skeleton
    (the reference writes slot 0 on every skeleton, which on a generic lattice
    is a neighbour's block and leaves the operator non-Hermitian, so there is
    no reference value to hold against).  The gather path equals the general
    path to 1e-10 and the dense objective within the KPM series' own error."""
    st, sj = build_ring(T, 24, delta=0.0, device="cpu"), build_ring(J, 24, delta=0.0)
    sk = st.skeleton
    N = sk.n_sites
    x0 = 0.3 + 0.1 * np.random.default_rng(3).normal(size=N)
    inserted = tsc.data_with_onsite_swave(st.data, torch.as_tensor(x0, dtype=torch.complex128), sk)
    assert float(tbs.hermiticity_error(inserted, sk)) < 1e-14
    diag = np.argmax(sk.cols == np.arange(N)[:, None], axis=1)
    assert (diag != 0).any()  # the diagonal is not slot 0 here
    np.testing.assert_allclose(inserted[np.arange(N), diag, 0, 3].numpy(), x0)
    theirs = np.array(jsc.data_with_onsite_swave(jnp.asarray(sj.data), jnp.asarray(x0, dtype=jnp.complex128)))
    assert float(tbs.hermiticity_error(torch.as_tensor(theirs), sk)) > 0.1  # the reference's caveat

    kw = dict(V=1.5, temperature=0.1, method="kpm", order=64, samples=8, seed=5, scale=6.0)
    out = {}
    for impl in ("plain_gather", "plain"):
        F_t = tsc.make_total_free_energy(st, impl=impl, **kw)
        x = tensor_from_numpy(x0, device="cpu", requires_grad=True)
        v_t = F_t(x.to(torch.complex128))
        out[impl] = (float(v_t.detach()), torch.autograd.grad(v_t, x)[0].numpy())
    assert out["plain_gather"][0] == pytest.approx(out["plain"][0], rel=1e-10)
    np.testing.assert_allclose(out["plain_gather"][1], out["plain"][1], atol=1e-10)
    F_d = tsc.make_total_free_energy(st, V=1.5, temperature=0.1, method="dense")
    x = tensor_from_numpy(x0, device="cpu", requires_grad=True)
    v_d = F_d(x.to(torch.complex128))
    assert out["plain"][0] == pytest.approx(float(v_d.detach()), rel=0.05)  # 8 probes, order 64


def test_gather_requests_that_cannot_run_raise(monkeypatch):
    st = build_ring(T, 40, device="cpu")
    sk, data = st.skeleton, st.data
    v = torch.as_tensor(_vector(40, 2, 0))
    # The kernels need a CUDA tensor: asking for them on the CPU raises.
    with pytest.raises(RuntimeError, match="CPU"):
        tkpm.moments(data, sk, v, 8, 3.0, impl="cuda_gather")
    with pytest.raises(RuntimeError, match="CPU"):
        cg.ell_gather_spmm(data, cg.plan_gather(sk, 2), v, impl="cuda")
    with pytest.raises(RuntimeError, match="CPU"):
        tspmm(data, sk, v, impl="cuda_gather")
    with pytest.raises(TypeError, match="GatherLayout"):
        cg.ell_gather_spmm(data, sk, v)
    # No feasible plan (a window that cannot fit shared memory): the named
    # path raises, the automatic choice takes the general kernels.
    cg.plan_gather.cache_clear()
    monkeypatch.setattr(cg, "SMEM_LIMIT", cg.TREE_BYTES + 16 * 48)
    try:
        assert cg.plan_gather(sk, 2) is None and not cg.supported_gather(sk, 2)
        assert ck.resolve_path(None, data, sk, 2) == "plain"
        with pytest.raises(ValueError, match="no feasible gather plan"):
            tkpm.moments(data, sk, v, 8, 3.0, impl="plain_gather")
        with pytest.raises(ValueError, match="no feasible gather plan"):
            ck.moments_gather(data, sk, v, 1 / 3.0, 8)
        assert np.isfinite(tkpm.moments(data, sk, v, 8, 3.0).numpy()).all()
    finally:
        cg.plan_gather.cache_clear()
    assert ck.launch_counts()["ell_gather_spmm"] == 0 and ck.launch_counts()["ell_gather_cheb_step"] == 0


def _window_rule_tk(bwb, K, tile):
    """TK of the window rule, restated: the widest TK ≤ min(probe_tile(K), 8)
    whose window of ``T + 2·bwb`` rows at 8·(4·TK + 2) bytes fits beside 8 KB,
    with T = 32 or the forced T; ``None`` where none fits."""
    for TK in (8, 4, 2, 1):
        room = (cg.SMEM_LIMIT - cg.TREE_BYTES) // ((4 * TK + 2) * 8) - 2 * bwb
        if TK <= min(ce.probe_tile(K), 8) and (32 if tile is None else tile) <= room:
            return TK
    return None


@pytest.mark.parametrize("Ks", [(1, 3), (8, 33)])
def test_launch_plan_feasibility_unchanged(Ks):
    """Plan only (no kernel, no product): the sliding-window plan is feasible
    exactly where the window rule says, with the same TK, so ``supported_gather``
    and with it the step's dispatch answer as before; every ring fits shared
    memory, and the runs of a plan without a card give each of an H100's 132
    SMs one block per column tile."""
    for K, bwb, tile in itertools.product(Ks, range(0, 3000, 13), (None, 32, 160)):
        plan = cg._launch_plan(250855, bwb, K, tile)
        assert (plan is None) == (_window_rule_tk(bwb, K, tile) is None)
        if plan is None:
            continue
        T, TK, depth, run, ctas, threads, smem = plan
        assert TK == _window_rule_tk(bwb, K, tile) and (tile is None or T == tile)
        site = (4 * TK + (2 if TK % 2 == 0 and K % 2 == 0 else 1)) * 8
        assert smem == (2 * bwb + (depth + 1) * T) * site <= cg.SMEM_LIMIT and 0 <= depth <= cg.MAX_DEPTH
        assert ctas == -(-250855 // run) and ctas * -(-K // TK) <= ce.DEFAULT_SMS
    # The sheet's shape (bwb 293 after RCM): tiles of 128 rows, one in flight, 1901 rows a block.
    assert cg._launch_plan(250855, 293, 8) == (128, 8, 1, 1901, 132, 1024, 229024)
    assert cg._launch_plan(23, 10, 3, (32, 8))[3:5] == (8, 3)  # forced T and run: three blocks


@pytest.mark.parametrize("Ks", [(1, 3), (8, 33)])
def test_bf16_plan_feasibility_unchanged_and_cluster_fits(Ks):
    """Plan only: the bf16 operator's plan exists exactly where the complex64
    plan does (``supported_gather`` answers by the window rule alone).  Where
    it takes the cluster form, a pair of blocks splits the column tile (``TK``
    each), every block's ring, stages and barriers fit shared memory beside
    its consumers (at most 512, whole warps) and its producer warp, tiles and
    runs are whole multiples of 4 rows, and the pairs fill an H100's 132 SMs
    at most once; elsewhere it is the complex64 plan itself."""
    S = 5
    for K, bwb, tile in itertools.product(Ks, range(0, 3000, 13), (None, 32, 160)):
        plan32 = cg._launch_plan(250855, bwb, K, tile)
        plan = cg._launch_plan(250855, bwb, K, tile, "bf16", S)
        assert (plan is None) == (plan32 is None)
        if plan is None:
            continue
        if plan.cluster == 1:
            assert plan == plan32 and plan.stage_bytes == 0
            continue
        T, TK, depth, run, ctas, threads, smem = plan
        assert K >= 2 and TK == min(ce.probe_tile(K), 8) // 2 and (tile is None or T == tile)
        assert smem == cg._cluster_smem(bwb, TK, K, T, depth + 1, S) <= cg.SMEM_LIMIT and 1 <= depth + 1 <= 4
        assert threads <= cg.CLUSTER_CONSUMERS and threads % 32 == 0 and T % 4 == 0 and run % 4 == 0
        assert plan.stage_bytes == T * S * (64 + 4) and (tile is not None or T >= cg.CLUSTER_MIN_TILE)
        assert ctas == -(-250855 // run) and 2 * ctas * -(-K // (2 * TK)) <= ce.DEFAULT_SMS


def test_bf16_plan_at_the_sheet_and_where_it_keeps_one_block():
    """The sheet's shape (bwb 293, S = 5, K = 8): a pair of blocks a run of
    3804 rows, 4 columns each, tiles of 96 rows in three stages of 32 640
    bytes, 223 824 bytes a block.  K = 1 leaves no columns to split, and a
    band too wide for tiles of 64 rows beside the stages keeps the one-block
    form, the complex64 plan.  A layout records its form; both forms of one
    skeleton share the relabelled skeleton, and the sweep's plan takes the
    operator's form."""
    plan = cg._launch_plan(250855, 293, 8, None, "bf16", 5)
    assert plan == (96, 4, 2, 3804, 66, 512, 223824) and plan.cluster == 2 and plan.stage_bytes == 32640
    assert plan[6] <= 232448
    for K, bwb in ((1, 293), (8, 600), (3, 2000)):
        one = cg._launch_plan(250855, bwb, K, None, torch.bfloat16, 5)
        assert one.cluster == 1 and one == cg._launch_plan(250855, bwb, K)
    st = build_ring(T, 40, device="cpu")
    sk = st.skeleton
    gl, gl16 = cg.plan_gather(sk, 8), cg.plan_gather(sk, 8, operator_dtype="bf16")
    assert (gl.cluster, gl.stage_bytes) == (1, 0)
    assert gl16.cluster == 2 and gl16.sk is gl.sk
    assert cg.plan_gather(sk, 8, operator_dtype="bf16") is gl16 and cg.plan_gather(sk, 1, operator_dtype="bf16").cluster == 1
    assert ck.StepPlan(sk, 8, "plain_gather", st.data, torch.bfloat16).layout is cg.plan_gather(
        sk, 8, operator_dtype=torch.bfloat16)
    rel = gl16.device_rel(torch.device("cpu"))
    assert rel.shape[0] % 4 == 0 and (rel[: sk.n_sites].numpy() == gl16.rel).all() and (rel[sk.n_sites:] == cg.PAD_REL).all()
    v = torch.as_tensor(_vector(40, 8, 1))
    d16 = ce.bf16_operator(gl16.relabel(st.data.to(torch.complex64)))
    np.testing.assert_array_equal(cg.ell_gather_spmm(d16, gl16, v).numpy(), cg.ell_gather_spmm(d16, gl, v).numpy())
