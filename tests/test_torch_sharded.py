"""PyTorch port, the row-sharded path over ``torch.distributed``.

One module-scoped fixture spawns four gloo ranks once, on CPU tensors in
complex128, and brings back what they computed: the halo product, the
moments on the rows mesh (overlap split on and off) and on a 2×2 rows ×
probes mesh, the free energy, LDOS and DOS, and the value and gradient of
the row-sharded gap objective for the s- and d-wave channels (the bond
field crosses slab edges).  The tests hold them against the reference's
sharded XLA path on a four-device virtual mesh (identical probes, 1e-10),
against the reference's single-device KPM calls, and the objective against
the reference's ``make_total_free_energy(method="kpm")`` with the same
probes and scale and against the port's own one-rank objective (1e-8).
The ranks import neither ``jax`` nor ``bodge_tpu``: this module imports them
only inside its tests.

The reference's ``impl="pallas_sharded"`` objective runs interpret-mode
Pallas inside ``shard_map``; its own test costs about 70 s of the suite
(six workers, one BLAS thread each, 8-core CPU), so it is not called here.
"""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import bodge_tpu_torch as T
from bodge_tpu_torch.models import selfconsistency as tsc
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.parallel import multihost
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.parallel import cuda_sharded as cs
from bodge_tpu_torch.parallel.cuda_sharded import chebyshev_scan_sharded
from bodge_tpu_torch.parallel.sharded import RowMesh
from bodge_tpu_torch.parallel import (
    RowSharding,
    dos_kpm_sharded_cuda,
    free_energy_kpm_sharded,
    free_energy_kpm_sharded_cuda,
    initialize_multihost,
    is_multihost,
    ldos_kpm_sharded_cuda,
    local_device_count,
    make_row_mesh,
    moments_sharded,
    moments_sharded_cuda,
    pack_operator_sharded,
    spmm_sharded,
    spmm_sharded_cuda,
)
from bodge_tpu_torch.parallel.cuda_sharded import moments_sharded_ad
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SHAPE = (12, 3, 2)  # four ranks of three x-planes: the overlap split has an interior
ORDER, K, SCALE, TEMP = 16, 4, 6.0, 0.1
SITES = [5, 30, 41, 70]
ENERGIES = np.linspace(-1.0, 1.0, 9)
OBJECTIVE = dict(V=1.5, temperature=0.1, method="kpm", order=16, samples=4)


def build_system(pkg, **kw):
    """The reference's row-sharding test system: open boundaries, a site-dependent on-site pairing."""
    lattice = pkg.CubicLattice(SHAPE)
    system = pkg.Hamiltonian(lattice, **kw)
    phase = np.random.default_rng(3).normal(size=(lattice.size, 1, 1))
    system.assemble(
        onsite=lambda ci: -0.7 * pkg.σ0 - 0.2 * pkg.σ3,
        pairing_onsite=lambda ci: (0.3 + 0.1 * phase) * pkg.jσ2,
        hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * pkg.σ0, 0),
    )
    return system


def normal_metal(pkg, **kw):
    system = pkg.Hamiltonian(pkg.CubicLattice(SHAPE), **kw)
    system.assemble(onsite=lambda ci: 0.4 * pkg.σ0, check=False, hopping=lambda ci, cj: np.where(
        (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * pkg.σ0, 0))
    return system


def _objective(system, pairing, task, **kw):
    """Value and gradient of the objective at the task's field."""
    F = tsc.make_total_free_energy(system, pairing=pairing, probes=task["probes"][pairing],
                                   scale=task["scales"][pairing], **OBJECTIVE, **kw)
    x = torch.as_tensor(task["field"]).requires_grad_(True)
    value = F(x.to(torch.complex128))
    (grad,) = torch.autograd.grad(value, x)
    return float(value.detach()), grad.numpy()


def _rank(rank, world, port, task, queue):
    """One gloo rank: every sharded entry point on CPU tensors."""
    assert initialize_multihost(f"localhost:{port}", world, rank, backend="gloo") and is_multihost()
    try:
        data, v = task["data"], task["v"]
        sk = tbs.skeleton(SHAPE)
        mesh = make_row_mesh(devices="cpu")
        rs = RowSharding(sk, mesh)
        out = {"no_reference_imported": not any(m in sys.modules for m in ("jax", "bodge_tpu")),
               "planes": rs.slab.planes, "mesh": dict(mesh.shape)}
        out["spmm"] = spmm_sharded(rs, data, v).numpy()
        out["moments"] = moments_sharded(rs, data, v, ORDER, SCALE).numpy()
        out["free_energy"] = free_energy_kpm_sharded(rs, data, TEMP, SCALE, order=ORDER, samples=K)
        for overlap in (False, True):
            out[("spmm_cuda", overlap)] = spmm_sharded_cuda(rs, data, v, overlap=overlap).numpy()
            out[("moments_cuda", overlap)] = moments_sharded_cuda(rs, data, v, ORDER, SCALE, overlap=overlap).numpy()
        out["free_energy_cuda"] = free_energy_kpm_sharded_cuda(rs, data, TEMP, SCALE, order=ORDER, samples=K)
        out["scan"] = rs.gather_rows(chebyshev_scan_sharded(rs, data, v, 1.0 / SCALE, 5, overlap=True)).numpy()
        out["ldos"] = ldos_kpm_sharded_cuda(rs, data, SITES, ENERGIES, order=ORDER, scale=SCALE)
        out["dos"] = dos_kpm_sharded_cuda(rs, data, ENERGIES, order=ORDER, scale=SCALE, samples=K)
        rs2 = RowSharding(sk, make_row_mesh(devices="cpu", probe_shards=2))
        out["mesh2"] = dict(rs2.mesh.shape)
        out["moments_2x2"] = moments_sharded_cuda(rs2, data, v, ORDER, SCALE).numpy()
        packed = pack_operator_sharded(rs, data, "bf16")
        out["bf16_slab"] = (tuple(packed.shape), str(packed.dtype))
        out["moments_bf16"] = moments_sharded_cuda(rs, packed, v, ORDER, SCALE, overlap=True).numpy()
        with pytest.raises(ValueError, match="rows only"):
            spmm_sharded_cuda(rs2, data, v)
        metal = normal_metal(T, device="cpu")
        for pairing in (None, "dwave"):
            for overlap in (False, True):
                out[("objective", pairing, overlap)] = _objective(
                    metal, pairing, task, impl="plain_sharded", mesh=mesh, overlap=overlap)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks():
    """The task (NumPy inputs) and rank 0's results of one four-rank gloo run."""
    import jax
    import jax.numpy as jnp

    import bodge_tpu as J
    from bodge_tpu.models import selfconsistency as jsc
    from bodge_tpu.ops import chebyshev as jkpm

    from bodge_tpu.ops import blocksparse as jbs

    system = build_system(T, device="cpu")
    rng = np.random.default_rng(1)
    N = system.skeleton.n_sites
    metal_j = normal_metal(J)
    assert np.array_equal(np.asarray(metal_j.host_data()), normal_metal(T, device="cpu").host_data())
    probes, scales = {}, {}
    for pairing in (None, "dwave"):  # the reference objective's own probes and scale
        z = jax.random.rademacher(jax.random.PRNGKey(11), (N, 4, OBJECTIVE["samples"]), dtype=jnp.float64)
        probes[pairing] = np.asarray(z) / np.sqrt(4 * N)
        base, struct = jnp.asarray(metal_j.data), jsc._resolve_pairing(pairing, metal_j.skeleton)
        head = jnp.full((N,), 2.0, dtype=base.dtype)
        d = (jsc.data_with_onsite_swave(base, head) if struct is None
             else jsc.data_with_bond_singlet(base, head, metal_j.skeleton, struct))
        scales[pairing] = float(jkpm.spectral_bound(d, metal_j.skeleton, impl="stencil"))
    task = {"data": system.host_data(), "v": rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K)),
            "field": 0.3 + 0.1 * rng.normal(size=N), "probes": probes, "scales": scales}
    # A fork server that has imported this module (torch and the port, not the
    # reference) once: the four ranks fork from it instead of importing it
    # four times, and none of them starts from this process, which runs JAX.
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, 4, port, task, queue)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=300)  # read before joining: rank 0 cannot exit with its result unread
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0, 0, 0], f"ranks ended with {codes}"
    # The reference's side: the same skeleton and blocks (the port's assembly
    # is bit-equal to the reference's, tests/test_torch_hamiltonian.py).
    return task, out, {"sk": jbs.skeleton(SHAPE), "metal": metal_j}


def test_ranks_import_no_reference_and_split_the_lattice(four_ranks):
    _, out, _ = four_ranks
    assert out["no_reference_imported"]
    assert out["planes"] == 3 and out["mesh"] == {"rows": 4}
    assert out["mesh2"] == {"rows": 2, "probes": 2}


def test_product_and_moments_match_reference_xla_path(four_ranks):
    """spmm_sharded / moments_sharded of the reference on a four-device
    virtual mesh (x64) against the four ranks' ``spmm_sharded``,
    ``moments_sharded`` and the fused-step forms: overlap split off and on,
    and the 2×2 rows × probes mesh.  1e-10.  And the four ranks'
    ``chebyshev_scan_sharded`` against the plain whole-lattice recursion."""
    import jax
    import jax.numpy as jnp
    from bodge_tpu.parallel import RowSharding as JRowSharding
    from bodge_tpu.parallel import make_row_mesh as j_make_row_mesh
    from bodge_tpu.parallel import moments_sharded as j_moments
    from bodge_tpu.parallel import spmm_sharded as j_spmm

    task, out, ref = four_ranks
    rs = JRowSharding(ref["sk"], j_make_row_mesh(4))
    # One program (eagerly, each operation of the shard_map compiles alone).
    y = np.asarray(jax.jit(lambda d, v: j_spmm(rs, d, v))(jnp.asarray(task["data"]), jnp.asarray(task["v"])))
    mu = np.asarray(j_moments(rs, jnp.asarray(task["data"]), jnp.asarray(task["v"]), ORDER, SCALE))
    for got in (out["spmm"], out[("spmm_cuda", False)], out[("spmm_cuda", True)]):
        assert np.abs(got - y).max() <= 1e-10 * np.abs(y).max()
    for got in (out["moments"], out[("moments_cuda", False)], out[("moments_cuda", True)], out["moments_2x2"]):
        assert got.shape == (ORDER, K) and np.abs(got - mu).max() <= 1e-10 * np.abs(mu).max()
    # chebyshev_scan_sharded: five steps from (t_prev, t_cur) = (v, v), as the reference's scan.
    d, sk = torch.as_tensor(task["data"]), tbs.skeleton(SHAPE)
    t_prev = t_cur = torch.as_tensor(task["v"])
    for _ in range(5):
        t_prev, t_cur = t_cur, ce.ell_cheb_step_plain(d, sk, t_cur, t_prev, 1.0 / SCALE)[0]
    assert np.abs(out["scan"] - t_cur.numpy()).max() <= 1e-10 * np.abs(t_cur.numpy()).max()


def test_free_energy_ldos_dos_match_reference(four_ranks):
    """The free energy against the reference's ``free_energy_kpm_sharded``
    (same probes for ``key=None`` / ``seed=None``, 1e-10); the LDOS of four
    sites and the DOS against the port's single-device KPM calls on the same
    probes and scale, which ``tests/test_torch_chebyshev.py`` holds against
    the reference's (1e-10 of the curve's maximum)."""
    import jax.numpy as jnp
    from bodge_tpu.parallel import RowSharding as JRowSharding
    from bodge_tpu.parallel import free_energy_kpm_sharded as j_free_energy
    from bodge_tpu.parallel import make_row_mesh as j_make_row_mesh

    task, out, ref = four_ranks
    F = j_free_energy(JRowSharding(ref["sk"], j_make_row_mesh(4)), jnp.asarray(task["data"]), TEMP, SCALE,
                      order=ORDER, samples=K)
    for got in (out["free_energy"], out["free_energy_cuda"]):
        assert abs(got - F) <= 1e-10 * abs(F)
    d, sk = torch.as_tensor(task["data"]), tbs.skeleton(SHAPE)
    ldos = tkpm.ldos_kpm_sites(d, sk, SITES, ENERGIES, order=ORDER, scale=SCALE)
    dos = tkpm.dos_kpm(d, sk, ENERGIES, order=ORDER, scale=SCALE, samples=K)
    assert np.abs(out["ldos"] - ldos).max() <= 1e-10 * np.abs(ldos).max()
    assert np.abs(out["dos"] - dos).max() <= 1e-10 * np.abs(dos).max()


@pytest.mark.parametrize("pairing", [None, "dwave"], ids=["swave", "dwave"])
def test_sharded_objective_matches_reference_and_one_rank(four_ranks, pairing):
    """Value and gradient with respect to a real field, four ranks (overlap
    split off and on) against the reference's KPM objective with the same
    probes and scale and against the port's one-rank objective in this
    process.  1e-8 of the value and of the largest gradient entry."""
    import jax
    import jax.numpy as jnp
    from bodge_tpu.models import selfconsistency as jsc

    task, out, ref = four_ranks
    F_j = jsc.make_total_free_energy(ref["metal"], pairing=pairing, impl="stencil", **OBJECTIVE)
    v_j, g_j = jax.value_and_grad(lambda x: F_j(x.astype(jnp.complex128)))(jnp.asarray(task["field"]))
    v_j, g_j = float(v_j), np.asarray(g_j)
    one_rank = _objective(normal_metal(T, device="cpu"), pairing, task, impl="plain_sharded")
    for value, grad in (out[("objective", pairing, False)], out[("objective", pairing, True)], one_rank):
        assert abs(value - v_j) <= 1e-8 * abs(v_j)
        assert np.abs(grad - g_j).max() <= 1e-8 * np.abs(g_j).max()
    assert np.abs(g_j).max() > 1e-3  # a gradient worth comparing


def test_bf16_slabs_match_the_whole_lattice(four_ranks):
    """Four ranks on ``pack_operator_sharded(..., "bf16")`` slabs (the halo
    step's plain version on the bf16 form, overlap split on) against the whole
    lattice's bf16 moments of the port's single-device sweep: 1e-10."""
    task, out, _ = four_ranks
    sk = tbs.skeleton(SHAPE)
    assert out["bf16_slab"] == ((sk.n_sites // 4, sk.n_slots, 4, 4, 2), "torch.bfloat16")
    want = tkpm.moments(torch.as_tensor(task["data"]), sk, task["v"], ORDER, SCALE, operator_dtype="bf16").numpy()
    assert np.abs(out["moments_bf16"] - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(want - out[("moments_cuda", False)]).max() > 1e-6 * np.abs(want).max()  # the form was used


def test_remat_gradients_bit_equal_and_saved_vectors_bounded():
    """The sharded sweep's gradient in a world of one on 8×8, order 66 (32
    steps): bit-equal for ``remat`` off, ``"auto"`` (chunks of ⌊√32⌋ = 5) and
    3, and the tensors the sweep saves for its backward pass (counted by
    ``saved_tensors_hooks``) number O(steps / chunk + chunk), not O(steps)."""
    shape, order = (8, 8, 1), 66
    system = T.Hamiltonian(T.CubicLattice(shape), device="cpu")
    system.assemble(onsite=lambda ci: -0.3 * T.σ0, pairing_onsite=lambda ci: 0.25 * T.jσ2,
                    hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -T.σ0, 0))
    rs = RowSharding(system.skeleton, make_row_mesh(devices="cpu"))
    before, after = rs.halo_rows()
    z = torch.as_tensor(np.random.default_rng(8).normal(size=(64, 4, 2)) + 0j)
    w = torch.linspace(1.0, -0.5, order, dtype=torch.float64)
    steps = ce.sweep_launches(order) - 1
    assert cs.remat_chunk_for(order, "auto") == 5 and cs.remat_chunk_for(order, None) == 5
    assert cs.remat_chunk_for(order, False) == 0 and cs.remat_chunk_for(order, 3) == 3
    assert cs.remat_chunk_for(60, "auto") == 0  # fewer than 32 steps
    grads, saved = {}, {}
    for remat in (False, "auto", 3):
        data, v0 = system.data.clone().requires_grad_(True), z.clone().requires_grad_(True)
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            mu = moments_sharded_ad(rs, data, v0, 1.0 / 6.0, order, data[before].detach(), data[after].detach(),
                                    remat=remat)
        grads[remat] = torch.autograd.grad((w[:, None] * mu).sum(), (data, v0))
        saved[remat] = count[0]
    for remat in ("auto", 3):
        for got, want in zip(grads[remat], grads[False]):
            assert torch.equal(got, want)
    assert saved[False] >= 3 * steps
    for remat, chunk in (("auto", 5), (3, 3)):
        assert saved[remat] <= 2 * (steps // chunk + chunk) + 12, saved
    with pytest.raises(ValueError, match="remat"):
        moments_sharded_ad(rs, system.data, z, 0.1, order, system.data[before], system.data[after], remat="always")


def test_one_rank_mesh_and_row_sharding_checks():
    """Without a process group the mesh is a world of one: the ring is a
    local copy (the slab's own last and first planes, buffers of their own),
    and the halo product is the whole product.  The reference's checks."""
    system = build_system(T, device="cpu")
    sk = system.skeleton
    mesh = make_row_mesh(devices="cpu")
    assert mesh.shape == {"rows": 1} and mesh.backend is None and mesh.device == torch.device("cpu")
    rs = RowSharding(sk, mesh)
    assert rs.n_shards == 1 and not rs.has_probe_axis and rs.slab.planes == SHAPE[0]
    v = torch.as_tensor(np.random.default_rng(2).normal(size=(sk.n_sites, 4, 2)) + 0j)
    hm, hp = rs.exchange(v)
    assert torch.equal(hm, v[-6:]) and torch.equal(hp, v[:6])
    assert hm.data_ptr() != v[-6:].data_ptr() and hp.data_ptr() != v.data_ptr()
    assert rs.stats["exchanges"] == 1
    assert torch.allclose(spmm_sharded(rs, system.data, v), system.apply(v), atol=1e-12, rtol=0)
    assert torch.equal(rs.shard_data(system.data), system.data) and torch.equal(rs.shard_vector(v), v)
    before, after = rs.halo_rows()
    assert np.array_equal(before, np.arange(66, 72)) and np.array_equal(after, np.arange(6))
    with pytest.raises(ValueError, match="divide evenly"):
        RowSharding(tbs.skeleton((5, 3, 1)), RowMesh({"rows": 2}, 0, 0, None, None, (0, 1), torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="stencil"):
        RowSharding(tbs.skeleton_from_pairs(3, np.arange(3), np.arange(3)), mesh)
    with pytest.raises(ValueError, match="rows"):
        rs.shard_vector(v[:5])
    with pytest.raises(ValueError, match="probe shards"):
        make_row_mesh(devices="cpu", probe_shards=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices='cpu'"):
            make_row_mesh()
    with pytest.raises(RuntimeError, match="CUDA device"):
        moments_sharded_cuda(rs, system.data, v, 4, SCALE, impl="cuda")
    with pytest.raises(ValueError, match="Unknown kernel implementation"):
        tsc.make_total_free_energy(system, V=1.0, method="kpm", impl="pallas_sharded")


def test_multihost_is_a_no_op_without_a_multi_process_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False  # no env, no arguments → no-op
    assert not dist.is_initialized() and is_multihost() is False
    assert local_device_count() == torch.cuda.device_count()
    assert multihost._env_looks_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost._env_looks_multihost() is False  # a world size alone names no coordinator
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert multihost._env_looks_multihost() is True
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost._env_looks_multihost() is False  # one process: nothing to join
