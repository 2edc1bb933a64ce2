"""PyTorch port, the tiled Chebyshev step: its plain version (stencil
arithmetic on ``sk.slots``, no ``cols`` read) against the general step on open
and periodic lattices, thin and thick ones, and against the reference's
lane-tiled Pallas kernel in interpret mode at one shape; the tile plan; and the
opt-in dispatch (``impl="cuda_tiled"`` / ``BODGE_PLANE_TILED=1``).  The CUDA
kernel itself is held against this plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.ops import pallas_spmm as pk
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_spmm as ck
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def build_system(pkg, shape, pbc, seed=12, **kw):
    """The system of the reference's plane-layout tests: open or periodic bonds,
    an on-site singlet with a random modulation."""
    lattice = pkg.CubicLattice(shape)
    system = pkg.Hamiltonian(lattice, **kw)
    phase = np.random.default_rng(seed).normal(size=(lattice.size, 1, 1))

    def hopping(ci, cj):
        bond = (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        if pbc:
            bond = np.ones_like(bond)
        return np.where(bond, -1.0 * pkg.σ0, 0)

    system.assemble(
        onsite=lambda ci: -0.7 * pkg.σ0 - 0.2 * pkg.σ3,
        pairing_onsite=lambda ci: (0.3 + 0.1 * phase) * pkg.jσ2,
        hopping=hopping,
    )
    return system


def _vector(N, K, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K)))


def check_tiled_plain_against_general(shape, pbc):
    """1e-12: the same complex128 sums, slot by slot instead of row by row."""
    st = build_system(T, shape, pbc, device="cpu")
    sk = st.skeleton
    N, K = sk.n_sites, 3
    data = st.data.clone()
    data[~sk.device_valid("cpu")] = 7.0 + 1j  # padding slots hold garbage
    t_cur, t_prev = _vector(N, K, 1), _vector(N, K, 2)
    for prev in (t_prev, None):
        want, pp_want = ce.ell_cheb_step_plain(data, sk, t_cur, prev, 0.23)
        got, pp = ce.stencil_cheb_step_tiled(data, sk, t_cur, prev, 0.23)  # CPU tensor: the plain version
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(pp.numpy(), pp_want.numpy(), rtol=1e-12, atol=1e-12)
    plan = ce.tile_plan(sk, K)
    Lx, Ly, Lz = shape
    M = Ly * Lz
    assert plan["h"] == (Lz if Ly > 1 else Lz - 1) and plan["TK"] == 4
    assert plan["n_strips"] == -(-M // plan["PB"]) and 1 <= plan["PB"] <= M
    assert plan["ctas"] == -(-(plan["n_strips"] * Lx) // plan["XR"])  # the blocks' items cover the lattice once
    site = (4 * plan["TK"] + 1) * 8  # K = 3: 8-byte copies, one float2 of padding
    assert plan["smem_bytes"] == plan["NR"] * (plan["PB"] + 2 * plan["h"]) * site
    assert plan["smem_bytes"] <= ce.SMEM_LIMIT - 2 * ce.TILED_THREADS * 4 and 3 <= plan["NR"] <= 6


@pytest.mark.parametrize("shape", [(6, 5, 1), (4, 4, 3), (3, 1, 5), (1, 6, 4)])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
def test_tiled_plain_matches_general_step(shape, pbc):
    """Two- and three-dimensional lattices, Lz > 1, a missing axis.  (The thin
    ones, extents 1 and 2, are in ``test_torch_tiled_thin.py``.)"""
    check_tiled_plain_against_general(shape, pbc)


def test_tiled_plain_matches_reference_tiled_kernel(monkeypatch):
    """Against ``_plane_cheb_step_tiled`` (interpret mode, float32) on a 3D
    periodic lattice — z shifts, z wrap and y wrap: 1e-4 on ``t_next`` and the
    reference test's own tolerance on the column sums."""
    monkeypatch.setattr(pk, "FLAT_VECTOR_VMEM_MAX", 0)  # make the reference plan the plane layout
    shape, K = (8, 36, 4), 4
    sj, st = build_system(J, shape, True), build_system(T, shape, True, device="cpu")
    assert np.array_equal(st.host_data(), np.asarray(sj.host_data()))
    sk_j, sk = sj.skeleton, st.skeleton
    lo = pk.plan(sk_j, K)
    assert lo.mode == "planes" and pk._tile_plan(sk_j, K, lo.P) is not None
    rng = np.random.default_rng(3)
    N = sk.n_sites
    v = (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(np.complex64)
    prev = (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(np.complex64)
    b = pk.pack_operator(np.asarray(sj.host_data()), sk_j, K, layout=lo)
    t_j, pp_j = pk._plane_cheb_step_tiled(
        b, pk.pack_vector(v, sk_j, layout=lo), pk.pack_vector(prev, sk_j, layout=lo), jnp.float32(0.23), sk_j, K)
    t_j = np.asarray(pk.unpack_vector(t_j, sk_j, K, np.complex64, layout=lo))
    got, pp = ce.stencil_cheb_step_tiled_plain(st.data, sk, torch.as_tensor(v).to(torch.complex128),
                                               torch.as_tensor(prev).to(torch.complex128), 0.23)
    np.testing.assert_allclose(got.numpy(), t_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pp[0].numpy(), np.asarray(pp_j).sum(axis=0), rtol=1e-5, atol=1e-3)


def test_tiled_dispatch_and_env_knob(monkeypatch):
    """Opt-in only: ``impl=None`` takes the tiled step on a stencil skeleton
    under ``BODGE_PLANE_TILED=1`` and not otherwise; a generic skeleton never
    does, and asking for it there raises."""
    st = build_system(T, (6, 5, 1), True, device="cpu")
    sk, data = st.skeleton, st.data
    v0 = _vector(sk.n_sites, 4, 5)
    generic = tbs.skeleton_from_lattice(T.CubicLattice((6, 5, 1)))
    monkeypatch.delenv("BODGE_PLANE_TILED", raising=False)
    assert not ck.use_tiled_step() and ck.resolve_path(None, data, sk, 4) == "plain"
    want = tkpm.moments(data, sk, v0, 16, 5.0).numpy()
    monkeypatch.setenv("BODGE_PLANE_TILED", "1")
    assert ck.use_tiled_step() and ck.resolve_path(None, data, sk, 4) == "plain_tiled"
    assert ck.resolve_path(None, data, generic, 4) == "plain_gather"
    assert ck.StepPlan(sk, 4, None, data).kind == "tiled"
    np.testing.assert_allclose(tkpm.moments(data, sk, v0, 16, 5.0).numpy(), want, atol=1e-12)
    assert st.free_energy(0.1, method="kpm", order=16, scale=5.0) == pytest.approx(
        st.free_energy(0.1, method="kpm", order=16, scale=5.0, impl="plain"), rel=1e-12)
    monkeypatch.delenv("BODGE_PLANE_TILED")
    np.testing.assert_allclose(tkpm.moments(data, sk, v0, 16, 5.0, impl="plain_tiled").numpy(), want, atol=1e-12)
    # Filtering through the tiled step is the same polynomial of H.
    coeffs = np.array([0.5, 0.0, -0.25, 0.0, 0.125])
    ys = [ck.filter_sweep(plan, data, v0, coeffs, 0.2)
          for plan in (ck.StepPlan(sk, 4, "plain", data), ck.StepPlan(sk, 4, "plain_tiled", data))]
    np.testing.assert_allclose(ys[1].numpy(), ys[0].numpy(), atol=1e-12)
    assert ck.filter_launches(len(coeffs)) == 4
    with pytest.raises(ValueError, match="stencil"):
        ce.stencil_cheb_step_tiled(data, generic, v0, None, 0.1)
    with pytest.raises(ValueError, match="stencil"):
        tkpm.moments(data, generic, v0, 8, 5.0, impl="plain_tiled")
    with pytest.raises(RuntimeError, match="CPU"):
        tkpm.moments(data, sk, v0, 8, 5.0, impl="cuda_tiled")
    with pytest.raises(RuntimeError, match="CPU"):
        ce.stencil_cheb_step_tiled(data, sk, v0, None, 0.1, impl="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        ce.tile_plan(sk, 8, tile=(64, 512))  # a strip wider than the plane of 5 sites
    with pytest.raises(ValueError, match="does not fit"):
        ce.tile_plan(tbs.skeleton((1, 40, 40)), 8, tile=(1600, 1))  # a ring of 4 × 1680 sites
    assert ce.tile_plan(sk, 8, tile=(3, 4, 5))["NR"] == 5 and ce.tile_plan(sk, 8, tile=(3, 4))["NR"] == 4
    assert ck.launch_counts()["stencil_cheb_step_tiled"] == 0  # plain versions count no launch


@pytest.mark.parametrize("shapes", [[(1000, 1000, 1), (64, 64, 4)], [(32, 32, 1), (32, 32, 32)]])
def test_tile_plan_fills_one_wave(shapes):
    """Plan only (no kernel): at K = 1, 8 and 64 the default plan's ring fits
    the three blocks an SM holds (or fewer, at the 32³ lattice's halo of 32),
    strips are a block's rows of sites or wider, and the blocks of all column
    tiles are one wave on an H100's 132 SMs, so at K = 64 the eight column
    tiles of a strip run side by side."""
    for shape in shapes:
        sk = tbs.skeleton(shape)
        M = shape[1] * shape[2]
        for K in (1, 8, 64):
            plan = ce.tile_plan(sk, K)
            per_sm = next(n for n in (3, 2, 1)
                          if plan["smem_bytes"] + 2 * ce.TILED_THREADS * 4 <= ce.SM_SHARED // n - ce.BLOCK_RESERVED)
            rows = ce.TILED_THREADS // plan["TK"]
            assert plan["PB"] == min(M, rows * max(1, -(-2 * plan["h"] // rows)))
            assert plan["ctas"] * -(-K // plan["TK"]) <= per_sm * ce.DEFAULT_SMS
            assert plan["NR"] >= 4  # at least one row in flight
        assert (per_sm, plan["NR"]) == ((3, 5) if shape != (32, 32, 32) else (1, 4))
