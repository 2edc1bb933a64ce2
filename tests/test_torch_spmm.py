"""PyTorch port, block SpMM and the fused Chebyshev step: the plain versions
against the ``bodge_tpu`` stencil in complex128 (atol 1e-12: same sums in
another order), and against the Pallas kernels in interpret mode in
complex64 (atol = rtol = 2e-4: float32 sums in another order, the tolerance
of tests/test_pallas.py), in the flat and in the plane layout.  Both
packages compute on the same operator, carried across as NumPy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bodge_tpu.ops import blocksparse as jbs
from bodge_tpu.ops import pallas_spmm as pk
from bodge_tpu.ops import spmm as jspmm
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import cuda_ell as te
from bodge_tpu_torch.ops import cuda_spmm as tk
from bodge_tpu_torch.ops import spmm as tspmm
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def random_blocks(shape, pbc, seed=0):
    """Random complex blocks on every structural slot of the cubic skeleton;
    the periodic wrap blocks are non-zero when ``pbc`` and zero otherwise."""
    sk = jbs.skeleton(shape)
    rng = np.random.default_rng(seed)
    N, S = sk.cols.shape
    data = rng.normal(size=(N, S, 4, 4)) + 1j * rng.normal(size=(N, S, 4, 4))
    keep = sk.valid.copy()
    if not pbc:
        coords = np.stack(np.unravel_index(np.arange(N), shape), axis=1)
        for s, (axis, d) in enumerate(sk.slots):
            if axis >= 0:
                moved = coords[:, axis] + d
                keep[:, s] &= (moved >= 0) & (moved < shape[axis])
    return data * keep[..., None, None], sk


# One XLA program per shape instead of one per roll and einsum.
jax_stencil = jax.jit(jspmm.spmm_stencil, static_argnums=1)


def random_vector(N, K, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(dtype)


SHAPES = [
    ((6, 5, 1), False),
    ((6, 5, 1), True),
    ((4, 7, 1), True),
    ((4, 4, 3), False),
    ((4, 4, 3), True),
    ((3, 1, 5), True),
    ((5, 6, 4), True),
]


@pytest.mark.parametrize("shape,pbc", SHAPES)
def test_plain_spmm_matches_jax_stencil(shape, pbc):
    data, skj = random_blocks(shape, pbc)
    st = hamiltonian_from_numpy(shape, data, skj.cols, device="cpu")
    v = random_vector(st.lattice.size, 3, seed=1)
    want = np.asarray(jax_stencil(jnp.asarray(data), skj, jnp.asarray(v)))
    vt = torch.as_tensor(v)
    sk = st.skeleton
    for fn in (tspmm.spmm_stencil, tspmm.spmm_gather, te.ell_spmm_plain, te.ell_spmm):
        got = fn(st.data, sk, vt).numpy()
        assert np.allclose(got, want, atol=1e-12, rtol=0), fn.__name__
    for impl in (None, "plain", "stencil", "gather"):
        assert np.allclose(st.apply(v, impl=impl).numpy(), want, atol=1e-12, rtol=0)
    assert te.ell_spmm.launches == 0  # the plain version launches nothing


def test_extent_two_padding_slot_and_generic_skeleton():
    # (2, 6, 1): the -1 slot of the extent-2 axis is padding (cols = -1).
    data, skj = random_blocks((2, 6, 1), True, seed=5)
    st = hamiltonian_from_numpy((2, 6, 1), data, device="cpu")
    assert (st.skeleton.cols < 0).any()
    v = random_vector(12, 2, seed=2)
    want = np.asarray(jax_stencil(jnp.asarray(data), skj, jnp.asarray(v)))
    assert np.allclose(te.ell_spmm_plain(st.data, st.skeleton, torch.as_tensor(v)).numpy(), want,
                       atol=1e-12, rtol=0)
    dense = st.matrix("dense") @ v.reshape(48, 2)
    assert np.allclose(want.reshape(48, 2), dense, atol=1e-12)

    # A generic skeleton from a pair list: gather path in both packages.
    rng = np.random.default_rng(4)
    r = np.concatenate([np.arange(9), rng.integers(0, 9, size=14)])
    c = np.concatenate([np.arange(9), rng.integers(0, 9, size=14)])
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    skt, skj = tbs.skeleton_from_pairs(9, rows, cols), jbs.skeleton_from_pairs(9, rows, cols)
    data = random_vector(9 * skt.n_slots * 4, 1, seed=6).reshape(9, skt.n_slots, 4, 4)
    data = data * skt.valid[..., None, None]
    v = random_vector(9, 5, seed=7)
    want = np.asarray(jspmm.spmm(jnp.asarray(data), skj, jnp.asarray(v), impl="stencil"))
    got = tspmm.spmm(torch.as_tensor(data), skt, torch.as_tensor(v), impl="stencil").numpy()
    assert np.allclose(got, want, atol=1e-12, rtol=0)
    got = te.ell_spmm_plain(torch.as_tensor(data), skt, torch.as_tensor(v)).numpy()
    assert np.allclose(got, want, atol=1e-12, rtol=0)


def _pallas_cheb_step(data64, sk, t_cur, t_prev, inv, K):
    b = pk.pack_operator(data64, sk, K)
    t_next_p, pp = pk.chebyshev_step_pallas(
        b, pk.pack_vector(t_cur, sk), pk.pack_vector(t_prev, sk), jnp.float32(inv), sk, K
    )
    t_next = np.asarray(pk.unpack_vector(t_next_p, sk, K, jnp.complex64))
    return t_next, np.asarray(jnp.sum(pp, axis=0))


def _check_cheb_step_against_pallas(shape, pbc):
    K, inv = 4, 1.0 / 8.0
    data, sk = random_blocks(shape, pbc, seed=3)
    data64 = data.astype(np.complex64)
    N = sk.n_sites
    t_cur = random_vector(N, K, seed=8, dtype=np.complex64)
    t_prev = random_vector(N, K, seed=9, dtype=np.complex64)
    want_next, want_sums = _pallas_cheb_step(data64, sk, t_cur, t_prev, inv, K)

    st = hamiltonian_from_numpy(shape, data64, sk.cols, dtype=np.complex64, device="cpu")
    got_next, pp = te.ell_cheb_step_plain(
        st.data, st.skeleton, torch.as_tensor(t_cur), torch.as_tensor(t_prev), inv
    )
    assert pp.shape == (1, 2 * K) and pp.dtype == torch.float32
    assert np.allclose(got_next.numpy(), want_next, atol=2e-4, rtol=2e-4)
    assert np.allclose(pp.sum(dim=0).numpy(), want_sums, atol=2e-4, rtol=2e-4)
    return st, t_cur, t_prev, inv, got_next, pp


def test_cheb_step_plain_matches_pallas_flat_layout():
    assert pk.plan(jbs.skeleton((6, 5, 1)), 4).mode == "flat"
    st, t_cur, t_prev, inv, got_next, pp = _check_cheb_step_against_pallas((6, 5, 1), True)
    # The wrapper on CPU tensors is the plain version; t_prev=None means zero.
    again, pp2 = te.ell_cheb_step(st.data, st.skeleton, torch.as_tensor(t_cur),
                                  torch.as_tensor(t_prev), inv)
    assert torch.equal(again, got_next) and torch.equal(pp2, pp)
    zero = torch.zeros_like(again)
    a, pa = te.ell_cheb_step(st.data, st.skeleton, torch.as_tensor(t_cur), None, inv)
    b, pb = te.ell_cheb_step(st.data, st.skeleton, torch.as_tensor(t_cur), zero, inv)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert te.ell_cheb_step.launches == 0


def test_cheb_step_plain_matches_pallas_plane_layout(monkeypatch):
    monkeypatch.setattr(pk, "FLAT_VECTOR_VMEM_MAX", 0)
    assert pk.plan(jbs.skeleton((5, 3, 2)), 4).mode == "planes"
    _check_cheb_step_against_pallas((5, 3, 2), True)


def test_cheb_step_plain_complex128_definition():
    st = hamiltonian_from_numpy((4, 3, 1), random_blocks((4, 3, 1), True, seed=2)[0], device="cpu")
    N, K, inv = 12, 3, 0.2
    t_cur, t_prev = (torch.as_tensor(random_vector(N, K, s)) for s in (1, 2))
    t_next, pp = te.ell_cheb_step_plain(st.data, st.skeleton, t_cur, t_prev, inv)
    H = torch.as_tensor(st.matrix("dense"))
    want = 2 * inv * (H @ t_cur.reshape(4 * N, K)).reshape(N, 4, K) - t_prev
    assert torch.allclose(t_next, want, atol=1e-12, rtol=0)
    assert pp.dtype == torch.float64
    assert torch.allclose(pp[0, :K], (t_cur.conj() * t_cur).real.sum(dim=(0, 1)), atol=1e-12)
    assert torch.allclose(pp[0, K:], (t_next.conj() * t_cur).real.sum(dim=(0, 1)), atol=1e-12)


def test_accountants_equal():
    for shape, K in (((6, 5, 1), 4), ((2, 6, 1), 8), ((4, 4, 3), 1)):
        skt, skj = tbs.skeleton(shape), jbs.skeleton(shape)
        assert tspmm.spmm_bytes(skt, K, 8) == jspmm.spmm_bytes(skj, K, 8)
        assert tspmm.chebyshev_step_bytes(skt, K, 8) == jspmm.chebyshev_step_bytes(skj, K, 8)
        assert tspmm.chebyshev_step_bytes(skt, K, 8, 2) == jspmm.chebyshev_step_bytes(skj, K, 8, 2)
        assert tspmm.spmm_flops(skt, K) == jspmm.spmm_flops(skj, K)
        assert tspmm.spmm_flops(skt, K, False) == jspmm.spmm_flops(skj, K, False)
    assert [te.probe_tile(K) for K in (1, 2, 3, 4, 8, 33, 2304)] == [1, 2, 4, 4, 8, 32, 32]
    assert [te.sweep_launches(o) for o in (1, 2, 3, 7, 32, 256)] == [1, 1, 2, 4, 16, 128]


def test_wrappers_refuse_what_the_kernel_does_not_take():
    sk = tbs.skeleton((4, 3, 1))
    data = torch.zeros((12, sk.n_slots, 4, 4), dtype=torch.complex64)
    v = torch.zeros((12, 4, 2), dtype=torch.complex64)
    # impl="cuda" on CPU tensors raises instead of carrying on on the CPU.
    with pytest.raises(RuntimeError, match="CPU"):
        te.ell_spmm(data, sk, v, impl="cuda")
    with pytest.raises(RuntimeError, match="CPU"):
        te.ell_cheb_step(data, sk, v, None, 0.1, impl="cuda")
    with pytest.raises(RuntimeError, match="CPU"):
        tk.moments_fused(data, sk, v, 0.1, 4, impl="cuda")
    with pytest.raises(RuntimeError, match="CPU"):
        tspmm.spmm(data, sk, v, impl="cuda")
    with pytest.raises(ValueError):
        te.ell_spmm(data, sk, v, impl="pallas")
    with pytest.raises(ValueError):
        tspmm.spmm(data, sk, v, impl="pallas")
    # The argument checks the kernel path applies before it launches.
    dev = v.device
    te._check_operand("v", v, (12, 4, 2), dev)
    with pytest.raises(ValueError, match="contiguous"):
        te._check_operand("v", v.transpose(0, 1), (4, 12, 2), dev)
    with pytest.raises(TypeError, match="complex64"):
        te._check_operand("v", v.to(torch.complex128), (12, 4, 2), dev)
    with pytest.raises(ValueError, match="shape"):
        te._check_operand("v", v, (12, 4, 3), dev)
    with pytest.raises(RuntimeError, match="expected"):
        te._check_operand("v", v, (12, 4, 2), torch.device("meta"))
    with pytest.raises(TypeError):
        te._check_operand("v", v.numpy(), (12, 4, 2), dev)
    with pytest.raises(ValueError, match=r"\[N, 4, K\]"):
        te._check_call(data, sk, v[:, :2])
    with pytest.raises(ValueError, match="shape"):
        te._check_call(data[:, :2], sk, v)
    assert te._check_call(data, sk, v) == (12, sk.n_slots, 2)
    assert tk.launch_counts() == {
        "ell_spmm": 0, "ell_cheb_step": 0, "ell_spmm_adjoint": 0, "ell_block_outer": 0,
        "ell_gather_spmm": 0, "ell_gather_cheb_step": 0, "stencil_cheb_step_tiled": 0,
        "ell_spmm_halo": 0, "ell_cheb_step_halo": 0, "ell_spmm_adjoint_halo": 0, "ell_block_outer_halo": 0,
        "ell_spmm_bf16": 0, "ell_cheb_step_bf16": 0, "ell_spmm_halo_bf16": 0, "ell_cheb_step_halo_bf16": 0,
        "ell_gather_spmm_bf16": 0, "ell_gather_cheb_step_bf16": 0, "stencil_cheb_step_tiled_bf16": 0,
        "ell_cheb_filter": 0, "ell_cheb_filter_bf16": 0, "ell_cheb_moments": 0, "ell_cheb_moments_bf16": 0,
        "ell_power_iteration": 0, "ell_cheb_step_window": 0, "ell_gather_cheb_step_window": 0,
        "ell_cheb_filter.steps": 0, "ell_cheb_filter_bf16.steps": 0, "ell_cheb_moments.steps": 0,
        "ell_cheb_moments_bf16.steps": 0, "ell_power_iteration.steps": 0,
    }
