"""PyTorch port, the halo kernels of the row-sharded path (one x-slab of the
lattice with its neighbour planes as separate buffers).

On the CPU the wrappers run their plain versions.  These tests hold them
against the reference's jnp restatements ``_plane_stencil_halo_ref`` /
``_plane_cheb_step_halo_ref`` (x64, 1e-12: the same sums in another order)
through the plane layout ``[Lx, rows, P]`` of ``bodge_tpu/ops/pallas_spmm``
packed in float64, against one interpret-mode call of the Pallas kernel
``_plane_cheb_step_halo`` (float32, 2e-4), against the whole-lattice step
cut into slabs, and the backward pass in its gather form against
``torch.autograd`` and ``jax.vjp`` (1e-10).

Complex gradients: for a real loss JAX returns ∂L/∂x − i·∂L/∂y and PyTorch
∂L/∂x + i·∂L/∂y, so ``g_torch = conj(g_jax)``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bodge_tpu.ops import blocksparse as jbs
from bodge_tpu.ops import pallas_spmm as pk
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_spmm as ck
from bodge_tpu_torch.parallel import cuda_sharded as cs
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def _random(shape, rng):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def random_blocks(shape, pbc, rng):
    """Random blocks on every structural slot; wrap blocks zero unless ``pbc``.
    Their entries are float32 numbers held in complex128: the reference's
    restatements cast the packed operator to float32 and then compute in x64."""
    sk = tbs.skeleton(shape)
    N, S = sk.cols.shape
    keep = sk.valid.copy()
    if not pbc:
        coords = np.stack(np.unravel_index(np.arange(N), shape), axis=1)
        for s, (axis, d) in enumerate(sk.slots):
            if axis >= 0:
                keep[:, s] &= (coords[:, axis] + d >= 0) & (coords[:, axis] + d < shape[axis])
    blocks = _random((N, S, 4, 4), rng).astype(np.complex64).astype(np.complex128)
    return blocks * keep[..., None, None], sk


def pack_operator64(data, sk, P=None):
    """``[N, S, 4, 4]`` → the reference's plane layout ``[Lx, 2·S·16, P]``, in float64."""
    Lx, Ly, Lz = sk.shape
    P = P or pk.plane_layout(jbs.skeleton(sk.shape), 1).P
    d = np.moveaxis(data.reshape(Lx, Ly * Lz, sk.n_slots, 4, 4), 1, -1)
    out = np.zeros((Lx, 2, sk.n_slots, 4, 4, P))
    out[:, 0, ..., : Ly * Lz], out[:, 1, ..., : Ly * Lz] = d.real, d.imag
    return out.reshape(Lx, -1, P)


def pack_planes64(v, M, P):
    """``[X·M, 4, K]`` → ``[X, 4·2·K, P]`` (orbital-major rows), in float64."""
    K = v.shape[-1]
    v3 = np.moveaxis(v.reshape(-1, M, 4, K), 1, -1)
    out = np.zeros((v3.shape[0], 4, 2, K, P))
    out[:, :, 0, :, :M], out[:, :, 1, :, :M] = v3.real, v3.imag
    return out.reshape(v3.shape[0], -1, P)


def unpack_planes(vp, M, K):
    v = np.asarray(vp).reshape(vp.shape[0], 4, 2, K, -1)[..., :M]
    v = np.moveaxis(v, -1, 1)
    return (v[:, :, :, 0] + 1j * v[:, :, :, 1]).reshape(-1, 4, K)


# (shape, periodic, slab planes Lxl, K): thin slabs (Lxl = 1, both halo
# planes feed one plane), an interior plane, z-extent > 1, and Lx = 2, whose
# -x slot is padding on every row.
CASES = [
    ((6, 5, 1), True, 1, 3),
    ((6, 5, 1), False, 2, 1),
    ((5, 3, 2), False, 3, 3),
    ((2, 6, 1), True, 1, 3),
]


@pytest.mark.parametrize("shape,pbc,Lxl,K", CASES, ids=str)
def test_plain_halo_product_and_step_match_reference(shape, pbc, Lxl, K):
    rng = np.random.default_rng(sum(shape) + Lxl + K)
    data, sk = random_blocks(shape, pbc, rng)
    Lx, Ly, Lz = shape
    M, x0 = Ly * Lz, Lx - Lxl
    slab = ce.halo_slab(sk, x0, Lxl)
    n = slab.n_local
    v, tp = _random((n, 4, K), rng), _random((n, 4, K), rng)
    hm, hp = _random((M, 4, K), rng), _random((M, 4, K), rng)  # any planes: the kernels do not know their origin
    d_l = data[slab.rows]
    inv = 0.37

    skj = jbs.skeleton(shape)
    P = pk.plane_layout(skj, K).P
    b = jnp.asarray(pack_operator64(data, sk)[x0:])
    vp, tpp = jnp.asarray(pack_planes64(v, M, P)), jnp.asarray(pack_planes64(tp, M, P))
    hmp, hpp = jnp.asarray(pack_planes64(hm, M, P)), jnp.asarray(pack_planes64(hp, M, P))
    y_want = unpack_planes(pk._plane_stencil_halo_ref(skj, K, b, vp, hmp, hpp), M, K)
    t_want, pp_want = pk._plane_cheb_step_halo_ref(skj, K, b, vp, hmp, hpp, tpp, inv)
    t_want, sums_want = unpack_planes(t_want, M, K), np.asarray(pp_want).sum(axis=0)

    T = lambda x: torch.as_tensor(x)
    y = ce.ell_spmm_halo(T(d_l), slab, T(v), T(hm), T(hp))
    t_next, pp = ce.ell_cheb_step_halo(T(d_l), slab, T(v), T(hm), T(hp), T(tp), inv)
    assert np.abs(y.numpy() - y_want).max() <= 1e-12
    assert np.abs(t_next.numpy() - t_want).max() <= 1e-12
    assert pp.shape == (1, 2 * K) and np.abs(pp[0].numpy() - sums_want).max() <= 1e-12
    assert ce.ell_cheb_step_halo.launches == ce.ell_spmm_halo.launches == 0  # plain versions launch nothing


def test_halo_step_matches_pallas_kernel_in_interpret_mode():
    """The one interpret-mode call: ``_plane_cheb_step_halo`` on a slab of two
    planes, K = 2, float32 (2e-4, the Pallas kernels' tolerance)."""
    rng = np.random.default_rng(3)
    shape, K, Lxl, inv = (4, 3, 1), 2, 2, 0.21
    data, sk = random_blocks(shape, True, rng)
    M, x0 = 3, 1
    slab = ce.halo_slab(sk, x0, Lxl)
    v, tp = _random((6, 4, K), rng), _random((6, 4, K), rng)
    hm, hp = _random((M, 4, K), rng), _random((M, 4, K), rng)
    skj = jbs.skeleton(shape)
    P = pk.plane_layout(skj, K).P
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    t_want, pp_want = pk._plane_cheb_step_halo(
        f32(pack_operator64(data, sk)[x0:x0 + Lxl]), f32(pack_planes64(v, M, P)), f32(pack_planes64(hm, M, P)),
        f32(pack_planes64(hp, M, P)), f32(pack_planes64(tp, M, P)), jnp.float32(inv), skj, K, Lxl)
    c64 = lambda x: torch.as_tensor(x).to(torch.complex64)
    t_next, pp = ce.ell_cheb_step_halo(c64(data[slab.rows]), slab, c64(v), c64(hm), c64(hp), c64(tp), inv)
    assert np.allclose(t_next.numpy(), unpack_planes(t_want, M, K), atol=2e-4, rtol=2e-4)
    assert np.allclose(pp[0].numpy(), np.asarray(pp_want).sum(axis=0), atol=2e-4, rtol=2e-4)


def _neighbour_planes(x, slab):
    """The planes before and after ``slab`` in the whole vector or operator ``x`` (ring wrap)."""
    Lx, M = slab.sk.shape[0], slab.plane
    before, after = (slab.x0 - 1) % Lx, (slab.x0 + slab.planes) % Lx
    return x[before * M:(before + 1) * M].clone(), x[after * M:(after + 1) * M].clone()


def test_slabs_of_the_plain_step_equal_the_whole_step():
    """Slabs fed their neighbours' planes, concatenated, equal the plain
    whole-lattice step; one slab of the whole lattice is the ring of one; the
    interior/boundary split (three row ranges into one buffer) equals one
    call; ``t_prev=None`` is zero.  1e-12 in complex128."""
    rng = np.random.default_rng(7)
    for shape, pbc, Lxl in (((6, 5, 1), True, 2), ((6, 4, 3), False, 3), ((4, 3, 2), True, 1),
                            ((2, 6, 1), True, 1), ((5, 3, 2), True, 5)):
        data, sk = random_blocks(shape, pbc, rng)
        N, K = sk.n_sites, 3
        v, tp = torch.as_tensor(_random((N, 4, K), rng)), torch.as_tensor(_random((N, 4, K), rng))
        d = torch.as_tensor(data)
        want, pp_want = ce.ell_cheb_step_plain(d, sk, v, tp, 0.3)
        parts, sums = [], 0
        for x0 in range(0, shape[0], Lxl):
            slab = ce.halo_slab(sk, x0, Lxl)
            r = slab.rows
            t, pp = ce.ell_cheb_step_halo(d[r], slab, v[r], *_neighbour_planes(v, slab), tp[r], 0.3)
            parts.append(t)
            sums = sums + pp.sum(dim=0)
            n, M = slab.n_local, slab.plane
            if Lxl >= 3:
                hm, hp = _neighbour_planes(v, slab)
                out = tp[r].clone()
                _, p_int = ce.ell_cheb_step_halo(d[r], slab, v[r], None, None, out, 0.3, rows=(M, n - M), out=out)
                _, p_lo = ce.ell_cheb_step_halo(d[r], slab, v[r], hm, hp, out, 0.3, rows=(0, M), out=out)
                _, p_hi = ce.ell_cheb_step_halo(d[r], slab, v[r], hm, hp, out, 0.3, rows=(n - M, n), out=out)
                assert torch.allclose(out, t, atol=1e-12, rtol=0)
                assert torch.allclose(p_int + p_lo + p_hi, pp, atol=1e-12, rtol=0)
            t0, _ = ce.ell_cheb_step_halo(d[r], slab, v[r], *_neighbour_planes(v, slab), None, 0.3)
            assert torch.allclose(t0, t + tp[r], atol=1e-12, rtol=0)
        assert torch.allclose(torch.cat(parts), want, atol=1e-12, rtol=0), shape
        assert torch.allclose(sums, pp_want[0], atol=1e-10, rtol=0)
        y_slabs = [ce.ell_spmm_halo(d[s.rows], s, v[s.rows], *_neighbour_planes(v, s))
                   for s in (ce.halo_slab(sk, x0, Lxl) for x0 in range(0, shape[0], Lxl))]
        assert torch.allclose(torch.cat(y_slabs), ce.ell_spmm_plain(d, sk, v), atol=1e-12, rtol=0)


def _halo_backward(d, a, b, w, w_sums, inv, slabs):
    """``(H̄, t̄_cur, t̄_prev)`` of one step on the whole lattice, assembled from
    :func:`halo_step_backward` on each of ``slabs``, with ``L = Re⟨w, t_next⟩
    + w_sums · sums``: the outer product with the forward halo planes, the
    adjoint with the planes of −G exchanged forward (here cut from the whole
    −G) and the neighbour rows' blocks."""
    K = a.shape[-1]
    neg_G = -(w + w_sums[K:] * a)
    parts = []
    for slab in slabs:
        r = slab.rows
        t_s, _ = ce.ell_cheb_step_halo(d[r], slab, a[r], *_neighbour_planes(a, slab), b[r], inv)
        ring = SimpleNamespace(exchange=lambda t, slab=slab: _neighbour_planes(neg_G, slab))
        parts.append(cs.halo_step_backward(
            d[r], slab, ring, a[r], _neighbour_planes(a, slab), t_s, inv, w[r], w_sums[:K], w_sums[K:],
            *_neighbour_planes(d, slab), backend="plain"))
    return [torch.cat(p) for p in zip(*parts)]


def test_halo_backward_against_autograd_and_jax_vjp():
    """The step's cotangents in gather form on three slabs and on one slab
    of the whole lattice (the ring of one), against ``torch.autograd``
    through the plain whole-lattice step (6×3×1); and on the ring of one of
    a chain of six sites, where every link is an x link, against
    ``jax.vjp`` of ``_plane_cheb_step_halo_ref`` with the halo planes taken
    from the slab itself.  Non-Hermitian blocks, complex128, 1e-10 (the
    operator cotangent against the restatement's float32 one: 1e-6)."""
    rng = np.random.default_rng(5)
    K, inv = 2, 0.23
    w_sums = torch.linspace(0.5, -1.0, 2 * K, dtype=torch.float64)
    data, sk = random_blocks((6, 3, 1), True, rng)
    N = sk.n_sites
    d, a, b, w = (torch.as_tensor(x) for x in (data, *(_random((N, 4, K), rng) for _ in range(3))))
    dd, aa, bb = (x.clone().requires_grad_(True) for x in (d, a, b))
    t_next, pp = ce.ell_cheb_step_plain(dd, sk, aa, bb, inv)
    loss = (t_next * w.conj()).real.sum() + (pp[0] * w_sums).sum()
    want = torch.autograd.grad(loss, (dd, aa, bb))
    for Lxl in (2, 6):
        got = _halo_backward(d, a, b, w, w_sums, inv, [ce.halo_slab(sk, x0, Lxl) for x0 in range(0, 6, Lxl)])
        for g, wnt in zip(got, want):
            assert (g - wnt).abs().max() <= 1e-10 * wnt.abs().max()

    shape, M = (6, 1, 1), 1
    data, sk = random_blocks(shape, True, rng)
    N = sk.n_sites
    d, a, b, w = (torch.as_tensor(x) for x in (data, *(_random((N, 4, K), rng) for _ in range(3))))
    skj, P = jbs.skeleton(shape), 128
    pack = lambda x: jnp.asarray(pack_planes64(x, M, P))

    def f(bp, v, tpp):
        t, partials = pk._plane_cheb_step_halo_ref(skj, K, bp, v, v[-1:], v[:1], tpp, inv)
        return t, partials.sum(axis=0)

    _, vjp = jax.vjp(jax.jit(f), jnp.asarray(pack_operator64(data, sk, P)), pack(a.numpy()), pack(b.numpy()))
    # The packed layout holds (re, im) as separate reals, so its cotangent
    # pair (∂L/∂x, ∂L/∂y) is PyTorch's ∂L/∂x + i·∂L/∂y; the cotangent of
    # Re⟨w, t_next⟩ there is w packed.
    ct_b, ct_v, ct_tp = vjp((pack(w.numpy()), jnp.asarray(w_sums.numpy())))
    cb = np.asarray(ct_b).reshape(shape[0], 2, sk.n_slots, 4, 4, P)[..., :M]
    cb = np.moveaxis(cb[:, 0] + 1j * cb[:, 1], -1, 1).reshape(N, sk.n_slots, 4, 4)
    got = [g.numpy() for g in _halo_backward(d, a, b, w, w_sums, inv, [ce.halo_slab(sk, 0, 6)])]
    # The restatement casts the packed operator to float32 before it computes
    # in x64, so its operator cotangent comes back rounded to float32.
    assert np.abs(got[0] - cb).max() <= 1e-6 * np.abs(cb).max()
    assert np.abs(got[1] - unpack_planes(ct_v, M, K)).max() <= 1e-10 * np.abs(got[1]).max()
    assert np.abs(got[2] - unpack_planes(ct_tp, M, K)).max() <= 1e-10 * np.abs(got[2]).max()


def test_halo_wrappers_refuse_what_the_kernels_do_not_take():
    sk = tbs.skeleton((4, 3, 1))
    slab = ce.halo_slab(sk, 1, 2)
    assert slab.n_local == 6 and slab.plane == 3 and slab.rows == slice(3, 9)
    cols = slab.cols
    assert cols.min() >= -3 and cols.max() < 9 and (cols[:3] < 0).any() and (cols[3:] >= 6).any()
    assert (ce.halo_slab(tbs.skeleton((2, 6, 1)), 0, 1).cols == ce.PAD_COLUMN).any()  # Lx = 2: -x slot is padding
    data = torch.zeros((6, sk.n_slots, 4, 4), dtype=torch.complex64)
    v = torch.zeros((6, 4, 2), dtype=torch.complex64)
    h = torch.zeros((3, 4, 2), dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="CPU"):
        ce.ell_cheb_step_halo(data, slab, v, h, h, None, 0.1, impl="cuda")
    with pytest.raises(RuntimeError, match="CPU"):
        ce.ell_spmm_adjoint_halo(data, slab, v, h, h, data[:3], data[:3], impl="cuda")
    with pytest.raises(ValueError, match="out="):
        ce.ell_spmm_halo(data, slab, v, h, h, rows=(0, 3))
    with pytest.raises(ValueError, match="hm and hp"):
        ce.ell_cheb_step_halo(data, slab, v, None, None, None, 0.1, rows=(0, 3), out=v.clone())
    with pytest.raises(ValueError, match="do not lie"):
        ce.ell_spmm_halo(data, slab, v, h, h, rows=(2, 9), out=v.clone())
    with pytest.raises(ValueError, match="do not lie"):
        ce.halo_slab(sk, 3, 2)
    with pytest.raises(ValueError, match="stencil"):
        ce.halo_slab(tbs.skeleton_from_pairs(3, np.arange(3), np.arange(3)), 0, 1)
    assert all(ck.launch_counts()[k] == 0 for k in ("ell_spmm_halo", "ell_cheb_step_halo",
                                                     "ell_spmm_adjoint_halo", "ell_block_outer_halo"))
