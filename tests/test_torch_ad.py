"""PyTorch port, the differentiable Chebyshev step.

On the CPU the wrappers run their plain versions, so these tests pin the
arithmetic the backward kernels implement: the adjoint product against the
forward product of the conjugate-transposed operator (non-Hermitian data),
the block outer product against ``torch.autograd``, ``ChebStep``'s
hand-written backward formulas by ``torch.autograd.gradcheck`` in complex128,
and the whole chain against ``jax.vjp`` / ``jax.grad`` of the reference.

Complex gradients: for a real loss JAX returns ∂L/∂x − i·∂L/∂y and PyTorch
∂L/∂x + i·∂L/∂y, so ``g_torch = conj(g_jax)`` wherever a complex input is
differentiated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bodge_tpu as J
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu.ops import pallas_spmm as pk
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_spmm as ck
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


C128 = torch.complex128


def _pairs_skeleton(n=11, extra=25, seed=11):
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.arange(n), rng.integers(0, n, size=extra)])
    c = np.concatenate([np.arange(n), rng.integers(0, n, size=extra)])
    return tbs.skeleton_from_pairs(n, np.concatenate([r, c]), np.concatenate([c, r]))


def _skeleton(case):
    return _pairs_skeleton() if case == "pairs" else tbs.skeleton(case)


def _random(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))


# (3,1,5): a three-site ring where both neighbours wrap; (2,6,1): an extent-2
# axis whose −1 slot is padding and whose +1 slot mirrors itself; "pairs": a
# generic skeleton with a per-row mirror table and ragged rows.
CASES = [(3, 1, 5), (2, 6, 1), (4, 3, 2), "pairs"]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_adjoint_plain_is_product_with_conjugate_transpose(case):
    sk = _skeleton(case)
    N, S = sk.cols.shape
    data = _random((N, S, 4, 4), 1)  # independent entries: not Hermitian, padding slots filled too
    v = _random((N, 4, 3), 2)
    valid = torch.as_tensor(sk.valid)[..., None, None]

    # The conjugate transpose in the same ELL layout: block (n, s) of H† is
    # the conjugate-transposed block that row cols[n, s] stores for column n.
    safe = torch.as_tensor(np.where(sk.valid, sk.cols, 0).astype(np.int64))
    mirror = torch.as_tensor(np.broadcast_to(sk.trans_slot, sk.cols.shape).astype(np.int64))
    data_dagger = (data * valid)[safe, mirror].transpose(-1, -2).conj() * valid

    got = ce.ell_spmm_adjoint(data, sk, v)  # CPU tensor: the plain version
    want = ce.ell_spmm_plain(data_dagger, sk, v)
    assert torch.allclose(got, want, atol=1e-12, rtol=0)
    dense = tbs.ell_to_dense_torch(data * valid, sk)
    want_dense = (dense.conj().T @ v.reshape(4 * N, 3)).reshape(N, 4, 3)
    assert torch.allclose(got, want_dense, atol=1e-12, rtol=0)
    assert not torch.allclose(got, ce.ell_spmm_plain(data, sk, v), atol=1e-3)  # H ≠ H†


@pytest.mark.parametrize("case", CASES, ids=str)
def test_block_outer_plain_is_operator_cotangent(case):
    sk = _skeleton(case)
    N, S = sk.cols.shape
    data = _random((N, S, 4, 4), 3).requires_grad_(True)
    t, g = _random((N, 4, 5), 4), _random((N, 4, 5), 5)
    y = ce.ell_spmm_plain(data, sk, t)
    (want,) = torch.autograd.grad(y, data, grad_outputs=g)
    got = ce.ell_block_outer(g, sk, t)
    assert got.shape == (N, S, 4, 4)
    assert torch.allclose(got, want, atol=1e-12, rtol=0)
    assert bool((got[torch.as_tensor(~sk.valid)] == 0).all())  # padding slots get zero

    buf = torch.ones_like(got)
    assert ce.ell_block_outer(g, sk, t, 0.5, out=buf) is buf  # overwrite
    assert torch.allclose(buf, 0.5 * want, atol=1e-12, rtol=0)
    ce.ell_block_outer(g, sk, t, 0.25, out=buf, accumulate=True)  # add
    assert torch.allclose(buf, 0.75 * want, atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="accumulate"):
        ce.ell_block_outer(g, sk, t, accumulate=True)

    # The fused forms: G = g + shift ⊙ t (g optional), −G handed out.
    shift = torch.as_tensor(np.linspace(-0.5, 1.5, 5))
    neg = torch.empty_like(t)
    fused = ce.ell_block_outer(g, sk, t, 0.5, shift=shift, neg_out=neg)
    G = g + shift * t
    assert torch.allclose(neg, -G, atol=1e-14, rtol=0)
    assert torch.allclose(fused, ce.ell_block_outer(G, sk, t, 0.5), atol=1e-12, rtol=0)
    only_shift = ce.ell_block_outer(None, sk, t, shift=shift)
    assert torch.allclose(only_shift, ce.ell_block_outer(shift * t, sk, t), atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="both be absent"):
        ce.ell_block_outer(None, sk, t)


@pytest.mark.parametrize("case", [(2, 6, 1), "pairs"], ids=str)
def test_adjoint_epilogue_terms(case):
    sk = _skeleton(case)
    N, S = sk.cols.shape
    data, v = _random((N, S, 4, 4), 40), _random((N, 4, 3), 41)
    add, x1, x2 = _random((N, 4, 3), 42), _random((N, 4, 3), 43), _random((N, 4, 3), 44)
    c1, c2 = torch.as_tensor([0.5, -1.0, 2.0]), torch.as_tensor([1.5, 0.25, -0.75])
    base = ce.ell_spmm_adjoint(data, sk, v)
    got = ce.ell_spmm_adjoint(data, sk, v, alpha=-0.3, add=add, axpy=((c1, x1), (c2, x2)))
    assert torch.allclose(got, -0.3 * base + add + c1 * x1 + c2 * x2, atol=1e-12, rtol=0)
    assert torch.allclose(ce.ell_spmm_adjoint(data, sk, v, axpy=((c1, x1),)), base + c1 * x1, atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="two axpy"):
        ce.ell_spmm_adjoint(data, sk, v, axpy=((c1, x1),) * 3)


@pytest.mark.parametrize("with_prev", [True, False], ids=["t_prev", "t_prev=None"])
@pytest.mark.parametrize("case", [(3, 1, 3), (2, 3, 1), "small pairs"], ids=str)
def test_chebstep_gradcheck(case, with_prev):
    """The hand-written backward (adjoint product, block outer product and
    the elementwise combinations, through their plain versions) against
    finite differences of the forward, complex128, non-Hermitian data.  Small
    skeletons of the same kinds as CASES (a ring of three, an extent-2 axis
    with its padding slot, a ragged generic one): the check perturbs every
    entry in turn."""
    sk = _pairs_skeleton(n=6, extra=8) if case == "small pairs" else _skeleton(case)
    N, S = sk.cols.shape
    data = _random((N, S, 4, 4), 6).requires_grad_(True)
    t_cur = _random((N, 4, 2), 7).requires_grad_(True)
    if with_prev:
        t_prev = _random((N, 4, 2), 8).requires_grad_(True)
        fn = lambda d, a, b: ck.ChebStep.apply(d, a, b, sk, 0.3, "plain")
        inputs = (data, t_cur, t_prev)
    else:
        fn = lambda d, a: ck.ChebStep.apply(d, a, None, sk, 0.3, "plain")
        inputs = (data, t_cur)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chebstep_backward_equals_autograd_of_plain_step(case):
    sk = _skeleton(case)
    N, S = sk.cols.shape
    K = 3
    data = _random((N, S, 4, 4), 9).requires_grad_(True)
    t_cur = _random((N, 4, K), 10).requires_grad_(True)
    t_prev = _random((N, 4, K), 11).requires_grad_(True)
    w_next, w_sums = _random((N, 4, K), 12), torch.as_tensor(np.linspace(-1.0, 2.0, 2 * K))

    def loss(t_next, sums):
        return (t_next * w_next.conj()).real.sum() + (sums * w_sums).sum()

    t_plain, pp = ce.ell_cheb_step_plain(data, sk, t_cur, t_prev, 0.21)
    want = torch.autograd.grad(loss(t_plain, pp[0]), (data, t_cur, t_prev))
    t_next, sums = ck.ChebStep.apply(data, t_cur, t_prev, sk, 0.21, None)
    assert torch.equal(t_next, t_plain) and torch.equal(sums, pp[0])
    got = torch.autograd.grad(loss(t_next, sums), (data, t_cur, t_prev))
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-12, rtol=0)

    # A step whose outputs are only partly used (absent cotangents), with an
    # operator that asks for no gradient.
    t_next, sums = ck.ChebStep.apply(data.detach(), t_cur, t_prev, sk, 0.21, None)
    (g_cur,) = torch.autograd.grad(sums[K:].sum(), t_cur)
    t_plain, pp = ce.ell_cheb_step_plain(data.detach(), sk, t_cur, t_prev, 0.21)
    (w_cur,) = torch.autograd.grad(pp[0, K:].sum(), t_cur)
    assert torch.allclose(g_cur, w_cur, atol=1e-12, rtol=0)


def _reference_system(shape, seed):
    """The operator of tests/test_pallas_ad.py: open boundaries, a random
    on-site pairing phase."""
    lattice = J.CubicLattice(shape)
    system = J.Hamiltonian(lattice)
    rng = np.random.default_rng(seed)
    phase = rng.normal(size=(lattice.size, 1, 1))
    system.assemble(
        onsite=lambda ci: -0.6 * J.σ0 - 0.1 * J.σ3,
        pairing_onsite=lambda ci: (0.3 + 0.1 * phase) * J.jσ2,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * J.σ0, 0
        ),
    )
    return lattice, system


def test_one_step_vjp_matches_pallas_custom_vjp():
    """One step's cotangents against ``jax.vjp`` through the reference's
    ``cheb_step_pallas_ad`` (flat layout, interpret mode, float32), on a
    chain of 12 sites with its periodic wrap link: the x links, wrap
    included, pass the kernel's flat shifts; y links are held by the
    gradient tests around this one.  The reference's gradient is taken in
    one compiled program.  Tolerance 2e-5 of the largest entry: the
    reference computes in float32."""
    lattice, system = _reference_system((12, 1, 1), seed=13)
    sk_j = system.skeleton
    N, K, inv = lattice.size, 4, 0.29
    assert pk.plan(sk_j, K).mode == "flat"
    data = np.asarray(system.host_data()).astype(np.complex64)
    rng = np.random.default_rng(2)
    draw = lambda: (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(np.complex64)
    t_cur, t_prev, w_next = draw(), draw(), draw()
    w_sums = np.linspace(0.5, -1.0, 2 * K).astype(np.float32)

    step = pk.cheb_step_pallas_ad(sk_j, K)

    def loss_j(d, a, b):
        t_next, partials = step(
            pk.pack_operator(d, sk_j, K), pk.pack_vector(a, sk_j), pk.pack_vector(b, sk_j),
            jnp.float32(inv),
        )
        t_next = pk.unpack_vector(t_next, sk_j, K, jnp.complex64)
        return jnp.sum(jnp.real(t_next * jnp.conj(w_next))) + jnp.sum(partials.sum(axis=0) * w_sums)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(jnp.asarray(data), jnp.asarray(t_cur), jnp.asarray(t_prev))

    sk = tbs.skeleton((12, 1, 1))
    d, a, b = (torch.as_tensor(x).to(C128).requires_grad_(True) for x in (data, t_cur, t_prev))
    t_next, sums = ck.ChebStep.apply(d, a, b, sk, inv, None)
    loss = (t_next * torch.as_tensor(w_next).conj()).real.sum() + (sums * torch.as_tensor(w_sums)).sum()
    got = torch.autograd.grad(loss, (d, a, b))
    for g, w in zip(got, want):
        w = np.conj(np.asarray(w))  # JAX's convention → PyTorch's
        assert np.abs(g.numpy() - w).max() <= 2e-5 * np.abs(w).max()


def test_moments_ad_gradient_matches_reference():
    """d(Σ_m w_m Σ_k μ_m[k]) / d(data) and / d(v0) through ``moments_fused_ad``
    against ``jax.grad`` through the reference's stencil moments (x64 on both
    sides; 1e-9 of the largest entry)."""
    lattice, system = _reference_system((8, 5, 1), seed=13)
    sk_j = system.skeleton
    N, K, order = lattice.size, 4, 12
    scale = float(jkpm.spectral_bound(system.host_data(), sk_j, impl="stencil"))
    data = np.array(system.host_data())
    rng = np.random.default_rng(4)
    v0 = rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))
    w = np.linspace(1.0, 0.3, order)

    def loss_j(d, v):
        mu = jkpm.moments(d, sk_j, v, order, scale, impl="stencil")
        return jnp.sum(jnp.asarray(w) * jnp.sum(mu, axis=1))

    f_j, (gd_j, gv_j) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(jnp.asarray(data), jnp.asarray(v0))

    sk = tbs.skeleton((8, 5, 1))
    d = torch.as_tensor(data).requires_grad_(True)
    v = torch.as_tensor(v0).requires_grad_(True)
    mu = ck.moments_fused_ad(d, sk, v, 1.0 / scale, order)
    assert mu.shape == (order, K)
    assert torch.equal(mu.detach(), ck.moments_fused(d.detach(), sk, v.detach(), 1.0 / scale, order))
    loss = (torch.as_tensor(w) * mu.sum(dim=1)).sum()
    assert abs(float(loss.detach()) - float(f_j)) <= 1e-9 * abs(float(f_j))
    gd, gv = torch.autograd.grad(loss, (d, v))
    for got, want in ((gd, gd_j), (gv, gv_j)):
        want = np.conj(np.asarray(want))
        assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("case", [(4, 3, 2), (2, 6, 1), "pairs"], ids=str)
def test_sweep_function_equals_loop_over_chebstep(case):
    """``MomentSweep`` (in-place operator cotangent, cotangents completed in
    the adjoint's epilogue) against the loop over ``ChebStep`` that autograd
    chains by itself, and against autograd through separate plain products:
    same moments, same gradients (1e-11 of the largest entry), non-Hermitian
    data."""
    sk = _skeleton(case)
    N, S = sk.cols.shape
    K, order, inv = 3, 9, 0.07
    w = torch.as_tensor(np.linspace(1.0, -0.4, order))[:, None] * torch.as_tensor([1.0, 0.5, 2.0])

    def by_steps(data, v0):
        t1, first = ck.ChebStep.apply(data, v0, None, sk, 0.5 * inv, None)
        t_prev, t_cur, sums = v0, t1, []
        for _ in range((order - 1) // 2):
            t_next, s = ck.ChebStep.apply(data, t_cur, t_prev, sk, inv, None)
            sums.append(s)
            t_prev, t_cur = t_cur, t_next
        return ce.moments_from_sums(torch.stack([first, *sums]), K, order)

    def by_products(data, v0):
        H = lambda v: inv * ce.ell_spmm_plain(data, sk, v)
        dot = lambda a, b: (a.conj() * b).sum(dim=(0, 1)).real
        ts = [v0, H(v0)]
        for _ in range((order - 1) // 2):
            ts.append(2.0 * H(ts[-1]) - ts[-2])
        mu0, mu1 = dot(v0, v0), dot(ts[1], v0)
        rest = [m for i in range(1, len(ts) - 1)
                for m in (2.0 * dot(ts[i], ts[i]) - mu0, 2.0 * dot(ts[i + 1], ts[i]) - mu1)]
        return torch.stack([mu0, mu1, *rest])[:order]

    results = []
    for fn in (lambda d, v: ck.moments_fused_ad(d, sk, v, inv, order), by_steps, by_products):
        data = _random((N, S, 4, 4), 50).requires_grad_(True)
        v0 = _random((N, 4, K), 51).requires_grad_(True)
        mu = fn(data, v0)
        results.append((mu.detach(), *torch.autograd.grad((w * mu).sum(), (data, v0))))
    for other in results[1:]:
        for got, want in zip(results[0], other):
            assert (got - want).abs().max() <= 1e-11 * want.abs().max()
    # Only the probes ask for a gradient: the operator cotangent is not returned.
    v0 = _random((N, 4, K), 51).requires_grad_(True)
    (gv,) = torch.autograd.grad((w * ck.moments_fused_ad(_random((N, S, 4, 4), 50), sk, v0, inv, order)).sum(), v0)
    assert (gv - results[0][2]).abs().max() <= 1e-11 * gv.abs().max()


@pytest.mark.parametrize("order", [1, 2, 3, 8, 9])
def test_moments_ad_forward_for_every_order_parity(order):
    sk = tbs.skeleton((4, 3, 1))
    N, S = sk.cols.shape
    data = _random((N, S, 4, 4), 20)
    data = data + data[
        torch.as_tensor(sk.cols.astype(np.int64)), torch.as_tensor(sk.trans_slot.astype(np.int64))
    ].transpose(-1, -2).conj()  # Hermitian, as a Hamiltonian is
    v0 = _random((N, 4, 2), 21)
    want = ck.moments_fused(data, sk, v0, 0.05, order)
    got = ck.moments_fused_ad(data.clone().requires_grad_(True), sk, v0, 0.05, order)
    assert got.shape == want.shape == (order, 2)
    assert torch.equal(got.detach(), want)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    sk = tbs.skeleton((3, 2, 1))
    N, S = sk.cols.shape
    data, v = _random((N, S, 4, 4), 30), _random((N, 4, 2), 31)
    before = ck.launch_counts()
    assert set(before) == set(ck.KERNELS) | {f"{n}.steps" for n in ck.SWEEP_KERNELS} and len(ck.KERNELS) == 25
    for call in (
        lambda: ce.ell_spmm_adjoint(data, sk, v, impl="cuda"),
        lambda: ce.ell_block_outer(v, sk, v, impl="cuda"),
        lambda: ck.ChebStep.apply(data, v, None, sk, 0.1, "cuda"),
        lambda: ck.moments_fused_ad(data, sk, v, 0.1, 4, impl="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match="Unknown kernel implementation"):
        ce.ell_spmm_adjoint(data, sk, v, impl="pallas")
    ce.ell_spmm_adjoint(data, sk, v)
    ce.ell_block_outer(v, sk, v)
    assert ck.launch_counts() == before  # plain versions count no launch
