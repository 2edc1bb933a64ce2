"""PyTorch port, bf16 operator storage (``operator_dtype=`` /
``BODGE_OPERATOR_STORAGE``): the bf16 form against the reference's bf16
packing (bit for bit), the KPM observables on it against the reference on the
same rounded operator (complex128, 1e-10), the env knob, the drift against
float32 storage within the reference's own bounds, the lowest-states solver,
and the paths that refuse the form.  On the CPU the plain versions upcast the
bf16 form exactly; the kernels' bf16 instantiations run only on the card
(``chip_smoke.py``).  No Pallas call: the reference's packing is plain
``jnp``."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu.ops import pallas_gather as jpg
from bodge_tpu.ops import pallas_spmm as jpk
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_gather as cg
from bodge_tpu_torch.ops import cuda_spmm as ck
from bodge_tpu_torch.parallel import cuda_sharded as cs
from bodge_tpu_torch.ops import lanczos as tlz
from bodge_tpu_torch.ops.spmm import chebyshev_step_bytes, spmm_bytes
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from tests.test_pallas import random_system
from tests.test_torch_gather import build_ring
from tests.test_torch_lanczos import bound_state_system
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SHAPE = (6, 5, 1)  # the system of the reference's own bf16 test (tests/test_pallas.py)
ENERGIES = np.linspace(-1.5, 1.5, 7)


def _bits(form) -> np.ndarray:
    """The 16-bit patterns of a bf16 array (NumPy / ml_dtypes or torch)."""
    if isinstance(form, torch.Tensor):
        return form.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(form).view(np.uint16)


def _unpack(planes, N):
    """``[2, S, 4, 4, W]`` re/im planes of the reference → ``[N, S, 4, 4, 2]``."""
    return np.moveaxis(np.asarray(planes)[..., :N], (0, -1), (-1, 0))


def _rounded(d):
    """The operator the bf16 form stores, as complex128."""
    return ce.operator_values(ce.bf16_operator(d), torch.complex128)


@pytest.fixture(scope="module")
def system():
    """``(data, skeleton, the reference's skeleton)``: the reference's 6×5
    random open system, complex128."""
    _, sj = random_system(SHAPE, pbc=False, seed=3)
    return torch.as_tensor(np.array(sj.host_data())), tbs.skeleton(SHAPE), sj.skeleton  # a writable copy


def test_bf16_form_is_the_reference_packing_bit_for_bit(system):
    """``bf16_operator`` holds the same 16 bits per part as the reference's
    ``pack_operator(..., operator_dtype=jnp.bfloat16)`` (flat layout at this
    size) and ``pack_gather_operator`` on a generic ring; the gather plan's
    operator is that form in the reference's relabelled order."""
    d, sk, sk_j = system
    N, S = sk.cols.shape
    assert jpk.plan(sk_j, 4).mode == "flat"
    packed = jpk.pack_operator(d.numpy(), sk_j, 4, operator_dtype=jnp.bfloat16)
    assert packed.dtype == jnp.bfloat16
    form = ce.bf16_operator(d)
    assert form.dtype == torch.bfloat16 and tuple(form.shape) == (N, S, 4, 4, 2) and form.is_contiguous()
    np.testing.assert_array_equal(_bits(form), _bits(_unpack(np.asarray(packed).reshape(2, S, 4, 4, -1), N)))
    assert ce.bf16_operator(form) is form

    st, sj = build_ring(T, 40, device="cpu"), build_ring(J, 40)
    sk_r, N_r = st.skeleton, st.skeleton.n_sites
    gl_j, gl = jpg.plan_gather(sj.skeleton, 4), cg.plan_gather(sk_r, 4)
    assert np.array_equal(gl.rank, gl_j.rank)
    ref = jpg.pack_gather_operator(np.asarray(sj.host_data()), sj.skeleton, gl_j, operator_dtype=jnp.bfloat16)
    ref = _unpack(np.moveaxis(np.asarray(ref), 0, 1).reshape(2, sk_r.n_slots, 4, 4, -1), N_r)
    plan = ck.StepPlan(sk_r, 4, "plain_gather", st.data, torch.bfloat16)
    np.testing.assert_array_equal(_bits(plan.operator(st.data)), _bits(ref))
    np.testing.assert_array_equal(_bits(ce.bf16_operator(st.data)[torch.as_tensor(gl.inv_rank)]), _bits(ref))


def test_kpm_observables_on_bf16_match_reference_on_rounded_operator(system):
    """moments / free energy / LDOS of sites / DOS with ``operator_dtype="bf16"``
    against the reference's stencil path on the rounded operator, complex128,
    same probes and scale: 1e-10.  Every plain path of the port on the bf16
    form equals the float32-storage call on the rounded operator."""
    d, sk, sk_j = system
    N = sk.n_sites
    rounded = _rounded(d)
    scale, order, temp = 9.0, 24, 0.1
    v0 = np.random.default_rng(4).normal(size=(N, 4, 3)) + 0j
    mu = tkpm.moments(d, sk, v0, order, scale, operator_dtype="bf16").numpy()
    want = np.asarray(jkpm.moments(jnp.asarray(rounded.numpy()), sk_j, v0, order, scale, impl="stencil"))
    np.testing.assert_allclose(mu, want, atol=1e-10 * np.abs(want).max(), rtol=0)
    for impl in ("plain", "plain_tiled", "stencil", "gather"):
        got = tkpm.moments(d, sk, v0, order, scale, impl=impl, operator_dtype="bf16")
        np.testing.assert_array_equal(got.numpy(), tkpm.moments(rounded, sk, v0, order, scale, impl=impl).numpy())
    r = jnp.asarray(rounded.numpy())
    pairs = (
        (tkpm.free_energy_kpm(d, sk, temp, order=order, samples=4, scale=scale, operator_dtype="bf16"),
         jkpm.free_energy_kpm(r, sk_j, temp, order=order, samples=4, scale=scale, impl="stencil")),
        (tkpm.ldos_kpm_sites(d, sk, [3, 17], ENERGIES, order=order, scale=scale, operator_dtype="bf16"),
         jkpm.ldos_kpm_sites(r, sk_j, [3, 17], ENERGIES, order=order, scale=scale, impl="stencil")),
        (tkpm.dos_kpm(d, sk, ENERGIES, order=order, scale=scale, samples=4, operator_dtype="bf16"),
         jkpm.dos_kpm(r, sk_j, ENERGIES, order=order, scale=scale, samples=4, impl="stencil")),
    )
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(np.asarray(got) - want).max() <= 1e-10 * np.abs(want).max()
    # The generic ring through the gather step's plain version.
    st, sj = build_ring(T, 40, device="cpu"), build_ring(J, 40)
    v1 = np.random.default_rng(6).normal(size=(st.skeleton.n_sites, 4, 2)) + 0j
    assert ck.resolve_path(None, st.data, st.skeleton, 2) == "plain_gather"
    got = tkpm.moments(st.data, st.skeleton, v1, 16, 3.5, operator_dtype="bf16").numpy()
    want = np.asarray(jkpm.moments(jnp.asarray(_rounded(st.data).numpy()), sj.skeleton, v1, 16, 3.5, impl="gather"))
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max(), rtol=0)


def test_facade_free_energy_and_env_knob(system, monkeypatch):
    """``Hamiltonian.free_energy(method="kpm", operator_dtype="bf16")`` and the
    same call under ``BODGE_OPERATOR_STORAGE=bf16`` give the reference's free
    energy of the rounded operator (1e-10); the reference's call with the
    argument succeeds (its CPU path stores float32).  Unknown names raise."""
    d, sk, sk_j = system
    _, sj = random_system(SHAPE, pbc=False, seed=3)
    st = hamiltonian_from_numpy(SHAPE, d.numpy(), device="cpu")
    kw = dict(method="kpm", order=24, samples=4, scale=9.0)
    want = float(jkpm.free_energy_kpm(jnp.asarray(_rounded(d).numpy()), sk_j, 0.1, order=24, samples=4, scale=9.0,
                                      impl="stencil"))
    by_argument = st.free_energy(0.1, operator_dtype="bf16", **kw)
    assert abs(by_argument - want) <= 1e-10 * abs(want)
    float32 = st.free_energy(0.1, **kw)
    assert float32 != by_argument and np.isfinite(sj.free_energy(0.1, operator_dtype="bf16", **kw))
    monkeypatch.setenv("BODGE_OPERATOR_STORAGE", "bf16")
    assert st.free_energy(0.1, **kw) == by_argument
    assert st.free_energy(0.1, operator_dtype="f32", **kw) == float32  # the argument overrides the knob
    for name in ("", "f32", "float32", torch.float32):
        assert ce.resolve_operator_storage(name) is None
    for name in (None, "bf16", "bfloat16", torch.bfloat16):
        assert ce.resolve_operator_storage(name) is torch.bfloat16
    with pytest.raises(ValueError, match="operator storage"):
        st.free_energy(0.1, operator_dtype="fp8", **kw)
    monkeypatch.setenv("BODGE_OPERATOR_STORAGE", "half")
    with pytest.raises(ValueError, match="operator storage"):
        st.free_energy(0.1, **kw)
    monkeypatch.delenv("BODGE_OPERATOR_STORAGE")
    assert ce.resolve_operator_storage(None) is None


def test_bf16_drift_within_the_reference_bounds(system):
    """bf16 against float32 storage, same vectors, complex64 as on the card:
    a product within 2e-2·max|y| and moments within 3e-2·max(1, |μ|) — the
    bounds of the reference's ``test_bf16_operator_storage_matches_f32``."""
    d, sk, _ = system
    d = d.to(torch.complex64)
    rng = np.random.default_rng(7)
    v = torch.as_tensor((rng.normal(size=(sk.n_sites, 4, 4)) + 1j * rng.normal(size=(sk.n_sites, 4, 4))),
                        dtype=torch.complex64)
    form = ce.bf16_operator(d)
    y32, y16 = ce.ell_spmm(d, sk, v), ce.ell_spmm(form, sk, v)
    assert y16.dtype == torch.complex64
    drift = float((y16 - y32).abs().max())
    assert 0 < drift < 2e-2 * float(y32.abs().max())
    mu32 = ck.moments_fused(d, sk, v, 1.0 / 8.0, 16)
    mu16 = ck.moments_fused(d, sk, v, 1.0 / 8.0, 16, operator_dtype=torch.bfloat16)
    assert float((mu16 - mu32).abs().max()) < 3e-2 * max(1.0, float(mu32.abs().max()))


@pytest.mark.filterwarnings("ignore:lowest_eigenstates")
def test_lowest_eigenstates_on_bf16_is_the_float32_solve_of_the_rounded_operator():
    """The bound-state lattice, one round at a given scale: with
    ``operator_dtype="bf16"`` the filter runs on the bf16 form and the
    Rayleigh–Ritz stage on the rounded operator, so the result equals the
    float32-storage call on the rounded operator; the dense fallback of a
    small system is the rounded operator's spectrum."""
    st = bound_state_system(T, device="cpu")
    rounded = _rounded(st.data)
    kw = dict(max_iter=1, seed=3, scale=8.5, full_output=True)
    E16, X16, info = tlz.lowest_eigenstates(st.data, st.skeleton, 8, operator_dtype="bf16", **kw)
    E32, X32, _ = tlz.lowest_eigenstates(rounded, st.skeleton, 8, **kw)
    np.testing.assert_array_equal(E16, E32)
    np.testing.assert_array_equal(X16, X32)
    assert info["step_launches"] > 0
    small = T.Hamiltonian(T.CubicLattice((5, 4, 1)), device="cpu")
    small.assemble(onsite=lambda ci: -0.3 * T.σ0, pairing_onsite=lambda ci: 0.21 * T.jσ2,
                   hopping=lambda ci, cj: -0.77 * T.σ0)
    E, _ = tlz.lowest_eigenstates(small.data, small.skeleton, 4, operator_dtype="bf16")
    dense = np.linalg.eigvalsh(tbs.ell_to_dense(_rounded(small.data).numpy(), small.skeleton))
    want = np.sort(dense[np.argsort(np.abs(dense), kind="stable")[:4]])
    np.testing.assert_allclose(E, want, atol=1e-12, rtol=0)


def test_differentiable_paths_refuse_the_bf16_form(system):
    """The adjoint and outer-product kernels take complex64 only, so the bf16
    form raises in ``ChebStep``, ``MomentSweep`` (also through a bf16 plan),
    ``ShardedMomentSweep`` and the adjoint wrappers; the bf16 wrappers refuse a
    complex operator; a plan takes only a resolved storage; plain versions
    count no launch."""
    d, sk, _ = system
    form = ce.bf16_operator(d)
    v = torch.zeros((sk.n_sites, 4, 2), dtype=torch.complex128)
    before = ck.launch_counts()
    with pytest.raises(TypeError, match="bf16 form"):
        ck.ChebStep.apply(form, v, None, sk, 0.1, "plain")
    with pytest.raises(TypeError, match="bf16 form"):
        ck.MomentSweep.apply(form, v.requires_grad_(True), sk, 0.1, 4, "plain")
    plan = ck.StepPlan(sk, 2, "plain", d, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 form"):
        ck.moments_fused_ad(d.clone().requires_grad_(True), sk, v, 0.1, 4, impl=plan)
    slab = ce.halo_slab(sk, 0, SHAPE[0])
    with pytest.raises(TypeError, match="bf16 form"):
        cs.ShardedMomentSweep.apply(form, v, slab, None, 0.1, 4, "plain", False, form[:5], form[:5], 0)
    with pytest.raises(TypeError, match="bf16 form"):
        ce.ell_spmm_adjoint(form, sk, v)
    with pytest.raises(TypeError, match="bf16 form"):
        ce.ell_spmm_adjoint_halo(d, slab, v, v[:5], v[:5], form[:5], form[:5])
    with pytest.raises(TypeError, match="bf16 form"):
        ce._check_call(form.to("meta"), sk, v.detach().to(torch.complex64).to("meta"))
    for wrapper, args in ((ce.ell_spmm_bf16, (d, sk, v)), (ce.ell_cheb_step_bf16, (d, sk, v, None, 0.1))):
        with pytest.raises(TypeError, match="bf16 form"):
            wrapper(*args)
    with pytest.raises(ValueError, match="resolve_operator_storage"):
        ck.StepPlan(sk, 2, "plain", d, "bf16")
    y = ce.ell_spmm_bf16(form, sk, v.detach())
    assert torch.equal(y, ce.ell_spmm(_rounded(d), sk, v.detach()))
    assert ck.launch_counts() == before
    # The kernels' argument check takes the form at its own dtype and shape.
    N, S = sk.cols.shape
    meta = torch.device("meta")
    vm = torch.empty((N, 4, 2), dtype=torch.complex64, device=meta)
    assert ce._check_forward(torch.empty((N, S, 4, 4, 2), dtype=torch.bfloat16, device=meta), sk, vm)[3] is True
    with pytest.raises(ValueError, match="shape"):
        ce._check_forward(torch.empty((N, S, 4, 4), dtype=torch.bfloat16, device=meta), sk, vm)


def test_byte_accounting_of_the_bf16_form():
    """The bounds the bf16 rows of the kernel table are read against, at the
    table's shapes (N = 10⁶, S = 5; the sheet N = 250855): 4 bytes a complex
    entry instead of 8, vectors unchanged."""
    big = types.SimpleNamespace(cols=np.empty((10**6, 5), dtype=np.int8))
    assert chebyshev_step_bytes(big, 8, 8) == 1408 * 10**6
    assert chebyshev_step_bytes(big, 8, 8, operator_itemsize=2) == 1088 * 10**6
    assert spmm_bytes(big, 8, 8) == 1152 * 10**6 and spmm_bytes(big, 8, 8, operator_itemsize=2) == 832 * 10**6
    assert chebyshev_step_bytes(big, 1, 8, operator_itemsize=2) == 416 * 10**6
    sheet = types.SimpleNamespace(cols=np.empty((250855, 5), dtype=np.int8))
    assert abs(chebyshev_step_bytes(sheet, 8, 8, operator_itemsize=2) / 3.35e12 * 1e3 - 0.0815) < 5e-5
