"""PyTorch port, lowest-states solver: the NumPy pieces carried over from
``bodge_tpu/ops/lanczos.py`` (order buckets, the float64 host product, the DCT
coefficients, the low-pass filter, the wanted-state selection, the signed
Rayleigh–Ritz step) give bit-equal results on the same inputs; the filter
kernel's launch plan, its plain version against a recursion on the reference's
pieces, and its wrapper's refusals (the kernel itself runs only on the card:
``chip_smoke.py``, phase ``lowest``)."""

import numpy as np
import pytest
import torch

from bodge_tpu.ops import lanczos as jlz
from bodge_tpu_torch.ops import cuda_ell as tce
from bodge_tpu_torch.ops import cuda_filter as tcf
from bodge_tpu_torch.ops import cuda_spmm as tck
from bodge_tpu_torch.ops import lanczos as tlz
import bodge_tpu_torch as T
from tests.test_torch_lanczos import swave_system
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def _rr_inputs():
    st = swave_system(T, (6, 5, 1), pot=0.08, device="cpu")
    sk, data = st.skeleton, st.host_data()
    N = sk.n_sites
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.normal(size=(4 * N, 6)) + 1j * rng.normal(size=(4 * N, 6)))
    return sk, data, N, Q


def _same_arrays(a, b):
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _helper_case(name, mod):
    sk, data, N, Q = _rr_inputs()
    hspmm = lambda M: mod._host_spmm_f64(data, sk, M.reshape(N, 4, -1)).reshape(4 * N, -1) / 5.0
    theta = np.array([0.01, -0.3, 0.3, 0.31, -0.0005, 0.5])
    res = np.array([0.02, 1e-5, 0.2, 1e-4, 2e-4, 1e-6])
    return {
        "bucket_order": lambda: np.array([mod._bucket_order(o) for o in (1, 64, 65, 700, 9000, 10**7)]),
        "host_spmm_f64": lambda: mod._host_spmm_f64(data.astype(np.complex64), sk, Q.reshape(N, 4, 6)),
        "cheb_coeffs_dct": lambda: mod._cheb_coeffs_dct(lambda x: np.exp(-3 * x * x), 96),
        "lowpass_coeffs": lambda: mod._lowpass_coeffs(0.04, 0.01, 384),
        "select_wanted_genuine": lambda: mod._select_wanted(theta, res, 3),
        "select_wanted_fallback": lambda: mod._select_wanted(theta, np.full(6, 0.4), 3),
        "signed_rayleigh_ritz": lambda: mod._signed_rayleigh_ritz(hspmm, Q, hspmm(Q)),
    }[name]()


@pytest.mark.parametrize("name", ["bucket_order", "host_spmm_f64", "cheb_coeffs_dct", "lowpass_coeffs",
                                  "select_wanted_genuine", "select_wanted_fallback", "signed_rayleigh_ritz"])
def test_numpy_pieces_bit_equal(name):
    _same_arrays(_helper_case(name, tlz), _helper_case(name, jlz))
    assert tlz._ORDER_BUCKETS == jlz._ORDER_BUCKETS and tlz._RES_C == jlz._RES_C


# The filter kernel's launch plan (pure arithmetic) at the widths the solver's
# histories take: 32×32 (N = 1024) fits one pair a thread at every width, 100×100
# (N = 10 000) only at K = 1, so global mode there; past the shared memory a block
# may stage, the per-step path.  S = 5 (a square lattice), 132 SMs.
@pytest.mark.parametrize("N, K, bf16, mode, grid, sites, per_thread", [
    (1024, 1, False, "registers", 128, 8, 1),
    (1024, 18, False, "registers", 128, 8, 1),
    (1024, 48, True, "registers", 205, 5, 1),
    (1024, 112, False, "registers", 512, 2, 1),
    (10000, 1, False, "registers", 132, 76, 1),
    (10000, 18, False, "global", 527, 19, 2),
    (10000, 128, True, "global", 527, 19, 10),
    (250000, 8, False, "per_step", 0, 0, 0),
])
def test_filter_plan(N, K, bf16, mode, grid, sites, per_thread):
    plan = tcf.filter_plan(N, K, 5, bf16=bf16, sms=132)
    assert (plan["mode"], plan["grid"], plan["sites_per_block"], plan["pairs_per_thread"]) == (
        mode, grid, sites, per_thread)
    if mode == "per_step":
        return
    assert grid <= tcf.FILTER_BLOCKS_PER_SM * 132 and (grid - 1) * sites < N <= grid * sites
    assert plan["smem_bytes"] == sites * tcf._site_bytes(5, bf16) <= tcf.FILTER_SMEM_CAP
    assert sites * K <= 256 * per_thread and (mode == "global" or per_thread == 1)
    assert tcf.filter_plan(N, K, 5, bf16=bf16, mode="global", sms=132)["mode"] == "global"
    if mode == "global":
        with pytest.raises(ValueError, match="registers mode does not fit"):
            tcf.filter_plan(N, K, 5, bf16=bf16, mode="registers", sms=132)


# ell_cheb_filter_plain against the recursion written with the reference's NumPy
# pieces (the complex128 host product, the DCT coefficients) on 6×5, M = 64, K = 3:
# 1e-12 in complex128 (the same sums in another order); in complex64, 1e-5 of the
# result's largest entry (64 float32 steps).
@pytest.mark.parametrize("dtype, tol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
def test_filter_plain_against_reference_pieces(dtype, tol):
    st = swave_system(T, (6, 5, 1), pot=0.08, device="cpu")
    sk, data = st.skeleton, st.host_data()
    rng = np.random.default_rng(4)
    v = rng.normal(size=(sk.n_sites, 4, 3)) + 1j * rng.normal(size=(sk.n_sites, 4, 3))
    inv = 1.0 / 6.0
    coeffs = jlz._cheb_coeffs_dct(lambda x: np.exp(-4.0 * x * x), 64)
    coeffs[1::2] = 0.0  # an even filter, as the solver's: the odd terms add nothing
    want = coeffs[0] * v
    t_prev, t_cur = v, inv * jlz._host_spmm_f64(data, sk, v)
    want = want + coeffs[1] * t_cur
    for c in coeffs[2:]:
        t_prev, t_cur = t_cur, 2.0 * inv * jlz._host_spmm_f64(data, sk, t_cur) - t_prev
        want = want + c * t_cur
    d, x = torch.as_tensor(data).to(dtype), torch.as_tensor(v).to(dtype)
    got = tcf.ell_cheb_filter_plain(d, sk, x, coeffs, inv)
    assert got.dtype == dtype and np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    plan = tck.StepPlan(sk, 3, None, d)  # the solver's sweep on the CPU: the same plain recursion
    assert torch.equal(tck.filter_sweep(plan, d, x, coeffs, inv), got)


def test_filter_wrapper_refusals():
    st = swave_system(T, (6, 5, 1), pot=0.08, device="cpu")
    sk = st.skeleton
    data = torch.as_tensor(st.host_data()).to(torch.complex64)
    v = torch.ones((sk.n_sites, 4, 2), dtype=torch.complex64)
    before = tck.launch_counts()
    assert {"ell_cheb_filter", "ell_cheb_filter.steps", "ell_cheb_filter_bf16.steps"} <= set(before)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcf.ell_cheb_filter(data, sk, v, [1.0, 0.5], 0.2, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcf.ell_cheb_filter_bf16(tce.bf16_operator(data), sk, v, [1.0, 0.5], 0.2, impl="cuda")
    for coeffs in ([], [[1.0, 0.5]]):
        with pytest.raises(ValueError, match="coeffs"):
            tcf.ell_cheb_filter(data, sk, v, coeffs, 0.2)
    with pytest.raises(TypeError, match="bf16"):
        tcf.ell_cheb_filter_bf16(data, sk, v, [1.0], 0.2)
    with pytest.raises(ValueError, match="mode"):
        tcf.filter_plan(sk.n_sites, 2, sk.n_slots, mode="shared")
    assert torch.equal(tcf.ell_cheb_filter(data, sk, v, [0.5], 0.2), 0.5 * v)
    assert tck.launch_counts() == before  # plain versions count no launch
