"""PyTorch port, lowest-states solver: the NumPy pieces carried over from
``bodge_tpu/ops/lanczos.py`` (order buckets, the float64 host product, the DCT
coefficients, the low-pass filter, the wanted-state selection, the signed
Rayleigh–Ritz step) give bit-equal results on the same inputs."""

import numpy as np
import pytest
import torch

from bodge_tpu.ops import lanczos as jlz
from bodge_tpu_torch.ops import lanczos as tlz
import bodge_tpu_torch as T
from tests.test_torch_banded import single_blas_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_lanczos import swave_system
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

# One intra-op thread: the suite runs several workers side by side, and idle
# OpenMP threads of a multi-threaded torch would spin against them.
torch.set_num_threads(1)


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


