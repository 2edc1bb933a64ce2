"""PyTorch port, the KPM calls' inputs: the LDOS probes built on the operator's
device and the spectral bound's seeded start vector, drawn once and kept.

Both must give the same numbers, bit for bit, as the NumPy block and the fresh
NumPy draw they replace.  This file imports neither JAX nor ``bodge_tpu``, so
its test marked ``cuda`` runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kpm_inputs.py

Without a card that test skips.
"""

import numpy as np
import pytest
import torch

from bodge_tpu_torch.models import systems
from bodge_tpu_torch.ops import chebyshev as kpm

ENERGIES = np.linspace(-1.5, 1.5, 9)


@pytest.fixture(scope="module")
def swave():
    return systems.swave_superconductor((6, 5, 1), dtype=np.complex64, device="cpu")


@pytest.mark.parametrize("N, sites, dtype", [
    (9, [2, 5], torch.complex64),
    (9, [2, 2, 7, 2], torch.complex64),  # repeated sites: a column of their own each
    (30, [0, 29, -1, -30], torch.complex128),  # negative indices count from the end, as in NumPy
    (4, [], torch.complex64),
])
def test_site_probes_equal_the_numpy_block(N, sites, dtype):
    got = kpm.site_probes(N, sites, torch.zeros(1, dtype=dtype))
    want = kpm.ldos_site_probes(N, sites, np.complex64 if dtype == torch.complex64 else np.complex128)
    assert got.dtype == dtype and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(IndexError):
        kpm.site_probes(N, [N], torch.zeros(1, dtype=dtype))
    with pytest.raises(IndexError):
        kpm.site_probes(N, [-N - 1], torch.zeros(1, dtype=dtype))


def test_ldos_kpm_sites_equal_the_moments_of_the_numpy_block(swave):
    data, sk = swave.data, swave.skeleton
    sites, order = [3, 17, 17, 28], 48
    scale = kpm.spectral_bound(data, sk)
    mu = kpm.moments(data, sk, kpm.ldos_site_probes(sk.n_sites, sites, np.complex64), order, scale)
    want = kpm.ldos_from_moments(mu, ENERGIES, scale, "jackson", len(sites))
    for given in (scale, None):  # None runs the bound inside the call, from the kept start vector
        got = kpm.ldos_kpm_sites(data, sk, sites, ENERGIES, order=order, scale=given)
        assert np.array_equal(got, want)


def _fresh_draw(n, seed):
    rng = np.random.default_rng(seed)
    shape = (n, 4, 1)
    return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def test_spectral_bound_start_vector_kept(swave, monkeypatch):
    data, sk = swave.data, swave.skeleton
    seed = 2_718_281_828  # a key no other test of this process uses
    kpm.reset_kpm_input_counts()
    first = kpm.spectral_bound(data, sk, seed=seed)
    second = kpm.spectral_bound(data, sk, seed=seed)
    assert kpm.kpm_input_counts() == {"start_vector.hits": 1, "start_vector.misses": 1}
    assert first == second
    kpm.reset_kpm_input_counts()
    assert kpm.kpm_input_counts() == {"start_vector.hits": 0, "start_vector.misses": 0}
    # against the draw made anew with nothing kept
    monkeypatch.setattr(kpm, "_start_vectors", type(kpm._start_vectors)())
    assert kpm.spectral_bound(data, sk, seed=seed) == first
    assert kpm.kpm_input_counts() == {"start_vector.hits": 0, "start_vector.misses": 1}
    # the kept vector is the draw cast as a pageable upload casts it; each caller gets a copy
    want = _fresh_draw(sk.n_sites, seed).to(data.dtype)
    got = kpm._seeded_start_vector(sk.n_sites, seed, data)
    assert got.dtype == data.dtype and torch.equal(got, want)
    got.zero_()
    assert torch.equal(kpm._seeded_start_vector(sk.n_sites, seed, data), want)
    # a generator bypasses the kept vectors
    kpm.reset_kpm_input_counts()
    kpm.spectral_bound(data, sk, generator=torch.Generator().manual_seed(3))
    assert kpm.kpm_input_counts() == {"start_vector.hits": 0, "start_vector.misses": 0}


def test_start_vector_keys(monkeypatch):
    monkeypatch.setattr(kpm, "_start_vectors", type(kpm._start_vectors)())
    like64, like128 = torch.zeros(1, dtype=torch.complex64), torch.zeros(1, dtype=torch.complex128)
    kpm.reset_kpm_input_counts()
    kpm._seeded_start_vector(20, 5, like64)
    kpm._seeded_start_vector(21, 5, like64)  # another lattice size
    kpm._seeded_start_vector(20, 6, like64)  # another seed
    kpm._seeded_start_vector(20, 5, like128)  # another dtype
    assert kpm.kpm_input_counts() == {"start_vector.hits": 0, "start_vector.misses": 4}
    kpm._seeded_start_vector(20, 5, like64)
    assert kpm.kpm_input_counts()["start_vector.hits"] == 1
    # only the last few keys are kept: the oldest goes first
    for seed in range(100, 100 + kpm.START_VECTORS_KEPT):
        kpm._seeded_start_vector(20, seed, like64)
    assert len(kpm._start_vectors) == kpm.START_VECTORS_KEPT
    kpm.reset_kpm_input_counts()
    kpm._seeded_start_vector(20, 5, like64)
    assert kpm.kpm_input_counts() == {"start_vector.hits": 0, "start_vector.misses": 1}
    assert torch.equal(kpm._seeded_start_vector(20, 5, like128), _fresh_draw(20, 5))


@pytest.mark.cuda
def test_ldos_kpm_sites_on_the_card_match_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sites, order = [5, 77, 77, 300], 256
    host = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cpu")
    card = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cuda")
    want = kpm.ldos_kpm_sites(host.data, host.skeleton, sites, ENERGIES, order=order)

    seen = []
    moments = kpm.moments

    def recording(data, sk, v0, *args, **kwargs):
        seen.append((type(v0), getattr(v0, "device", None)))
        return moments(data, sk, v0, *args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the NumPy probe block was built")

    monkeypatch.setattr(kpm, "moments", recording)
    monkeypatch.setattr(kpm, "ldos_site_probes", refused)
    kpm.reset_kpm_input_counts()
    got = [kpm.ldos_kpm_sites(card.data, card.skeleton, sites, ENERGIES, order=order) for _ in range(2)]
    assert all(t is torch.Tensor and d.type == "cuda" for t, d in seen) and len(seen) == 2
    assert kpm.kpm_input_counts()["start_vector.hits"] >= 1
    assert np.array_equal(got[0], got[1])
    assert np.allclose(got[0], want, atol=2e-4 * np.abs(want).max(), rtol=0)
    # the kept start vector on the card is the CPU's draw, bit for bit
    v = kpm._seeded_start_vector(card.skeleton.n_sites, 0, card.data)
    assert v.device.type == "cuda"
    assert torch.equal(v.cpu(), _fresh_draw(card.skeleton.n_sites, 0).to(torch.complex64))
