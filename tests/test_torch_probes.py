"""PyTorch port, the Rademacher probe block drawn on the card (``ops/cuda_probes``).

The kernel's plain version (its own algorithm: the per-thread jump, the stride,
the two bit positions) must equal ``chebyshev.rademacher_probes``, NumPy's draw,
bit for bit; the KPM driver draws on the card only for a complex64 or float32
operator there, and says so in ``probe_draw_counts()``.  This file imports
neither JAX nor ``bodge_tpu``, so its tests marked ``cuda`` run on a machine with
a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_probes.py

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from bodge_tpu_torch.models import selfconsistency as sc
from bodge_tpu_torch.models import systems
from bodge_tpu_torch.ops import chebyshev as kpm
from bodge_tpu_torch.ops import cuda_probes as cp

SEEDS = [(0, 42), (1, 42), (7919, 42), (2**62 - 1, 42), (None, 42), (None, 1), (None, 11)]


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
@pytest.mark.parametrize("samples", [1, 3, 8])
@pytest.mark.parametrize("N", [1, 7, 1000])
@pytest.mark.parametrize("seed, default_seed", SEEDS)
def test_plain_draw_equals_numpy(seed, default_seed, N, samples, dtype):
    want = kpm.rademacher_probes(N, samples, seed, dtype, default_seed=default_seed)
    for blocks in (None, 1):  # the planned stride, and one block of 256 threads stepping many times
        got = cp.rademacher_plain(N, samples, seed, dtype, default_seed=default_seed, blocks=blocks)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("a, b", [(0, 0), (0, 5), (1, 1), (255, 257), (135168, 3), (2**40 + 3, 2**33)])
def test_jump_composes(a, b):
    state, inc = cp.pcg64_state(2024)
    mult_a, plus_a = cp.jump(a, inc)
    mult_b, plus_b = cp.jump(b, inc)
    got = (mult_b * ((mult_a * state + plus_a) & cp.MASK128) + plus_b) & cp.MASK128
    generator = np.random.PCG64(2024)
    generator.advance(a + b)
    assert got == generator.state["state"]["state"]
    if a + b <= 600:  # and against stepping one draw at a time
        s = state
        for _ in range(a + b):
            s = (s * cp.MULT + inc) & cp.MASK128
        assert got == s


@pytest.fixture(scope="module")
def swave():
    return systems.swave_superconductor((6, 5, 1), dtype=np.complex64, device="cpu")


def test_cpu_operator_keeps_the_numpy_draw(swave):
    data, sk = swave.data, swave.skeleton
    kpm.reset_probe_draw_counts()
    got = kpm.trace_probes(sk.n_sites, 4, 9, data)
    assert kpm.probe_draw_counts() == {"probes.card": 0, "probes.host": 1}
    assert got.dtype == data.dtype and torch.equal(got, torch.as_tensor(kpm.rademacher_probes(sk.n_sites, 4, 9,
                                                                                              np.complex64)))
    kpm.reset_probe_draw_counts()
    kpm.free_energy_kpm(data, sk, 0.05, order=32, samples=4, seed=9, scale=8.0)
    kpm.dos_kpm(data, sk, [0.0, 0.5], order=32, samples=4, scale=8.0)
    assert kpm.probe_draw_counts() == {"probes.card": 0, "probes.host": 2}
    kpm.reset_probe_draw_counts()
    assert kpm.probe_draw_counts() == {"probes.card": 0, "probes.host": 0}
    # the CPU form of the wrapper is the plain version; other dtypes are refused
    assert torch.equal(cp.rademacher(sk.n_sites, 3, 4, torch.float32, "cpu"),
                       torch.as_tensor(kpm.rademacher_probes(sk.n_sites, 3, 4, np.float32)))
    with pytest.raises(TypeError):
        cp.rademacher(sk.n_sites, 3, 4, torch.complex128, "cpu")


def test_gap_objective_default_probes(swave):
    """``probes=None`` draws by the same rule as the NumPy block the caller could pass."""
    kwargs = dict(temperature=0.05, method="kpm", order=32, samples=4, seed=3, scale=8.0)
    N = swave.skeleton.n_sites
    given = kpm.rademacher_probes(N, 4, 3, np.float64, default_seed=11) / np.sqrt(N * 4)
    delta = torch.full((N,), 0.2)
    drawn = sc.make_total_free_energy(swave, V=1.0, **kwargs)(delta)
    passed = sc.make_total_free_energy(swave, V=1.0, probes=given, **kwargs)(delta)
    assert torch.equal(drawn, passed)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_equals_the_plain_version_on_the_card():
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = cp.rademacher.launches
    cases = [(1, 1, 0, torch.complex64), (7, 3, None, torch.float32), (1000, 8, 7919, torch.complex64),
             (300_000, 8, 2**62 - 1, torch.complex64), (300_000, 5, 12, torch.float32)]  # the last two: many strides
    for N, samples, seed, dtype in cases:
        got = cp.rademacher(N, samples, seed, dtype, dev)
        assert got.device.type == "cuda" and got.dtype == dtype and got.shape == (N, 4, samples)
        blocks = cp.draw_plan(N * 2 * samples, sms)
        plain = cp.rademacher_plain(N, samples, seed, np.dtype(str(dtype).removeprefix("torch.")), blocks=blocks)
        assert torch.equal(got.cpu(), torch.from_numpy(plain))
        assert torch.equal(got, cp.rademacher(N, samples, seed, dtype, dev))  # a repeat is the same block
    assert cp.rademacher.launches - before == 2 * len(cases)


@pytest.mark.cuda
def test_free_energy_on_the_card_draws_there(monkeypatch):
    dev = _card()
    card = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cuda")
    data, sk = card.data, card.skeleton
    kpm.reset_probe_draw_counts()
    got = kpm.free_energy_kpm(data, sk, 0.01, order=128, samples=8, seed=7, scale=8.0)
    assert kpm.probe_draw_counts() == {"probes.card": 1, "probes.host": 0}
    # the NumPy block through the upload the card draw replaces: the same F, bit for bit
    monkeypatch.setattr(kpm, "trace_probes", lambda N, samples, seed, like, default_seed=42: kpm._as_tensor(
        kpm.rademacher_probes(N, samples, seed, np.complex64, default_seed), like))
    assert kpm.free_energy_kpm(data, sk, 0.01, order=128, samples=8, seed=7, scale=8.0) == got
    monkeypatch.undo()
    # the gap objective's default probes, normalised on the card, against the NumPy block passed in
    N = sk.n_sites
    kwargs = dict(temperature=0.05, method="kpm", order=32, samples=4, seed=3, scale=8.0)
    given = kpm.rademacher_probes(N, 4, 3, np.float64, default_seed=11) / np.sqrt(N * 4)
    delta = torch.full((N,), 0.2, device=dev)
    kpm.reset_probe_draw_counts()
    drawn = sc.make_total_free_energy(card, V=1.0, **kwargs)(delta)
    assert kpm.probe_draw_counts() == {"probes.card": 1, "probes.host": 0}
    assert torch.equal(drawn, sc.make_total_free_energy(card, V=1.0, probes=given, **kwargs)(delta))
