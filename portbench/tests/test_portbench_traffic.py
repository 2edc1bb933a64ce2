"""Every traffic generator draws the same traffic from the same seed."""

import numpy as np

from portbench.harness import loader

from conftest import ROOT

SEEDS = (0, 7, 2**31 + 11, 3 * 2**32 + 5)


def ldos_rows(name, seed, calls=6):
    cell = loader.cell(name, ROOT)
    driver = cell.driver.Driver(None, cell.config, cell.mix, seed)
    return [cell.driver.row_sites(driver.rng, driver.shape, cell.mix, cell.config) for _ in range(calls)]


def test_ldos_rows_repeat_from_the_seed():
    for name in ("swave_1000x1000.ldos_map", "rashba_dp_64x64x4.ldos_map"):
        for seed in SEEDS:
            assert ldos_rows(name, seed) == ldos_rows(name, seed)
        assert ldos_rows(name, SEEDS[0]) != ldos_rows(name, SEEDS[1])


def test_ldos_rows_stay_inside_and_cross_the_wall():
    for seed in SEEDS:
        for row in ldos_rows("swave_1000x1000.ldos_map", seed, 20):
            xs, ys = [s[0] for s in row], {s[1] for s in row}
            assert xs == list(range(xs[0], xs[0] + 16)) and len(ys) == 1
            assert 100 <= xs[0] and xs[-1] < 900 and 100 <= ys.pop() < 900
        for row in ldos_rows("rashba_dp_64x64x4.ldos_map", seed, 20):
            assert [s[0] for s in row] == list(range(24, 40))  # centred on the wall at x = 32
            assert len({s[1:] for s in row}) == 1 and 0 <= row[0][2] < 4


def test_descent_traffic_repeats_from_the_seed(monkeypatch):
    cell = loader.cell("swave_1000x1000.gap_descent", ROOT)
    config = {**cell.config, "shape": [20, 20, 1]}
    drivers = [cell.driver.Driver(None, config, cell.mix, s) for s in (SEEDS[2], SEEDS[2], SEEDS[3])]
    assert np.array_equal(drivers[0].probes, drivers[1].probes)
    assert not np.array_equal(drivers[0].probes, drivers[2].probes)
    assert [drivers[0].coupling(i) for i in range(30)] == [drivers[1].coupling(i) for i in range(30)]
    norms = np.linalg.norm(drivers[0].probes.astype(np.float64), axis=(0, 1))
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)
    assert sorted({drivers[0].coupling(i) for i in range(11)}) == [round(2.0 + 0.1 * k, 10) for k in range(11)]
