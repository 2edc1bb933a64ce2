"""PyTorch port, the light-cone sweep: an LDOS sweep steps only the rows its probes
have reached (``cuda_spmm.LightCone``, ``StepPlan.light_cone``) on the plain path.

Against the whole-lattice sweep of the same probe block (``moments`` without a
hint) in complex64: the same products on every row a step computes, the partial
sums added in another order, so 1e-6 of the largest value.  Against the references
in complex128 at the tolerances of their own tests: ``bodge_tpu``'s stencil
``ldos_kpm_sites`` (1e-9, tests/test_torch_chebyshev.py) and the benchmark's float64
reference on the honeycomb (1e-10, tests/test_torch_honeycomb.py).  Lattices small
enough, and orders low enough, that the window stays partial for most steps.
"""

import numpy as np
import pytest
import torch

from bodge_tpu.models import systems as jsys
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu_torch.models import systems
from bodge_tpu_torch.ops import chebyshev as kpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_spmm as ck
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from portbench.reference import bdg
from portbench.reference import kpm as ref_kpm
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

ENERGIES = np.linspace(-1.2, 1.2, 9)
SCALE = 7.5  # above the norm of every system here


def whole_ldos(data, sk, sites, order, scale):
    """The LDOS of ``sites`` from the whole-lattice sweep of the same probe block."""
    mu = kpm.moments(data, sk, kpm.site_probes(sk.n_sites, sites, data), order, scale)
    return kpm.ldos_from_moments(mu, ENERGIES, scale, "jackson", len(sites))


def cone_rows(lo, hi, band, n, steps):
    """Σ_m |W_m| over a sweep's steps m = 1 … steps, W_m = [lo − m·band, hi + m·band] ∩ [0, n)."""
    return sum(min(n, hi + m * band + 1) - max(0, lo - m * band) for m in range(1, steps + 1))


def test_stencil_window_cut_at_one_edge():
    """Sites on the second x-plane of a 24×16 s-wave lattice: the window meets x = 0 at
    the second step and the far edge at the 23rd; the other steps are light-cone steps."""
    shape, order = (24, 16, 1), 64
    sites = [16 * 1 + y for y in (3, 4, 5, 6)]  # index = 16·x + y
    system = systems.swave_superconductor(shape, dtype=np.complex64, device="cpu")
    data, sk = system.data, system.skeleton
    assert ck.nonzero_bandwidth(data, sk) == 16 < np.abs(sk.cols - np.arange(sk.n_sites)[:, None]).max()
    ce.reset_window_counts()
    got = kpm.ldos_kpm_sites(data, sk, sites, ENERGIES, order=order, scale=SCALE)
    steps = ce.sweep_launches(order)
    assert ce.window_counts() == {"steps": steps, "window_steps": 22,
                                  "rows": cone_rows(19, 22, 16, sk.n_sites, steps), "lattice_rows": steps * sk.n_sites}
    want = whole_ldos(data, sk, sites, order, SCALE)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    sj = jsys.swave_superconductor(shape)
    st = hamiltonian_from_numpy(shape, np.asarray(sj.host_data()), sj.skeleton.cols, sj.skeleton.trans_slot,
                                device="cpu")
    got = kpm.ldos_kpm_sites(st.data, st.skeleton, sites, ENERGIES, order=order, scale=SCALE)
    want = np.asarray(jkpm.ldos_kpm_sites(sj.data, sj.skeleton, sites, ENERGIES, order=order, scale=SCALE,
                                          impl="stencil"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(1.0, np.abs(want).max()))


def test_honeycomb_window_through_the_gather_plan():
    """A 32×8 graphene ribbon runs the gather step: the window is the probe sites'
    relabelled rows, grown by the plan's bwb a step."""
    shape, order = (32, 8, 1), 64
    sites = [8 * 14 + 3, 8 * 15 + 3]  # index = y + 8·x
    system = systems.graphene_swave(shape, dtype=np.complex64, device="cpu")
    data, sk = system.data, system.skeleton
    plan = ck.StepPlan(sk, 4 * len(sites), None, data)
    cone = plan.light_cone(data, sites)
    rows = plan.layout.rank[sites]
    assert plan.kind == "gather" and cone == ck.LightCone(rows.min(), rows.max(), plan.layout.bwb, sk.n_sites)
    ce.reset_window_counts()
    got = kpm.ldos_kpm_sites(data, sk, sites, ENERGIES, order=order, scale=4.0)
    counts = ce.window_counts()
    assert 0 < counts["window_steps"] < counts["steps"] and counts["rows"] < counts["lattice_rows"]
    want = whole_ldos(data, sk, sites, order, 4.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    exact = systems.graphene_swave(shape, device="cpu")
    config = {"system": "graphene_swave", "shape": list(shape), "params": {"t": 1.0, "mu": 0.3, "delta": 0.1},
              "dtype": "complex128"}
    A = bdg.csr(config, "cpu")
    got = exact.ldos_map([np.unravel_index(s, shape) for s in sites], ENERGIES, method="kpm", order=order, scale=4.0)
    want = ref_kpm.ldos(A, sk.n_sites, sites, ENERGIES, order, 4.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_nonzero_wrap_blocks_give_the_whole_lattice():
    """Wrap blocks filled in by hand (a periodic operator): the band is the wrap's, the
    cone is the whole lattice from the first step, and the sweep is the whole one."""
    system = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cpu")
    data, sk = system.data, system.skeleton
    sites = [16 * 12 + 8]
    assert ck.nonzero_bandwidth(data, sk) == 16
    zero = (data == 0).all(dim=-1).all(dim=-1) & sk.device_valid("cpu")
    data[zero] = 0.1 * torch.eye(4, dtype=data.dtype)  # in place: the band is measured again
    assert ck.nonzero_bandwidth(data, sk) == np.abs(sk.cols - np.arange(sk.n_sites)[:, None]).max()
    assert ck.StepPlan(sk, 4, None, data).light_cone(data, sites) is None
    ce.reset_window_counts()
    got = kpm.ldos_kpm_sites(data, sk, sites, ENERGIES, order=32, scale=SCALE)
    assert ce.window_counts() == {"steps": 0, "window_steps": 0, "rows": 0, "lattice_rows": 0}
    np.testing.assert_array_equal(got, whole_ldos(data, sk, sites, 32, SCALE))


def test_rademacher_probes_take_no_window():
    """Probes with no support hint (trace_function's) run the whole lattice, uncounted."""
    system = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cpu")
    ce.reset_window_counts()
    F = kpm.free_energy_kpm(system.data, system.skeleton, 0.05, order=32, samples=4, scale=SCALE)
    dos = kpm.dos_kpm(system.data, system.skeleton, ENERGIES, order=32, samples=4, scale=SCALE)
    assert np.isfinite(F) and np.isfinite(dos).all()
    assert ce.window_counts() == {"steps": 0, "window_steps": 0, "rows": 0, "lattice_rows": 0}


def test_light_cone_rows_and_the_window_steps():
    """``LightCone.rows`` is W_m cut to the lattice; the plain light-cone steps agree
    with the whole-lattice steps on their rows, leave zeros elsewhere, and refuse rows
    outside the lattice."""
    cone = ck.LightCone(lo=40, hi=43, band=16, n=384)
    assert cone.rows(1) == (24, 60) and cone.rows(3) == (0, 92) and cone.rows(21) == (0, 380)
    assert cone.rows(22) is None and ck.LightCone(0, 383, 16, 384).rows(1) is None
    system = systems.swave_superconductor((24, 16, 1), dtype=np.complex64, device="cpu")
    data, sk = system.data, system.skeleton
    rng = np.random.default_rng(7)
    t_cur, t_prev = (torch.as_tensor(rng.normal(size=(384, 4, 3)) + 1j * rng.normal(size=(384, 4, 3)))
                     .to(torch.complex64) for _ in range(2))
    whole, _ = ce.ell_cheb_step_plain(data, sk, t_cur, t_prev, 0.1)
    part, sums = ce.ell_cheb_step_window(data, sk, t_cur, t_prev, 0.1, (24, 60))
    assert sums.shape == (1, 6)
    np.testing.assert_array_equal(part[24:60].numpy(), whole[24:60].numpy())
    assert not part[:24].any() and not part[60:].any()
    with pytest.raises(ValueError, match="rows"):
        ce.ell_cheb_step_window(data, sk, t_cur, t_prev, 0.1, (24, 385))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ce.ell_cheb_step_window(data, sk, t_cur, t_prev, 0.1, (24, 60), impl="cuda")
