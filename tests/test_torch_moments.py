"""PyTorch port, the KPM moment sweep in one launch (``ell_cheb_moments``):
its plain version against the reference's doubled-moment scan
(``bodge_tpu/ops/chebyshev.py`` ``_moments_scan``) on an 8×8 s-wave and a
(3,3,2) Rashba lattice, its launch plan, its wrapper's refusals, and
``moments_fused`` on CPU tensors staying on the plain per-step path; and the
spectral bound's power iteration in one launch (``ell_power_iteration``): its
launch plan and its wrapper on CPU tensors (its plain version against the
reference's bound is in ``tests/test_torch_chebyshev.py``); and ``sweep_mode``,
the one rule for how the moment, filter and power sweeps run.  The kernels run
only on the card: ``chip_smoke.py``, the small kernel checks and phases
``main``, ``lowest`` and ``bf16``."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bodge_tpu.models import systems as jsys
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu_torch.ops import cuda_ell as tce
from bodge_tpu_torch.ops import cuda_filter as tcf
from bodge_tpu_torch.ops import cuda_spmm as tck
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SCALE = 7.5  # above the norm of both systems
ORDERS = (1, 2, 7, 32)
K = 3


@pytest.fixture(scope="module")
def references():
    """Per system: the port's operator and skeleton on the CPU, the probes, and
    the reference's moments at the largest order — one ``_moments_scan`` call
    each; a smaller order's moments are the same scan's first entries."""
    out = {}
    for name, sj in (("swave", jsys.swave_superconductor((8, 8, 1), zeeman=[0.0, 0.0, 0.1])),
                     ("rashba", jsys.rashba_dp_wave((3, 3, 2)))):
        st = hamiltonian_from_numpy(sj.lattice.shape, np.asarray(sj.host_data()), sj.skeleton.cols,
                                    sj.skeleton.trans_slot, device="cpu")
        rng = np.random.default_rng(len(name))
        N = st.skeleton.n_sites
        v0 = rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))
        want = np.asarray(jkpm._moments_scan(sj.data, sj.skeleton, jnp.asarray(v0), 1.0 / SCALE, max(ORDERS),
                                             "stencil"))
        out[name] = (st, v0, want)
    return out


# complex128: 1e-12 of max|μ| (the same recursion, the sums in another order);
# complex64: 2e-5 of max|μ| (at most 16 float32 steps, sums over 4N ≤ 256 entries).
@pytest.mark.parametrize("system", ["swave", "rashba"])
def test_plain_matches_reference_scan(references, system):
    st, v0, want = references[system]
    for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 2e-5)):
        data, v = st.data.to(dtype), torch.as_tensor(v0).to(dtype)
        for order in ORDERS:
            got = tcf.ell_cheb_moments_plain(data, st.skeleton, v, 1.0 / SCALE, order)
            assert got.shape == (order, K) and got.dtype == (torch.float64 if dtype == torch.complex128
                                                             else torch.float32)
            assert np.abs(got.numpy() - want[:order]).max() <= tol * np.abs(want).max(), (dtype, order)


# The moment kernel's plan on 132 SMs at the main path's sweeps: rashba 64×64×4
# (S = 7) at K = 8 and 4 fits one pair a thread; 200×200 (S = 5) at K = 4 only
# global mode; 10⁶ sites no plan (a block's sites beyond its shared memory).
@pytest.mark.parametrize("N, K, S, order, mode, grid, sites", [
    (16384, 8, 7, 256, "registers", 512, 32),
    (16384, 4, 7, 512, "registers", 283, 58),
    (40000, 4, 5, 512, "global", 527, 76),
    (1000000, 8, 5, 256, "per_step", 0, 0),
])
def test_moments_plan(N, K, S, order, mode, grid, sites):
    plan = tcf.moments_plan(N, K, S, order, sms=132)
    assert (plan["mode"], plan["grid"], plan["sites_per_block"]) == (mode, grid, sites)
    assert plan["steps"] == tce.sweep_launches(order) == 1 + (order - 1) // 2
    if mode == "per_step":
        assert tcf.moments_plan(N, K, S, order, bf16=True, sms=132)["mode"] == "per_step"
        return
    assert grid <= tcf.FILTER_BLOCKS_PER_SM * 132 and (grid - 1) * sites < N <= grid * sites
    assert plan["smem_bytes"] == sites * tcf._site_bytes(S, False, K) <= tcf.FILTER_SMEM_CAP
    assert plan["smem_bytes"] == sites * (tcf._site_bytes(S, False) + 8 * K)  # the reduction buffer counted
    assert plan["partials_bytes"] == plan["steps"] * grid * 2 * K * 4 <= tcf.MOMENTS_PARTIALS_CAP
    assert tcf.moments_plan(N, K, S, order, mode="global", sms=132)["mode"] == "global"
    if mode == "global":
        with pytest.raises(ValueError, match="registers mode does not fit"):
            tcf.moments_plan(N, K, S, order, mode="registers", sms=132)
    # partials past the cap do not fit: the per-step path, or a refusal when forced
    long = (tcf.MOMENTS_PARTIALS_CAP // (grid * 2 * K * 4) + 1) * 2
    assert tcf.moments_plan(N, K, S, long, sms=132)["mode"] != mode
    with pytest.raises(ValueError, match="steps of partials"):
        tcf.moments_plan(N, K, S, long, mode=mode, sms=132)


def test_moments_wrapper_refusals(references):
    st, v0, _ = references["rashba"]
    sk, data = st.skeleton, st.data.to(torch.complex64)
    v = torch.as_tensor(v0).to(torch.complex64)
    before = tck.launch_counts()
    assert {"ell_cheb_moments", "ell_cheb_moments.steps", "ell_cheb_moments_bf16.steps"} <= set(before)
    assert set(tck.SWEEP_KERNELS) == {"ell_cheb_filter", "ell_cheb_filter_bf16", *tck.MOMENT_KERNELS,
                                      *tck.POWER_KERNELS}
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcf.ell_cheb_moments(data, sk, v, 0.1, 8, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcf.ell_cheb_moments_bf16(tce.bf16_operator(data), sk, v, 0.1, 8, impl="cuda")
    with pytest.raises(TypeError, match="bf16"):
        tcf.ell_cheb_moments_bf16(data, sk, v, 0.1, 8)
    for order in (0, -3):
        with pytest.raises(ValueError, match="order"):
            tcf.ell_cheb_moments(data, sk, v, 0.1, order)
        with pytest.raises(ValueError, match="order"):
            tcf.moments_plan(sk.n_sites, K, sk.n_slots, order)
    with pytest.raises(ValueError, match="mode"):
        tcf.moments_plan(sk.n_sites, K, sk.n_slots, 8, mode="shared")
    with pytest.raises(ValueError, match="N, K, S"):
        tcf.moments_plan(0, K, sk.n_slots, 8)
    assert torch.equal(tcf.ell_cheb_moments(data, sk, v, 0.1, 8),
                       tcf.ell_cheb_moments_plain(data, sk, v, 0.1, 8))  # a CPU tensor: the plain version
    assert tck.launch_counts() == before  # plain versions count no launch


# On CPU tensors moments_fused keeps the per-step plain path, in complex128 and
# in the bf16 form: the same moments as the moment kernel's plain version (the
# same float64 recursion bit for bit; the bf16 form within 1e-6 of max|μ|, its
# float32 products in another order), and no launch counted.
def test_moments_fused_on_cpu_runs_the_plain_path(references):
    st, v0, want = references["swave"]
    sk = st.skeleton
    v = torch.as_tensor(v0)
    before = tck.launch_counts()
    plan = tck.StepPlan(sk, K, None, v)
    got = tck.moments_fused(st.data, sk, v, 1.0 / SCALE, 32)
    step = lambda t_cur, t_prev, scale, out: plan.step(st.data, t_cur, t_prev, scale)
    assert torch.equal(got, tce.moment_recursion(step, v, 1.0 / SCALE, 32))
    assert torch.equal(got, tcf.ell_cheb_moments_plain(st.data, sk, v, 1.0 / SCALE, 32))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    v64 = v.to(torch.complex64)
    got16 = tck.moments_fused(st.data, sk, v64, 1.0 / SCALE, 7, operator_dtype=torch.bfloat16)
    plain16 = tcf.ell_cheb_moments_plain(tce.bf16_operator(st.data), sk, v64, 1.0 / SCALE, 7)
    assert got16.dtype == torch.float32 and np.abs((got16 - plain16).numpy()).max() <= 1e-6 * plain16.abs().max()
    assert tck.launch_counts() == before


# The power kernel's plan on 132 SMs at the main path's spectral bounds (K = 1,
# 60 steps): rashba 64×64×4 (S = 7), the 200×200 s-wave and the lowest-states
# lattices 32×32 and 100×100 (S = 5) fit one site a thread; 10⁶ sites no plan
# (a block's sites beyond its shared memory at 528 blocks).
@pytest.mark.parametrize("N, S, mode, grid, sites", [
    (16384, 7, "registers", 274, 60),
    (40000, 5, "registers", 477, 84),
    (1024, 5, "registers", 128, 8),
    (10000, 5, "registers", 132, 76),
    (1000000, 5, "per_step", 0, 0),
])
def test_power_plan(N, S, mode, grid, sites):
    plan = tcf.power_plan(N, S, 60, sms=132)
    assert (plan["mode"], plan["grid"], plan["sites_per_block"], plan["steps"]) == (mode, grid, sites, 60)
    if mode == "per_step":
        for forced in tcf.MODES:  # a forced mode that does not fit raises
            with pytest.raises(ValueError, match=f"power kernel's {forced} mode does not fit"):
                tcf.power_plan(N, S, 60, mode=forced, sms=132)
        return
    assert grid <= tcf.FILTER_BLOCKS_PER_SM * 132 and (grid - 1) * sites < N <= grid * sites
    assert plan["smem_bytes"] == sites * tcf._site_bytes(S, False) + tcf.POWER_BLOCK_BYTES <= tcf.FILTER_SMEM_CAP
    assert plan["partials_bytes"] == 60 * grid * 4
    assert tcf.power_plan(N, S, 60, mode="global", sms=132)["mode"] == "global"
    # partials past the cap do not fit: the per-step path, or a refusal when forced
    long = tcf.MOMENTS_PARTIALS_CAP // (grid * 4) + 1
    assert tcf.power_plan(N, S, long, sms=132)["mode"] != mode
    with pytest.raises(ValueError, match="steps of partials"):
        tcf.power_plan(N, S, long, mode=mode, sms=132)


# On a CPU tensor the wrapper runs the plain version, and spectral_bound the
# plain per-step loop (the same float64 loop bit for bit); impl="cuda" raises;
# no launch is counted.
def test_power_iteration_on_cpu(references):
    st, _, _ = references["swave"]
    sk, data = st.skeleton, st.data
    rng = np.random.default_rng(0)  # spectral_bound's start vector at seed 0
    v = torch.as_tensor(rng.standard_normal((sk.n_sites, 4, 1)) + 1j * rng.standard_normal((sk.n_sites, 4, 1)))
    before = tck.launch_counts()
    assert {"ell_power_iteration", "ell_power_iteration.steps"} <= set(before)
    got = tcf.ell_power_iteration(data, sk, v, 60)
    assert got.dim() == 0 and got.dtype == torch.float64
    assert torch.equal(got, tcf.ell_power_iteration_plain(data, sk, v, 60))
    from bodge_tpu_torch.ops import chebyshev as tkpm

    assert tkpm.spectral_bound(data, sk) == float(got) * 1.05
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcf.ell_power_iteration(data.to(torch.complex64), sk, v.to(torch.complex64), 60, impl="cuda")
    for iters in (0, -2):
        with pytest.raises(ValueError, match="iters"):
            tcf.ell_power_iteration(data, sk, v, iters)
        with pytest.raises(ValueError, match="iters"):
            tcf.power_plan(sk.n_sites, sk.n_slots, iters)
    assert tck.launch_counts() == before  # plain versions count no launch


# sweep_mode, the one rule for how the three sweeps run: the plain versions on
# a CPU tensor; on the card one launch a step on the gather and tiled steps and
# for the power iteration of the bf16 form; else the mode of the sweep's
# cuda_filter plan, "per_step" where none fits (plans for 132 SMs, as without a
# card).  A plan on the card is stood in for by its backend, kind and skeleton.
MODE_CASES = {  # case: (kind, N, bf16, {sweep: mode})
    "gather": ("gather", 64, False, {"moments": "per_step", "filter": "per_step", "power": "per_step"}),
    "tiled": ("tiled", 64, False, {"moments": "per_step", "filter": "per_step", "power": "per_step"}),
    "ell": ("ell", 64, False, {"moments": "registers", "filter": "registers", "power": "registers"}),
    "ell bf16": ("ell", 64, True, {"moments": "registers", "filter": "registers", "power": "per_step"}),
    "ell 10^6": ("ell", 10**6, False, {"moments": "per_step", "filter": "per_step", "power": "per_step"}),
}


@pytest.mark.parametrize("sweep", tck.SWEEPS)
@pytest.mark.parametrize("case", ["cpu", *MODE_CASES])
def test_sweep_mode(references, sweep, case):
    st, v0, _ = references["swave"]
    order = 60 if sweep == "power" else 32
    if case == "cpu":
        plan = tck.StepPlan(st.skeleton, K, None, st.data)
        assert tck.sweep_mode(plan, st.data, sweep, K, order) == "plain"
        return
    kind, N, bf16, modes = MODE_CASES[case]
    plan = types.SimpleNamespace(backend="cuda", kind=kind,
                                 sk=types.SimpleNamespace(cols=np.broadcast_to(np.int32(0), (N, 5))))
    data = torch.zeros(1, dtype=torch.bfloat16 if bf16 else torch.complex64)
    assert tck.sweep_mode(plan, data, sweep, K, order) == modes[sweep]
    with pytest.raises(ValueError, match="sweep"):
        tck.sweep_mode(plan, data, "spmm")
