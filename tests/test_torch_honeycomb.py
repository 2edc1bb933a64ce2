"""PyTorch port, the honeycomb lattice: ``HoneycombLattice`` (a brick wall) against
a honeycomb flake built independently from its two-atom unit cell, the recipe
``graphene_swave`` against the benchmark's float64 reference
(``portbench/reference``), and the gather path's counters (``gather_counts``) and
spans (``bodge.gather.plan``, ``bodge.gather.relabel``).

This file imports neither JAX nor ``bodge_tpu``, so its test marked ``cuda`` runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_honeycomb.py

Without a card that test skips.
"""

import numpy as np
import pytest
import torch

from bodge_tpu_torch import CubicLattice, HoneycombLattice
from bodge_tpu_torch.models import systems
from bodge_tpu_torch.ops import blocksparse as bs
from bodge_tpu_torch.ops import chebyshev as kpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import cuda_gather as cg
from bodge_tpu_torch.ops import cuda_spmm as ck
from portbench.reference import bdg
from portbench.reference import kpm as ref_kpm

T, MU, DELTA = 1.0, 0.3, 0.1
ENERGIES = np.linspace(-1.0, 1.0, 9)


def flake(Lx, Ly):
    """``Ly`` zigzag chains of ``Lx`` atoms cut from graphene's Bravais lattice
    (a1 = (√3, 0), a2 = (√3/2, 3/2), atoms A at 0 and B at (0, 1); a_cc = 1):
    ``(positions [N, 2], bonds [B, 2])``, the bonds found by distance.  Chain j
    holds the B atoms of cell row j and the A atoms of row j + 1, which sit at
    x = (√3/2)·p for integers p; the window p ∈ [1, Lx] is taken."""
    pos = []
    for n2 in range(Ly + 1):
        for n1 in range(-Ly - 2, Lx + 2):
            for basis in ((0.0, 0.0), (0.0, 1.0)):
                pos.append((np.sqrt(3) * n1 + np.sqrt(3) / 2 * n2 + basis[0], 1.5 * n2 + basis[1]))
    pos = np.array(pos)
    p = np.rint(pos[:, 0] / (np.sqrt(3) / 2)).astype(int)
    keep = (p >= 1) & (p <= Lx) & (pos[:, 1] > 0.5) & (pos[:, 1] < 1.5 * Ly + 1.0)
    pos = pos[keep]
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    bonds = np.argwhere(np.abs(d - 1.0) < 1e-9)
    return pos, bonds


def dense_bdg(n, bonds):
    """The 4N×4N BdG matrix of graphene_swave's terms on a graph, in the basis
    {e↑, e↓, h↑, h↓} per site: h = −μ on site, −t on bonds, Δ jσ2 pairing."""
    H = np.zeros((n, 4, n, 4), complex)
    js2 = np.array([[0, 1], [-1, 0]])
    for i in range(n):
        H[i, :2, i, :2] = -MU * np.eye(2)
        H[i, 2:, i, 2:] = MU * np.eye(2)
        H[i, :2, i, 2:] = DELTA * js2
        H[i, 2:, i, :2] = DELTA * js2.T
    for i, j in bonds:
        H[i, :2, j, :2] = -T * np.eye(2)
        H[i, 2:, j, 2:] = T * np.eye(2)
    return H.reshape(4 * n, 4 * n)


def config(shape):
    return {"system": "graphene_swave", "shape": list(shape), "params": {"t": T, "mu": MU, "delta": DELTA}}


def test_the_brick_wall_is_the_honeycomb():
    pos, bonds = flake(24, 8)
    assert len(pos) == 24 * 8 and len(bonds) > 0
    lattice = HoneycombLattice(24, 8)
    system = systems.graphene_swave((24, 8, 1), device="cpu")
    want = np.linalg.eigvalsh(dense_bdg(len(pos), bonds))
    got = np.linalg.eigvalsh(system.matrix("dense"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)  # complex128 eigensolves of one matrix up to relabelling
    sk = system.skeleton
    assert not sk.stencil and sk.n_slots == 4
    neighbours = ((sk.cols >= 0).sum(axis=1) - 1).reshape(24, 8)
    assert np.array_equal(np.sort(neighbours.ravel()), np.sort(np.bincount(bonds[:, 0], minlength=len(pos))))
    assert (neighbours[1:-1, 1:-1] == 3).all()  # the bulk
    assert set(neighbours[:, [0, -1]].ravel().tolist()) | set(neighbours[[0, -1]].ravel().tolist()) <= {1, 2, 3}
    # 2 or 3 everywhere but the two far corners of a ribbon of even length, held by one x-bond each
    assert sorted(map(tuple, np.argwhere(neighbours == 1).tolist())) == [(23, 0), (23, 7)]
    assert set(neighbours.ravel().tolist()) == {1, 2, 3}
    assert not isinstance(lattice, CubicLattice)


def test_the_scalar_contract_matches_the_arrays():
    lattice = HoneycombLattice(7, 5)
    assert lattice.size == 35 and lattice.shape == (7, 5, 1)
    coords = lattice.site_coords
    assert [tuple(c) for c in coords] == list(lattice.sites())
    assert [lattice.index(tuple(int(v) for v in c)) for c in coords] == list(range(35))
    assert np.array_equal(lattice.index_array(coords), np.arange(35))
    src, dst = lattice.bond_arrays()
    pairs = {(tuple(a), tuple(b)) for a, b in zip(src.tolist(), dst.tolist())}
    assert pairs == set(lattice.bonds()) and len(pairs) == len(src)
    for (x, y, _), (u, v, _) in pairs:
        assert (abs(x - u), abs(y - v)) in ((1, 0), (0, 1))
        assert x != u or (x + min(y, v)) % 2 == 0  # a y-bond only where x + y of the lower site is even
    assert list(lattice.edges()) == [] and all(len(a) == 0 for a in lattice.edge_arrays())
    for bad in ((7, 0, 0), (0, 5, 0), (0, 0, 1), (-1, 0, 0)):
        with pytest.raises(ValueError):
            lattice.index(bad)
    with pytest.raises(ValueError):
        lattice.index_array(np.array([[0, 5, 0]]))
    with pytest.raises(ValueError):
        systems.graphene_swave((4, 4, 2), device="cpu")


def test_skeleton_from_pairs_sorts_and_refuses():
    rng = np.random.default_rng(3)
    n = 50
    rows, cols = rng.integers(0, n, 400), rng.integers(0, n, 400)
    rows, cols = np.concatenate([rows, cols, np.arange(n)]), np.concatenate([cols, rows, np.arange(n)])
    sk = bs.skeleton_from_pairs(n, rows, cols)
    for i in range(n):  # each row's slots hold its distinct partners in increasing order
        want = np.unique(cols[rows == i])
        assert np.array_equal(sk.cols[i, :len(want)], want) and (sk.cols[i, len(want):] == -1).all()
    with pytest.raises(ValueError, match="outside"):
        bs.skeleton_from_pairs(n, np.array([0, n]), np.array([n, 0]))


def test_graphene_swave_operator_matches_the_reference():
    system = systems.graphene_swave((12, 6, 1), device="cpu")
    want = bdg.csr(config((12, 6, 1)), "cpu").to_dense().numpy()
    np.testing.assert_array_equal(system.matrix("dense"), want)  # the same float64 terms, entry by entry


def test_graphene_swave_kpm_matches_the_reference():
    """complex128 on both sides, the same algorithms: the gaps are orders of
    summation, 1e-10 of the largest value."""
    shape = (20, 6, 1)
    n = 120
    system = systems.graphene_swave(shape, device="cpu")
    A = bdg.csr(config(shape), "cpu")
    a = ref_kpm.spectral_bound(lambda v: torch.mm(A, v), n, "cpu")
    sites = [(5, 2, 0), (6, 2, 0), (9, 4, 0)]
    got = system.ldos_map(sites, ENERGIES, method="kpm", order=96)
    want = ref_kpm.ldos(A, n, [int(np.ravel_multi_index(s, shape)) for s in sites], ENERGIES, 96, a)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())

    temperature, order, samples, seed = 0.01, 64, 4, 2**40 + 3
    got = system.free_energy(temperature, method="kpm", order=order, samples=samples, seed=seed)
    z = 2.0 * np.random.default_rng(seed).integers(0, 2, size=(n, 4, samples)) - 1.0
    G = lambda x: -np.abs(a * x) / 2 - temperature * np.log1p(np.exp(-np.abs(a * x) / temperature))
    coeffs = ref_kpm.chebyshev_series(G, order) * ref_kpm.jackson(order)
    mu = ref_kpm.moments(A, torch.as_tensor(z).reshape(4 * n, -1).to(torch.complex128), a, order)
    want = 0.5 * float(coeffs @ mu.sum(axis=1)) / samples
    assert abs(got - want) <= 1e-10 * abs(want)


def test_gather_counts():
    system = systems.graphene_swave((16, 8, 1), device="cpu")
    data, sk = system.data, system.skeleton
    v0 = kpm.site_probes(sk.n_sites, [3, 40], data)
    cg.reset_gather_counts()
    first = kpm.moments(data, sk, v0, 32, 4.0)
    assert cg.gather_counts() == {"plans": 1, "operator_relabels": 1, "vector_relabels": 1}
    second = kpm.moments(data, sk, v0, 32, 4.0)  # the plan is cached: relabelled again, not planned again
    assert cg.gather_counts() == {"plans": 1, "operator_relabels": 2, "vector_relabels": 2}
    assert torch.equal(first, second)
    kpm.spectral_bound(data, sk)  # K = 1: a plan of its own, one operator and one vector relabelled
    assert cg.gather_counts() == {"plans": 2, "operator_relabels": 3, "vector_relabels": 3}
    plan = ck.StepPlan(sk, 8, None, data)
    plan.leave(plan.enter(v0))
    assert cg.gather_counts() == {"plans": 2, "operator_relabels": 3, "vector_relabels": 5}
    # a stencil skeleton takes none of these paths; the counters stay out of launch_counts()
    box = systems.swave_superconductor((6, 5, 1), device="cpu")
    box.ldos_map([(2, 2, 0)], ENERGIES, method="kpm", order=32)
    assert cg.gather_counts() == {"plans": 2, "operator_relabels": 3, "vector_relabels": 5}
    assert not set(cg.gather_counts()) & set(ck.launch_counts())
    cg.reset_gather_counts()
    assert cg.gather_counts() == {"plans": 0, "operator_relabels": 0, "vector_relabels": 0}


def test_gather_spans_in_a_cpu_trace():
    system = systems.graphene_swave((16, 6, 1), device="cpu")  # a new skeleton: its plans are built inside
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        system.ldos_map([(4, 2, 0)], ENERGIES, method="kpm", order=32)
    names = {e.key: e.count for e in prof.key_averages()}
    assert names.get(cg.PLAN_SPAN) == 2  # the bound's plan (K = 1) and the sweep's (K = 4)
    assert names.get(cg.RELABEL_SPAN) == 4  # the operator and the start vector, the operator and the probes


@pytest.mark.cuda
def test_ldos_map_on_the_card_takes_the_gather_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape, order = (512, 64, 1), 256
    sites = [(200 + k, 30, 0) for k in range(16)]  # K = 64: eight column tiles of TK = 8
    host = systems.graphene_swave(shape, dtype=np.complex64, device="cpu")
    card = systems.graphene_swave(shape, dtype=np.complex64, device="cuda")
    want = host.ldos_map(sites, ENERGIES, method="kpm", order=order)
    layout = cg.plan_gather(card.skeleton, 64)
    assert layout is not None and layout.TK == 8 and layout.bwb == 64
    cg.reset_gather_counts()
    before = ck.launch_counts()
    got = card.ldos_map(sites, ENERGIES, method="kpm", order=order)
    launched = {k: v - before[k] for k, v in ck.launch_counts().items()}
    # the LDOS probes' light cone stays inside the ribbon: every step is the light-cone form
    assert launched["ell_gather_cheb_step_window"] == ce.sweep_launches(order) and launched["ell_gather_cheb_step"] == 0
    assert launched["ell_gather_spmm"] == 60
    assert launched["ell_cheb_step"] == 0 and launched["ell_spmm"] == 0 and launched["ell_cheb_moments"] == 0
    assert cg.gather_counts()["operator_relabels"] == 2
    assert np.allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=0)  # float32 sums in two orders
