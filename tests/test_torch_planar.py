"""PyTorch port, the planar entry points (``bodge_tpu_torch.ops.planar``) and
the dispatch names of the seventh slice: the planar functions against
``bodge_tpu.ops.planar`` on the CPU (float32 planes: 2e-6 of the largest entry
for products and moments — sums of up to 28 float32 terms in another order —
and 1e-5 for float32 eigenvalues), the planar entry points on
``device_operator()`` bit for bit against the façade's complex calls on a
complex64 operator, ``device_operator``'s cache,
``default_impl`` / ``use_planar_device_path`` under ``BODGE_PLANAR``,
``device_pauli``, and the packed inserts against the reference's
``plane_packed_insert_*`` (values, and the moments of the inserted operator)
and against the field writes the sharded objective made before them (value
and gradient bit for bit).  No Pallas call: the reference's planar path and
its packing are plain ``jnp``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu import common as jcommon
from bodge_tpu.models import selfconsistency as jsc
from bodge_tpu.models import systems as jsys
from bodge_tpu.ops import pallas_spmm as jpk
from bodge_tpu.ops import planar as jpl
from bodge_tpu_torch import common as tcommon
from bodge_tpu_torch.models import selfconsistency as tsc
from bodge_tpu_torch.models import systems as tsys
from bodge_tpu_torch.ops import blocksparse as tbs
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.ops import cuda_ell as ce
from bodge_tpu_torch.ops import planar as tpl
from bodge_tpu_torch.parallel import RowSharding, free_energy_kpm_sharded, make_row_mesh
from tests.test_torch_gather import build_ring
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SHAPE = (6, 5, 1)
ENERGIES = np.linspace(-1.5, 1.5, 7)


def _close(ours, theirs, rel):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert np.abs(ours - theirs).max() <= rel * np.abs(theirs).max()


def _bits(t):
    t = torch.as_tensor(t)
    return torch.view_as_real(t).view(torch.int32 if t.dtype == torch.complex64 else torch.int64)


@pytest.fixture(scope="module")
def swave():
    """The reference's 6×5 s-wave system with a Zeeman split (complex128 host
    data), both skeletons, and the planar forms of both packages."""
    sj = jsys.swave_superconductor(SHAPE, zeeman=np.array([0.0, 0.0, 0.15]))
    d = np.array(sj.host_data())  # a writable copy
    return d, sj.skeleton, tbs.skeleton(SHAPE), tpl.to_planar(d, device="cpu"), jpl.to_planar(d)


def test_converters_and_products_match_reference(swave, monkeypatch):
    d, sk_j, sk_t, dp, dp_j = swave
    assert dp.dtype == torch.float32 and tuple(dp.shape) == (2, *d.shape)
    # NumPy input goes to the card unless the CPU is asked for; tensors stay put.
    assert torch.equal(tpl.from_planar(dp.numpy(), device="cpu"), tpl.from_planar(dp))
    assert torch.equal(tpl.to_planar(torch.ones(3)), torch.stack((torch.ones(3), torch.zeros(3))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for convert, arg in ((tpl.to_planar, d), (tpl.from_planar, dp.numpy())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert(arg)
    monkeypatch.undo()
    assert np.array_equal(dp.numpy(), np.asarray(dp_j))  # the same float32 rounding
    assert np.array_equal(tpl.from_planar(dp).numpy(), np.asarray(jpl.from_planar(dp_j)))
    assert tpl.is_planar(dp) and not tpl.is_planar(torch.as_tensor(d)) and not tpl.is_planar(ce.bf16_operator(
        torch.as_tensor(d[:2])))  # a two-row bf16 form is not planar
    vp = np.random.default_rng(1).standard_normal((2, sk_t.n_sites, 4, 3)).astype(np.float32)
    y = tpl.spmm_planar_stencil(dp, sk_t, torch.as_tensor(vp))
    _close(y, jpl.spmm_planar_stencil(dp_j, sk_j, jnp.asarray(vp)), 2e-6)
    assert torch.equal(y, tpl.spmm_planar(dp, sk_t, torch.as_tensor(vp)))

    ring_t, ring_j = build_ring(T, 12, device="cpu"), build_ring(J, 12)
    rp = np.random.default_rng(2).standard_normal((2, 12, 4, 2)).astype(np.float32)
    yr = tpl.spmm_planar_gather(tpl.to_planar(ring_t.data), ring_t.skeleton, torch.as_tensor(rp))
    _close(yr, jpl.spmm_planar_gather(jpl.to_planar(np.asarray(ring_j.host_data())), ring_j.skeleton, rp), 2e-6)
    with pytest.raises(ValueError, match="stencil"):
        tpl.spmm_planar_stencil(tpl.to_planar(ring_t.data), ring_t.skeleton, torch.as_tensor(rp))


def test_moments_trace_bound_and_hermiticity_match_reference(swave):
    d, sk_j, sk_t, dp, dp_j = swave
    order, inv = 16, 0.15
    vp = np.random.default_rng(3).standard_normal((2, sk_t.n_sites, 4, 2)).astype(np.float32)
    mu = tpl.moments_planar(dp, sk_t, torch.as_tensor(vp), inv, order)
    mu_j = np.asarray(jpl.moments_planar(dp_j, sk_j, jnp.asarray(vp), jnp.float32(inv), order))
    _close(mu, mu_j, 2e-6)
    # The reference's trace_fn_planar is Σ_m c_m Σ_k of these moments (its own
    # scan, compiled again); held here against that sum of its moments.
    coeffs = np.linspace(1.0, -0.5, order).astype(np.float32)
    est = tpl.trace_fn_planar(dp, sk_t, torch.as_tensor(vp), coeffs, inv, order)
    assert abs(float(est) - coeffs @ mu_j.sum(axis=1)) <= 2e-6 * np.abs(mu_j).sum(axis=1).max() * np.abs(coeffs).sum()
    # The bound is the complex call's on the complex form (that one is held
    # against the reference's to 3 % in test_torch_chebyshev.py).
    assert tpl.spectral_bound_planar(dp, sk_t) == tkpm.spectral_bound(tpl.from_planar(dp), sk_t)

    broken = dp.clone()
    broken[0, 3, 1, 0, 1] += 0.5
    for op in (dp, broken):
        ours = float(tpl.hermiticity_error_planar(op, sk_t))
        assert abs(ours - float(jpl.hermiticity_error_planar(jnp.asarray(op.numpy()), sk_j))) <= 1e-6
    assert ours > 0.4


def test_dense_spectra_match_reference(swave):
    """``eigvalsh_planar`` / ``eigh_planar`` (complex eigh here, the real
    embedding in the reference): the same d eigenvalues to 1e-5 and the same
    eigenspaces, compared by the projector onto each multiplet at the gap."""
    d, sk_j, sk_t, dp, dp_j = swave
    A = tpl.dense_embedding(dp, sk_t)
    assert np.array_equal(A.numpy(), np.asarray(jpl.dense_embedding(dp_j, sk_j)))
    E_v = tpl.eigvalsh_planar(dp, sk_t)
    _close(E_v, jpl.eigvalsh_planar(dp_j, sk_j), 1e-5)
    E, X = tpl.eigh_planar(dp, sk_t)
    E_j, X_j = jpl.eigh_planar(dp_j, sk_j)
    assert E.shape == (sk_t.matrix_dim,) and X.dtype == torch.complex64
    _close(E, E_j, 1e-5)
    _close(E, E_v, 1e-5)
    E64 = E.double().numpy()
    for level in np.unique(np.round(E64[np.abs(E64) < 0.5], 4)):  # the multiplets nearest the gap
        pick = np.abs(E64 - level) < 1e-3
        proj = lambda Y: Y[:, pick] @ Y[:, pick].conj().T
        assert np.abs(proj(X.numpy()) - proj(np.asarray(X_j))).max() < 1e-4


def test_planar_calls_bit_equal_to_complex_calls(monkeypatch):
    """Under ``BODGE_PLANAR=1`` the planar entry points on ``device_operator()``
    (the planar form) give the façade's complex calls' results bit for bit on a
    complex64 operator, and the façade's own calls do not change with the flag;
    a planar operator handed to the sharded free energy likewise."""
    system = tsys.swave_superconductor(SHAPE, zeeman=np.array([0.0, 0.0, 0.15]), dtype=np.complex64,
                                           device="cpu")
    sk = system.skeleton
    v = np.random.default_rng(4).standard_normal((sk.n_sites, 4, 3)).astype(np.complex64)
    kw = dict(method="kpm", order=32, scale=5.0)
    sites = [(1, 1, 0), (3, 2, 0)]
    facade = {
        "free_energy": lambda: system.free_energy(0.1, method="kpm", order=32, samples=4),
        "ldos": lambda: system.ldos((2, 2, 0), ENERGIES, **kw),
        "ldos_map": lambda: system.ldos_map(sites, ENERGIES, **kw),
        "dos": lambda: system.dos(ENERGIES, order=32, samples=4, scale=5.0),
        "apply": lambda: system.apply(v),
        "eigenvalues": lambda: system.eigenvalues(),
        "diagonalize": lambda: system.diagonalize(format="raw")[0],
    }
    positive = lambda E: E[sk.matrix_dim // 2:].numpy()  # the façade's spectra: E > 0
    planar = {
        "free_energy": lambda op: tkpm.free_energy_kpm(op, sk, 0.1, order=32, samples=4),
        "ldos": lambda op: tkpm.ldos_kpm(op, sk, system.lattice[(2, 2, 0)], ENERGIES, order=32, scale=5.0),
        "ldos_map": lambda op: tkpm.ldos_kpm_sites(op, sk, [system.lattice[s] for s in sites], ENERGIES,
                                                   order=32, scale=5.0),
        "dos": lambda op: tkpm.dos_kpm(op, sk, ENERGIES, order=32, samples=4, scale=5.0),
        "apply": lambda op: tpl.from_planar(tpl.spmm_planar(op, sk, tpl.to_planar(v, device="cpu"))),
        "eigenvalues": lambda op: positive(tpl.eigvalsh_planar(op, sk)),
        "diagonalize": lambda op: positive(tpl.eigh_planar(op, sk)[0]),
    }

    def run(calls, *args):
        system._eigh_cache = None
        return {name: fn(*args) for name, fn in calls.items()}

    def same(got, want, name):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want)), name
        else:
            assert np.array_equal(np.asarray(got), np.asarray(want)), name

    complex_out = run(facade)
    monkeypatch.setenv("BODGE_PLANAR", "1")
    op = system.device_operator()
    assert tpl.is_planar(op)
    for outputs in (run(planar, op), run(facade)):
        for name, want in complex_out.items():
            same(outputs[name], want, name)
    rs = RowSharding(sk, make_row_mesh(devices="cpu"))
    assert free_energy_kpm_sharded(rs, op, 0.1, 5.0, order=32, samples=4) == \
        free_energy_kpm_sharded(rs, system.data, 0.1, 5.0, order=32, samples=4)
    assert torch.equal(system.matrix("dense_jnp"), system.matrix("dense_torch"))


def test_device_operator_cached_per_version_and_kind(monkeypatch):
    system = tsys.swave_superconductor((4, 3, 1), device="cpu")
    assert system.device_operator() is system.data  # the complex operator itself
    monkeypatch.setenv("BODGE_PLANAR", "1")
    op = system.device_operator()
    assert tpl.is_planar(op) and system.device_operator() is op
    assert torch.equal(tpl.from_planar(op, np.complex128), system.data.to(torch.complex64).to(torch.complex128))
    system.assemble(onsite=lambda ci: -0.2 * T.σ0)  # a new version
    again = system.device_operator()
    assert again is not op and torch.equal(again, tpl.to_planar(system.data))
    monkeypatch.setenv("BODGE_PLANAR", "0")
    assert system.device_operator() is system.data


def test_default_impl_and_planar_flag(monkeypatch):
    for flag in (None, "0", "1"):
        if flag is None:
            monkeypatch.delenv("BODGE_PLANAR", raising=False)
        else:
            monkeypatch.setenv("BODGE_PLANAR", flag)
        planar = flag == "1"
        assert tpl.use_planar_device_path() is planar
        assert tkpm.default_impl() == ("planar" if planar else "auto")
        assert tkpm._resolve_impl(None) == tkpm._resolve_impl("auto") == tkpm.default_impl()
        assert tkpm._resolve_impl("plain") == "plain"


def test_device_pauli_matches_reference():
    ours = tcommon.device_pauli(device="cpu")
    assert ours.dtype == torch.complex128 and ours.shape == (4, 2, 2)  # the CPU's default complex dtype
    assert np.array_equal(ours.numpy(), np.asarray(jcommon.device_pauli(np.complex128)))
    assert tcommon.device_pauli(np.complex64, "cpu").dtype == torch.complex64


def _unpack_planes(b, sk_j, dtype):
    """The reference's plane-packed operator ``[Lx, 2·S·16, P]`` → ``[N, S, 4, 4]`` complex."""
    Lx, Ly, Lz = sk_j.shape
    p = np.asarray(b).reshape(Lx, 2, sk_j.n_slots, 4, 4, -1)[..., : Ly * Lz]
    p = np.moveaxis(p, -1, 1)  # [Lx, M, 2, S, 4, 4]
    return (p[:, :, 0] + 1j * p[:, :, 1]).reshape(-1, sk_j.n_slots, 4, 4).astype(dtype)


@pytest.mark.parametrize("channel", ["swave", "dwave bond"])
def test_packed_inserts_match_reference(channel):
    """The inserts write what the reference's ``plane_packed_insert_*`` write
    into its packed float32 operator (all pairing positions, zeros included,
    partners from ``struct[trans_slot]†``), and the inserted operators give
    the same moments through the plain sweep.  On the bf16 form they write the
    bf16 rounding of those values, bit for bit — the rounding the reference's
    bf16 packing makes (``test_torch_bf16.py``)."""
    shape = (6, 4, 1)
    metal = jsys.swave_superconductor(shape, delta=0.0)
    sk_j, sk_t = metal.skeleton, tbs.skeleton(shape)
    host = np.asarray(metal.host_data())
    field = (0.3 + 0.05 * np.random.default_rng(5).standard_normal(sk_t.n_sites)).astype(np.float32)
    lo = jpk.plane_layout(sk_j, 4)
    struct = tsc.bond_structure_dwave(sk_t)
    b = jpk.pack_operator(host, sk_j, layout=lo)
    base = torch.as_tensor(host.astype(np.complex64))
    if channel == "swave":
        theirs = jpk.plane_packed_insert_swave(b, jnp.asarray(field), sk_j)
        insert = lambda form: ce.plane_packed_insert_swave(form, torch.as_tensor(field), sk_t)
    else:
        m = np.asarray(jsc.bond_field(jnp.asarray(field), sk_j, struct)).astype(np.float32)
        theirs = jpk.plane_packed_insert_bond(b, jnp.asarray(m), sk_j, struct)
        insert = lambda form: ce.plane_packed_insert_bond(form, torch.as_tensor(m), sk_t, struct)
    ours = insert(base)
    got, want = ours.numpy(), _unpack_planes(theirs, sk_j, np.complex64)
    assert ours.dtype == base.dtype and np.array_equal(got, want)
    in_bf16 = insert(ce.bf16_operator(base))
    assert in_bf16.dtype == torch.bfloat16 and torch.equal(in_bf16.view(torch.int16),
                                                           ce.bf16_operator(ours).view(torch.int16))
    probes = tkpm.rademacher_probes(sk_t.n_sites, 4, 3, np.complex128)
    mu = [tkpm.moments(torch.as_tensor(x.astype(np.complex128)), sk_t, probes, 16, 6.0).numpy()
          for x in (got, want)]
    _close(mu[0], mu[1], 1e-12)


def test_inserts_keep_the_sharded_objective_bit_equal():
    """The inserts the sharded objective now calls give the field writes it
    made before them (restated below) bit for bit, value and gradient, for a
    complex field on a shuffled subset of rows (a slab with its halo rows)."""
    shape = (6, 4, 1)
    sk = tbs.skeleton(shape)
    metal = tsys.swave_superconductor(shape, delta=0.0, device="cpu")
    rows = np.concatenate([np.arange(20, 24), np.arange(4, 20), np.arange(0, 4)])
    rng = np.random.default_rng(6)
    struct = tsc.bond_structure_dwave(sk)
    structH = np.conj(np.swapaxes(struct[sk.trans_slot], -1, -2))
    for cdt in (torch.complex64, torch.complex128):
        base = metal.data.to(cdt)[torch.as_tensor(rows)]
        weights = torch.as_tensor(rng.standard_normal((*base.shape, 2))).to(base.real.dtype)
        loss = lambda data: (torch.view_as_real(data) * weights).sum()

        def value_and_grad(write):
            x = torch.as_tensor(0.3 + 0.05 * rng.standard_normal(sk.n_sites)).to(base.real.dtype)
            x.requires_grad_(True)
            data = write(x.to(cdt))
            (g,) = torch.autograd.grad(loss(data), x)
            return data.detach(), g

        for new, old in (
            (lambda d: ce.plane_packed_insert_swave(base, d[torch.as_tensor(rows)], sk),
             lambda d: _swave_write(base, d[torch.as_tensor(rows)])),
            (lambda d: ce.plane_packed_insert_bond(base, tsc.bond_field(d, sk, struct, rows), sk, struct),
             lambda d: _bond_write(base, tsc.bond_field(d, sk, struct, rows).to(cdt), struct, structH)),
        ):
            state = rng.bit_generator.state
            data_new, g_new = value_and_grad(new)
            rng.bit_generator.state = state
            data_old, g_old = value_and_grad(old)
            assert torch.equal(_bits(data_new), _bits(data_old))
            assert torch.equal(g_new, g_old) and g_new.abs().max() > 0


def _swave_write(base, delta):
    """The sharded objective's on-site write before the inserts."""
    blk = (delta[:, None, None] * torch.as_tensor(np.asarray(T.jσ2)).to(dtype=base.dtype)).to(base.dtype)
    data = base.clone()
    data[:, 0, 0:2, 2:4] = blk
    data[:, 0, 2:4, 0:2] = blk.transpose(-1, -2).conj()
    return data


def _bond_write(base, m, struct, structH):
    """The sharded objective's bond write before the inserts."""
    like = lambda a: torch.as_tensor(np.asarray(a)).to(dtype=base.dtype)
    data = base.clone()
    data[:, :, 0:2, 2:4] = m[:, :, None, None] * like(struct)[None]
    data[:, :, 2:4, 0:2] = m[:, :, None, None] * like(structH)[None]
    return data
