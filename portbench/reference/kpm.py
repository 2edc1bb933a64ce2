"""Plain float64 kernel-polynomial (KPM) observables on a sparse operator.

The textbook method of Weisse et al., Rev. Mod. Phys. 78, 275 (2006): Chebyshev
moments mu_m = Re <v| T_m(H/a) |v> by the three-term recursion, two moments a
product through T_2m = 2 T_m^2 - 1 and T_2m+1 = 2 T_m+1 T_m - T_1 (Sec. II-D),
Jackson damping, and the density series. The bound a is 1.05 times the last norm of
60 normalised power iterations from a complex normal start vector drawn with
``numpy.random.default_rng(0)``, the bound that defines the KPM observables of
bodge's KPM calls. Everything is complex128 or float64, on whatever device the
operator lives; nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

POWER_ITERATIONS = 60
MARGIN = 1.05


def spectral_bound(apply, n_sites: int, device) -> float:
    """1.05 x the power-iteration estimate of ||H|| for the product ``apply``."""
    rng = np.random.default_rng(0)
    shape = (n_sites, 4, 1)
    v = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape), device=device)
    v = v.reshape(-1, 1)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(POWER_ITERATIONS):
        w = apply(v)
        norm = torch.linalg.vector_norm(w)
        v = w / norm
    return float(norm) * MARGIN


def jackson(order: int) -> np.ndarray:
    m = np.arange(order)
    M = order + 1
    return ((M - m) * np.cos(np.pi * m / M) + np.sin(np.pi * m / M) / np.tan(np.pi / M)) / M


def chebyshev_series(fn, order: int) -> np.ndarray:
    """Coefficients c_m of fn on [-1, 1] by Gauss-Chebyshev quadrature on
    max(2 order, 256) nodes (c_0 halved, so fn = sum_m c_m T_m)."""
    Q = max(2 * order, 256)
    theta = np.pi * (np.arange(Q) + 0.5) / Q
    c = 2.0 / Q * np.cos(np.outer(np.arange(order), theta)) @ fn(np.cos(theta))
    c[0] /= 2.0
    return c


def column_dots(a, b):
    """Re <a_k, b_k> for every column k of ``[rows, K]`` tensors."""
    return torch.mm(a.mH, b).diagonal().real


def moments(A, v0, a: float, order: int):
    """``[order, K]`` float64 moments of H = A / a against the columns of ``v0``."""
    inv = 1.0 / a
    t_prev, t_cur = v0, torch.mm(A, v0) * inv
    mu0, mu1 = column_dots(v0, v0), column_dots(v0, t_cur)
    rows = [mu0, mu1]
    while len(rows) < order:
        t_next = torch.addmm(t_prev, A, t_cur, beta=-1.0, alpha=2.0 * inv)
        rows.append(2.0 * column_dots(t_cur, t_cur) - mu0)
        rows.append(2.0 * column_dots(t_next, t_cur) - mu1)
        t_prev, t_cur = t_cur, t_next
    return torch.stack(rows[:order]).cpu().numpy()


def density(mu: np.ndarray, energies, a: float) -> np.ndarray:
    """``[n_energies, K]`` Jackson-damped densities from moments ``[order, K]``."""
    order = mu.shape[0]
    x = np.clip(np.asarray(energies, float) / a, -0.999999, 0.999999)
    m = np.arange(order)
    T = np.cos(m[None, :] * np.arccos(x)[:, None])
    weights = np.where(m == 0, 1.0, 2.0) * jackson(order)
    return (T @ (weights[:, None] * mu)) / (np.pi * a * np.sqrt(1.0 - x[:, None] ** 2))


def ldos(A, n_sites: int, sites, energies, order: int, a: float, columns: int = 64) -> np.ndarray:
    """Electron LDOS ``[len(sites), n_energies]``: the spin-up and spin-down
    electron orbitals of each site probed by unit vectors, ``columns`` at a time."""
    sites = np.asarray(sites)
    probes = [(s, o) for s in sites for o in range(4)]
    dens = []
    for lo in range(0, len(probes), columns):
        chunk = probes[lo:lo + columns]
        v0 = torch.zeros(4 * n_sites, len(chunk), dtype=torch.complex128, device=A.device)
        for k, (s, o) in enumerate(chunk):
            v0[4 * int(s) + o, k] = 1.0
        dens.append(density(moments(A, v0, a, order), energies, a))
    dens = np.concatenate(dens, axis=1).reshape(len(energies), len(sites), 4)
    return (dens[:, :, 0] + dens[:, :, 1]).T


def free_energy_and_slope(A, add_field, x: float, z, a: float, coeffs: np.ndarray, n_sites: int, V: float,
                          stored=None):
    """F_total(x) = 1/2 (4N/K) sum_m c_m sum_k mu_m[k] + N x^2 / V for the operator
    H(x) = A + x P (``add_field(y, v, c)`` adds c P v to y) and unit probe columns
    ``z``, with its derivative in x carried along the recursion (forward mode): the
    vectors t_m and their derivatives dt_m ride one product as ``[t_m | dt_m]``.
    Returns (F, dF/dx). ``stored(x)`` is the amplitude the operator holds, where a
    storage rounds it."""
    inv = 1.0 / a
    xs = x if stored is None else stored(x)
    K = z.shape[1]

    def step(T, T_prev, alpha):
        """alpha [H t | H dt + P t] - [t_prev | dt_prev] for T = [t | dt]."""
        Y = alpha * torch.mm(A, T) if T_prev is None else torch.addmm(T_prev, A, T, beta=-1.0, alpha=alpha)
        add_field(Y, T, alpha * xs)
        add_field(Y[:, K:], T[:, :K], alpha)
        return Y

    def traces(U, W):  # Re sum_k <u_k, w_k> for the four pairs of halves: tt, t dt, dt t
        G = torch.mm(U.mH, W)
        return [float(torch.diagonal(G[i:i + K, j:j + K]).sum().real) for i, j in ((0, 0), (0, K), (K, 0))]

    order = len(coeffs)
    T0 = torch.cat([z, torch.zeros_like(z)], dim=1)
    T1 = step(T0, None, inv)
    mu0 = traces(T0, T0)[0]
    mu1, dmu1, _ = traces(T0, T1)
    F, dF = coeffs[0] * mu0 + coeffs[1] * mu1, coeffs[1] * dmu1
    m = 2
    while m < order:
        T2 = step(T1, T0, 2.0 * inv)
        tt, tdt, _ = traces(T1, T1)
        F += coeffs[m] * (2.0 * tt - mu0)
        dF += coeffs[m] * 4.0 * tdt
        if m + 1 < order:
            t2t1, t2dt1, dt2t1 = traces(T2, T1)
            F += coeffs[m + 1] * (2.0 * t2t1 - mu1)
            dF += coeffs[m + 1] * (2.0 * (dt2t1 + t2dt1) - dmu1)
        T0, T1 = T1, T2
        m += 2
    scale = 0.5 * 4 * n_sites / K
    return F * scale + n_sites * x * x / V, dF * scale + 2.0 * n_sites * x / V
