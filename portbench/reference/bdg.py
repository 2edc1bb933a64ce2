"""Plain float64 Bogoliubov-de Gennes operators, built from a configuration file.

A site carries the basis {e-up, e-down, h-up, h-down}. Following the convention of
bodge (Ouassou et al., PRB 109, 174506, Sec. II), the 4x4 block of a site pair is

    on site i:       [[h_ii, D_ii], [D_ii^+, -h_ii^*]]
    bond i -> j:     [[h_ij, D_ij], [D_ji^+, -h_ij^*]]

where h is the electron 2x2 term and D the pairing 2x2 term. The lattice is a box
of shape (Lx, Ly, Lz) with open boundaries, sites numbered x-major with z fastest
(index = z + y*Lz + x*Ly*Lz), and bonds between nearest neighbours only.

The 2x2 terms of a model live in ``reference/systems/<system>.py`` and are found by
the configuration's ``system`` name. Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib.util
import warnings
from pathlib import Path

import numpy as np
import torch

SYSTEMS = Path(__file__).resolve().parent / "systems"
DIRECTIONS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def model(name: str):
    """The module of 2x2 terms for the system ``name``."""
    path = SYSTEMS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no plain reference for system {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(f"portbench_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def coords(shape) -> np.ndarray:
    """``[N, 3]`` integer coordinates in site order."""
    x, y, z = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)


def _nambu(h, d, d_rev):
    """4x4 blocks ``[[h, d], [d_rev^+, -h^*]]`` from 2x2 terms ``[B, 2, 2]``."""
    b = np.zeros((len(h), 4, 4), np.complex128)
    b[:, :2, :2] = h
    b[:, 2:, 2:] = -np.conj(h)
    if d is not None:
        b[:, :2, 2:] = d
        b[:, 2:, :2] = np.conj(np.swapaxes(d_rev, -1, -2))
    return b


def blocks(config: dict, overrides: dict | None = None):
    """The operator as ``[(offset, rows, blocks)]``: for the on-site term and each
    direction with bonds, the site indices ``rows`` that have the term, the flat
    index offset of the partner site, and the 4x4 blocks ``[B, 4, 4]``."""
    params = {**config.get("params", {}), **(overrides or {})}
    terms = model(config["system"])
    shape = tuple(config["shape"])
    c = coords(shape)
    N = len(c)
    out = []
    h = np.broadcast_to(terms.onsite(c, params), (N, 2, 2))
    d = terms.pairing_onsite(c, params)
    d = None if d is None else np.broadcast_to(d, (N, 2, 2))
    out.append((0, np.arange(N), _nambu(h, d, d)))
    strides = np.array([shape[1] * shape[2], shape[2], 1])
    for step in DIRECTIONS:
        step = np.array(step)
        inside = np.all((c + step >= 0) & (c + step < np.array(shape)), axis=1)
        if not inside.any():
            continue
        rows = np.nonzero(inside)[0]
        ci, cj = c[rows], c[rows] + step
        hop = np.broadcast_to(terms.hopping(ci, cj, params), (len(rows), 2, 2))
        pair = terms.pairing(ci, cj, params)
        pair_rev = terms.pairing(cj, ci, params)
        out.append((int(step @ strides), rows, _nambu(hop, pair, pair_rev)))
    return out


def nonzeros_per_site(config: dict) -> np.ndarray:
    """``[N]``: nonzero complex entries in each site's four rows of the operator."""
    N = int(np.prod(config["shape"]))
    count = np.zeros(N, np.int64)
    for _offset, rows, b in blocks(config):
        np.add.at(count, rows, np.count_nonzero(b, axis=(1, 2)))
    return count


def csr(config: dict, device, overrides: dict | None = None) -> torch.Tensor:
    """The 4N x 4N operator as a complex128 sparse CSR tensor on ``device``,
    holding the nonzero entries only."""
    N = int(np.prod(config["shape"]))
    rows, cols, vals = [], [], []
    orb = torch.arange(4, device=device)
    for offset, r, b in blocks(config, overrides):
        b = torch.as_tensor(b, device=device)
        r = torch.as_tensor(r, device=device)
        i = (4 * r[:, None, None] + orb[None, :, None]).expand(b.shape)
        j = (4 * (r + offset)[:, None, None] + orb[None, None, :]).expand(b.shape)
        keep = b != 0
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(b[keep])
    index = torch.stack([torch.cat(rows), torch.cat(cols)])
    with warnings.catch_warnings():  # torch calls its sparse layouts beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(index, torch.cat(vals), (4 * N, 4 * N), check_invariants=False)
        return a.coalesce().to_sparse_csr()


def add_onsite_singlet(y: torch.Tensor, v: torch.Tensor, c: float) -> torch.Tensor:
    """``y += c P v`` in place for the on-site singlet field of unit amplitude,
    P = [[0, j s2], [j s2^+, 0]] on every site, with ``y`` and ``v`` (or column
    slices of them) in the ``[4N, K]`` layout. Returns ``y``."""
    w, u = y.unflatten(0, (-1, 4)), v.unflatten(0, (-1, 4))
    w[:, 0].add_(u[:, 3], alpha=c)
    w[:, 1].sub_(u[:, 2], alpha=c)
    w[:, 2].sub_(u[:, 1], alpha=c)
    w[:, 3].add_(u[:, 0], alpha=c)
    return y
