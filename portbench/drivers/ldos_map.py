"""Driver of ``Hamiltonian.ldos_map(sites, energies, method="kpm")``.

Each call maps the LDOS of a row of consecutive sites along the mix's axis. Where
the configuration names a ``feature`` (a domain wall) on that axis, the row is
centred on it; otherwise its start is drawn. Its other coordinates are drawn too,
each at least ``margin`` (a share of the lattice's extent) from the edges. The draws
come from the seed, call by call. No ``scale=`` is given, so every call runs the
program's own spectral bound.

The check: once the window has closed, calls drawn from the seed are recomputed by
the float64 reference (as many as ``check.budget`` site-column-steps allow, at most
``check.max_calls``), and ``ldos_gap`` is the widest gap between the program's LDOS
and the reference's, over all their sites and energies, as a share of the
reference's largest value.

``options`` go to every call; the harness gives none (the control of
``portbench/calibrate.py`` gives ``operator_dtype="bf16"``).
"""

from __future__ import annotations

import numpy as np
import torch


def row_sites(rng, shape, mix: dict, config: dict) -> list:
    """The coordinates of one call's row of sites."""
    axis, length = mix["row"]["axis"], mix["row"]["length"]
    feature = config.get("feature")
    start = []
    for a, n in enumerate(shape):
        edge = int(mix["row"]["margin"] * n)
        if a == axis and feature is not None and feature["axis"] == axis:
            start.append(int(feature["at"]) - length // 2)
        elif a == axis:
            start.append(int(rng.integers(edge, n - edge - length + 1)))
        else:
            start.append(int(rng.integers(edge, n - edge)))
    sites = []
    for k in range(length):
        c = list(start)
        c[axis] += k
        sites.append(tuple(c))
    return sites


def flat(shape, sites) -> list:
    return [int(np.ravel_multi_index(s, shape)) for s in sites]


class Driver:
    def __init__(self, system, config: dict, mix: dict, seed: int, **options):
        self.system, self.config, self.mix, self.options = system, config, mix, options
        self.shape = tuple(config["shape"])
        streams = np.random.SeedSequence(seed).spawn(3)
        self.rng = np.random.default_rng(streams[0])
        self.warm_rng = np.random.default_rng(streams[1])
        self.check_rng = np.random.default_rng(streams[2])
        e = mix["energies"]
        self.energies = np.linspace(e["min"], e["max"], e["count"])

    def _call(self, sites):
        return self.system.ldos_map(sites, self.energies, method="kpm", order=self.mix["order"],
                                    kernel=self.mix["kernel"], **self.options)

    def warm_up(self):
        self._call(row_sites(self.warm_rng, self.shape, self.mix, self.config))

    def call(self, i: int):
        sites = row_sites(self.rng, self.shape, self.mix, self.config)
        out = self._call(sites)
        columns = [s for s in flat(self.shape, sites) for _orbital in range(4)]
        work = [{"kind": "moments", "order": self.mix["order"], "K": len(columns), "sites": columns}]
        return 1, work, (sites, out)

    def release(self):
        self.system = None

    def compare(self, calls, device) -> dict:
        from portbench.reference import bdg, kpm

        done = [c for c in calls if c.output is not None]
        if not done:
            return {"ldos_gap": float("inf")}
        n_sites = int(np.prod(self.shape))
        check = self.mix["check"]
        per_call = n_sites * 4 * len(done[0].output[0]) * self.mix["order"]
        count = int(min(len(done), check["max_calls"], max(1, check["budget"] // per_call)))
        picks = sorted(self.check_rng.choice(len(done), size=count, replace=False))
        A = bdg.csr(self.config, device)
        a = kpm.spectral_bound(lambda v: torch.mm(A, v), n_sites, device)
        gap = 0.0
        for p in picks:
            sites, out = done[p].output
            ref = kpm.ldos(A, n_sites, flat(self.shape, sites), self.energies, self.mix["order"], a)
            gap = max(gap, float(np.max(np.abs(out - ref)) / np.max(np.abs(ref))))
        return {"ldos_gap": gap}
