"""Driver of ``Hamiltonian.free_energy(temperature, method="kpm", order, samples)``.

A closed loop of free-energy evaluations, as in a parameter sweep of F: call i
passes ``seed`` drawn from the run's seed, so each call draws new Rademacher
probes (``samples`` columns of +-1 over every orbital). No ``scale=`` is given,
so every call runs the program's own spectral bound.

The check: once the window has closed, the float64 reference recomputes F of the
first call and of ``check.calls`` more drawn from the seed, with the same probes,
drawn by the program's documented rule from the call's seed
(``numpy.random.default_rng(seed)``, ``2 * integers(0, 2, size=(N, 4, samples)) - 1``),
and F = 1/2 Tr G(H) with G(E) = -|E|/2 - T log(1 + exp(-|E|/T)): Chebyshev
coefficients of G on the reference's own bound, Jackson damping, the moments of
the probes, the trace estimate over the ``samples`` columns. ``F_gap`` is the
widest gap between a call's F and the reference's, as a share of the reference's.

``options`` go to every call; the harness gives none (the control of
``portbench/calibrate_storage.py`` gives ``operator_dtype="bf16"``).
"""

from __future__ import annotations

import numpy as np
import torch


def probes(n_sites: int, samples: int, seed: int) -> np.ndarray:
    """``[n_sites, 4, samples]`` +-1 columns, drawn as the program draws them from ``seed``."""
    rng = np.random.default_rng(int(seed))
    return 2.0 * rng.integers(0, 2, size=(n_sites, 4, samples)) - 1.0


class Driver:
    def __init__(self, system, config: dict, mix: dict, seed: int, **options):
        self.system, self.config, self.mix, self.options = system, config, mix, options
        self.n = int(np.prod(config["shape"]))
        streams = np.random.SeedSequence(seed).spawn(3)
        self.rng = np.random.default_rng(streams[0])
        self.warm_rng = np.random.default_rng(streams[1])
        self.check_rng = np.random.default_rng(streams[2])

    def _call(self, probe_seed: int) -> float:
        return float(self.system.free_energy(self.mix["temperature"], method="kpm", order=self.mix["order"],
                                             samples=self.mix["samples"], seed=probe_seed, **self.options))

    def warm_up(self):
        self._call(int(self.warm_rng.integers(2**62)))

    def call(self, i: int):
        probe_seed = int(self.rng.integers(2**62))
        F = self._call(probe_seed)
        work = [{"kind": "moments", "order": self.mix["order"], "K": self.mix["samples"]}]
        return 1, work, (probe_seed, F)

    def release(self):
        self.system = None

    def reference(self, device):
        """``F_of(seed)``: the float64 reference's F for the probes of ``seed``."""
        from portbench.reference import bdg, kpm

        n, order, T = self.n, self.mix["order"], self.mix["temperature"]
        A = bdg.csr(self.config, device)
        a = kpm.spectral_bound(lambda v: torch.mm(A, v), n, device)
        if T == 0:
            g = lambda x: -np.abs(a * x) / 2
        else:
            g = lambda x: -np.abs(a * x) / 2 - T * np.log1p(np.exp(-np.abs(a * x) / T))
        coeffs = kpm.chebyshev_series(g, order) * kpm.jackson(order)

        def F_of(seed: int) -> float:
            z = torch.as_tensor(probes(n, self.mix["samples"], seed), device=device).to(torch.complex128)
            mu = kpm.moments(A, z.reshape(4 * n, -1), a, order)  # [order, samples]
            return 0.5 * float(coeffs @ mu.sum(axis=1)) / self.mix["samples"]

        return F_of

    def compare(self, calls, device) -> dict:
        done = [i for i, c in enumerate(calls) if c.output is not None]
        if not done or done[0] != 0:
            return {"F_gap": float("inf")}
        others = done[1:]
        picks = [0] + sorted(self.check_rng.choice(others, size=min(len(others), self.mix["check"]["calls"]),
                                                   replace=False).tolist() if others else [])
        F_of = self.reference(device)
        gap = 0.0
        for p in picks:
            seed, F = calls[p].output
            F_ref = F_of(seed)
            gap = max(gap, abs(F - F_ref) / abs(F_ref))
        return {"F_gap": float(gap)}
