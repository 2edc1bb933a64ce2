"""Driver of ``models.selfconsistency.solve_gap(method="kpm")`` on a uniform s-wave field.

A closed loop of gap solves as in a phase-diagram sweep: call i takes the coupling
``V = couplings[(start + i) mod len]`` and starts from the Delta the previous call
returned (the first from ``delta0``); ``start`` is drawn from the seed. Every call
hands over the same probes, ``probes`` Rademacher columns drawn from the seed,
scaled to unit length and stored as float32 in NumPy, so their upload stays in the
call; no ``scale=`` is given, so every call estimates its own spectral bound.

The check: once the window has closed, the float64 reference replays the first call
(its ``steps`` momentum steps from the same start, with its own forward-mode
derivative) and ``delta_gap`` is the gap between the program's returned Delta and
the replay's, as a share of the replay's; ``F_gap`` is the widest gap between a
call's returned F_total and the reference's F_total at that call's returned Delta,
over the first call and ``check.calls`` more drawn from the seed, as a share of the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch


class Driver:
    def __init__(self, system, config: dict, mix: dict, seed: int):
        self.system, self.config, self.mix = system, config, mix
        self.n = int(np.prod(config["shape"]))
        streams = np.random.SeedSequence(seed).spawn(3)
        rng = np.random.default_rng(streams[0])
        self.check_rng = np.random.default_rng(streams[2])
        self.couplings = np.round(np.arange(mix["coupling"]["min"], mix["coupling"]["max"] + 1e-9,
                                            mix["coupling"]["step"]), 10)
        self.start = int(rng.integers(len(self.couplings)))
        z = 2.0 * rng.integers(0, 2, size=(self.n, 4, mix["probes"]), dtype=np.int8) - 1.0
        self.probes = (z / np.sqrt(4 * self.n)).astype(np.float32)
        self.delta = mix["delta0"]

    def coupling(self, i: int) -> float:
        return float(self.couplings[(self.start + i) % len(self.couplings)])

    def _solve(self, V: float, delta0: float, steps: int):
        from bodge_tpu_torch.models.selfconsistency import solve_gap

        return solve_gap(self.system, V, temperature=0.0, method="kpm", order=self.mix["order"],
                         uniform=True, steps=steps, learning_rate=self.mix["rate"] / self.n,
                         delta0=delta0, probes=self.probes, delta_max=self.mix["delta_max"])

    def warm_up(self):
        self._solve(self.coupling(0), self.mix["delta0"], 2)

    def call(self, i: int):
        V, delta0 = self.coupling(i), self.delta
        delta, F = self._solve(V, delta0, self.mix["steps"])
        self.delta = float(delta[0].real)
        work = [{"kind": "gradient", "order": self.mix["order"], "K": self.mix["probes"],
                 "repeat": self.mix["steps"]},
                {"kind": "moments", "order": self.mix["order"], "K": self.mix["probes"]}]
        spread = float(np.max(np.abs(delta - delta[0])))
        return self.mix["steps"], work, (V, delta0, complex(delta[0]), spread, float(F))

    def release(self):
        self.system = None

    def reference(self, device, dtype=torch.complex128, storage=None):
        """``F_at(V, x) -> (F_total, dF/dx)`` of the plain reference, computed in
        ``dtype``; ``storage`` (a pair of functions) rounds the operator's entries
        and the field's amplitude as a lower-precision storage of H would."""
        from portbench.reference import bdg, kpm

        n, order = self.n, self.mix["order"]
        A = bdg.csr(self.config, device, overrides={"delta": 0.0})
        if storage is not None:
            A = storage[0](A)
        A = A.to(dtype)
        field = bdg.add_onsite_singlet
        headroom = self.mix["delta_max"]
        a = kpm.spectral_bound(lambda v: field(torch.mm(A, v.to(dtype)), v.to(dtype), headroom), n, device)
        coeffs = kpm.chebyshev_series(lambda x: -np.abs(a * x) / 2, order) * kpm.jackson(order)
        z = torch.as_tensor(self.probes, device=device).to(dtype).reshape(4 * n, -1)
        stored = None if storage is None else storage[1]
        return lambda V, x: kpm.free_energy_and_slope(A, field, x, z, a, coeffs, n, V, stored)

    def replay(self, F_at, V: float, delta0: float) -> float:
        """The Delta that ``steps`` momentum steps of the gap solve reach from ``delta0``."""
        x, m, rate = delta0, 0.0, self.mix["rate"] / self.n
        for _ in range(self.mix["steps"]):
            m = 0.9 * m + F_at(V, x)[1]
            x = x - rate * m
        return x

    def compare(self, calls, device) -> dict:
        done = [i for i, c in enumerate(calls) if c.output is not None]
        if not done or done[0] != 0:
            return {"delta_gap": float("inf"), "F_gap": float("inf")}
        F_at = self.reference(device)
        V, delta0, delta, spread, _F = calls[0].output
        x = self.replay(F_at, V, delta0)
        delta_gap = (abs(delta - x) + spread) / abs(x)

        others = done[1:]
        picks = [0] + sorted(self.check_rng.choice(others, size=min(len(others), self.mix["check"]["calls"]),
                                                   replace=False).tolist() if others else [])
        F_gap = 0.0
        for p in picks:
            V, _d0, delta, _s, F = calls[p].output
            F_ref = F_at(V, delta.real)[0]
            F_gap = max(F_gap, abs(F - F_ref) / abs(F_ref))
        return {"delta_gap": float(delta_gap), "F_gap": float(F_gap)}
