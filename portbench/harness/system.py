"""Build a configuration's system with the program under test.

A configuration names a recipe of ``bodge_tpu_torch.models.systems`` (``system``),
the lattice ``shape``, the recipe's scalar parameters (``params``) and the storage
``dtype``. A ``profile`` parameter, ``{"kind": "tanh", "axis": a, "center": c,
"width": w}``, becomes the callable A(m) = tanh((m_a - c) / w) of the bond midpoint.
"""

from __future__ import annotations

import numpy as np


def profile(spec: dict):
    if spec["kind"] != "tanh":
        raise ValueError(f"unknown profile kind {spec['kind']!r}")
    axis, center, width = spec["axis"], spec["center"], spec["width"]
    return lambda mid: np.tanh((mid[:, axis] - center) / width)


def build(config: dict, device):
    """The configuration's ``Hamiltonian``, assembled on ``device``."""
    from bodge_tpu_torch.models import systems

    recipe = getattr(systems, config["system"])
    params = dict(config.get("params", {}))
    if "profile" in params:
        params["profile"] = profile(params["profile"])
    return recipe(tuple(config["shape"]), **params, dtype=np.dtype(config["dtype"]), device=device)
