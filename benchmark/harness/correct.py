"""The comparison that decides ``correct``: what the window's stages
produced (``harness/capture.py``) against the plain reference
(``reference/``), worked out again from the same inputs once the window
has closed. Each key of the configuration's ``limits`` names a check,
``checks/<number>.py``, whose ``value(items, config)`` gives the number
from its stage's sample; the key's value is its limit.

The reference follows the program from the program's own state: the
inputs each sampled call was given (its map, matches, window).

A number with nothing to compare in a run is None and is not judged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_np(x):
    """A tensor as a NumPy array on the host; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def words(x):
    """Descriptor rows as unsigned 32-bit words."""
    return np.ascontiguousarray(to_np(x)).view(np.uint32)


def intrinsics(cam: Dict):
    return tuple(float(cam[k]) for k in ("fx", "fy", "cx", "cy"))


def compare(stash, checks: Dict, config: Dict) -> Dict:
    """{number: value or None}, each from its stage's sample."""
    return {name: chk.value(stash.items(chk.STAGE), config)
            for name, chk in checks.items()}


def info(stash, checks: Dict) -> Dict:
    """What the checks that give ``info(items)`` say of their samples."""
    out = {}
    for chk in checks.values():
        if hasattr(chk, "info"):
            out.update(chk.info(stash.items(chk.STAGE)))
    return out


def judge(values: Dict, limits: Dict):
    """(correct, {name: {"value", "limit"}}): every number with a value
    within its limit, and at least one number compared."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in values.items()}
    judged = [c for c in checks.values() if c["value"] is not None]
    ok = bool(judged) and all(c["value"] <= c["limit"] for c in judged)
    return ok, checks
