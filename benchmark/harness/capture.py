"""What the comparison keeps from the window: for each stage that a check
names (``checks/<number>.py``), a sample of the stage's calls, drawn
from the seed, taken at the names the program's callers look up.

A check gives its stage's key (``STAGE``), the sample's size per run
(``SAMPLE``), the sites (``SITES``: (module, attribute) pairs) and
``keep(args, kwargs, result) -> item or list of items``. A driver adds
sites of its own to a stage (its ``SITES``: {stage: [(module,
attribute), ...]}), for a path that binds a stage's function into its
own namespace. Checks that name one stage share its sample.
"""

from __future__ import annotations

from typing import Dict

from harness.stash import Stash


def bind(names, defaults, args, kwargs):
    """A call's arguments by name, its defaults filled in."""
    out = dict(defaults)
    out.update(zip(names, args))
    out.update(kwargs)
    return out


def keep_call(args, kwargs, out):
    """The call as it was made and what it returned."""
    return (args, kwargs, out)


def stash(seed: int, checks: Dict, driver_sites: Dict = None) -> Stash:
    """The window's sampler for ``checks`` ({number: check module})."""
    driver_sites = driver_sites or {}
    targets = {}
    for name, chk in checks.items():
        sites = [tuple(s) for s in chk.SITES] + [
            tuple(s) for s in driver_sites.get(chk.STAGE, ())]
        if chk.STAGE in targets:
            size, have, _ = targets[chk.STAGE]
            if (size, have) != (chk.SAMPLE, sites):
                raise ValueError(f"check {name} samples stage {chk.STAGE} "
                                 "otherwise than a check before it")
            continue
        targets[chk.STAGE] = (chk.SAMPLE, sites, chk.keep)
    return Stash(seed, targets)
