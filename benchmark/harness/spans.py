"""Spans taken from the benchmark's side: ``spans/<span>.json`` names the
program's functions, as their callers look them up (a module attribute,
or ``Class.method``), whose calls make up the span. A driver adds
targets of its own to a span (the driver's ``SPANS``: {span: [(module,
attribute), ...]}), for a path that binds the span's function into its
own namespace. A traced run installs the spans that its cell's
per-layer readers name (the readers' ``SPANS``). While installed, every
call of one is timed on the host clock between two device
synchronisations, and recorded as (span, target, start, end) in seconds
of ``time.perf_counter``.
"""

from __future__ import annotations

import importlib
import json
import time
from pathlib import Path
from typing import List, Tuple

import torch


def load(spans_dir: Path, names, driver_spans):
    """[(span name, [(module, attribute path), ...])] of the named spans:
    each span's file's targets, then the driver's for it."""
    out = []
    for n in sorted(set(names)):
        targets = [tuple(t) for t in json.loads(
            (spans_dir / f"{n}.json").read_text())["targets"]]
        targets += [tuple(t) for t in driver_spans.get(n, ())
                    if tuple(t) not in targets]
        out.append((n, targets))
    return out


class Spans:
    def __init__(self, spec, sync=None):
        self.spec = spec
        self.sync = torch.cuda.synchronize if sync is None else sync
        self.records: List[Tuple[str, str, float, float]] = []
        self._saved = []

    def install(self) -> None:
        for name, targets in self.spec:
            for mod_name, path in targets:
                owner = importlib.import_module(mod_name)
                *parents, attr = path.split(".")
                for p in parents:
                    owner = getattr(owner, p)
                orig = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
                self._saved.append((owner, attr, orig))
                setattr(owner, attr, self._wrap(name, path, orig))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    def _wrap(self, name, path, fn):
        rec, sync = self.records, self.sync

        def timed(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                rec.append((name, path, t0, time.perf_counter()))

        return timed
