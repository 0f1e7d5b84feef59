"""Keep, from the calls the measured window makes, a sample drawn from the
seed of what the program's stages were given and what they returned, for
the comparison with the reference once the window has closed.

``Stash`` patches module attributes of the program (the names its
callers look up at call time) with wrappers that call the original and
keep the arguments and results of a reservoir sample of the calls: every
call has the same chance of being kept, whatever the number of calls.
Keeping costs a Python call and a reference per call; nothing is copied
or synchronised inside the window.
"""

from __future__ import annotations

import importlib
import random
import zlib
from typing import Dict, List, Tuple


class Reservoir:
    def __init__(self, size: int, seed: int, key: str):
        self.size = size
        self.items: List = []
        self.seen = 0
        self._rng = random.Random((seed * 1000003) ^ zlib.crc32(key.encode()))

    def offer(self, item) -> None:
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.items.append(item)
            return
        j = self._rng.randrange(n + 1)
        if j < self.size:
            self.items[j] = item


class Stash:
    """``targets`` maps a key to (size, [(module, attribute), ...],
    keep(args, kwargs, result) -> item or list of items)."""

    def __init__(self, seed: int, targets: Dict[str, Tuple]):
        self.targets = targets
        self.samples = {k: Reservoir(size, seed, k)
                        for k, (size, _, _) in targets.items()}
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        for key, (_, where, keep) in self.targets.items():
            for mod_name, attr in where:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(key, orig, keep))

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, key, orig, keep):
        res = self.samples[key]

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            items = keep(args, kwargs, out)
            for item in (items if isinstance(items, list) else [items]):
                res.offer(item)
            return out

        return wrapper

    def items(self, key: str) -> List:
        return list(self.samples[key].items)
