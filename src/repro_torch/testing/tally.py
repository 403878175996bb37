"""A per-lane count of the weights the partitioned train step gathers
(`distributed.partition`): while a `GatherTally` is active, every tensor
`sharding.gather` returns for a lane (its ``lane=`` form) is counted on
that lane from when it is made until its storage is freed, and each
lane's high-water is kept.

    with GatherTally() as tally:
        state, metrics = step(state, batch)
    tally.high[lane]      # the most bytes the lane held gathered at once
    tally.calls[lane]     # how many gathers it made
    tally.total[lane]     # and their bytes
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict

from ..distributed import sharding


class GatherTally:
    def __init__(self):
        self.live = defaultdict(int)
        self.high = defaultdict(int)
        self.calls = defaultdict(int)
        self.total = defaultdict(int)
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self):
        self._orig = sharding.gather
        sharding.gather = self._gather
        return self

    def __exit__(self, *exc):
        sharding.gather = self._orig

    def _gather(self, s, *args, lane=None, **kw):
        out = self._orig(s, *args, lane=lane, **kw)
        if lane is not None:
            n = out.numel() * out.element_size()
            with self._lock:
                self.calls[lane] += 1
                self.total[lane] += n
                self.live[lane] += n
                self.high[lane] = max(self.high[lane], self.live[lane])
            weakref.finalize(out.untyped_storage(), self._free, lane, n)
        return out

    def _free(self, lane, n):
        with self._lock:
            self.live[lane] -= n
