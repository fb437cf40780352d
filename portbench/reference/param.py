"""The hot-parameter side of the plain reference: a NumPy model of the
per-value check over a windowed count-min sketch, replayed over what a run
served.

Upstream (``ClusterParamFlowChecker``) keeps one counter a value in each
bucket of the rule's ``LeapArray`` and blocks a request when any of its
values' window count + acquire exceeds that value's threshold (its
override, or the rule's count). The configuration states the port's
replacement of those counters: each rule's buckets hold a count-min sketch
of ``depth`` lanes of ``width`` cells, a value's count is the least of its
cells' window sums (never under the true count), and its cells are the
splitmix64 finalizer of the value's 64-bit hash plus the lane's multiple of
the golden ratio, modulo the width.

Where the port states a choice of its own, the model takes it:

- a request is one step at one engine ms; its values see the sketch as the
  step found it, and values that fall on the same cells in every lane share
  one budget, taken in the request's order;
- the admitted values of a request are counted even when another of its
  values blocks it (a conservative overcount), and the request answers OK
  only when every value passed;
- the slim twin answers 0 on a primary (no bucket of it is authoritative),
  so it takes no part in a decision and is left out.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .flow import NEVER

OK, BLOCKED, NO_RULE_EXISTS = 0, 1, 3
GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def sketch_cells(hashes: np.ndarray, depth: int, width: int) -> np.ndarray:
    """``[n, depth]`` cell of each value hash in each lane."""
    with np.errstate(over="ignore"):
        x = (hashes.astype(np.uint64)[:, None]
             + np.arange(1, depth + 1, dtype=np.uint64)[None, :] * GOLDEN)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(width)).astype(np.int64)


class ParamModel:
    """The param rules' sketches: ``counts[rule, bucket, lane, cell]`` on
    one ring of ``n_buckets`` buckets of ``bucket_ms``. ``rules`` are
    ``(flow_id, count, {value_hash: threshold})`` in load order."""

    def __init__(self, param: dict,
                 rules: Sequence[Tuple[int, float, Dict[int, float]]]):
        if param.get("sketch", "cms") != "cms":
            raise NotImplementedError("the model holds the count-min sketch")
        self.bucket_ms = int(param["bucket_ms"])
        self.n = int(param["n_buckets"])
        self.interval = self.bucket_ms * self.n
        self.depth, self.width = int(param["depth"]), int(param["width"])
        self.rules = {int(fid): (i, np.float32(count), dict(items))
                      for i, (fid, count, items) in enumerate(rules)}
        self.counts = np.zeros((len(rules), self.n, self.depth, self.width),
                               np.int64)
        self.starts = np.full(self.n, NEVER, np.int64)
        # the control: every write dropped, so no sketch ever fills
        self.frozen = False

    def request(self, flow_id: int, acquire: int, hashes: Sequence[int],
                now: int) -> Tuple[int, np.ndarray]:
        """``(status, admitted per value)``."""
        if not hashes:
            return OK, np.zeros(0, bool)
        entry = self.rules.get(int(flow_id))
        if entry is None:
            return NO_RULE_EXISTS, np.zeros(0, bool)
        rule, count, items = entry
        h = np.asarray(list(hashes), np.int64)
        cells = sketch_cells(h, self.depth, self.width)
        cur = (now // self.bucket_ms) % self.n
        start = now - now % self.bucket_ms
        if self.starts[cur] != start and not self.frozen:
            self.counts[:, cur] = 0
            self.starts[cur] = start
        age = now - self.starts
        inside = (age >= 0) & (age < self.interval)
        lanes = np.arange(self.depth)
        sums = self.counts[rule][:, lanes[None, :], cells].transpose(1, 2, 0)
        est = (sums * inside).sum(axis=2).min(axis=1)  # [n]
        admit = np.zeros(h.size, bool)
        used: Dict[bytes, int] = {}
        for i in range(h.size):
            key = cells[i].tobytes()
            thr = np.float32(items.get(int(h[i]), count))
            before = used.get(key, 0)
            if np.float32(est[i]) + np.float32(before) \
                    + np.float32(acquire) <= thr:
                admit[i] = True
                used[key] = before + int(acquire)
        if not self.frozen:
            for d in range(self.depth):
                np.add.at(self.counts[rule, cur, d], cells[admit, d],
                          int(acquire))
        return (OK if admit.all() else BLOCKED), admit
