"""The benchmark's inputs, made from the configuration, the traffic mix and
the seed: rules, pre-encoded request frames, and their byte models.

Frozen copies from the repository's test kits, so that the yardstick does
not move with them: the bounded Zipf sampler
(``tests/torch_kernel_check.py::ZipfIds``), the param rule and value draws
(``tests/torch_param_check.py``: counts 50-500 a value, overrides on each
rule's ten hottest values, values bounded-Zipf over 200,000 a rule, the
splitmix64 value hash), and the byte models of the decide and count-min
steps (``chip_smoke.py::decide_bytes``, ``::param_bytes``). Numpy only.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from portbench import wire

# the published peak memory bandwidth of one H100 SXM (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


class ZipfIds:
    """Bounded Zipf(``alpha``) sampler over ``[0, n)`` (rank 0 hottest)."""

    def __init__(self, n: int, alpha: float = 1.1):
        w = np.arange(1, n + 1, dtype=np.float64) ** -alpha
        self.cdf = np.cumsum(w / w.sum())

    def __call__(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return np.minimum(
            np.searchsorted(self.cdf, rng.random(size)), self.cdf.size - 1
        ).astype(np.int64)


def value_hashes(slots: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Stable 64-bit hashes of (rule, value) pairs (splitmix64)."""
    x = (slots.astype(np.uint64) << np.uint64(32)) ^ values.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x.view(np.int64)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of one seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), int(int(seed) < 0),
                                  int.from_bytes(stream.encode(), "little")])


# Every seed gets the same work in another order: the rules, and the
# multiset of rows or requests a pool holds, are drawn once from this seed;
# a run's own seed orders them.
BASE_SEED = 0


# -- flow rules ---------------------------------------------------------------
class FlowRuleColumns(NamedTuple):
    flow_id: np.ndarray  # int64
    count: np.ndarray  # float64
    namespace: List[str]
    behavior: np.ndarray  # int32: 0 default, 1 warm-up, 2 pacing, 3 both


def flow_rules(spec: dict, max_flows: int) -> FlowRuleColumns:
    """The configuration's rules (``bench.py``'s shape): flow ``i`` counts
    ``count_base + i % count_mod`` a second, in namespace ``ns{i %
    namespaces}``; every ``k``-th flow of ``behavior_every`` takes its
    control behavior, the first listed winning."""
    n = int(spec.get("n_rules", max_flows))
    fid = np.arange(n, dtype=np.int64)
    count = float(spec["count_base"]) + (fid % int(spec["count_mod"]))
    beh = np.zeros(n, np.int32)
    for k, b in reversed(spec.get("behavior_every", [])):
        beh[fid % int(k) == 0] = int(b)
    ns = [f"ns{i % int(spec['namespaces'])}" for i in range(n)]
    return FlowRuleColumns(fid, count.astype(np.float64), ns, beh)


# -- param rules -------------------------------------------------------------
class ParamRuleSpec(NamedTuple):
    flow_id: int
    count: float
    items: Dict[int, float]  # value hash -> threshold


def param_rules(spec: dict) -> List[ParamRuleSpec]:
    """``n_rules`` param rules: a count drawn in ``[count_lo, count_hi]``
    a value, and overrides (a tenth of the count, at least 2) on each
    rule's ``hot_values`` hottest values, keyed by the value's hash. The
    same for every seed."""
    rng = rng_for(BASE_SEED, "param-rules")
    n, hot = int(spec["n_rules"]), int(spec["hot_values"])
    counts = rng.integers(int(spec["count_lo"]), int(spec["count_hi"]) + 1,
                          size=n).astype(np.float32)
    out = []
    for r in range(n):
        fid = int(spec["first_id"]) + r
        hs = value_hashes(np.full(hot, fid), np.arange(hot))
        thr = np.float32(max(2.0, float(np.floor(counts[r] / 10.0))))
        out.append(ParamRuleSpec(fid, float(counts[r]),
                                 {int(h): float(thr) for h in hs}))
    return out


# -- traffic pools ------------------------------------------------------------
class FlowPool(NamedTuple):
    """``pulls`` x ``frames_per_pull`` pre-encoded BATCH_FLOW frames, in
    send order; frame ``j`` holds rows ``ids[j]``."""

    ids: np.ndarray  # [frames, rows_per_frame] int64
    acquire: np.ndarray  # [frames, rows_per_frame] int32
    prios: np.ndarray  # [frames, rows_per_frame] bool
    frames_per_pull: int


def flow_pool(traffic: dict, max_flows: int, seed: int) -> FlowPool:
    rows, per = int(traffic["rows_per_pull"]), int(traffic["rows_per_frame"])
    if rows % per:
        raise ValueError("rows_per_pull must be a multiple of rows_per_frame")
    fpp = rows // per
    n_frames = int(traffic["pool_pulls"]) * fpp
    ids = ZipfIds(max_flows, float(traffic["zipf_alpha"]))(
        rng_for(BASE_SEED, "flow-pool"), n_frames * per)
    ids = rng_for(seed, "flow-order").permutation(ids).reshape(n_frames, per)
    acq = np.full((n_frames, per), int(traffic["acquire"]), np.int32)
    prios = np.zeros((n_frames, per), bool)
    return FlowPool(ids, acq, prios, fpp)


def frame_key(ids: np.ndarray) -> bytes:
    """A frame's identity: the digest of its flow ids."""
    return hashlib.blake2b(np.ascontiguousarray(ids, np.int64).tobytes(),
                           digest_size=16).digest()


class ParamRequest(NamedTuple):
    flow_id: int
    acquire: int
    hashes: Tuple[int, ...]


def param_pool(traffic: dict, rules: List[ParamRuleSpec],
               seed: int) -> List[ParamRequest]:
    """``pool_requests`` PARAM_FLOW requests: the rule bounded-Zipf over
    the rules, ``values_min``-``values_max`` values bounded-Zipf over
    ``values_per_rule``, acquire ``acquire_min``-``acquire_max``; the
    seed orders them."""
    rng = rng_for(BASE_SEED, "param-pool")
    n = int(traffic["pool_requests"])
    rule_rank = ZipfIds(len(rules), float(traffic["rule_zipf_alpha"]))(rng, n)
    k = rng.integers(int(traffic["values_min"]),
                     int(traffic["values_max"]) + 1, size=n)
    vals = ZipfIds(int(traffic["values_per_rule"]),
                   float(traffic["value_zipf_alpha"]))(rng, int(k.sum()))
    acq = rng.integers(int(traffic["acquire_min"]),
                       int(traffic["acquire_max"]) + 1, size=n)
    out, pos = [], 0
    for i in range(n):
        fid = rules[int(rule_rank[i])].flow_id
        v = vals[pos:pos + int(k[i])]
        pos += int(k[i])
        hs = value_hashes(np.full(v.size, fid), v)
        out.append(ParamRequest(fid, int(acq[i]), tuple(int(h) for h in hs)))
    return [out[i] for i in rng_for(seed, "param-order").permutation(n)]


def encode_flow_pool(pool: FlowPool) -> List[bytearray]:
    """Each frame of the pool as its wire bytes (xid 0, rewritten at send)."""
    return [bytearray(wire.encode_batch_request(0, pool.ids[j],
                                                pool.acquire[j],
                                                pool.prios[j]))
            for j in range(pool.ids.shape[0])]


def encode_param_pool(pool: List[ParamRequest]) -> List[bytearray]:
    return [bytearray(wire.encode_param_request(0, r.flow_id, r.acquire,
                                                r.hashes)) for r in pool]


# -- byte models -------------------------------------------------------------
# the decide kernel's [N] input columns and outputs (ops/decide_cuda.py's
# ROW_COLUMNS and DecideRows), bytes a row
DECIDE_COL_BYTES = 56
DECIDE_OUT_BYTES = 28
EVENTS, OCCUPY = 6, 1


def decide_bytes(n_rows: int, n_buckets: int, rows_touched: int, tails: int,
                 stale_rows: int) -> int:
    """Bytes the decide step must move: each distinct flow row's [B, E]
    window and [B] occupy row read once, every [N] input column read once,
    every [N] output written once, one [E] write per segment tail, and the
    stale column zeroed when the ring rolls."""
    return (rows_touched * n_buckets * (EVENTS + OCCUPY) * 4
            + n_rows * (DECIDE_COL_BYTES + DECIDE_OUT_BYTES)
            + tails * EVENTS * 4 + stale_rows * EVENTS * 4)


def param_bytes(sketch: str, n: int, depth: int, n_buckets: int,
                admitted: int, touched_pairs: int) -> int:
    """Bytes one param step must move: the [N] columns (slot, D indices,
    acquire, threshold, valid in; admit, estimate out), D x B gathered cells
    (a SALSA cell is read as its 4-byte pair), and the admitted rows' D cell
    writes for count-min, or each touched pair's 4 bytes read and written
    for SALSA."""
    cols = n * (4 + 4 * depth + 4 + 4 + 1 + 1 + 4)
    gathered = n * depth * n_buckets * 4
    if sketch == "salsa":
        return cols + gathered + touched_pairs * 2 * 4
    return cols + gathered + admitted * depth * 4
