"""Seeded workloads of the hot-param path: ``chip_smoke.py``,
``tests/test_torch_kernels.py`` and the CPU parity tests import it.

Everything is made from a ``numpy.random.Generator``:

- param rules: a count of 50-500 per value, and item overrides on the ten
  hottest values of each rule;
- kernel batches (:func:`kernel_batch`): rules drawn bounded-Zipf over the
  slots, values bounded-Zipf (alpha 1.1) over 200,000 distinct values per
  rule (the reference's per-resource cardinality cap,
  ``ClusterParamMetric.java:37``), acquires 1-3; plus, in every batch,
  padded rows, rows with ``rule_slot = -1``, a pair of rows on a fresh value
  whose budget fits one of them (the second is rejected by the in-batch
  prefix alone, on even steps), and a block of hot rows on one value with a
  high threshold and a large acquire, none above SAT alone, which together
  saturate their SALSA pair within one step; a row on the OTHER cell of that
  pair (both cells of an unmerged pair whose summed adds merge it, then both
  indices of a merged pair); on odd steps two small rows on the two cells
  of another pair, which stays unmerged; on every third step an admitted
  row that acquires 0;
- service streams (:func:`service_stream`): requests of 1-4 values
  acquiring 1-3.

:func:`check_param_steps` steps a kernel and its plain version over the
batches from two copies of one state and compares admit, estimate and
every state leaf with ``torch.equal`` (:func:`twin_fns` gives the pair with
the slim twin: ``param_decide``'s count-min launch against the torch-op
composition ``slim_prestep``, ``cms_decide_update_plain``,
``slim_poststep``; :func:`with_twin` adds the batches' slim indices and
:func:`twin_state` a primary's or a standby's state); for SALSA it also
holds every pair of the current plane that no admitted row addressed to its
bits before the step, on both sides, and the kernel's add-sum buffer to all
zero. It reports
which of :data:`COVERAGE` the steps reached. :data:`STEP_OFFSETS_MS` (500 ms buckets, a 2-bucket ring)
spans 2.7 s: same-bucket steps, rolls onto buckets that hold counts, and
steps that must mask an aged bucket that holds counts.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.engine.param import (
    ParamConfig,
    ParamState,
    hash_indices,
)
from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
from functools import lru_cache

from sentinel_tpu_torch.sketch.salsa import SAT
from torch_kernel_check import ZipfIds

VALUES = 200_000  # distinct values per rule
HOT_VALUES = 10  # item overrides on the hottest values of each rule
HOT_SLOT = 1  # the slot of the saturating block
BOTH_SLOT = 2  # the slot of the two small rows on one pair's two cells
ZERO_SLOT = 3  # the slot of the admitted row that acquires 0
T0_MS = 20_040
# from T0: same bucket; a new bucket; a roll onto the first (written) bucket
# and a step in it; a roll onto the second (written) bucket while the first
# has aged out holding counts, and a step in it
STEP_OFFSETS_MS = (0, 120, 600, 1110, 1150, 2660, 2720)
COVERAGE = ("rolled_written_bucket", "masked_aged_bucket",
            "prefix_only_reject", "padded_rows", "no_rule_rows")
SALSA_COVERAGE = COVERAGE + (
    "newly_merged", "routed_to_merged",
    # admitted rows on both cells of one unmerged pair that stays unmerged
    "pair_both_cells",
    # the same where no add alone lifts a side above SAT but their sums do:
    # one merge, counted once
    "pair_summed_merge",
    # admitted rows on one merged pair through its even and its odd index
    "merged_pair_both_indices",
    "admitted_zero_acquire",
)

# what a batch of fewer than 8 rows can reach: one row a step, cycling
# through a live row, a row without a rule and a padded row
SMALL_COVERAGE = ("rolled_written_bucket", "masked_aged_bucket",
                  "padded_rows", "no_rule_rows")

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def coverage_for(sketch: str, n: int = 8) -> Tuple[str, ...]:
    if n < 8:
        return SMALL_COVERAGE
    return SALSA_COVERAGE if sketch == "salsa" else COVERAGE


def value_hashes(slots: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Stable 64-bit hashes of (rule, value) pairs (splitmix64)."""
    x = (slots.astype(np.uint64) << np.uint64(32)) ^ values.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x.view(np.int64)


class ParamRules:
    """Per-slot counts (50-500) and overrides of the ``HOT_VALUES`` hottest
    values (a tenth of the count, at least 2)."""

    def __init__(self, n_rules: int, rng: np.random.Generator):
        self.count = rng.integers(50, 501, size=n_rules).astype(np.float32)

    def threshold(self, slots: np.ndarray, values: np.ndarray) -> np.ndarray:
        base = self.count[slots]
        hot = np.maximum(2.0, np.floor(base / 10.0)).astype(np.float32)
        return np.where(values < HOT_VALUES, hot, base).astype(np.float32)


def _lane0_cells(config: ParamConfig, slot: int,
                 values: np.ndarray) -> np.ndarray:
    h = value_hashes(np.full(values.shape, slot), values)
    return hash_indices(h, config.depth, config.cell_width)[:, 0]


@lru_cache(maxsize=None)
def _special_values(depth: int, cell_width: int) -> Tuple[int, int, int, int]:
    """``(hot, hot_partner, both_even, both_odd)``: values past the Zipf
    range, found by search. ``hot`` has an odd lane-0 cell in ``HOT_SLOT``
    (adds to it are routed once its SALSA pair has merged) and
    ``hot_partner`` the even cell of the same pair; ``both_even`` and
    ``both_odd`` share one lane-0 pair in ``BOTH_SLOT``."""
    config = ParamConfig(depth=depth, width=cell_width)  # cms: cells = width
    cand = np.arange(VALUES, VALUES + 64 * cell_width)
    cells = _lane0_cells(config, HOT_SLOT, cand)
    hot_at = int(np.argmax(cells % 2 == 1))
    partner_at = np.nonzero(cells == cells[hot_at] - 1)[0]
    cells_b = _lane0_cells(config, BOTH_SLOT, cand)
    order = np.argsort(cells_b, kind="stable")
    sorted_cells = cells_b[order]
    adj = np.nonzero((sorted_cells[:-1] % 2 == 0)
                     & (sorted_cells[1:] == sorted_cells[:-1] + 1))[0]
    if not partner_at.size or not adj.size:
        raise RuntimeError("no special values among the candidates")
    return (int(cand[hot_at]), int(cand[partner_at[0]]),
            int(cand[order[adj[0]]]), int(cand[order[adj[0] + 1]]))


def kernel_batch(config: ParamConfig, rng: np.random.Generator,
                 slot_zipf: ZipfIds, value_zipf: ZipfIds, rules: ParamRules,
                 n: int, step: int) -> Dict[str, np.ndarray]:
    """``n`` rows (``n >= 8``) of the kernel's columns, numpy."""
    if n < 8:
        raise ValueError("a kernel batch holds at least 8 rows")
    P = config.max_param_rules
    n_pad = max(1, n // 64)
    n_none = max(1, n // 100)
    k_hot = max(2, n // 64)
    hot, partner, both_even, both_odd = _special_values(config.depth,
                                                        config.cell_width)
    n_zero = 1 if step % 3 == 0 else 0
    n_rand = n - n_pad - n_none - 2 - n_zero - 1 - k_hot
    if step % 2 == 0:
        # a fresh value each step whose budget fits one of its two rows
        two_slots, two_values = np.full(2, (7 * step + 3) % P), \
            np.full(2, VALUES + 1000 + step)
        two_acq, two_thr = np.full(2, 2), 3.0
    else:
        two_slots, two_values = np.full(2, BOTH_SLOT), \
            np.array([both_even, both_odd])
        two_acq, two_thr = np.array([1, 2]), 1e9
    slots = np.concatenate([
        np.minimum(slot_zipf(rng, n_rand), P - 1),
        np.full(n_none, -1),
        two_slots,
        np.full(n_zero, ZERO_SLOT),
        np.full(1 + k_hot, HOT_SLOT),
    ]).astype(np.int64)
    values = np.concatenate([
        value_zipf(rng, n_rand + n_none),
        two_values,
        np.full(n_zero, VALUES + 3000 + step),
        np.full(1, partner),
        np.full(k_hot, hot),
    ])
    # no hot add lifts its cell above SAT alone; together they do
    hot_acq = max(64, SAT // k_hot + 1)
    if hot_acq > SAT:
        raise ValueError("one hot add must stay at or below SAT")
    acq = np.concatenate([
        rng.integers(1, 4, size=n_rand + n_none),
        two_acq,
        np.zeros(n_zero),
        np.ones(1),
        np.full(k_hot, hot_acq),
    ]).astype(np.int32)
    thr = rules.threshold(np.maximum(slots, 0), values)
    at = n_rand + n_none
    thr[at:at + 2] = two_thr
    thr[at + 2:] = 1e9
    order = rng.permutation(n - n_pad)
    slots, values, acq, thr = slots[order], values[order], acq[order], \
        thr[order]
    hashes = value_hashes(np.maximum(slots, 0), values)
    # padded rows: not valid, arbitrary content
    slots = np.concatenate([slots, rng.integers(0, P, size=n_pad)])
    hashes = np.concatenate([hashes, rng.integers(0, 2**62, size=n_pad)])
    acq = np.concatenate([acq, np.ones(n_pad, np.int32)])
    thr = np.concatenate([thr, np.zeros(n_pad, np.float32)])
    valid = np.arange(n) < n - n_pad
    return dict(
        rule_slot=slots.astype(np.int32),
        idx=hash_indices(hashes, config.depth, config.cell_width),
        acquire=acq.astype(np.int32),
        threshold=thr.astype(np.float32),
        valid=valid,
    )


def to_device(cols: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in cols.items()}


def clone_param_state(st: ParamState) -> ParamState:
    return ParamState(*(t.clone() for t in st))


def step_fns(sketch: str):
    """``(kernel, plain)``, each ``fn(state, cols, now, bucket_ms) ->
    (admit, est)`` updating ``state`` in place."""
    if sketch == "cms":
        def run(fn):
            return lambda st, c, now, bms: fn(
                st.counts, st.starts, c["rule_slot"], c["idx"],
                c["acquire"], c["threshold"], c["valid"], now, bms)

        return (run(cms_cuda.cms_decide_update),
                run(cms_cuda.cms_decide_update_plain))

    def run_salsa(fn):
        return lambda st, c, now, bms: fn(
            st.counts, st.starts, st.merges, c["rule_slot"], c["idx"],
            c["acquire"], c["threshold"], c["valid"], now, bms)

    return (run_salsa(salsa_cuda.salsa_decide_update),
            run_salsa(salsa_cuda.salsa_decide_update_plain))


def _pair_coverage(plane0: np.ndarray, plane1: np.ndarray,
                   cols: Dict[str, np.ndarray], admit: np.ndarray) -> set:
    """The pair cases of :data:`SALSA_COVERAGE` one step reached, from the
    current plane as the roll left it (``plane0 [P, D, 2W]``), the plane
    after the step and the admitted rows."""
    rows = np.nonzero(admit)[0]
    reached = set()
    if not rows.size:
        return reached
    if (cols["acquire"][rows] == 0).any():
        reached.add("admitted_zero_acquire")
    P, D, C = plane0.shape
    slot = cols["rule_slot"][rows].astype(np.int64)[:, None]  # [n, 1]
    idx = cols["idx"][rows].astype(np.int64)  # [n, D]
    d_ar = np.arange(D)[None, :]
    acq = np.broadcast_to(cols["acquire"][rows].astype(np.int64)[:, None],
                          idx.shape)
    merged0 = plane0[slot, d_ar, idx | 1] < 0
    merged1 = plane1[slot, d_ar, idx | 1] < 0
    own0 = plane0[slot, d_ar, idx].astype(np.int64)
    key = ((slot * D + d_ar) * C + (idx & ~1)).reshape(-1)
    _, inv = np.unique(key, return_inverse=True)
    odd = (idx % 2 == 1).reshape(-1)
    n_groups = inv.max() + 1
    has_even = np.bincount(inv, weights=~odd, minlength=n_groups) > 0
    has_odd = np.bincount(inv, weights=odd, minlength=n_groups) > 0
    both = (has_even & has_odd)[inv]
    m0, m1 = merged0.reshape(-1), merged1.reshape(-1)
    alone = (own0 + acq).reshape(-1) > SAT  # this add alone saturates
    any_alone = (np.bincount(inv, weights=alone, minlength=n_groups) > 0)[inv]
    if (both & ~m0 & ~m1).any():
        reached.add("pair_both_cells")
    if (both & ~m0 & m1 & ~any_alone).any():
        reached.add("pair_summed_merge")
    if (both & m0).any():
        reached.add("merged_pair_both_indices")
    return reached


def current_plane_after_roll(config: ParamConfig, before: ParamState,
                             now: int) -> torch.Tensor:
    """The current bucket's ``[P, D, cells]`` plane as the roll of a step at
    ``now`` leaves it: zeros when its recorded start is stale."""
    cur, cur_start = cms_cuda.ring(now, config.bucket_ms, config.n_buckets)
    plane = before.counts[:, cur]
    if int(before.starts[cur]) != cur_start:
        return torch.zeros_like(plane)
    return plane.clone()


def untouched_pairs_equal(plane0: torch.Tensor, plane1: torch.Tensor,
                          cols: Dict[str, torch.Tensor],
                          admit: torch.Tensor) -> bool:
    """Whether every pair of a SALSA plane that no admitted row addressed
    has the same bits after the step (``plane1``) as before (``plane0``)."""
    P, D, C = plane0.shape
    rows = torch.nonzero(admit)[:, 0]
    touched = torch.zeros((P, D, C // 2), dtype=torch.bool,
                          device=plane0.device)
    slot = cols["rule_slot"][rows].long()[:, None]
    d_ar = torch.arange(D, device=plane0.device)[None, :]
    touched[slot, d_ar, cols["idx"][rows].long() // 2] = True
    keep = ~touched
    pairs0 = plane0.view(P, D, C // 2, 2)
    pairs1 = plane1.view(P, D, C // 2, 2)
    return torch.equal(pairs0[keep], pairs1[keep])


def _twin_coverage(config: ParamConfig, before: ParamState,
                   cols: Dict[str, np.ndarray], now: int, stale: bool,
                   after: ParamState) -> set:
    """Which of :data:`TWIN_COVERAGE` one step reached."""
    cur, cur_start = cms_cuda.ring(now, config.bucket_ms, config.n_buckets)
    auth = before.slim_auth.cpu().numpy().copy()
    slim = before.slim.cpu().numpy().copy()
    reached = set()
    if stale:
        if auth[cur] and slim[:, cur].any():
            reached.add("rolled_authoritative_twin")
        auth[cur] = False
        slim[:, cur] = 0
    starts = before.starts.cpu().numpy().astype(np.int64)
    starts[cur] = cur_start
    age = now - starts
    use = (age >= 0) & (age < config.interval_ms) & auth  # [B]
    slot, live = cols["rule_slot"], cols["valid"] & (cols["rule_slot"] >= 0)
    safe = np.maximum(slot, 0).astype(np.int64)[:, None]
    ds = np.arange(config.slim_depth)[None, :]
    sums = sum(slim[safe, b, ds, cols["idx_slim"]].astype(np.int64) * use[b]
               for b in range(config.n_buckets))
    if (live & (sums.min(axis=1) > 0)).any():
        reached.add("slim_estimate_counted")
    if (after.slim[:, cur].cpu().numpy() > slim[:, cur]).any():
        reached.add("slim_cells_raised")
    return reached


def step_coverage(config: ParamConfig, before: ParamState,
                  cols: Dict[str, np.ndarray], now: int, admit: np.ndarray,
                  est: np.ndarray, after: ParamState) -> set:
    """Which of :data:`SALSA_COVERAGE` one step reached, from the state
    before it, its inputs, its outputs and the state after it."""
    merges_after = after.merges.cpu().numpy()
    cur, cur_start = cms_cuda.ring(now, config.bucket_ms, config.n_buckets)
    starts = before.starts.cpu().numpy()
    counts = before.counts.cpu().numpy()
    written = (counts != 0).any(axis=(0, 2, 3))  # [B]
    stale = int(starts[cur]) != cur_start
    reached = set()
    if stale and written[cur]:
        reached.add("rolled_written_bucket")
    age = now - starts.astype(np.int64)
    aged = ~((age >= 0) & (age < config.interval_ms))
    aged[cur] = False
    if (aged & written).any():
        reached.add("masked_aged_bucket")
    slot, valid = cols["rule_slot"], cols["valid"]
    live = valid & (slot >= 0)
    fits = est.astype(np.float32) + cols["acquire"].astype(np.float32) \
        <= cols["threshold"]
    if (live & fits & ~admit).any():
        reached.add("prefix_only_reject")
    if (~valid).any():
        reached.add("padded_rows")
    if (valid & (slot < 0)).any():
        reached.add("no_rule_rows")
    if "idx_slim" in cols:
        reached |= _twin_coverage(config, before, cols, now, stale, after)
    if config.sketch == "salsa":
        if merges_after.sum() > before.merges.cpu().numpy().sum():
            reached.add("newly_merged")
        if not stale:
            idx = cols["idx"]
            rows = np.nonzero(admit)[0]
            for d in range(idx.shape[1]):
                c = idx[rows, d]
                hi = counts[slot[rows], cur, d, c | 1]
                if ((c % 2 == 1) & (hi < 0)).any():
                    reached.add("routed_to_merged")
        plane0 = current_plane_after_roll(config, before, now).cpu().numpy()
        reached |= _pair_coverage(plane0, after.counts[:, cur].cpu().numpy(),
                                  cols, admit)
    return reached


class StepCheck(NamedTuple):
    max_abs_err: float
    mismatches: List[str]
    kernel_state: ParamState
    reached: set
    admitted: int
    blocked: int


def _compare(a, b):
    if torch.equal(a, b):
        return None
    return float((a.double() - b.double()).abs().max())


def check_param_steps(config: ParamConfig, state: ParamState, batches,
                      nows, fns=None) -> StepCheck:
    """Step the kernel of ``config.sketch`` and its plain version (or the
    pair ``fns``) over ``batches`` (numpy columns) at ``nows`` from two
    copies of ``state``."""
    kernel, plain = fns or step_fns(config.sketch)
    st_k, st_p = clone_param_state(state), clone_param_state(state)
    dev = state.counts.device
    mismatches, max_err, reached = [], 0.0, set()
    admitted = blocked = 0
    for k, (cols, now) in enumerate(zip(batches, nows)):
        before = clone_param_state(st_p)
        c = to_device(cols, dev)
        a_k, e_k = kernel(st_k, c, now, config.bucket_ms)
        a_p, e_p = plain(st_p, c, now, config.bucket_ms)
        pairs = [("admit", a_k, a_p), ("estimate", e_k, e_p)] + [
            (f"state.{f}", x, y) for f, x, y in zip(st_k._fields, st_k, st_p)
        ]
        for label, x, y in pairs:
            err = _compare(x, y)
            if err is not None:
                mismatches.append(f"step {k}: {label}")
                max_err = max(max_err, err)
        if config.sketch == "salsa":
            plane0 = current_plane_after_roll(config, before, now)
            cur = cms_cuda.ring(now, config.bucket_ms, config.n_buckets)[0]
            for side, st in (("kernel", st_k), ("plain", st_p)):
                if not untouched_pairs_equal(plane0, st.counts[:, cur], c,
                                             a_p):
                    mismatches.append(
                        f"step {k}: a pair no admitted row addressed "
                        f"changed ({side})")
            delta = salsa_cuda.persistent_delta(st_k.counts)
            if delta is not None and bool(delta.any()):
                mismatches.append(f"step {k}: the add-sum buffer is not "
                                  f"all zero")
        admit = a_p.cpu().numpy()
        live = cols["valid"] & (cols["rule_slot"] >= 0)
        admitted += int(admit.sum())
        blocked += int((live & ~admit).sum())
        reached |= step_coverage(config, before, cols, now, admit,
                                 e_p.cpu().numpy(), st_p)
    return StepCheck(max_err, mismatches, st_k, reached, admitted, blocked)


def _small_batch(cols: Dict[str, np.ndarray], n: int,
                 step: int) -> Dict[str, np.ndarray]:
    """``n < 8`` rows of an 8-row batch, starting at its first live row, row
    without a rule or padded row as ``step % 3`` says (wrapping)."""
    valid, slot = cols["valid"], cols["rule_slot"]
    kinds = (valid & (slot >= 0), valid & (slot < 0), ~valid)
    first = int(np.argmax(kinds[step % 3]))
    rows = (first + np.arange(n)) % valid.size
    return {k: v[rows] for k, v in cols.items()}


def kernel_batches(config: ParamConfig, n: int, seed: int):
    """The batches and step times of one :func:`check_param_steps` run.
    Below 8 rows a step's batch is cut from an 8-row one
    (:data:`SMALL_COVERAGE` says what such steps reach)."""
    rng = np.random.default_rng(seed)
    rules = ParamRules(config.max_param_rules, rng)
    slot_zipf = ZipfIds(config.max_param_rules)
    value_zipf = ZipfIds(VALUES)
    nows = [T0_MS + dt for dt in STEP_OFFSETS_MS]
    batches = [kernel_batch(config, rng, slot_zipf, value_zipf, rules,
                            max(n, 8), k) for k in range(len(nows))]
    if n < 8:
        batches = [_small_batch(b, n, k) for k, b in enumerate(batches)]
    return batches, nows


# -- the service's request stream ---------------------------------------------
class ParamRuleSpec(NamedTuple):
    flow_id: int
    count: float
    item_thresholds: Tuple[Tuple[int, float], ...]


def service_rule_specs(n_rules: int, rng: np.random.Generator,
                       first_id: int = 10_000) -> List[ParamRuleSpec]:
    """``n_rules`` param rules, each with item overrides on its
    ``HOT_VALUES`` hottest values (keyed by the (flow id, value) hash)."""
    rules = ParamRules(n_rules, rng)
    specs = []
    for r in range(n_rules):
        fid = first_id + r
        vals = np.arange(HOT_VALUES)
        hs = value_hashes(np.full(HOT_VALUES, fid), vals)
        thr = rules.threshold(np.full(HOT_VALUES, r), vals)
        specs.append(ParamRuleSpec(
            fid, float(rules.count[r]),
            tuple((int(h), float(t)) for h, t in zip(hs, thr)),
        ))
    return specs


def reload_specs(specs: List[ParamRuleSpec], rng: np.random.Generator,
                 n_new: int) -> List[ParamRuleSpec]:
    """A reload that drops every fifth rule (freeing its slot) and adds
    ``n_new`` rules (reusing freed slots)."""
    kept = [s for i, s in enumerate(specs) if i % 5]
    first = max(s.flow_id for s in specs) + 1
    return kept + service_rule_specs(n_new, rng, first_id=first)


def service_stream(specs: List[ParamRuleSpec], rng: np.random.Generator,
                   n_requests: int) -> List[Tuple[int, int, List[int]]]:
    """``(flow_id, acquire, value_hashes)`` requests: the rule drawn
    bounded-Zipf over ``specs``, 1-4 values bounded-Zipf over ``VALUES``,
    acquire 1-3."""
    rule_zipf, value_zipf = ZipfIds(len(specs)), ZipfIds(VALUES)
    out = []
    for _ in range(n_requests):
        fid = specs[int(rule_zipf(rng, 1)[0])].flow_id
        k = int(rng.integers(1, 5))
        vals = value_zipf(rng, k)
        hs = value_hashes(np.full(k, fid), vals)
        out.append((fid, int(rng.integers(1, 4)), [int(h) for h in hs]))
    return out


# what the twin's steps reach: on a primary (no bucket authoritative) the
# twin is still raised; a standby's also counts it and rolls a flagged bucket
TWIN_COVERAGE = {
    "primary": ("slim_cells_raised",),
    "standby": ("slim_cells_raised", "slim_estimate_counted",
                "rolled_authoritative_twin"),
    "off": (),
}


def with_twin(config: ParamConfig,
              batches: List[Dict[str, np.ndarray]]) -> List[Dict]:
    """The batches with their rows' slim cell indices (``idx_slim``), drawn
    from a value hash of each row's lane-0 cell and slot, so rows on one
    value share them; unchanged when the twin is off."""
    from sentinel_tpu_torch.sketch.slim import slim_indices

    if not config.slim_enabled:
        return batches
    out = []
    for cols in batches:
        h = (cols["idx"][:, 0].astype(np.int64) * 1_000_003
             + cols["rule_slot"])
        out.append(dict(cols, idx_slim=slim_indices(config, h)))
    return out


def twin_state(config: ParamConfig, kind: str, device,
               seed: int = 0) -> ParamState:
    """A zero state (``"primary"``, ``"off"``), or a standby's: both ring
    buckets live at :data:`T0_MS`, counts and slim cells drawn, the slim
    rows of bucket 1 (the first to roll) authoritative and bucket 0's not."""
    from sentinel_tpu_torch.engine.param import make_param_state

    st = make_param_state(config, device=device)
    if kind != "standby":
        return st
    rng = np.random.default_rng(seed)
    bms = config.bucket_ms
    cur = (T0_MS // bms) % config.n_buckets
    starts = np.array([T0_MS - T0_MS % bms - ((cur - b) % config.n_buckets)
                       * bms for b in range(config.n_buckets)], np.int32)
    st.starts.copy_(torch.as_tensor(starts))
    st.counts.copy_(torch.as_tensor(
        rng.integers(0, 40, tuple(st.counts.shape)).astype(np.int32)))
    st.slim.copy_(torch.as_tensor(
        rng.integers(0, 30, tuple(st.slim.shape)).astype(np.int32)))
    st.slim_auth.copy_(torch.as_tensor(
        np.arange(config.n_buckets) % 2 == 1))
    return st


def twin_fns(config: ParamConfig):
    """``(fused, plain)`` for :func:`check_param_steps` with the slim twin:
    ``param_decide`` through the count-min kernel (on the card the twin
    rides its one launch) and the torch-op composition ``slim_prestep``,
    ``cms_decide_update_plain``, ``slim_poststep``."""
    from sentinel_tpu_torch.engine.param import param_decide
    from sentinel_tpu_torch.sketch.slim import slim_poststep, slim_prestep

    kcfg = config._replace(sketch="cms", impl="pallas")
    names = ("rule_slot", "idx", "acquire", "threshold", "valid")

    def fused(st, c, now, bms):
        _, admit, est = param_decide(kcfg, st, *(c[k] for k in names), now,
                                     idx_slim=c.get("idx_slim"))
        return admit, est

    def plain(st, c, now, bms):
        if "idx_slim" not in c:
            return cms_cuda.cms_decide_update_plain(
                st.counts, st.starts, *(c[k] for k in names), now, bms)
        est_slim = slim_prestep(config, st, c["rule_slot"], c["idx_slim"],
                                now)
        thr = c["threshold"] - est_slim.to(torch.float32)
        admit, est = cms_cuda.cms_decide_update_plain(
            st.counts, st.starts, c["rule_slot"], c["idx"], c["acquire"],
            thr, c["valid"], now, bms)
        slim_poststep(config, st, c["rule_slot"], c["idx"], c["idx_slim"],
                      c["valid"], now)
        return admit, est + est_slim

    return fused, plain
