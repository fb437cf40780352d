"""Accuracy-vs-reference harness for the sketch variants (the port's copy
of ``sentinel_tpu/sketch/parity.py``).

Drives fixed-seed Zipf value streams through the real decide path
(:func:`sentinel_tpu_torch.engine.param.param_decide`: the CUDA kernels on
the card, the torch-ops core on the CPU, as ``ParamConfig.impl`` selects)
against an exact host-side counter, and reports the per-key overestimate
distribution. The gates are **zero undercounts** (the one-sided count-min
guarantee every variant must keep) and the slim twin's error staying
within 2x of the fat sketch's on a stream both can hold.

Queries go through :func:`query_np`, a host-side mirror of the device
estimate math (decoded live-bucket sums, min over lanes), so measuring
accuracy never perturbs the state under test.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.engine.param import (
    hash_indices,
    make_param_state,
    param_decide,
)
from sentinel_tpu_torch.sketch import decoded_counts_np
from sentinel_tpu_torch.sketch.slim import (
    host_array,
    slim_indices,
    slim_query_np,
)

DEFAULT_SEED = 0x5A15A  # fixed-seed streams: CI runs are reproducible


def key_hashes(n_keys: int, seed: int = DEFAULT_SEED) -> np.ndarray:
    """``n_keys`` stable, distinct 64-bit value hashes."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-(2 ** 63), 2 ** 63 - 1, size=2 * n_keys, dtype=np.int64)
    h = np.unique(h)[:n_keys]
    if h.shape[0] < n_keys:  # astronomically unlikely; keep deterministic
        extra = np.arange(n_keys - h.shape[0], dtype=np.int64) + 7
        h = np.concatenate([h, extra])
    return h


def zipf_stream(
    n_keys: int,
    n_events: int,
    alpha: float = 1.1,
    seed: int = DEFAULT_SEED,
) -> Tuple[np.ndarray, np.ndarray]:
    """``-> (hashes [n_events] int64, key_ids [n_events] int32)`` — a
    Zipf(alpha)-weighted stream over ``n_keys`` distinct values."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.power(np.arange(1, n_keys + 1, dtype=np.float64), alpha)
    w /= w.sum()
    ids = rng.choice(n_keys, size=n_events, p=w).astype(np.int32)
    return key_hashes(n_keys, seed)[ids], ids


def exact_counts(key_ids: np.ndarray, n_keys: int,
                 acquire: int = 1) -> np.ndarray:
    """The reference: an exact per-key counter of the same stream."""
    return np.bincount(key_ids, minlength=n_keys).astype(np.int64) * acquire


def run_stream(
    config,
    stream_hashes: np.ndarray,
    *,
    slot: int = 0,
    acquire: int = 1,
    threshold: float = 1e9,
    batch: int = 512,
    now: int = 1_000,
    maintain_slim: bool = True,
    device: DeviceLike = None,
):
    """Feed a value-hash stream through ``param_decide`` in fixed-size
    batches at a fixed ``now`` (single live bucket: no decay between feed
    and query) and return the final ``ParamState``, on ``device`` (``cuda``
    unless told otherwise). One param kernel launch a batch on the card."""
    dev = resolve_device(device)
    state = make_param_state(config, device=dev)
    n = stream_hashes.shape[0]
    slim_on = maintain_slim and config.slim_enabled
    rule_slot = torch.full((batch,), slot, dtype=torch.int32, device=dev)
    acq = torch.full((batch,), acquire, dtype=torch.int32, device=dev)
    thr = torch.full((batch,), threshold, dtype=torch.float32, device=dev)
    for off in range(0, n, batch):
        chunk = stream_hashes[off:off + batch]
        pad = batch - chunk.shape[0]
        idx = np.pad(
            hash_indices(chunk, config.depth, config.cell_width),
            ((0, pad), (0, 0)),
        )
        idx_slim = (
            np.pad(slim_indices(config, chunk), ((0, pad), (0, 0)))
            if slim_on else None
        )
        valid = np.zeros(batch, bool)
        valid[:chunk.shape[0]] = True
        state, _admit, _est = param_decide(
            config,
            state,
            rule_slot,
            torch.from_numpy(idx).to(dev),
            acq,
            thr,
            torch.from_numpy(valid).to(dev),
            int(now),
            idx_slim=(None if idx_slim is None
                      else torch.from_numpy(idx_slim).to(dev)),
        )
    return state


def query_np(config, state, slot: int, hashes: np.ndarray,
             now: int) -> np.ndarray:
    """``[N] int64`` fat-sketch estimates — host mirror of the device math
    (decoded cells, live-bucket sums, min over depth lanes)."""
    idx = hash_indices(hashes, config.depth, config.cell_width)
    dec = decoded_counts_np(config, state.counts)[int(slot)]  # [B, D, C]
    starts = host_array(state.starts)
    age = int(now) - starts
    live = (age >= 0) & (age < config.interval_ms)
    winsum = (dec.astype(np.int64) * live[:, None, None]).sum(axis=0)
    per_d = winsum[np.arange(config.depth)[None, :], idx]
    return per_d.min(axis=1)


def stream_report(
    config,
    *,
    n_keys: int,
    n_events: int,
    alpha: float = 1.1,
    seed: int = DEFAULT_SEED,
    acquire: int = 1,
    batch: int = 512,
    with_slim: bool = True,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """One full parity run: feed the stream, query every distinct key, and
    report the overestimate distribution vs the exact reference (plus the
    slim twin's, when enabled). ``undercounts`` MUST be zero for every
    variant — that's the safety gate."""
    now = 1_000
    hashes, ids = zipf_stream(n_keys, n_events, alpha, seed)
    state = run_stream(
        config, hashes, acquire=acquire, batch=batch, now=now,
        maintain_slim=with_slim, device=device,
    )
    keys = key_hashes(n_keys, seed)
    true = exact_counts(ids, n_keys, acquire)
    est = query_np(config, state, 0, keys, now)
    err = est - true
    report: Dict[str, object] = {
        "sketch": config.sketch,
        "impl": config.impl,
        "nKeys": int(n_keys),
        "nEvents": int(n_events),
        "alpha": float(alpha),
        "seed": int(seed),
        "undercounts": int((err < 0).sum()),
        "errCdf": _cdf(err),
        "meanRelErr": float(
            (err / np.maximum(true, 1)).mean()
        ),
    }
    if with_slim and config.slim_enabled:
        est_slim = slim_query_np(config, state, 0, keys, now)
        serr = est_slim - true
        report["slim"] = {
            "undercounts": int((serr < 0).sum()),
            "errCdf": _cdf(serr),
            "meanRelErr": float((serr / np.maximum(true, 1)).mean()),
        }
    return report


def _cdf(err: np.ndarray) -> Dict[str, float]:
    return {
        "p50": float(np.percentile(err, 50)),
        "p90": float(np.percentile(err, 90)),
        "p99": float(np.percentile(err, 99)),
        "max": float(err.max()) if err.size else 0.0,
        "mean": float(err.mean()) if err.size else 0.0,
    }


def effective_cardinality(
    config,
    *,
    err_budget: float = 0.25,
    k_grid=(32, 48, 64, 96, 128, 192, 256, 384, 512),
    events_per_key: int = 12,
    alpha: float = 1.05,
    seed: int = DEFAULT_SEED,
    batch: int = 512,
    device: DeviceLike = None,
) -> float:
    """Largest key cardinality the sketch holds with p90 overestimate
    within ``err_budget`` of the mean per-key count, on the fixed-seed Zipf
    stream, log-interpolated past the last grid point that meets the
    budget. This is the "effective key cardinality at equal HBM bytes"
    metric from the SALSA evaluation: plain int32 width-W vs SALSA int16
    width-2W are byte-identical, so the ratio of their effective
    cardinalities is the memory win. The p90 (not mean-relative) statistic
    keeps the sweep monotone — mean relative error is dominated by a
    handful of tail keys catching heavy-hitter collision mass.
    """
    import math

    budget = err_budget * events_per_key  # absolute p90 error budget
    errs = []
    for k in k_grid:
        rep = stream_report(
            config,
            n_keys=int(k),
            n_events=int(k) * events_per_key,
            alpha=alpha,
            seed=seed,
            batch=batch,
            with_slim=False,
            device=device,
        )
        errs.append(float(rep["errCdf"]["p90"]))
    # last grid point within budget, then log-interpolate into the first
    # failing point after it
    last_ok = None
    for i, e in enumerate(errs):
        if e <= budget:
            last_ok = i
    if last_ok is None:
        return float(k_grid[0])
    if last_ok == len(k_grid) - 1:
        return float(k_grid[-1])
    k0, k1 = float(k_grid[last_ok]), float(k_grid[last_ok + 1])
    e0, e1 = max(errs[last_ok], 1e-3), max(errs[last_ok + 1], 1e-3)
    t = (math.log(budget + 1e-9) - math.log(e0)) / (
        math.log(e1) - math.log(e0)
    )
    t = min(max(t, 0.0), 1.0)
    return float(math.exp(math.log(k0) + t * (math.log(k1) - math.log(k0))))
