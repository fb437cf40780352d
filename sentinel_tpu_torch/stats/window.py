"""Sliding-window counters as ring-indexed tensors (port of
``sentinel_tpu/stats/window.py``).

Same geometry as the reference: a ring of ``n_buckets`` time buckets whose
window starts are one shared ``starts[B]`` vector, ``counts[R, B, C]`` per
resource, mask-on-read validity and engine-relative int32 milliseconds.

Differences from the JAX module:

- **In place.** JAX's pure functions with donated buffers become in-place
  updates: every writer mutates ``ws.starts`` / ``ws.counts`` and returns the
  same :class:`WindowState` for chaining.
- **Host clock.** ``now`` is a host ``int``; ring slot and window start are
  host integers (Python ``//`` and ``%`` are floor ops, like ``jnp``'s).
- **Masked rows, not dropped indices.** JAX's ``mode="drop"`` scatters
  silently discard out-of-range rows. Here out-of-range rows keep an
  in-range index and carry a neutral value (0 for adds, the dtype's lowest
  value for maxes), which CUDA scatters accept. Negative indices in
  ``[-R, 0)`` wrap like the reference's (``jnp`` normalizes them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# Sentinel value for "slot never occupied": far in the past relative to any
# engine-relative timestamp (engine time starts near 0).
NEVER = -(2**30)


class WindowSpec(NamedTuple):
    """Static geometry of a sliding window (``LeapArray(sampleCount,
    intervalInMs)``)."""

    bucket_ms: int
    n_buckets: int

    @property
    def interval_ms(self) -> int:
        return self.bucket_ms * self.n_buckets


class WindowState(NamedTuple):
    """``starts``: ``[n_buckets] int32``; ``counts``: ``[R, n_buckets, C]``."""

    starts: torch.Tensor
    counts: torch.Tensor


def make_window(
    spec: WindowSpec,
    n_resources: int,
    n_channels: int,
    dtype=torch.int32,
    device=None,
) -> WindowState:
    return WindowState(
        starts=torch.full(
            (spec.n_buckets,), NEVER, dtype=torch.int32, device=device
        ),
        counts=torch.zeros(
            (n_resources, spec.n_buckets, n_channels), dtype=dtype,
            device=device,
        ),
    )


def bucket_index(spec: WindowSpec, now: int) -> Tuple[int, int]:
    """``(ring slot, window start)`` for time ``now`` (host ints)."""
    now = int(now)
    return (now // spec.bucket_ms) % spec.n_buckets, now - now % spec.bucket_ms


def floordiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """``jnp``'s integer ``//`` (floor), not C's truncation."""
    return torch.div(x, d, rounding_mode="floor")


def lowest(dtype: torch.dtype):
    """The neutral element of a max-scatter for ``dtype``."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def in_range_rows(ids: torch.Tensor, n: int):
    """``(safe ids, ok)`` for a scatter along an axis of length ``n``:
    negative ids in ``[-n, 0)`` wrap, anything else out of range is masked
    (``ok`` False, id 0)."""
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    return torch.where(ok, ids, 0), ok


def masked_set_(
    target: torch.Tensor,
    ids: torch.Tensor,
    values,
    mask: torch.Tensor,
) -> torch.Tensor:
    """``target[ids[i]] = values[i]`` for rows with ``mask[i]``, in place.

    The masked form of JAX's ``.at[where(mask, ids, F)].set(v, mode="drop")``.
    Rows of one slot that are selected carry equal values (the callers'
    contract, which keeps the reference deterministic), so a max over them
    picks that value; ``hit`` marks the slots any selected row touched.
    """
    ids, ok = in_range_rows(ids, target.shape[0])
    mask = mask & ok
    hit = torch.zeros(target.shape[0], dtype=torch.int32, device=target.device)
    hit.scatter_reduce_(0, ids, mask.to(torch.int32), "amax")
    if isinstance(values, torch.Tensor):
        low = lowest(target.dtype)
        staged = torch.full_like(target, low)
        staged.scatter_reduce_(
            0, ids, torch.where(mask, values.to(target.dtype), low), "amax"
        )
    else:
        staged = torch.full_like(target, values)
    target.copy_(torch.where(hit.bool(), staged, target))
    return target


def masked_max_(
    target: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """``target[ids[i]] = max(target[ids[i]], values[i])`` for masked-in
    rows, in place (JAX ``.at[].max(mode="drop")``)."""
    ids, ok = in_range_rows(ids, target.shape[0])
    low = lowest(target.dtype)
    target.scatter_reduce_(
        0, ids, torch.where(mask & ok, values.to(target.dtype), low), "amax"
    )
    return target


def _scatter_add_(counts, resource_ids, idx, channel_ids, values):
    """Masked 3-D scatter-add into bucket column ``idx`` (a host int or a
    per-row tensor), as one ``index_add_`` over the flat counts: integer
    atomics, so duplicate targets accumulate in any order to one result."""
    R, Bn, C = counts.shape
    rid, r_ok = in_range_rows(resource_ids, R)
    cid, c_ok = in_range_rows(
        torch.as_tensor(channel_ids, device=counts.device).expand_as(rid), C
    )
    ok = r_ok & c_ok
    if isinstance(idx, int):
        bid = torch.full_like(rid, idx)
    else:
        bid, b_ok = in_range_rows(idx, Bn)
        ok = ok & b_ok
    flat = (rid * Bn + bid) * C + cid
    vals = torch.where(ok, values.to(counts.dtype), 0)
    counts.view(-1).index_add_(0, flat, vals)


def roll(spec: WindowSpec, ws: WindowState, now: int) -> WindowState:
    """Ensure the ring slot for ``now`` holds the current window (zero it if
    stale), in place. The stale flag stays on the device: the column is
    multiplied by 0 or 1, so no host sync is needed. The new start is
    written with ``fill_`` (a kernel argument): ``starts[idx] = v`` copies a
    host scalar, which waits for the stream to drain."""
    idx, cur_start = bucket_index(spec, now)
    stale = ws.starts[idx] != cur_start
    keep = torch.where(stale, 0, 1).to(ws.counts.dtype)
    ws.counts[:, idx, :].mul_(keep)
    ws.starts[idx].fill_(cur_start)
    return ws


def add_events(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    resource_ids: torch.Tensor,
    channel_ids: torch.Tensor,
    values: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> WindowState:
    """Batched scatter-add of ``values`` into the current bucket, in place;
    duplicate ``(resource, channel)`` pairs accumulate."""
    roll(spec, ws, now)
    idx, _ = bucket_index(spec, now)
    if valid is not None:
        values = torch.where(valid, values, 0)
    _scatter_add_(ws.counts, resource_ids, idx, channel_ids, values)
    return ws


def add_event_rows(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    resource_ids: torch.Tensor,
    row_updates: torch.Tensor,
    channels: Optional[Tuple[int, ...]] = None,
) -> WindowState:
    """Scatter-add ``row_updates[i, j]`` into channel ``channels[j]`` of the
    current bucket of resource ``resource_ids[i]``, in place."""
    roll(spec, ws, now)
    idx, _ = bucket_index(spec, now)
    chans = range(row_updates.shape[1]) if channels is None else channels
    for j, ch in enumerate(chans):
        _scatter_add_(ws.counts, resource_ids, idx, int(ch), row_updates[:, j])
    return ws


def add_column(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    deltas: torch.Tensor,
    channel: int = 0,
) -> WindowState:
    """Add a dense per-resource delta vector to one channel of the current
    bucket, in place (the namespace guard's update)."""
    roll(spec, ws, now)
    idx, _ = bucket_index(spec, now)
    ws.counts[:, idx, channel].add_(deltas.to(ws.counts.dtype))
    return ws


def valid_mask(spec: WindowSpec, ws: WindowState, now: int) -> torch.Tensor:
    """``[n_buckets] bool`` — slots whose window is inside
    ``(now - interval, now]``."""
    age = int(now) - ws.starts
    return (age >= 0) & (age < spec.interval_ms)


def _masked_sum(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # jnp.sum keeps int32 (no x64); torch.sum would widen to int64
    return torch.sum(rows * mask[None, :].to(rows.dtype), dim=1,
                     dtype=rows.dtype)


def window_sum(
    spec: WindowSpec, ws: WindowState, now: int, channel: int
) -> torch.Tensor:
    """``[n_resources]`` sum of one channel over valid buckets."""
    return _masked_sum(ws.counts[:, :, int(channel)],
                       valid_mask(spec, ws, now))


def window_sum_at(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    channel: int,
    ids: torch.Tensor,
) -> torch.Tensor:
    """``[K]`` valid-bucket sums of one channel at resource rows ``ids``
    (gather first: O(K · n_buckets), independent of the table size)."""
    rows = ws.counts[ids.to(torch.int64), :, int(channel)]
    return _masked_sum(rows, valid_mask(spec, ws, now))


def window_sum_all(spec: WindowSpec, ws: WindowState, now: int):
    """``[n_resources, n_channels]`` sums over valid buckets."""
    mask = valid_mask(spec, ws, now)
    return torch.sum(
        ws.counts * mask[None, :, None].to(ws.counts.dtype), dim=1,
        dtype=ws.counts.dtype,
    )


def rebase(ws: WindowState, delta_ms: int) -> WindowState:
    """Shift the engine epoch forward by ``delta_ms``, in place (NEVER stays
    NEVER)."""
    ws.starts.copy_(
        torch.where(ws.starts == NEVER, ws.starts, ws.starts - int(delta_ms))
    )
    return ws


# ---------------------------------------------------------------------------
# Future (occupy/borrow) windows — FutureBucketLeapArray analog: a slot is
# valid when its window lies strictly in the future within the next interval.
# ---------------------------------------------------------------------------


def future_valid_mask(spec: WindowSpec, ws: WindowState, now: int):
    ahead = ws.starts - int(now)
    return (ahead > 0) & (ahead <= spec.interval_ms)


def future_sum(
    spec: WindowSpec, ws: WindowState, now: int, channel: int
) -> torch.Tensor:
    """``[n_resources]`` counts waiting in future windows."""
    return _masked_sum(ws.counts[:, :, int(channel)],
                       future_valid_mask(spec, ws, now))


def future_sum_at(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    channel: int,
    ids: torch.Tensor,
) -> torch.Tensor:
    """``[K]`` future-window sums at resource rows ``ids``."""
    rows = ws.counts[ids.to(torch.int64), :, int(channel)]
    return _masked_sum(rows, future_valid_mask(spec, ws, now))


def add_future(
    spec: WindowSpec,
    ws: WindowState,
    now: int,
    wait_ms: torch.Tensor,
    resource_ids: torch.Tensor,
    channel_ids: torch.Tensor,
    values: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> WindowState:
    """Scatter-add into the bucket ``wait_ms`` ahead of ``now``, in place
    (``OccupiableBucketLeapArray.addWaiting``).

    The target offset is clamped to ``[1, B-1]`` buckets ahead. Rows with
    ``wait_ms <= 0`` or ``valid=False`` contribute neither counts nor slot
    resets. The reference gates the full-tensor reset multiply behind a
    ``lax.cond``; here it always runs (multiplying by 1 is exact), which
    keeps the step free of device-to-host syncs.
    """
    now = int(now)
    wait_ms = wait_ms.to(torch.int32)
    row_ok = wait_ms > 0
    if valid is not None:
        row_ok = row_ok & valid
    values = torch.where(row_ok, values, 0)

    _, cur_start = bucket_index(spec, now)
    future_time = wait_ms + now
    k = floordiv(future_time - cur_start, spec.bucket_ms)
    k = torch.clamp(k, 1, spec.n_buckets - 1)
    start = k * spec.bucket_ms + cur_start
    idx = torch.remainder(floordiv(start, spec.bucket_ms), spec.n_buckets)
    start = torch.where(row_ok, start, NEVER).to(torch.int32)

    desired = torch.full_like(ws.starts, NEVER)
    desired.scatter_reduce_(0, idx.to(torch.int64), start, "amax")
    needs_reset = (desired != NEVER) & (desired != ws.starts)
    keep = (~needs_reset).to(ws.counts.dtype)
    ws.counts.mul_(keep[None, :, None])
    ws.starts.copy_(torch.where(needs_reset, desired, ws.starts))
    _scatter_add_(ws.counts, resource_ids, idx, channel_ids, values)
    return ws
