"""The flow axis sharded over a mesh of shards (port of
``sentinel_tpu/parallel/sharding.py``).

The mesh has one axis, ``"flows"``. The per-flow leaves of the state and of
the rule table are cut along it: shard ``s`` owns the ``max_flows / S``
consecutive flow rows from ``s * max_flows / S``, on ``devices[s]``. The
leaves the reference replicates (the window ``starts``, the namespace window,
``ns_max_qps`` and ``ns_connected``) are copied to every shard. The host
splits each batch by owner (:func:`split_rows`): a shard steps only the rows
whose flow it owns, a psum gives each the namespace counts of the others'
rows (``engine/decide.py``, ``axis``), and each writes its verdicts into the
batch's positions of its rows. The reference's devices each see the whole
batch and mask the rows they do not own; the verdicts and the state are the
same.

The reference's mesh is one process driving every shard (``shard_map`` over
``jax.devices()``); here it is one thread per shard in one process, each
running the unchanged single-shard core. A ``psum`` or ``pmax`` is an
in-process barrier: each shard hands in its tensor, and the reduction adds
(or maxes) the contributions in rank order on ``devices[0]`` and copies the
result to the shard's device. Every shard runs on its device's current
stream, and the barrier orders the host's enqueues, so a step waits on no
device. ``torch.distributed`` is not used: the service's snapshot, delta and
metrics read every shard from one process, and NCCL cannot put two ranks on
one card.

A mesh may repeat a device: ``[torch.device("cuda", 0)] * 4`` is four
shards on one card, ``[torch.device("cpu")] * 8`` the tests' mesh. On a
mesh of one device a sharded leaf keeps its whole tensor (``base``) and the
shards are views of it, so the global view host code reads costs no copy.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sentinel_tpu_torch._device import resolve_device
from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.decide import (
    RequestBatch,
    ShardAxis,
    VerdictBatch,
    TokenStatus,
    _core_for,
    batch_to,
    host_to_device,
)
from sentinel_tpu_torch.engine.rules import RuleTable
from sentinel_tpu_torch.engine.state import (
    BreakerState,
    EngineState,
    ShapingState,
)
from sentinel_tpu_torch.stats.window import WindowState

# a shard that neither arrives at a collective nor raises within this many
# seconds breaks the barrier, and the step raises
BARRIER_TIMEOUT_S = 600.0


class FlowMesh:
    """An ordered list of devices, one shard each, along one named axis
    (the reference's one-axis ``jax.sharding.Mesh``)."""

    def __init__(self, devices: Sequence, axis: str = "flows"):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a flow mesh needs at least one device")
        self.axis = axis
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def single_device(self) -> bool:
        """Every shard on one device: sharded leaves are views of one
        tensor."""
        return len({str(d) for d in self.devices}) == 1

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i):
        return self.devices[i]

    def __repr__(self) -> str:
        return f"FlowMesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def run(self, fn: Callable[[int, ShardAxis], object]) -> List[object]:
        """``[fn(rank, axis) for every rank]``, one thread per shard (rank 0
        on the caller's), with the axis's collectives between them. If any
        shard raises, the barrier is broken, no shard waits on, and the
        first shard's own exception (in rank order) is raised."""
        coll = _Collective(self.devices)
        with self._lock:
            if self.size > 1 and self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.size - 1,
                    thread_name_prefix=f"{self.axis}-shard",
                )
            futures = [
                self._pool.submit(_run_shard, fn, rank, coll)
                for rank in range(1, self.size)
            ]
            out: List[object] = [None] * self.size
            errors: List[BaseException] = []
            try:
                out[0] = _run_shard(fn, 0, coll)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
            for rank, fut in enumerate(futures, 1):
                try:
                    out[rank] = fut.result()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
        if errors:
            own = [e for e in errors
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or errors)[0]
        return out


def _device_ctx(device: torch.device):
    """The shard's device as the thread's current one: the kernels are
    launched through ctypes, on the thread's current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _run_shard(fn, rank: int, coll: "_Collective"):
    try:
        with _device_ctx(coll.devices[rank]):
            return fn(rank, coll.axis(rank))
    except BaseException:
        coll.barrier.abort()
        raise


class _Collective:
    """The psum and pmax of one sharded call: a barrier, then every shard
    reduces the S contributions in rank order on ``devices[0]``. Two
    alternating slot lists let a shard post its next contribution while a
    slower one still reads the last: nobody passes collective ``k + 1``'s
    barrier before every shard has finished reading collective ``k``."""

    def __init__(self, devices):
        self.devices = devices
        n = len(devices)
        self.barrier = threading.Barrier(n, timeout=BARRIER_TIMEOUT_S)
        self._slots = ([None] * n, [None] * n)
        self._calls = [0] * n

    def reduce(self, rank: int, t: torch.Tensor, op) -> torch.Tensor:
        k = self._calls[rank]
        self._calls[rank] = k + 1
        slots = self._slots[k & 1]
        slots[rank] = t
        self.barrier.wait()
        lead = self.devices[0]
        acc = slots[0].to(lead)
        for part in slots[1:]:
            acc = op(acc, part.to(lead))
        return acc.to(self.devices[rank])

    def axis(self, rank: int) -> ShardAxis:
        return ShardAxis(
            rank=rank,
            size=len(self.devices),
            psum=lambda t: self.reduce(rank, t, torch.add),
            pmax=lambda t: self.reduce(rank, t, torch.maximum),
        )


def make_flow_mesh(devices=None, axis: str = "flows") -> FlowMesh:
    """A mesh over ``devices`` (every CUDA device when None). Repeats are
    allowed: ``[torch.device("cuda", 0)] * 4`` is four shards on one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device(None)  # raises: no card
    return FlowMesh(devices, axis)


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------


class ShardedTensor:
    """One leaf of a flow-sharded state or rule table: ``parts[s]`` on
    ``devices[s]``. A partitioned leaf holds rows ``[s * f, (s + 1) * f)``
    in ``parts[s]``; a replicated leaf holds a whole copy in each. On a mesh
    of one device a partitioned leaf keeps its whole tensor in ``base`` and
    its parts are views of it."""

    __slots__ = ("parts", "replicated", "base")

    def __init__(self, parts, replicated: bool,
                 base: Optional[torch.Tensor] = None):
        self.parts = list(parts)
        self.replicated = bool(replicated)
        self.base = base

    @property
    def shards(self) -> List[torch.Tensor]:
        return self.parts

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def shape(self):
        head = self.parts[0].shape
        if self.replicated:
            return tuple(head)
        return (sum(p.shape[0] for p in self.parts),) + tuple(head[1:])

    def full(self) -> torch.Tensor:
        """The whole leaf on ``devices[0]``: a replicated leaf's first copy,
        a partitioned leaf's ``base``, else its parts gathered (a copy)."""
        if self.replicated:
            return self.parts[0]
        if self.base is not None:
            return self.base
        lead = self.parts[0].device
        return torch.cat([p.to(lead) for p in self.parts])

    def assign_(self, t: torch.Tensor) -> None:
        """Write the whole leaf ``t`` into the shards; storage ``t`` shares
        with a part is not copied onto itself."""
        if self.replicated:
            for p in self.parts:
                if p is not t:
                    p.copy_(t)
            return
        if self.base is not None:
            if t is not self.base:
                self.base.copy_(t)
            return
        lo = 0
        for p in self.parts:
            p.copy_(t[lo:lo + p.shape[0]])
            lo += p.shape[0]

    def clone(self) -> "ShardedTensor":
        if self.base is not None:
            base = self.base.clone()
            return ShardedTensor(base.split(self.parts[0].shape[0]), False,
                                 base)
        return ShardedTensor([p.clone() for p in self.parts],
                             self.replicated)

    def __array__(self, dtype=None, copy=None):
        a = self.full().detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        kind = "replicated" if self.replicated else "sharded"
        return (f"ShardedTensor({kind}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, shards={len(self.parts)})")


def _state_specs() -> EngineState:
    """True where a state leaf is cut along the flow axis, False where it is
    replicated (the reference's ``_state_specs``)."""
    return EngineState(
        flow=WindowState(starts=False, counts=True),
        occupy=WindowState(starts=False, counts=True),
        ns=WindowState(starts=False, counts=False),
        shaping=ShapingState(lpt=True, warm_tokens=True, warm_filled=True),
        outcome=WindowState(starts=False, counts=True),
        breaker=BreakerState(state=True, opened_ms=True, probe_ms=True),
    )


def _rules_specs() -> RuleTable:
    """The rule table's counterpart of :func:`_state_specs`; a table with no
    degrade rules keeps its ``br_*`` columns None."""
    replicated = ("ns_max_qps", "ns_connected")
    return RuleTable(**{f: f not in replicated for f in RuleTable._fields})


def _map_state(fn, state: EngineState, *rest) -> EngineState:
    return EngineState(*(
        type(plane)(*(
            fn(*leaves) for leaves in zip(plane, *(r[i] for r in rest))
        ))
        for i, plane in enumerate(state)
    ))


def _map_rules(fn, rules: RuleTable, *rest) -> RuleTable:
    return RuleTable(*(
        None if leaves[0] is None else fn(*leaves)
        for leaves in zip(rules, *rest)
    ))


def _whole(leaf) -> torch.Tensor:
    return leaf.full() if isinstance(leaf, ShardedTensor) else leaf


def _shard_leaf(leaf, sharded: bool, mesh: FlowMesh,
                copy: bool) -> ShardedTensor:
    t = _whole(leaf)
    devs = mesh.devices
    if not sharded:
        if copy:
            return ShardedTensor([t.to(d, copy=True) for d in devs], True)
        return ShardedTensor([t.to(d) for d in devs], True)
    f = t.shape[0] // mesh.size
    if mesh.single_device:
        base = t.to(devs[0], copy=copy)
        return ShardedTensor(base.split(f), False, base)
    return ShardedTensor(
        [t[s * f:(s + 1) * f].to(d, copy=True) for s, d in enumerate(devs)],
        False,
    )


def _check_even(n_rows: int, mesh: FlowMesh) -> None:
    if n_rows % mesh.size != 0:
        raise ValueError(
            f"max_flows={n_rows} must be divisible by mesh size {mesh.size}"
        )


def shard_state(state: EngineState, mesh: FlowMesh,
                axis: str = "flows") -> EngineState:
    """A copy of ``state`` placed on the mesh: an ``EngineState`` of
    :class:`ShardedTensor` leaves. ``state`` may itself be sharded (onto
    another mesh). ``axis`` is taken for the reference's signature."""
    _check_even(_whole(state.flow.counts).shape[0], mesh)
    return _map_state(
        lambda leaf, spec: _shard_leaf(leaf, spec, mesh, copy=True),
        state, _state_specs(),
    )


def shard_rules(rules: RuleTable, mesh: FlowMesh,
                axis: str = "flows") -> RuleTable:
    """``rules`` placed on the mesh. The step never writes a rule table, so
    on a mesh of one device the parts are views of ``rules``' tensors."""
    _check_even(_whole(rules.valid).shape[0], mesh)
    return _map_rules(
        lambda leaf, spec: _shard_leaf(leaf, spec, mesh, copy=False),
        rules, _rules_specs(),
    )


def gather_state(state: EngineState) -> EngineState:
    """The global view of a sharded state, on the mesh's first device (no
    copy on a mesh of one device; see :meth:`ShardedTensor.full`)."""
    return _map_state(_whole, state)


def scatter_state_(sharded: EngineState, state: EngineState) -> None:
    """Write the global state ``state`` into ``sharded``'s shards."""
    _map_state(lambda s, t: s.assign_(t), sharded, state)


def clone_sharded_state(state: EngineState) -> EngineState:
    return _map_state(lambda leaf: leaf.clone(), state)


def _local(tree_map, tree, rank: int):
    return tree_map(lambda leaf: leaf.parts[rank], tree)


def host_rows(arr, rows) -> np.ndarray:
    """``arr[rows]`` (global row indices, axis 0) as host numpy, shard-aware:
    a partitioned :class:`ShardedTensor` is read shard by shard, each shard
    gathering only the requested rows it owns; a replicated one, a tensor or
    an array in one read."""
    rows = np.asarray(rows, np.int64)
    if not isinstance(arr, ShardedTensor):
        if isinstance(arr, torch.Tensor):
            idx = torch.from_numpy(rows).to(arr.device)
            return arr.index_select(0, idx).cpu().numpy()
        return np.asarray(arr)[rows]
    if arr.replicated:
        return host_rows(arr.parts[0], rows)
    out = np.empty((rows.shape[0],) + tuple(arr.shape[1:]),
                   arr.parts[0][:0].cpu().numpy().dtype)
    seen = np.zeros(rows.shape[0], bool)
    lo = 0
    for part in arr.parts:
        hi = lo + part.shape[0]
        mask = (rows >= lo) & (rows < hi)
        if mask.any():
            out[mask] = host_rows(part, rows[mask] - lo)
            seen |= mask
        lo = hi
    if not seen.all():
        raise ValueError(
            f"host_rows: rows outside the leaf: {rows[~seen].tolist()}"
        )
    return out


def _write_back(sharded: EngineState, rank: int, local: EngineState) -> None:
    """A leaf the core returned as a new tensor is copied into the shard's
    part (the core updates in place, so this is normally a no-op)."""
    def put(leaf, new):
        part = leaf.parts[rank]
        if new is not part:
            part.copy_(new)
    _map_state(put, sharded, local)


class RowSplit(NamedTuple):
    """Which rows of one frame each shard steps (:func:`split_rows`): shard
    ``s`` takes ``rows[cuts[s]:cuts[s + 1]]`` and the same stretch of
    ``runs``."""

    rows: np.ndarray  # int64 positions of the owned rows, grouped by shard
    runs: np.ndarray  # int64 run number of each of those rows
    cuts: np.ndarray  # int64 [size + 1]: where each shard's stretch starts
    n_runs: int  # runs of one owner among the frame's owned rows


def split_rows(slots, f_local: int, size: int) -> RowSplit:
    """Split one frame by owner: shard ``s`` gets the positions of the rows
    whose slot lies in ``[s * f_local, (s + 1) * f_local)``, in batch order;
    no shard gets a row of slot -1 (padding, no rule) or beyond. The owned
    rows fall into runs, maximal stretches of one owner (one a non-empty
    shard when the batch is sorted by slot); each shard's rows carry their
    run numbers for the namespace guard."""
    slots = np.asarray(slots, dtype=np.int64)
    owner = np.where((slots >= 0) & (slots < f_local * size),
                     slots // f_local, -1)
    pos = np.flatnonzero(owner >= 0)
    own = owner[pos]
    head = np.ones(own.shape[0], dtype=bool)
    head[1:] = own[1:] != own[:-1]
    run = np.cumsum(head) - 1
    order = np.argsort(own, kind="stable")
    cuts = np.searchsorted(own[order], np.arange(size + 1))
    return RowSplit(pos[order], run[order], cuts.astype(np.int64),
                    int(head.sum()))


def _host_slots(flow_slot) -> np.ndarray:
    if isinstance(flow_slot, torch.Tensor):
        return flow_slot.cpu().numpy()
    return np.asarray(flow_slot)


def _take(frame: RequestBatch, idx: torch.Tensor) -> RequestBatch:
    """The leaves of ``frame`` at positions ``idx`` (on its device)."""
    return RequestBatch(*(leaf.index_select(0, idx) for leaf in frame))


def _put(out: VerdictBatch, idx: torch.Tensor, v: VerdictBatch) -> None:
    """Write a shard's verdicts into the batch's verdicts at ``idx`` (on the
    verdicts' device)."""
    for dst, src in zip(out, v):
        dst.index_copy_(0, idx, src.to(dst.device))


def make_sharded_decide(
    config: EngineConfig,
    mesh: FlowMesh,
    axis: str = "flows",
    grouped: bool = False,
    uniform: bool = False,
    donate: bool = False,
    depth: Optional[int] = None,
):
    """The sharded step ``(state, rules, batch, now) -> (state', verdicts)``
    over a state from :func:`shard_state` and a table from
    :func:`shard_rules`.

    ``config.max_flows`` must divide evenly by the mesh size. The host
    splits each frame by owner (:func:`split_rows`; the batch's slots are
    read on the host). Each shard runs the single-shard core (the CUDA
    kernel's under ``grouped`` on a card, as ``engine.decide._core_for``
    picks) on its own rows with a :class:`ShardAxis`, and writes their
    verdicts into the batch's verdicts on ``mesh[0]``; a row no shard owns
    answers FAIL (padding) or NO_RULE_EXISTS, as in the reference. A shard
    with no rows in a frame decides none, but meets the others at every
    collective and rolls its windows.

    ``donate=True`` updates the state in place (the port of the reference's
    buffer donation); otherwise the state is copied first and the input
    stays as it was. ``depth=F`` takes ``[F, batch_size]`` stacked frames
    and runs F sharded steps at one ``now``, each frame on the state the
    one before left; verdicts come back ``[F, batch_size]``. ``axis`` is
    taken for the reference's signature: the mesh names its own axis.
    """
    _check_even(config.max_flows, mesh)
    if depth is not None and depth < 2:
        raise ValueError(f"fused depth must be >= 2, got {depth}")
    devs = mesh.devices
    f_local = config.max_flows // mesh.size

    def sharded_step(state, rules, batch, now):
        if not donate:
            state = clone_sharded_state(state)
        now = int(now)
        slots = _host_slots(batch.flow_slot)
        splits = [split_rows(frame, f_local, mesh.size)
                  for frame in (slots[None] if depth is None else slots)]
        on_dev = {str(d): batch_to(batch, d) for d in devs}
        # every frame's rows and runs, on each device in one copy; a shard
        # takes its stretches (views)
        packed = np.concatenate([np.concatenate([sp.rows, sp.runs])
                                 for sp in splits])
        idx_on = {str(d): host_to_device(packed, d) for d in devs}
        base = np.cumsum([0] + [2 * sp.rows.shape[0] for sp in splits])
        valid = on_dev[str(devs[0])].valid
        out = VerdictBatch(
            status=torch.where(valid, int(TokenStatus.NO_RULE_EXISTS),
                               int(TokenStatus.FAIL)).to(torch.int8),
            wait_ms=torch.zeros(valid.shape, dtype=torch.int32,
                                device=valid.device),
            remaining=torch.zeros(valid.shape, dtype=torch.int32,
                                  device=valid.device),
        )

        def shard(rank: int, ax: ShardAxis):
            dev = devs[rank]
            core = _core_for(config, grouped, dev)
            st = _local(_map_state, state, rank)
            rl = _local(_map_rules, rules, rank)
            b = on_dev[str(dev)]
            idx, lead_idx = idx_on[str(dev)], idx_on[str(devs[0])]
            for k, split in enumerate(splits):
                frame = b if depth is None else RequestBatch(
                    *(leaf[k] for leaf in b))
                n = split.rows.shape[0]
                lo = int(base[k] + split.cuts[rank])
                hi = int(base[k] + split.cuts[rank + 1])
                st, v = core(config, st, rl, _take(frame, idx[lo:hi]), now,
                             grouped=grouped, uniform=uniform,
                             axis=ax._replace(runs=idx[lo + n:hi + n],
                                              n_runs=split.n_runs))
                _put(out if depth is None else VerdictBatch(
                    *(leaf[k] for leaf in out)), lead_idx[lo:hi], v)
            _write_back(state, rank, st)

        mesh.run(shard)
        return state, out

    return sharded_step


class MeshState:
    """A service's sharded state and the global view its host code reads and
    writes in place (snapshots, deltas, metrics, leases, reports).

    On a mesh of one device the view's sharded leaves are the shards'
    ``base`` tensors and its replicated leaves are shard 0's copies, so it
    costs no copy; a step first copies shard 0's replicated leaves to the
    other shards, in case host code moved them. On a mesh of several devices
    the view is gathered on ``devices[0]`` at its first read after a step,
    and written back to the shards before the next step.
    """

    def __init__(self, state: EngineState, mesh: FlowMesh):
        self.mesh = mesh
        self.sharded = shard_state(state, mesh)
        self._view: Optional[EngineState] = None

    def view(self) -> EngineState:
        if self._view is None:
            self._view = gather_state(self.sharded)
        return self._view

    def assign(self, state: EngineState) -> None:
        """Make ``state`` (global, on ``devices[0]``) the shards' state."""
        if state is self._view:
            return
        scatter_state_(self.sharded, state)
        self._view = None

    def for_step(self) -> EngineState:
        """The sharded state, with what host code wrote into the view."""
        if self._view is not None:
            scatter_state_(self.sharded, self._view)
            if not self.mesh.single_device:
                self._view = None
        return self.sharded
