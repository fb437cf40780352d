"""ctypes binding to the native front doors and the local engine's
sliding window (the port's copy of the door half and the window of
``sentinel_tpu/native/lib.py``).

:func:`load` builds the repo's ``native/src/*.cpp`` into
``sentinel_tpu_torch/build/`` at first use (:mod:`.build`) and loads that
library; it never loads the JAX package's library. Unlike the reference,
nothing here degrades to a pure-Python path: a failed build or load raises
with the compiler's output. :class:`Frontdoor` is the epoll TCP door,
:class:`ShmDoor` the shared-memory ring door for co-located clients,
:class:`ShmRingClient` the client half of one ring segment, and
:class:`NativeWindow` the lock-free sliding window behind the local
engine's statistic nodes (``local/stat.py``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    F64 = ctypes.c_double
    sig = {
        # sliding windows of the local engine (sentinel_native.cpp)
        "sn_window_create": ([I32, I32, I32], P),
        "sn_window_destroy": ([P], None),
        "sn_window_add": ([P, I64, I32, F64], None),
        "sn_window_sum": ([P, I64, I32], F64),
        "sn_window_snapshot": ([P, I64, ctypes.POINTER(F64)], None),
        "sn_window_prev_bucket": ([P, I64, I32], F64),
        "sn_window_min_ratio": ([P, I64, I32, I32], F64),
        "sn_window_start_at": ([P, I32], I64),
        "sn_window_count_at": ([P, I32, I32], F64),
        "sn_window_add_future": ([P, I64, I32, F64], None),
        "sn_window_future_waiting": ([P, I64, I32], F64),
        "sn_window_take_matured": ([P, I64, I32], F64),
        "sn_stat_pass": ([P, P, P, I64, F64], None),
        "sn_stat_event": ([P, P, I64, I32, F64], None),
        "sn_stat_rt_success": ([P, P, I64, F64, F64], None),
        "sn_stat_touched_sum": ([P, P, P, I64, I32], F64),
        # native TCP front door (sentinel_frontdoor.cpp)
        "sn_fd_create": ([ctypes.c_char_p, I32, I32], P),
        "sn_fd_port": ([P], I32),
        "sn_fd_stop": ([P], None),
        "sn_fd_destroy": ([P], None),
        "sn_fd_wait_batch": (
            [
                P, I32, ctypes.POINTER(I64), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8), I32, ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(ctypes.c_uint8), I32,
                ctypes.POINTER(I32),
            ],
            I32,
        ),
        "sn_fd_submit": (
            [
                P, I32, ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(I32),
                ctypes.POINTER(I32),
            ],
            None,
        ),
        "sn_fd_send": ([P, I32, I32, ctypes.c_char_p, I32], None),
        "sn_fd_next_control": (
            [
                P, ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8), I32, ctypes.POINTER(I32),
            ],
            I32,
        ),
        "sn_fd_stats": ([P, ctypes.POINTER(ctypes.c_uint64)], None),
        "sn_fd_set_idle_ttl": ([P, I64], None),
        "sn_fd_close_conn": ([P, I32, I32], None),
        # shared-memory ring door (sentinel_shm.cpp)
        "sn_shm_create": ([ctypes.c_char_p, I64, I32], P),
        "sn_shm_stop": ([P], None),
        "sn_shm_destroy": ([P], None),
        "sn_shm_wait_batch": (
            [
                P, I32, ctypes.POINTER(I64), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8), I32, ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(ctypes.c_uint8), I32,
                ctypes.POINTER(I32),
            ],
            I32,
        ),
        "sn_shm_submit": (
            [
                P, I32, ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(I32),
                ctypes.POINTER(I32),
            ],
            None,
        ),
        "sn_shm_send": ([P, I32, I32, ctypes.c_char_p, I32], None),
        "sn_shm_next_control": (
            [
                P, ctypes.POINTER(I32), ctypes.POINTER(I32),
                ctypes.POINTER(ctypes.c_uint8), I32, ctypes.POINTER(I32),
            ],
            I32,
        ),
        "sn_shm_close_conn": ([P, I32, I32], None),
        "sn_shm_stats": ([P, ctypes.POINTER(ctypes.c_uint64)], None),
        "sn_shm_client_create": ([ctypes.c_char_p, I32, I32, I32], P),
        "sn_shm_client_destroy": ([P], None),
        "sn_shm_client_send": ([P, ctypes.c_char_p, I32], I32),
        "sn_shm_client_recv": (
            [P, ctypes.POINTER(ctypes.c_uint8), I32, I32], I32
        ),
        "sn_shm_client_alive": ([P], I32),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> ctypes.CDLL:
    """The loaded native library, built from the checkout's sources on
    first use. Raises ``RuntimeError`` (with the compiler's output) when the
    build fails and ``OSError`` when the library does not load."""
    global _lib
    with _lock:
        if _lib is None:
            from sentinel_tpu_torch.native.build import build

            _lib = _configure(ctypes.CDLL(build()))
        return _lib


class Frontdoor:
    """The native epoll TCP front door (``sentinel_frontdoor.cpp``).

    One IO thread owns sockets, framing, decode, and response writes; Python
    pulls whole request batches with :meth:`wait_batch_into` (GIL released
    while blocked), runs the device step, and answers with :meth:`submit`.
    Control-plane frames (PING, param, concurrent) surface through
    :meth:`next_control`; replies go back via :meth:`send`.
    """

    CTRL_FRAME, CTRL_OPEN, CTRL_CLOSE = 0, 1, 2

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 arena_cap: int = 65536):
        lib = load()
        self._lib = lib
        # the arena must fit at least one max-size frame or a full frame
        # could never be admitted and its connection would park forever
        # (MAX_BATCH_PER_FRAME is derived from the wire layout in
        # protocol.py, the single source of truth the C++ codec mirrors)
        from sentinel_tpu_torch.cluster.protocol import MAX_BATCH_PER_FRAME

        arena_cap = max(arena_cap, MAX_BATCH_PER_FRAME)
        # the C side binds with inet_addr (IPv4 literals only) — resolve
        # names like "localhost" here so the API matches the asyncio server
        if host:
            import socket as _socket

            host = _socket.gethostbyname(host)
        self._h = lib.sn_fd_create(host.encode(), port, arena_cap)
        if not self._h:
            raise OSError(f"native front door failed to bind {host}:{port}")
        self.port = int(lib.sn_fd_port(self._h))
        self.arena_cap = arena_cap
        self._ctrl_buf = ctypes.create_string_buffer(70000)
        self._ctrl_lock = threading.Lock()
        self._stopped = False

    def _ptr(self, arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def wait_batch_into(self, staging: dict, timeout_ms: int = 100,
                        max_n: Optional[int] = None):
        """Block for data-plane requests; decoded rows land directly in the
        caller's ``staging`` arrays (``ids`` int64, ``counts`` int32,
        ``prios`` uint8 and the per-frame ``f_fd`` / ``f_gen`` / ``f_xid`` /
        ``f_n`` int32 and ``f_type`` uint8) — the zero-copy intake path: the
        IO thread's arena is memcpy'd once into a recycled staging block
        and never touched by the allocator again. Returns ``None`` on
        timeout, else ``(n, k)`` row/frame counts; the caller owns slicing
        views out of ``staging`` and keeping the block alive until the
        verdicts for those rows have been submitted. ``max_n`` additionally
        clamps to the staging row capacity, and the frame-array length
        bounds how many frames one pull may take (the remainder stays
        queued)."""
        from sentinel_tpu_torch.cluster.protocol import MAX_BATCH_PER_FRAME

        cap = int(staging["ids"].shape[0])
        max_f = int(staging["f_fd"].shape[0])
        if max_n is None:
            max_n = cap
        max_n = min(
            max(int(max_n), MAX_BATCH_PER_FRAME), cap, self.arena_cap
        )
        n_frames = ctypes.c_int32()
        n = self._lib.sn_fd_wait_batch(
            self._h, timeout_ms,
            self._ptr(staging["ids"], ctypes.c_int64),
            self._ptr(staging["counts"], ctypes.c_int32),
            self._ptr(staging["prios"], ctypes.c_uint8),
            max_n,
            self._ptr(staging["f_fd"], ctypes.c_int32),
            self._ptr(staging["f_gen"], ctypes.c_int32),
            self._ptr(staging["f_xid"], ctypes.c_int32),
            self._ptr(staging["f_n"], ctypes.c_int32),
            self._ptr(staging["f_type"], ctypes.c_uint8),
            max_f, ctypes.byref(n_frames),
        )
        if n <= 0:
            return None
        return n, n_frames.value

    def submit(self, frames, status, remaining, wait_ms) -> None:
        """Encode + send verdict frames for a ``wait_batch_into`` pull
        (``frames`` is its per-frame metadata)."""
        import numpy as np

        # every array binds to a local: an unnamed ascontiguousarray copy
        # would be freed the moment _ptr() returns, leaving sn_fd_submit
        # reading freed memory whenever a caller passes a non-contiguous
        # or wrongly-typed array
        f_fd, f_gen, f_xid, f_n, f_type = frames
        f_fd = np.ascontiguousarray(f_fd, np.int32)
        f_gen = np.ascontiguousarray(f_gen, np.int32)
        f_xid = np.ascontiguousarray(f_xid, np.int32)
        f_n = np.ascontiguousarray(f_n, np.int32)
        f_type = np.ascontiguousarray(f_type, np.uint8)
        status = np.ascontiguousarray(status, np.int8)
        remaining = np.ascontiguousarray(remaining, np.int32)
        wait_ms = np.ascontiguousarray(wait_ms, np.int32)
        self._lib.sn_fd_submit(
            self._h, len(f_fd),
            self._ptr(f_fd, ctypes.c_int32),
            self._ptr(f_gen, ctypes.c_int32),
            self._ptr(f_xid, ctypes.c_int32),
            self._ptr(f_n, ctypes.c_int32),
            self._ptr(f_type, ctypes.c_uint8),
            self._ptr(status, ctypes.c_int8),
            self._ptr(remaining, ctypes.c_int32),
            self._ptr(wait_ms, ctypes.c_int32),
        )

    def submit_many(self, frames_list, status, remaining, wait_ms) -> None:
        """Answer SEVERAL ``wait_batch_into`` pulls with one native call.

        ``frames_list`` holds each pull's frame-metadata tuple, in the same
        order their requests are concatenated in the verdict arrays. One
        ``sn_fd_submit`` call means one outbox lock acquisition and one IO
        wakeup for the whole fused group, and the C++ scatter encode can
        group consecutive same-connection frames ACROSS pull boundaries
        into single per-writer buffers."""
        import numpy as np

        if len(frames_list) == 1:
            return self.submit(frames_list[0], status, remaining, wait_ms)
        merged = tuple(
            np.concatenate([np.asarray(fr[i]) for fr in frames_list])
            for i in range(5)
        )
        self.submit(merged, status, remaining, wait_ms)

    def send(self, fd: int, gen: int, frame: bytes) -> None:
        self._lib.sn_fd_send(self._h, fd, gen, frame, len(frame))

    def set_idle_ttl(self, ttl_ms: int) -> None:
        """Enable the IO-thread idle sweep (0 disables)."""
        self._lib.sn_fd_set_idle_ttl(self._h, int(ttl_ms))

    def close_conn(self, fd: int, gen: int) -> None:
        self._lib.sn_fd_close_conn(self._h, fd, gen)

    def next_control(self):
        """``None`` or ``(kind, fd, gen, payload bytes)``."""
        fd = ctypes.c_int32()
        gen = ctypes.c_int32()
        ln = ctypes.c_int32()
        with self._ctrl_lock:
            kind = self._lib.sn_fd_next_control(
                self._h, ctypes.byref(fd), ctypes.byref(gen),
                ctypes.cast(self._ctrl_buf, ctypes.POINTER(ctypes.c_uint8)),
                len(self._ctrl_buf), ctypes.byref(ln),
            )
            if kind < 0:
                return None
            # string_at copies only the written bytes — .raw would build
            # the full 70KB buffer as bytes for every 7-byte PING
            payload = (
                ctypes.string_at(self._ctrl_buf, ln.value)
                if ln.value > 0 else b""
            )
        return kind, fd.value, gen.value, payload

    def stats(self):
        """Counters are independently monotonic (relaxed atomics read
        without a common lock): the dict is NOT a consistent cross-counter
        snapshot — e.g. ``frames_in`` may already include a frame whose
        rows are not yet in ``requests_in``. Consumers diffing two reads
        (bench occupancy math) must clamp derived deltas at zero."""
        import numpy as np

        out = np.zeros(4, np.uint64)
        self._lib.sn_fd_stats(
            self._h, self._ptr(out, ctypes.c_uint64)
        )
        return {
            "frames_in": int(out[0]), "requests_in": int(out[1]),
            "bytes_in": int(out[2]), "bytes_out": int(out[3]),
        }


    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._lib.sn_fd_stop(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self.stop()
            except Exception:
                pass
            self._lib.sn_fd_destroy(h)
            self._h = None


class ShmDoor:
    """The shared-memory ring front door (``sentinel_shm.cpp``).

    Same batch contract as :class:`Frontdoor` — ``wait_batch_into`` /
    ``submit`` / ``submit_many`` / ``next_control`` / ``send`` — so the
    server's intake, reply, and control lanes drive either door through
    one code path. The "fd" of a frame is the client segment id; replies
    are scatter-encoded straight into that client's response ring by the
    C side. A C++ poller thread (spin-then-sleep on a shared futex
    doorbell) replaces the epoll IO thread; co-located clients attach by
    dropping a segment file into ``shm_dir``.
    """

    CTRL_FRAME, CTRL_OPEN, CTRL_CLOSE = 0, 1, 2

    def __init__(self, shm_dir: str, arena_cap: int = 65536,
                 spin_us: Optional[int] = None):
        # Adaptive spin default: on a single-core host the spinner only
        # burns the peer's timeslice (measured: RTT ~= 2x the spin window),
        # so go straight to the futex; with spare cores a short spin dodges
        # the syscall entirely in the steady state.
        if spin_us is None:
            spin_us = 0 if (os.cpu_count() or 1) <= 1 else 100
        lib = load()
        self._lib = lib
        from sentinel_tpu_torch.cluster.protocol import MAX_BATCH_PER_FRAME

        arena_cap = max(arena_cap, MAX_BATCH_PER_FRAME)
        self._h = lib.sn_shm_create(
            os.fsencode(shm_dir), arena_cap, int(spin_us)
        )
        if not self._h:
            raise OSError(f"shm door failed to initialize in {shm_dir!r}")
        self.dir = shm_dir
        self.arena_cap = arena_cap
        self.port = -1  # no TCP endpoint; keeps door-agnostic logging sane
        self._ctrl_buf = ctypes.create_string_buffer(70000)
        self._ctrl_lock = threading.Lock()
        self._stopped = False

    _ptr = Frontdoor._ptr
    # identical pull/answer surface — the ctypes marshaling only differs in
    # the export name, so rebind the TCP door's methods over sn_shm_*
    def wait_batch_into(self, staging: dict, timeout_ms: int = 100,
                        max_n: Optional[int] = None):
        from sentinel_tpu_torch.cluster.protocol import MAX_BATCH_PER_FRAME

        cap = int(staging["ids"].shape[0])
        max_f = int(staging["f_fd"].shape[0])
        if max_n is None:
            max_n = cap
        max_n = min(
            max(int(max_n), MAX_BATCH_PER_FRAME), cap, self.arena_cap
        )
        n_frames = ctypes.c_int32()
        n = self._lib.sn_shm_wait_batch(
            self._h, timeout_ms,
            self._ptr(staging["ids"], ctypes.c_int64),
            self._ptr(staging["counts"], ctypes.c_int32),
            self._ptr(staging["prios"], ctypes.c_uint8),
            max_n,
            self._ptr(staging["f_fd"], ctypes.c_int32),
            self._ptr(staging["f_gen"], ctypes.c_int32),
            self._ptr(staging["f_xid"], ctypes.c_int32),
            self._ptr(staging["f_n"], ctypes.c_int32),
            self._ptr(staging["f_type"], ctypes.c_uint8),
            max_f, ctypes.byref(n_frames),
        )
        if n <= 0:
            return None
        return n, n_frames.value


    def submit(self, frames, status, remaining, wait_ms) -> None:
        import numpy as np

        f_fd, f_gen, f_xid, f_n, f_type = frames
        f_fd = np.ascontiguousarray(f_fd, np.int32)
        f_gen = np.ascontiguousarray(f_gen, np.int32)
        f_xid = np.ascontiguousarray(f_xid, np.int32)
        f_n = np.ascontiguousarray(f_n, np.int32)
        f_type = np.ascontiguousarray(f_type, np.uint8)
        status = np.ascontiguousarray(status, np.int8)
        remaining = np.ascontiguousarray(remaining, np.int32)
        wait_ms = np.ascontiguousarray(wait_ms, np.int32)
        self._lib.sn_shm_submit(
            self._h, len(f_fd),
            self._ptr(f_fd, ctypes.c_int32),
            self._ptr(f_gen, ctypes.c_int32),
            self._ptr(f_xid, ctypes.c_int32),
            self._ptr(f_n, ctypes.c_int32),
            self._ptr(f_type, ctypes.c_uint8),
            self._ptr(status, ctypes.c_int8),
            self._ptr(remaining, ctypes.c_int32),
            self._ptr(wait_ms, ctypes.c_int32),
        )

    submit_many = Frontdoor.submit_many

    def send(self, fd: int, gen: int, frame: bytes) -> None:
        # TCP frames carry a 2-byte length prefix; ring slots carry the
        # payload with the slot len word playing the prefix's role
        payload = frame[2:]
        self._lib.sn_shm_send(self._h, fd, gen, payload, len(payload))

    def set_idle_ttl(self, ttl_ms: int) -> None:
        # liveness is pid-based (the poller sweep), not activity-based
        pass

    def close_conn(self, fd: int, gen: int) -> None:
        self._lib.sn_shm_close_conn(self._h, fd, gen)

    def next_control(self):
        fd = ctypes.c_int32()
        gen = ctypes.c_int32()
        ln = ctypes.c_int32()
        with self._ctrl_lock:
            kind = self._lib.sn_shm_next_control(
                self._h, ctypes.byref(fd), ctypes.byref(gen),
                ctypes.cast(self._ctrl_buf, ctypes.POINTER(ctypes.c_uint8)),
                len(self._ctrl_buf), ctypes.byref(ln),
            )
            if kind < 0:
                return None
            payload = (
                ctypes.string_at(self._ctrl_buf, ln.value)
                if ln.value > 0 else b""
            )
        return kind, fd.value, gen.value, payload

    def stats(self):
        """Counters are independently monotonic (relaxed atomics): the
        dict is NOT a consistent cross-counter snapshot. Consumers diffing
        two reads must clamp derived deltas at zero."""
        import numpy as np

        out = np.zeros(10, np.uint64)
        self._lib.sn_shm_stats(self._h, self._ptr(out, ctypes.c_uint64))
        return {
            "frames_in": int(out[0]), "requests_in": int(out[1]),
            "bytes_in": int(out[2]), "bytes_out": int(out[3]),
            "shm_polls": int(out[4]), "shm_doorbells": int(out[5]),
            "shm_ring_full": int(out[6]), "shm_segments": int(out[7]),
            "shm_req_slots_used": int(out[8]),
            "shm_req_slots_total": int(out[9]),
        }


    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._lib.sn_shm_stop(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self.stop()
            except Exception:
                pass
            self._lib.sn_shm_destroy(h)
            self._h = None


class ShmRingClient:
    """Low-level client half of one shm segment (``sn_shm_client_*``).

    Byte-level transport only: callers hand it full wire frames (with the
    2-byte length prefix, exactly what the TCP socket would carry) and get
    response payloads back; the prefix is stripped/re-added here so
    ``cluster.shm_client`` reuses the ``protocol.py`` codecs verbatim.
    Raises ``ConnectionRefusedError`` when no live door owns ``shm_dir``.
    """

    def __init__(self, shm_dir: str, slot_payload: int = 65536,
                 n_slots: int = 16, spin_us: Optional[int] = None):
        if spin_us is None:  # same adaptive rule as ShmDoor
            spin_us = 0 if (os.cpu_count() or 1) <= 1 else 50
        lib = load()
        self._lib = lib
        self._h = lib.sn_shm_client_create(
            os.fsencode(shm_dir), int(slot_payload), int(n_slots),
            int(spin_us)
        )
        if not self._h:
            raise ConnectionRefusedError(
                f"no live shm door in {shm_dir!r}"
            )
        self._rbuf = ctypes.create_string_buffer(70000)
        self._lock = threading.Lock()

    def send_frame(self, frame: bytes, timeout_ms: int = 100) -> bool:
        """Publish one length-prefixed wire frame. Spins/backs off while
        the request ring is full, up to ``timeout_ms``. False = give up
        (ring still full); raises ``ConnectionResetError`` once the server
        dropped the segment or died."""
        import time as _time

        payload = frame[2:]
        deadline = _time.monotonic() + timeout_ms / 1000.0
        while True:
            h = self._h
            if not h:
                raise ConnectionResetError("shm segment closed")
            rc = self._lib.sn_shm_client_send(h, payload, len(payload))
            if rc == 1:
                return True
            if rc < 0:
                raise ConnectionResetError("shm door dropped this segment")
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.0002)

    def recv_payload(self, timeout_ms: int = 100) -> Optional[bytes]:
        """One response frame payload (no length prefix), or ``None`` on
        timeout; raises ``ConnectionResetError`` when the server is gone."""
        with self._lock:
            n = self._lib.sn_shm_client_recv(
                self._h,
                ctypes.cast(self._rbuf, ctypes.POINTER(ctypes.c_uint8)),
                len(self._rbuf), int(timeout_ms),
            )
            if n > 0:
                return ctypes.string_at(self._rbuf, n)
        if n < 0:
            raise ConnectionResetError("shm door dropped this segment")
        return None


    def alive(self) -> bool:
        return bool(self._lib.sn_shm_client_alive(self._h))

    def close(self) -> None:
        h = self._h
        if h:
            self._h = None
            self._lib.sn_shm_client_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWindow:
    """Sliding window backed by the native library: the API of
    ``local.stat.HostWindow`` plus the future (occupy) ops. The library is
    built at the first window's construction; a failed build raises."""

    __slots__ = ("_lib", "_h", "bucket_ms", "n_buckets", "n_channels",
                 "interval_ms")

    def __init__(self, bucket_ms: int, n_buckets: int, n_channels: int):
        lib = load()
        self._lib = lib
        self._h = lib.sn_window_create(bucket_ms, n_buckets, n_channels)
        if not self._h:
            raise MemoryError("sn_window_create failed")
        self.bucket_ms = bucket_ms
        self.n_buckets = n_buckets
        self.n_channels = n_channels
        self.interval_ms = bucket_ms * n_buckets

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sn_window_destroy(h)
            self._h = None

    def add(self, now: int, chan: int, n: float = 1.0) -> None:
        self._lib.sn_window_add(self._h, now, chan, n)

    def sum(self, now: int, chan: int) -> float:
        return self._lib.sn_window_sum(self._h, now, chan)

    def qps(self, now: int, chan: int) -> float:
        return self.sum(now, chan) * 1000.0 / self.interval_ms

    def snapshot(self, now: int) -> list:
        out = (ctypes.c_double * self.n_channels)()
        self._lib.sn_window_snapshot(self._h, now, out)
        return list(out)

    def previous_bucket(self, now: int, chan: int) -> float:
        return self._lib.sn_window_prev_bucket(self._h, now, chan)

    def min_ratio(self, now: int, num_chan: int, den_chan: int) -> float:
        return self._lib.sn_window_min_ratio(self._h, now, num_chan, den_chan)

    def start_at(self, b: int) -> int:
        return self._lib.sn_window_start_at(self._h, b)

    def count_at(self, b: int, chan: int) -> float:
        return self._lib.sn_window_count_at(self._h, b, chan)

    # future/occupy ops (FutureWindow analog; use a dedicated instance)
    def add_future(self, future_time: int, n: float, chan: int = 0) -> None:
        self._lib.sn_window_add_future(self._h, future_time, chan, n)

    def future_waiting(self, now: int, chan: int = 0) -> float:
        return self._lib.sn_window_future_waiting(self._h, now, chan)

    def take_matured(self, now: int, chan: int = 0) -> float:
        return self._lib.sn_window_take_matured(self._h, now, chan)
