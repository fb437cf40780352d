"""The port's shared-memory ring door under torn and hostile writers and
client death, and the doors' raw pull and echo surfaces
(``sentinel_tpu_torch.native.lib``: ``ShmRingClient.fuzz`` / ``rtt_probe``,
``Frontdoor`` / ``ShmDoor`` ``wait_batch`` and ``echo_start`` /
``echo_stop``).

The reference's ``tests/test_shm_door.py`` classes ``TestTornWriter`` and
``TestClientDeath`` through a port ``NativeTokenServer(shm_dir=...)`` on
the CPU, with the port's ring client and codec: the ring's publish protocol
(payload, then length word, then a release-store of the tail) means a
client killed or parked mid-slot-write never publishes the slot, so the
door never reads a torn frame at any ring index, the wrap included; hostile
publishes resolve like TCP garbage; a SIGKILLed client's segment is
reclaimed by the pid sweep; the door keeps serving throughout.
"""

import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.shm_client import (  # noqa: E402
    ShmTokenClient,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    EngineConfig,
)
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native door",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=256)
N_SLOTS = 8  # small ring so tests cross the wrap boundary quickly


@pytest.fixture(scope="module")
def shm_server(tmp_path_factory):
    svc = DefaultTokenService(CFG, device="cpu")
    svc.load_rules([ClusterFlowRule(flow_id=1, count=1e9,
                                    mode=ThresholdMode.GLOBAL)])
    shm_dir = str(tmp_path_factory.mktemp("shm-door"))
    server = NativeTokenServer(svc, port=0, idle_ttl_s=None, shm_dir=shm_dir)
    server.start()
    yield server, shm_dir
    server.stop()


def _ring(shm_dir, **kw):
    from sentinel_tpu_torch.native.lib import ShmRingClient

    return ShmRingClient(shm_dir, **kw)


def _segments(server) -> int:
    return int(server.stats()["shm_segments"])


def _wait_segments(server, want: int, timeout_s: float = 3.0) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        n = _segments(server)
        if n == want:
            return n
        time.sleep(0.02)
    return _segments(server)


def _assert_still_serving(shm_dir):
    c = ShmTokenClient(shm_dir, timeout_ms=3000)
    try:
        assert c.ping()
        out = c.request_batch_arrays(np.full(4, 1, np.int64))
        assert out is not None and (out[0] == int(TokenStatus.OK)).all()
    finally:
        c.close()


def _roundtrip(ring, xid: int) -> None:
    """One 3-row batch through the raw ring; asserts xid exactness and OK
    verdicts: the probe that a torn stage changed nothing."""
    frame = P.encode_batch_request(
        xid, np.full(3, 1, np.int64),
        np.full(3, 1, np.int32), np.zeros(3, np.uint8),
    )
    assert ring.send_frame(frame, timeout_ms=2000)
    payload = ring.recv_payload(timeout_ms=3000)
    assert payload is not None, f"no response for xid {xid}"
    got = struct.unpack(">i", payload[:4])[0]
    assert got == xid, f"xid mismatch: sent {xid}, got {got}"
    n = struct.unpack(">H", payload[5:7])[0]
    assert n == 3
    status = np.frombuffer(payload[7:7 + 9 * 3],
                           np.uint8)[0::9].view(np.int8)
    assert (status == int(TokenStatus.OK)).all()


class TestTornWriter:
    def test_torn_stage_never_read_at_every_boundary(self, shm_server):
        """Stages 0 (full payload and length staged, unpublished) and 1
        (half a payload, no length) at EVERY ring index across two full
        wraps: the door never consumes the staged garbage, and the valid
        frame that overwrites the slot next round-trips with its xid."""
        server, shm_dir = shm_server
        ring = _ring(shm_dir, n_slots=N_SLOTS)
        try:
            garbage = bytes(range(256)) * 4
            for i in range(2 * N_SLOTS + 1):  # crosses the wrap twice
                assert ring.fuzz(garbage, stage=0)
                assert ring.fuzz(garbage, stage=1)
                _roundtrip(ring, xid=100 + i)
            assert ring.alive()
        finally:
            ring.close()
        _assert_still_serving(shm_dir)

    def test_hostile_len_word_drops_segment(self, shm_server):
        """Stage 2 publishes a slot whose length word exceeds the slot: the
        door drops the whole segment (never reads past the slot) and keeps
        serving fresh segments."""
        server, shm_dir = shm_server
        ring = _ring(shm_dir, n_slots=N_SLOTS)
        try:
            assert ring.fuzz(b"x", stage=2)
            with pytest.raises(ConnectionResetError):
                for _ in range(100):  # bounded: the drop lands in ~100 ms
                    payload = ring.recv_payload(timeout_ms=50)
                    assert payload is None
            assert not ring.alive()
        finally:
            ring.close()
        assert _wait_segments(server, 0) == 0
        _assert_still_serving(shm_dir)

    def test_garbage_payload_flows_to_validation(self, shm_server):
        """Stage 3 publishes valid-length garbage, the TCP fuzz corpus's
        hostile bytes: answered, ignored or the segment dropped, the poller
        never wedges and the door keeps serving."""
        server, shm_dir = shm_server
        for blob in (
            b"\xff" * 64,  # bogus type byte
            b"\x00" * 4,  # runt: below header size
            struct.pack(">ib", 5, 5) + b"\xff\xff",  # lying row count
            bytes(range(200)),  # random-ish structure
        ):
            ring = _ring(shm_dir, n_slots=N_SLOTS)
            try:
                assert ring.fuzz(blob, stage=3)
                try:
                    ring.recv_payload(timeout_ms=200)
                except ConnectionResetError:
                    pass  # dropped like a TCP parse violation
            finally:
                ring.close()
            _assert_still_serving(shm_dir)
        assert _wait_segments(server, 0) == 0

    def test_ring_full_backpressure_not_death(self, shm_server):
        """A burst the client does not drain is backpressure, never death:
        every published request is answered or counted in ``ring_full``,
        the segment survives, and the next round trip works."""
        server, shm_dir = shm_server
        full_before = int(server.stats()["shm_ring_full"])
        ring = _ring(shm_dir, n_slots=N_SLOTS)
        try:
            frame = P.encode_batch_request(
                7, np.full(1, 1, np.int64),
                np.full(1, 1, np.int32), np.zeros(1, np.uint8),
            )
            sent = 0
            for _ in range(4 * N_SLOTS):  # no recv: responses back up
                if ring.send_frame(frame, timeout_ms=200):
                    sent += 1
            assert sent >= N_SLOTS
            got = 0
            while ring.recv_payload(timeout_ms=500) is not None:
                got += 1
            dropped = int(server.stats()["shm_ring_full"]) - full_before
            assert got + dropped == sent, (
                f"answered {got} + dropped {dropped} != published {sent}")
            assert ring.alive()
            _roundtrip(ring, xid=4242)
        finally:
            ring.close()


_KILL_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[4])
import numpy as np
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.native.lib import ShmRingClient

shm_dir, advance, stage = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
ring = ShmRingClient(shm_dir, n_slots=8)
frame = P.encode_batch_request(
    1, np.full(1, 1, np.int64), np.full(1, 1, np.int32),
    np.zeros(1, np.uint8),
)
for i in range(advance):  # park the write cursor at the target ring index
    assert ring.send_frame(frame, timeout_ms=2000)
    assert ring.recv_payload(timeout_ms=3000) is not None
assert ring.fuzz(b"torn" * 64, stage)  # mid-slot-write state, unpublished
sys.stdout.write("READY\n")
sys.stdout.flush()
os.kill(os.getpid(), signal.SIGSTOP)  # park until the parent SIGKILLs us
"""


class TestClientDeath:
    @pytest.mark.parametrize(
        "advance,stage",
        [(0, 0), (7, 1), (8, 0)],  # ring start, last index, wrap boundary
    )
    def test_sigkill_mid_write_reclaims_segment(self, shm_server, advance,
                                                stage):
        """A client SIGKILLed parked mid-slot-write: the pid sweep reclaims
        its segment, the torn bytes never surface as a frame, and the door
        keeps serving."""
        server, shm_dir = shm_server
        before = server.stats()
        proc = subprocess.Popen(
            [sys.executable, "-I", "-c", _KILL_CHILD, shm_dir,
             str(advance), str(stage), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            line = proc.stdout.readline()
            assert line.strip() == "READY", (
                f"child failed: {proc.stderr.read()}")
            assert _segments(server) >= 1
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        # the pid sweep (500 ms cadence) reclaims the orphan segment
        assert _wait_segments(server, 0) == 0
        after = server.stats()
        # each advance iteration is exactly one frame; nothing torn counted
        torn_consumed = after["frames_in"] - before["frames_in"] - advance
        assert torn_consumed <= 0, (
            f"server consumed {torn_consumed} unpublished torn frame(s)")
        _assert_still_serving(shm_dir)

    def test_segment_files_unlinked_after_death(self, shm_server):
        """After reclaim, no orphan ``seg-*.ring`` files linger."""
        server, shm_dir = shm_server
        _wait_segments(server, 0)
        rings = [f for f in os.listdir(shm_dir) if f.endswith(".ring")]
        assert rings == []


# -- the doors' raw pull and echo surfaces ------------------------------------
def _frame(xid, n):
    return P.encode_batch_request(xid, np.arange(n, dtype=np.int64) * 3,
                                  np.full(n, 2, np.int32),
                                  (np.arange(n) % 2).astype(np.uint8))


def test_frontdoor_wait_batch_and_submit():
    from sentinel_tpu_torch.native.lib import Frontdoor

    door = Frontdoor("127.0.0.1", 0)
    s = socket.create_connection(("127.0.0.1", door.port), timeout=10)
    try:
        s.sendall(_frame(5, 7) + _frame(6, 3))
        rows = []
        deadline = time.monotonic() + 10
        frames = []
        while sum(len(r) for r in rows) < 10:
            assert time.monotonic() < deadline
            got = door.wait_batch(timeout_ms=100)
            if got is None:
                continue
            ids, counts, prios, fr = got
            assert ids.dtype == np.int64 and prios.dtype == bool
            assert (counts == 2).all()
            rows.append(ids.copy())
            frames.append((fr, len(ids), prios.copy()))
        ids = np.concatenate(rows)
        assert ids.tolist() == [3 * i for i in range(7)] + [0, 3, 6]
        reader = P.FrameReader()
        for fr, n, prios in frames:
            st = np.where(prios, 1, 0).astype(np.int8)
            door.submit(fr, st, np.arange(n, dtype=np.int32),
                        np.zeros(n, np.int32))
        got = []
        while len(got) < 2:
            got += reader.feed(s.recv(1 << 16))
        xids = [P.decode_batch_response(p)[0] for p in got]
        assert xids == [5, 6]
        assert P.decode_batch_response(got[0])[1].tolist() == [
            i % 2 for i in range(7)]
    finally:
        s.close()
        door.stop()


def test_frontdoor_echo_answers_every_row_granted():
    from sentinel_tpu_torch.native.lib import Frontdoor

    door = Frontdoor("127.0.0.1", 0)
    door.echo_start()
    s = socket.create_connection(("127.0.0.1", door.port), timeout=10)
    try:
        reader = P.FrameReader()
        for xid in range(1, 6):
            s.sendall(_frame(xid, 4 * xid))
            got = []
            while not got:
                got = reader.feed(s.recv(1 << 16))
            rx, st, _rem, _wait = P.decode_batch_response(got[0])
            assert rx == xid and st.tolist() == [0] * (4 * xid)
    finally:
        s.close()
        door.echo_stop()
        door.stop()


def test_shm_echo_rtt_probe_and_wait_batch(tmp_path):
    from sentinel_tpu_torch.native.lib import ShmDoor

    door = ShmDoor(str(tmp_path))
    ring = _ring(str(tmp_path), n_slots=N_SLOTS)
    try:
        # a pull through the door's own buffers
        assert ring.send_frame(_frame(9, 5), timeout_ms=2000)
        got = None
        deadline = time.monotonic() + 10
        while got is None:
            assert time.monotonic() < deadline
            got = door.wait_batch(timeout_ms=100)
        ids, counts, prios, fr = got
        assert ids.tolist() == [0, 3, 6, 9, 12] and fr[2].tolist() == [9]
        door.submit(fr, np.zeros(5, np.int8), np.zeros(5, np.int32),
                    np.zeros(5, np.int32))
        payload = ring.recv_payload(timeout_ms=3000)
        assert P.decode_batch_response(payload)[0] == 9
        # the pure-C echo loop, timed from the client's side
        door.echo_start()
        rtt = ring.rtt_probe(_frame(1, 8), iters=200)
        door.echo_stop()
        assert rtt.dtype == np.int64 and rtt.shape == (200,)
        assert (rtt > 0).all()
    finally:
        ring.close()
        door.stop()
