"""Versioned token-server state snapshot and restore (the port's copy of
``sentinel_tpu/ha/snapshot.py``; the file format is the reference's, byte
for byte, so either package restores the other's artifact).

The window and sketch tensors live on the card and back cluster-wide
admission: a restarted (or standby) token server that forgets them
over-admits a full window of traffic across every client at once. So the
server periodically captures its state to a host-side artifact and
restores it on startup:

- artifact = one JSON document: ``version``, ``saved_at_ms``, rule sources,
  slot maps, and each window/sketch tensor as
  ``{dtype, shape, data=base64(zlib(raw))}`` — self-describing, greppable
  metadata, compact arrays (the counters are mostly zeros).
- restore goes through ``DefaultTokenService.import_state``: rules reload
  through the normal path and counter rows remap per flow_id, so the
  artifact is valid for a warm standby whose slot assignment differs.
- engine time continues from the snapshot epoch — counters older than one
  window expire on the first masked read instead of resurrecting stale
  quota; a snapshot is never *more* permissive than the truth, only up to
  one window less.

``SnapshotManager`` is the periodic writer (daemon thread, injectable
period); ``save_snapshot``/``restore_latest`` are the one-shot forms server
startup uses.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import zlib
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.cluster.token_service import ClusterParamFlowRule
from sentinel_tpu_torch.engine.rules import (
    decode_degrade_rule,
    decode_rule,
    encode_degrade_rule,
    encode_rule,
)
from sentinel_tpu_torch.metrics.ha import ha_metrics

SNAPSHOT_VERSION = 1
KEY_SNAPSHOT_PERIOD_S = "sentinel.tpu.ha.snapshot.period.s"

_PREFIX = "sentinel-snapshot-"
_SUFFIX = ".json"


# -- array codec -------------------------------------------------------------
def _enc_array(arr: np.ndarray) -> Dict[str, object]:
    arr = np.ascontiguousarray(arr)
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": base64.b64encode(zlib.compress(arr.tobytes())).decode(
            "ascii"
        ),
    }


def _dec_array(doc: Dict[str, object]) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(doc["data"]))
    return np.frombuffer(raw, dtype=np.dtype(doc["dtype"])).reshape(
        doc["shape"]
    ).copy()


def _enc_win(win: Dict[str, np.ndarray]) -> Dict[str, object]:
    return {k: _enc_array(v) for k, v in win.items()}


def _dec_win(doc: Dict[str, object]) -> Dict[str, np.ndarray]:
    return {k: _dec_array(v) for k, v in doc.items()}


# -- document codec ----------------------------------------------------------
def encode_snapshot(state: Dict[str, object]) -> Dict[str, object]:
    """``DefaultTokenService.export_state()`` capture → JSON-safe document."""
    return {
        "version": SNAPSHOT_VERSION,
        "saved_at_ms": int(_clock.now_ms()),
        "engine_now": state["engine_now"],
        "epoch_ms": state["epoch_ms"],
        "wall_ms": state["wall_ms"],
        "ns_max_qps": state["ns_max_qps"],
        "connected": state["connected"],
        "namespace_set": state["namespace_set"],
        "rules": [encode_rule(r) for r in state["rules"]],
        "param_rules": [
            {
                "flow_id": r.flow_id,
                "count": r.count,
                "item_thresholds": [
                    [int(h), float(c)] for h, c in (r.item_thresholds or ())
                ],
                "namespace": r.namespace,
            }
            for r in state["param_rules"]
        ],
        "slot_of": {str(k): int(v) for k, v in state["slot_of"].items()},
        "ns_of": dict(state["ns_of"]),
        "param_slot_of": {
            str(k): int(v) for k, v in state["param_slot_of"].items()
        },
        "flow": _enc_win(state["flow"]),
        "occupy": _enc_win(state["occupy"]),
        "ns": _enc_win(state["ns"]),
        "param": _enc_win(state["param"]),
        # per-flow shaper clocks (absent in pre-shaping snapshots; the
        # importer then starts those slots cold)
        **(
            {"shaping": _enc_win(state["shaping"])}
            if "shaping" in state else {}
        ),
        # per-flow completion-outcome columns (absent in pre-outcome
        # snapshots; the importer then starts those columns cold)
        **(
            {"outcome": _enc_win(state["outcome"])}
            if "outcome" in state else {}
        ),
        # circuit-breaker rules + state columns (absent in pre-breaker
        # snapshots; the importer then restores every breaker CLOSED)
        **(
            {
                "degrade_rules": [
                    encode_degrade_rule(d) for d in state["degrade_rules"]
                ],
            }
            if "degrade_rules" in state else {}
        ),
        **(
            {"breaker": _enc_win(state["breaker"])}
            if "breaker" in state else {}
        ),
        # hierarchy-coordinator ledger piggyback (already JSON-safe; absent
        # when no coordinator is co-located with this pod)
        **({"hier": state["hier"]} if "hier" in state else {}),
    }


def decode_snapshot(doc: Dict[str, object]) -> Dict[str, object]:
    """JSON document → the dict shape ``import_state`` consumes. Raises
    ``ValueError`` on an unknown version."""
    version = doc.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {version!r} "
            f"(this build reads {SNAPSHOT_VERSION})"
        )
    return {
        "engine_now": int(doc["engine_now"]),
        "epoch_ms": int(doc["epoch_ms"]),
        "wall_ms": int(doc["wall_ms"]),
        "ns_max_qps": float(doc["ns_max_qps"]),
        "connected": {str(k): int(v) for k, v in doc["connected"].items()},
        "namespace_set": list(doc["namespace_set"]),
        "rules": [decode_rule(r) for r in doc["rules"]],
        "param_rules": [
            ClusterParamFlowRule(
                int(r["flow_id"]), float(r["count"]),
                tuple((int(h), float(c)) for h, c in r["item_thresholds"])
                or None,
                str(r["namespace"]),
            )
            for r in doc["param_rules"]
        ],
        "slot_of": {int(k): int(v) for k, v in doc["slot_of"].items()},
        "ns_of": {str(k): int(v) for k, v in doc["ns_of"].items()},
        "param_slot_of": {
            int(k): int(v) for k, v in doc["param_slot_of"].items()
        },
        "flow": _dec_win(doc["flow"]),
        "occupy": _dec_win(doc["occupy"]),
        "ns": _dec_win(doc["ns"]),
        "param": _dec_win(doc["param"]),
        **(
            {"shaping": _dec_win(doc["shaping"])}
            if "shaping" in doc else {}
        ),
        **(
            {"outcome": _dec_win(doc["outcome"])}
            if "outcome" in doc else {}
        ),
        **(
            {
                "degrade_rules": [
                    decode_degrade_rule(d) for d in doc["degrade_rules"]
                ],
            }
            if "degrade_rules" in doc else {}
        ),
        **(
            {"breaker": _dec_win(doc["breaker"])}
            if "breaker" in doc else {}
        ),
        **({"hier": doc["hier"]} if "hier" in doc else {}),
    }


def snapshot_to_doc(service) -> Dict[str, object]:
    """One device→host capture, already encoded."""
    return encode_snapshot(service.export_state())


def restore_from_doc(service, doc: Dict[str, object]) -> None:
    service.import_state(decode_snapshot(doc))
    ha_metrics().count_snapshot("restore")


# -- directory artifacts -----------------------------------------------------
def _fsync_dir(directory: str) -> None:
    """Flush a rename to the directory inode (no-op where directories can't
    be opened, e.g. Windows)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_snapshot(service, directory: str, retain: int = 3) -> str:
    """Write one snapshot artifact; atomic (tmp + rename), prunes to the
    newest ``retain`` files. Returns the artifact path."""
    doc = snapshot_to_doc(service)
    os.makedirs(directory, exist_ok=True)
    name = f"{_PREFIX}{doc['saved_at_ms']}{_SUFFIX}"
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        # crash safety: the rename below is only atomic for data already on
        # disk — an unsynced tmp can survive a crash as a torn artifact
        # under the FINAL name
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)  # persist the rename itself
    ha_metrics().count_snapshot("save")
    for stale in _artifacts(directory)[:-max(1, int(retain))]:
        try:
            os.remove(os.path.join(directory, stale))
        except OSError:
            pass
    return path


def _artifact_key(name: str):
    """Numeric value of the embedded save timestamp. Lexical order would
    misplace artifacts across a digit rollover (999 vs 1000 — real under an
    injected ManualClock); names whose timestamp doesn't parse sort oldest
    so they are pruned first and restored last."""
    try:
        return (0, int(name[len(_PREFIX):-len(_SUFFIX)]), name)
    except ValueError:
        return (-1, 0, name)


def _artifacts(directory: str) -> list:
    """Snapshot filenames in the directory, oldest → newest (ordered by the
    embedded save timestamp, numerically; same-ms ties break lexically)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        (n for n in names
         if n.startswith(_PREFIX) and n.endswith(_SUFFIX)),
        key=_artifact_key,
    )


def load_latest(directory: str) -> Optional[Dict[str, object]]:
    """Newest readable artifact in the directory, or None. A torn or
    corrupt newest file falls back to the next-newest (the writer is
    atomic, but the disk under it doesn't have to be)."""
    for name in reversed(_artifacts(directory)):
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            record_log.warning("skipping unreadable snapshot %s", path)
    return None


def restore_latest(service, directory: str) -> bool:
    """Restore the newest artifact into ``service``; False when the
    directory has none (fresh node) or the artifact doesn't fit this
    service's geometry (config changed — start cold rather than corrupt)."""
    doc = load_latest(directory)
    if doc is None:
        return False
    try:
        restore_from_doc(service, doc)
    except ValueError as e:
        record_log.warning("snapshot restore skipped: %s", e)
        return False
    return True


class SnapshotManager:
    """Periodic snapshot writer for a live token service.

    A daemon thread saves every ``period_s`` (default from
    ``sentinel.tpu.ha.snapshot.period.s``); ``save_now()`` forces one
    between ticks (server shutdown uses it). A
    failed save is logged and retried next tick — snapshotting must never
    take the serving path down with it."""

    def __init__(
        self,
        service,
        directory: str,
        period_s: Optional[float] = None,
        retain: int = 3,
    ):
        self.service = service
        self.directory = directory
        self.period_s = float(
            period_s
            if period_s is not None
            else SentinelConfig.get_float(KEY_SNAPSHOT_PERIOD_S, 30.0)
        )
        self.retain = retain
        self.last_path: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SnapshotManager":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sentinel-snapshot", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, final_save: bool = True) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if final_save:
            self.save_now()

    def save_now(self) -> Optional[str]:
        try:
            self.last_path = save_snapshot(
                self.service, self.directory, self.retain
            )
            return self.last_path
        except Exception:
            record_log.exception(
                "snapshot save failed (dir=%s)", self.directory
            )
            return None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.save_now()
