"""The HA snapshot *file* across packages (``sentinel_tpu_torch.ha.snapshot``
against ``sentinel_tpu.ha.snapshot``).

- After the same seeded stream of pulls, reports and param requests, the
  port's snapshot blob (``replication.encode_snapshot_blob``) and its
  ``save_snapshot`` artifact are byte-equal to the JAX package's, for both
  sketches.
- A JAX ``save_snapshot`` artifact restored by the port's
  ``restore_latest``, and the reverse: after the restore the two standbys
  (one of each package) are bit-identical, the artifact each writes back is
  byte-equal, and the next pulls, reports and param requests give equal
  verdicts and state leaves.
- The reference's directory cases (``tests/test_ha_snapshot.py``) on the
  port: retain and prune, numeric order across a digit rollover, a torn or
  corrupt newest artifact, every artifact torn, an empty directory, a
  geometry mismatch, an unknown version, and ``SnapshotManager``'s final
  save.

Every comparison is bitwise; the clocks are both packages' ``ManualClock``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.ha import replication as JR  # noqa: E402
from sentinel_tpu.ha import snapshot as JS  # noqa: E402

from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.ha import replication as TR  # noqa: E402
from sentinel_tpu_torch.ha import snapshot as TS  # noqa: E402
from sentinel_tpu_torch.metrics.ha import (  # noqa: E402
    ha_metrics,
    reset_ha_metrics_for_tests,
)
from torch_ha_check import (  # noqa: E402
    KINDS,
    KW,
    PORT,
    assert_flow_rows_equal,
    assert_standbys_equal,
    manual_clocks,
    same,
    traffic,
)

SNAP = {"jax": JS, "port": TS}


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_snapshot_blob_and_artifact_are_byte_equal(sketch, clocks,
                                                   tmp_path):
    services = [KINDS[k].make(sketch=sketch) for k in ("jax", "port")]
    traffic(services, clocks, np.random.default_rng(11), rounds=8,
            check=lambda kind, outs: same(outs))
    jblob = JR.encode_snapshot_blob(services[0].export_state())
    tblob = TR.encode_snapshot_blob(services[1].export_state())
    assert jblob == tblob
    paths = [SNAP[k].save_snapshot(s, str(tmp_path / k))
             for k, s in zip(("jax", "port"), services)]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert _read(paths[0]) == _read(paths[1])


@pytest.mark.parametrize("primary_kind", ["jax", "port"])
def test_artifact_restores_across_packages(primary_kind, clocks, tmp_path):
    primary = KINDS[primary_kind].make()
    rng = np.random.default_rng(12)
    traffic([primary], clocks, rng, rounds=10, check=lambda k, o: None)
    SNAP[primary_kind].save_snapshot(primary, str(tmp_path / "primary"))
    for c in clocks:
        c.advance(40)
    # cold standbys: the artifact's rules land in the artifact's order
    js, ts = KINDS["jax"].make(rules=False), PORT.make(rules=False)
    assert JS.restore_latest(js, str(tmp_path / "primary"))
    assert TS.restore_latest(ts, str(tmp_path / "primary"))
    assert_standbys_equal(js, ts, "after the restore")
    assert_flow_rows_equal(primary, ts, "the port standby vs the primary")
    # written back by each package: the same bytes under the same name
    jpath = JS.save_snapshot(js, str(tmp_path / "jax"))
    tpath = TS.save_snapshot(ts, str(tmp_path / "port"))
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert _read(jpath) == _read(tpath)

    def check(kind, outs):
        same(outs)
        assert_standbys_equal(js, ts, f"after a {kind}")

    traffic([primary, js, ts], clocks, rng, rounds=4, check=check)


def _warm(clock):
    """A port service with a few pulls in its window."""
    svc = PORT.make()
    svc.request_batch_arrays(np.arange(0, 40, dtype=np.int64))
    clock.advance(30)
    return svc


def _case_retain_prunes_oldest(d, clock):
    donor = _warm(clock)
    paths = []
    for _ in range(5):
        paths.append(TS.save_snapshot(donor, d, retain=3))
        clock.advance(1000)  # a distinct saved_at_ms per artifact
    kept = sorted(os.listdir(d))
    assert len(kept) == 3
    assert os.path.basename(paths[-1]) in kept
    assert os.path.basename(paths[0]) not in kept


def _case_numeric_order_across_digit_rollover(d, clock):
    # lexically "...-999.json" sorts after "...-1000.json"; the order must
    # follow the timestamp, so the newest restores and the oldest prunes
    donor = _warm(clock)
    clock.set_ms(999)
    TS.save_snapshot(donor, d)
    clock.set_ms(1000)
    TS.save_snapshot(donor, d)
    assert TS.load_latest(d)["saved_at_ms"] == 1000
    clock.set_ms(1001)
    TS.save_snapshot(donor, d, retain=2)
    assert sorted(os.listdir(d)) == ["sentinel-snapshot-1000.json",
                                     "sentinel-snapshot-1001.json"]


def _case_corrupt_newest_falls_back(d, clock):
    donor = _warm(clock)
    TS.save_snapshot(donor, d)
    clock.advance(1000)
    good = TS.load_latest(d)
    with open(os.path.join(
            d, f"sentinel-snapshot-{clock.now_ms()}.json"), "w") as f:
        f.write('{"version": 1, "truncated')
    assert TS.load_latest(d) == good
    heir = PORT.make(rules=False)
    assert TS.restore_latest(heir, d) is True
    assert_flow_rows_equal(donor, heir, "restored from the older artifact")


def _case_every_artifact_torn(d, clock):
    path = TS.save_snapshot(_warm(clock), d)
    with open(path, "w") as f:
        f.write('{"truncated": ')
    assert TS.load_latest(d) is None
    assert TS.restore_latest(PORT.make(rules=False), d) is False


def _case_empty_directory_is_a_cold_start(d, clock):
    svc = PORT.make(rules=False)
    assert TS.restore_latest(svc, d) is False
    assert TS.restore_latest(svc, os.path.join(d, "nowhere")) is False
    assert svc.current_rules() == []


def _case_geometry_mismatch_restores_cold(d, clock):
    TS.save_snapshot(_warm(clock), d)
    smaller = DefaultTokenService(EngineConfig(**{**KW, "max_flows": 8}),
                                  device="cpu")
    assert TS.restore_latest(smaller, d) is False
    assert smaller.current_rules() == []


def _case_unknown_version_is_refused(d, clock):
    doc = TS.snapshot_to_doc(_warm(clock))
    doc["version"] = 99
    with pytest.raises(ValueError, match="unsupported snapshot version"):
        TS.decode_snapshot(doc)


def _case_manager_final_save(d, clock):
    manager = TS.SnapshotManager(_warm(clock), d, period_s=3600.0)
    manager.start()
    try:
        first = manager.save_now()
        assert first is not None and os.path.exists(first)
        assert manager.last_path == first
    finally:
        clock.advance(1000)
        manager.stop(final_save=True)
    assert manager.last_path != first  # stop wrote one more artifact
    assert os.path.exists(manager.last_path)
    assert ha_metrics().snapshot()["snapshots"]["save"] == 2
    # a failed save is logged, not raised
    broken = TS.SnapshotManager(manager.service, os.path.join(d, "\0bad"),
                                period_s=3600.0)
    assert broken.save_now() is None and broken.last_path is None


@pytest.mark.parametrize("case", [
    _case_retain_prunes_oldest,
    _case_numeric_order_across_digit_rollover,
    _case_corrupt_newest_falls_back,
    _case_every_artifact_torn,
    _case_empty_directory_is_a_cold_start,
    _case_geometry_mismatch_restores_cold,
    _case_unknown_version_is_refused,
    _case_manager_final_save,
], ids=lambda f: f.__name__[len("_case_"):])
def test_artifact_directory(case, clocks, tmp_path):
    reset_ha_metrics_for_tests()
    case(str(tmp_path), clocks[1])
