"""The port's rolling stat logger (``sentinel_tpu_torch.metrics.
stat_logger``): the reference's ``tests/test_stat_logger.py`` classes
``TestStatLogger``, ``TestRollingFileWriter`` and ``TestStatLogSearch`` run
against the port's copy on the port's ``ManualClock`` (``TestBlockLogWiring``
needs the local engine, not ported), plus the log directory's resolution and
one seeded stream written byte-equal by both packages' loggers."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.metrics import stat_logger as j_stat_logger  # noqa: E402

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.metrics import stat_logger as t_stat_logger  # noqa: E402
from sentinel_tpu_torch.metrics.stat_logger import (  # noqa: E402
    RollingFileWriter,
    StatEntry,
    StatLogger,
    StatLogSearcher,
    reset_registry_for_tests,
    search_stat_log,
    stat_logger,
)


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture(autouse=True)
def clean_registry():
    reset_registry_for_tests()
    yield
    reset_registry_for_tests()


class TestStatLogger:
    def test_window_aggregation_and_format(self, manual_clock, tmp_path):
        lg = StatLogger("t", interval_ms=1000, log_dir=str(tmp_path))
        base = manual_clock.now_ms() // 1000 * 1000
        manual_clock.set_ms(base)
        for _ in range(3):
            lg.stat("res", "origin")
        lg.stat("res2", "-", count=2)
        lg.stat("rt", value=12.5)
        lg.stat("rt", value=7.5)
        manual_clock.advance(1000)  # next window: first write seals previous
        lg.stat("res", "origin")
        lg.flush()
        lines = (tmp_path / "t.log").read_text().strip().splitlines()
        assert f"{base}|res,origin|3" in lines
        assert f"{base}|res2,-|2" in lines
        assert f"{base}|rt|2,20" in lines
        assert f"{base + 1000}|res,origin|1" in lines

    def test_entry_cap_overflows_are_counted(self, manual_clock, tmp_path):
        lg = StatLogger("cap", interval_ms=1000, log_dir=str(tmp_path),
                        max_entries=2)
        base = manual_clock.now_ms() // 1000 * 1000
        manual_clock.set_ms(base)
        for i in range(5):
            lg.stat(f"k{i}")
        lg.flush()
        text = (tmp_path / "cap.log").read_text()
        assert f"{base}|k0|1" in text
        assert f"{base}|k1|1" in text
        assert f"{base}|__overflow__|3" in text

    def test_registry_returns_same_instance(self, tmp_path):
        a = stat_logger("same", log_dir=str(tmp_path))
        b = stat_logger("same", log_dir=str(tmp_path))
        assert a is b


class TestRollingFileWriter:
    def test_size_roll_with_backups(self, tmp_path):
        path = str(tmp_path / "roll.log")
        w = RollingFileWriter(path, max_bytes=40, max_backups=2)
        w.write_lines(["a" * 30])
        w.write_lines(["b" * 30])  # rolls: roll.log.1 = a's
        w.write_lines(["c" * 30])  # rolls again: .2 = a's, .1 = b's
        assert "c" in open(path).read()
        assert "b" in open(path + ".1").read()
        assert "a" in open(path + ".2").read()
        w.write_lines(["d" * 30])  # oldest (a) dropped
        assert not os.path.exists(path + ".3")
        assert "b" in open(path + ".2").read()


class TestStatLogSearch:
    def test_entry_parses_both_line_formats(self):
        e = StatEntry.from_line("1700000000000|res,origin|3\n")
        assert (e.timestamp_ms, e.key, e.count, e.total) == (
            1700000000000, ("res", "origin"), 3, None)
        v = StatEntry.from_line("1700000001000|rt|2,20.5")
        assert (v.count, v.total) == (2, 20.5)

    def test_search_spans_rotation_boundary(self, tmp_path):
        # three windows written across a forced roll: window 0 lands in
        # .2, window 1 in .1, window 2 in the live file — a range query
        # covering all three must stitch them back in time order
        path = str(tmp_path / "s.log")
        w = RollingFileWriter(path, max_bytes=40, max_backups=3)
        for i in range(3):
            w.write_lines([f"{1000 * (i + 1)}|outcome_reported|{i + 1}"])
        assert os.path.exists(path + ".2"), "roll did not happen"
        found = StatLogSearcher(path, max_backups=3).find(0, 10_000)
        assert [e.timestamp_ms for e in found] == [1000, 2000, 3000]
        assert [e.count for e in found] == [1, 2, 3]
        # range bounds are inclusive and filter per-window
        mid = StatLogSearcher(path, max_backups=3).find(2000, 2000)
        assert [e.count for e in mid] == [2]

    def test_key_prefix_filter_and_torn_lines(self, tmp_path):
        path = str(tmp_path / "k.log")
        w = RollingFileWriter(path, max_bytes=10_000, max_backups=1)
        w.write_lines([
            "1000|outcome_reported,42|7",
            "1000|lease_grant|3",
            "garbage line without pipes",
            "1000|outcome_reported,43|2,55",
        ])
        got = StatLogSearcher(path).find(
            0, 5000, key_prefix=("outcome_reported",))
        assert [e.key for e in got] == [("outcome_reported", "42"),
                                       ("outcome_reported", "43")]
        assert got[1].total == 55.0

    def test_named_search_helper(self, manual_clock, tmp_path):
        lg = StatLogger("searched", interval_ms=1000, log_dir=str(tmp_path))
        base = manual_clock.now_ms() // 1000 * 1000
        manual_clock.set_ms(base)
        lg.stat("outcome_reported", count=16)
        lg.flush()
        got = search_stat_log("searched", base, base + 999,
                              log_dir=str(tmp_path))
        assert len(got) == 1 and got[0].count == 16


def test_log_dir_follows_the_config_key(tmp_path, monkeypatch):
    key = t_stat_logger.LOG_DIR_KEY
    prev = SentinelConfig.get(key)
    try:
        SentinelConfig.set(key, str(tmp_path / "cfg"))
        monkeypatch.setenv("SENTINEL_LOG_DIR", str(tmp_path / "env"))
        assert t_stat_logger.default_stat_log_dir() == str(tmp_path / "cfg")
        SentinelConfig.set(key, "")
        assert t_stat_logger.default_stat_log_dir() == str(tmp_path / "env")
    finally:
        SentinelConfig.set(key, prev or "")


def test_same_stream_same_file_as_the_reference(tmp_path):
    """A seeded stream of keyed and valued stats over several windows,
    through both packages' loggers on their ``ManualClock``s at the same
    millisecond: the files are byte-equal."""
    rng = np.random.default_rng(7)
    start = 1_700_000_000_123
    clocks = (j_clock.ManualClock(start), t_clock.ManualClock(start))
    prev = (j_clock.set_clock(clocks[0]), t_clock.set_clock(clocks[1]))
    try:
        loggers = [m.StatLogger("same", interval_ms=1000,
                                log_dir=str(tmp_path / name), max_entries=6)
                   for m, name in ((j_stat_logger, "jax"),
                                   (t_stat_logger, "port"))]
        for _ in range(200):
            key = ("ev" + str(int(rng.integers(0, 8))),
                   str(int(rng.integers(0, 3))))
            count = int(rng.integers(1, 5))
            value = (float(rng.integers(0, 900)) / 4
                     if rng.random() < 0.3 else None)
            step = int(rng.integers(0, 60))
            for lg, c in zip(loggers, clocks):
                lg.stat(*key, count=count, value=value)
                c.advance(step)
        for lg in loggers:
            lg.flush()
    finally:
        j_clock.set_clock(prev[0])
        t_clock.set_clock(prev[1])
    texts = [(tmp_path / name / "same.log").read_bytes()
             for name in ("jax", "port")]
    assert texts[0] == texts[1] and texts[1].count(b"\n") > 20
    assert b"__overflow__" in texts[1]
