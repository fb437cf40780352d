"""Whole runs of each cell on the CPU at small sizes: the result line, the
door's framing, and the comparison failing every planted fault and the
control. The card-only test runs the control at the cells' own sizes."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench_small import CELLS, DOOR, ROOT, small_run

PLANTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
FORBIDDEN = {"jax", "jaxlib", "flax", "sentinel_tpu"}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_result_line_keys(workload):
    res = small_run(workload)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_every_frame_is_answered_once_under_its_xid():
    """The load generator rewrites each pre-encoded frame's xid in place
    and cycles the pool: every frame comes back once, under its xid, with
    every row in its place (the reference's replies match by digest)."""
    from portbench import wire

    frame = bytearray(wire.encode_batch_request(0, [5, 6], [1, 1], [0, 0]))
    before = bytes(frame)
    wire.set_xid(frame, 0x12345678)
    assert wire.head(bytes(frame[2:]))[0] == 0x12345678
    assert frame[:2] == before[:2] and frame[6:] == before[6:]
    res = small_run("flow100k-pull16k-door")
    assert res["checks"]["frames_unanswered"]["value"] == 0
    assert res["checks"]["frames_undecided"]["value"] == 0
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["attempted"] % CELLS["flow100k-pull16k-door"]["traffic"][
        "rows_per_frame"] == 0


@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_planted_fault_fails_the_check(workload, plant):
    res = small_run(workload, plant=plant)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_check(workload):
    """The control (the reference with its state left unchanged by every
    step, so nothing ever fills a window) in the program's place."""
    res = small_run(workload, control="state_unchanged")
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3000000101, 3000000102, 3000000103])
@pytest.mark.parametrize("workload", sorted(set(CELLS) - {DOOR}))
def test_control_fails_at_the_cells_size(cuda, workload, seed):
    import time

    from portbench import harness

    res = harness.run(workload, seed, 10.0, False, time.monotonic(),
                      control="state_unchanged")
    print(json.dumps({"workload": workload, "seed": seed,
                      "checks": res["checks"]}))
    assert res["correct"] is False, res["checks"]


def test_no_forbidden_module_in_a_run():
    """A run holds no module whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``sentinel_tpu`` (compared whole: ``sentinel_tpu_torch`` is
    the port), and no file of the benchmark imports one."""
    code = (
        "import sys, json; sys.path.insert(0, 'portbench/tests');"
        "from portbench_small import small_run;"
        "small_run('param256-paramflow-door');"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sentinel_tpu_torch" in tops
    assert not tops & FORBIDDEN
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module or ""]
                else:
                    continue
                assert not {m.split(".")[0] for m in mods} & FORBIDDEN, (
                    name, mods)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flow100k-pull16k-door", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
