"""What the benchmark's own tests share (run them with ``python -m pytest
portbench/tests``; they import nothing of the JAX package): the repo's root
on the path, and small runs of each cell on the CPU."""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small sizes the CPU runs in seconds: the program's torch-ops cores on the
# CPU against the reference's frozen copies of them
FLOW_SMALL = dict(
    config={"engine": {"max_flows": 3000, "max_namespaces": 64,
                       "batch_size": 1024, "bucket_ms": 100,
                       "n_buckets": 10},
            "rules": {"n_rules": 3000, "count_base": 100.0, "count_mod": 100,
                      "mode": "GLOBAL", "namespaces": 64,
                      "behavior_every": [[97, 1], [89, 2], [83, 3]]},
            "service": {"fuse_depths": [8, 4, 2], "ns_max_qps": 3000.0}},
    traffic={"rows_per_pull": 4096, "rows_per_frame": 1024,
             "pool_pulls": 64, "inflight": 2, "warmup_s": 0.5})
PARAM_SMALL = dict(
    # counts low enough that values cross them within the short window
    config={"engine": {"max_flows": 64, "batch_size": 256},
            "param": {"max_param_rules": 256, "depth": 2, "width": 256,
                      "bucket_ms": 100, "n_buckets": 10, "sketch": "cms",
                      "slim_depth": 2, "slim_width": 64},
            "rules": {"n_rules": 256, "first_id": 10000, "count_lo": 5,
                      "count_hi": 20, "hot_values": 10}},
    traffic={"pool_requests": 512, "inflight": 4, "warmup_s": 0.3})
EMBEDDED_SMALL = dict(
    config=FLOW_SMALL["config"],
    traffic={"rows_per_pull": 1024, "rows_per_frame": 1024,
             "pool_pulls": 64, "warmup_s": 0.5})
DOOR = "flow100k-pull16k-door"
CELLS = {DOOR: FLOW_SMALL,
         "flow100k-pull16k-embedded": EMBEDDED_SMALL,
         "param256-paramflow-door": PARAM_SMALL}


def bench() -> dict:
    """``BENCHMARK.json`` with the door cell that ``PERF.md`` keeps for a
    later benchmark (its files are in place), so the tests drive the door
    as well."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": DOOR, "config": "flow100k",
                           "traffic": "pull16k-door", "chips": 1,
                           "why": "the door cell, kept for later"})
    b["end_to_end"].append({"name": "verdicts_per_s", "unit": "verdicts/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": [DOOR]})
    return b


def small_run(workload: str, seed: int = 1234567890123, seconds: float = 1.5,
              **kw) -> dict:
    """One run of a cell on the CPU at its small size."""
    from portbench import harness

    size = CELLS[workload]
    return harness.run(workload, seed, seconds, False, time.monotonic(),
                       device="cpu", config_override=size["config"],
                       traffic_override=size["traffic"], bench=bench(), **kw)
