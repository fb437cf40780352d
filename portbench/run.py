"""The benchmark of ``sentinel_tpu_torch`` on one or more CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output: a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error). Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()  # set-up runs from here to the first request

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin_away_from_loadgen():
    """The load generator takes the last CPU this process may use; the
    server keeps the others (set before any thread starts, so every thread
    of the server inherits it). Returns the load generator's CPU, or None
    on a single CPU."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None
    os.sched_setaffinity(0, set(cpus[:-1]))
    return cpus[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.loadgen_cpu = _pin_away_from_loadgen()
    # the server's work on the host runs in its own lanes (threads); torch's
    # pool of CPU workers would only spin beside them, on the same CPUs
    os.environ["OMP_NUM_THREADS"] = "1"
    # the program's stat log goes inside the checkout, at a fixed path
    os.environ["CSP_SENTINEL_LOG_DIR"] = os.path.join(
        ROOT, ".portbench", "stat_logs")
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.run_cli(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
