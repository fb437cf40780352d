"""One run of one cell: find its configuration, traffic mix and metrics by
the names in ``BENCHMARK.json``, set the server up, drive it from the load
generator for the window, check what it answered against the plain
reference, and print the result.

Everything that belongs to one configuration kind, traffic mix or metric
lives in a file of its own, found by name: ``kinds/<kind>.py`` (the
configuration file's ``kind``) sets the program up and checks it,
``traffic/<traffic>.json`` is the mix, ``metrics/<metric>.py`` reads one
metric from the run (:class:`Context`). Adding a cell or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pickle
import struct
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "sentinel_tpu")
# the traced part of a --trace 1 window, at its end
TRACE_SLICE_S = 1.0
# how long the load generator waits past the window for replies still due
DRAIN_S = 60.0


class RunError(RuntimeError):
    """The run cannot produce a result (it prints none)."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise RunError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell's entries and files: ``workload``, ``config`` (the
    parsed file), ``traffic`` (the parsed mix), ``end_to_end`` and
    ``per_layer`` (the metric entries it reports)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(
        workload=w, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )


def reader(metric: str):
    return load_module(os.path.join(HERE, "metrics", metric + ".py"),
                       "portbench_metric_" + metric.replace(".", "_"))


def kind(name: str):
    return load_module(os.path.join(HERE, "kinds", name + ".py"),
                       "portbench_kind_" + name)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are a forbidden name whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class LoadGen:
    """The load generator process (``loadgen.py``), pinned to ``cpu``."""

    def __init__(self, job: dict, cpu: Optional[int]):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
        if cpu is not None:
            os.sched_setaffinity(self.proc.pid, {cpu})
        self.proc.stdin.write((json.dumps(job) + "\n").encode())
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if line.strip() != b"ready":
            self.kill()
            raise RunError("the load generator did not start")

    def go(self, t_end: float) -> None:
        self.proc.stdin.write(f"go {t_end!r}\n".encode())
        self.proc.stdin.flush()

    def results(self) -> dict:
        head = self.proc.stdout.read(8)
        if len(head) != 8:
            self.kill()
            raise RunError("the load generator ended without results")
        (n,) = struct.unpack(">Q", head)
        out = pickle.loads(self.proc.stdout.read(n))
        self.proc.wait(timeout=30)
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


class Context:
    """What a metric reader may read of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_done(self) -> np.ndarray:
        """The load generator's requests completed inside the window:
        ``[k, 4]`` of (time, round trip s, device verdicts, refused)."""
        d = self.loadgen["done"]
        return d[(d[:, 0] >= self.t0) & (d[:, 0] < self.t1)]

    def server_delta(self, key: str) -> float:
        return self.server_after[key] - self.server_before[key]


def sleep_until(t: float) -> None:
    while True:
        dt = t - time.monotonic()
        if dt <= 0:
            return
        time.sleep(min(dt, 0.5))


def host_line(torch) -> str:
    """The host and card facts printed beside every run."""
    threads = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                threads = int(line.split()[1])
    smi = "nvidia-smi not found"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.limit,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return (f"host: cpus={len(os.sched_getaffinity(0))} threads={threads} "
            f"torch={torch.__version__} cuda={torch.version.cuda} "
            f"card={smi}")


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda",
        loadgen_cpu: Optional[int] = None,
        config_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None,
        plant: Optional[str] = None, control: Optional[str] = None,
        bench: Optional[dict] = None) -> dict:
    """One run; returns the result object (see ``run.py``).
    ``config_override`` / ``traffic_override`` update the cell's files
    (the tests run small sizes on the CPU); ``plant`` names a fault the
    cell's kind plants in the program (the tests show each fails
    ``correct``); ``control`` puts the reference with that guarantee
    broken in the program's place in the comparison (the control, which
    must fail it too); ``bench`` stands in for ``BENCHMARK.json`` (the
    tests add the cells kept for later)."""
    import torch

    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(bench, workload)
    config = {**cell["config"], **(config_override or {})}
    traffic = {**cell["traffic"], **(traffic_override or {})}
    tracer = None
    if trace:
        from portbench import tracing

        tracer = tracing.DeviceTrace(device)
        tracer.prime()
    impl = kind(config["kind"]).Cell(config, traffic, seed, device,
                                     tracing=trace, plant=plant,
                                     seconds=seconds)
    lg = None
    try:
        t_import = time.monotonic()
        port = impl.start()
        t_server = time.monotonic()
        lg = impl.load(port, DRAIN_S, loadgen_cpu)
        t_end = time.monotonic() + float(traffic["warmup_s"]) + seconds
        lg.go(t_end)
        t0 = t_end - seconds
        print(f"setup: to the program {t_import - t_process:.2f} s, program "
              f"{t_server - t_import:.2f} s, load generator "
              f"{t_end - seconds - float(traffic['warmup_s']) - t_server:.2f}"
              f" s, warm-up traffic {float(traffic['warmup_s']):.2f} s",
              file=sys.stderr, flush=True)
        sleep_until(t0)
        before = impl.snapshot()
        t1 = t_end
        if tracer is not None:
            # the slice closes the window: tracing slows the host's launches,
            # so the host's readings stop where it starts
            t1 = t_end - min(TRACE_SLICE_S, seconds / 2)
            sleep_until(t1)
            after = impl.snapshot()
            tracer.start()
            sleep_until(t_end)
            tracer.stop()
        else:
            sleep_until(t_end)
            after = impl.snapshot()
        print(host_line(torch), file=sys.stderr, flush=True)
        lg_out = lg.results()
        lg = None
        peak = impl.memory_peak_bytes()
        spans = impl.host_spans()
        impl.stop()
        t_check = time.monotonic()
        check = impl.check(lg_out, control=control)
        delta = {k: after[k] - before[k] for k in after}
        print(f"window: server {delta}; loadgen sent "
              f"{lg_out['sent_frames']} frames; reference check "
              f"{time.monotonic() - t_check:.1f} s", file=sys.stderr,
              flush=True)
    finally:
        if lg is not None:
            lg.kill()
        impl.stop()
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that the run may not hold: {found}")
    ctx = Context(
        seconds=t1 - t0, t0=t0, t1=t1, loadgen=lg_out,
        server_before=before, server_after=after, check=check,
        trace=tracer.summary(spans) if tracer is not None else None,
        setup_s=t0 - t_process, config=config, traffic=traffic)
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in names:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    done = ctx.window_done()
    missing = len(lg_out["missing"]) * lg_out["rows_per_frame"]
    refused = int(done[:, 3].sum()) if done.size else 0
    answered = int(done[:, 2].sum() + done[:, 3].sum()) if done.size else 0
    checks = check["checks"]
    result = {
        "correct": all(v <= lim for _n, v, lim in checks),
        "attempted": answered + missing,
        "failed": refused + missing,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if torch.device(device).type == "cuda"
            else torch.device(device).type,
            "kind": (torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if tracer is not None:
        s = ctx.trace
        result["device"]["busy_s"] = s["busy_s"]
        result["device"]["window_s"] = s["window_s"]
        result["breakdown"] = s["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def run_cli(args, t_process: float) -> int:
    import torch

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = cell_of(bench, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_process,
                     loadgen_cpu=args.loadgen_cpu)
    except RunError as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
