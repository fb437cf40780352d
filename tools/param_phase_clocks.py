#!/usr/bin/env python3
"""Per-phase device clocks of one count-min param launch (``csrc/cms.cu``).

    python3 tools/param_phase_clocks.py [N ...]     (default 8 64 65 1024 4096)

Copies ``sentinel_tpu_torch/csrc`` to ``sentinel_tpu_torch/build/
phase_clocks/`` (git-ignored), inserts ``clock64()`` stamps into the copy
(thread 0 of the block, at each phase boundary: prologue and roll, per-row
estimate, the sort's fill, digit check and four passes (zero, count, scan,
scatter), staging, the three admission passes, the adds), builds it with
the port's ``nvcc`` flags, runs a warmed step of ``chip_smoke.py`` phase 4's
workload that does not roll at each ``N``, and prints the cycles between
stamps. The stamps are thread 0's view: a phase that ends at a barrier
includes the wait for the slowest warp. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

STAMPS = (
    "#define STAMP(i) do { if (threadIdx.x == 0) "
    "stamp_clk[i] = clock64(); } while (0)\n")
NAMES = {0: "start", 1: "prologue", 2: "rows", 3: "fill", 4: "sort_end",
         5: "stage", 6: "pass1", 7: "pass2", 8: "pass3", 9: "admit_out",
         10: "admit", 11: "adds", 20: "digit_check"}
for _p in range(4):
    for _j, _n in enumerate(("zero", "count", "scan", "scatter")):
        NAMES[21 + 4 * _p + _j] = f"sort{_p}_{_n}"

# (file, anchor, replacement): where the stamps go in the copy
PATCHES = (
    ("seg_scan.cuh", "namespace seg {",
     "__device__ long long stamp_clk[64];\n" + STAMPS + "namespace seg {"),
    ("seg_scan.cuh", "  const uint32_t varying = a ^ o;\n",
     "  const uint32_t varying = a ^ o;\n  int pass_no = 0;\n  STAMP(20);\n"),
    ("seg_scan.cuh",
     "    for (int e = tid; e < nw * DIGITS; e += nt) sc.hist[e] = 0u;\n"
     "    sync(nt);\n",
     "    for (int e = tid; e < nw * DIGITS; e += nt) sc.hist[e] = 0u;\n"
     "    sync(nt);\n    STAMP(21 + 4 * pass_no);\n"),
    ("seg_scan.cuh", "    sync(nt);\n    scan_counters(sc, nw, nt);\n",
     "    sync(nt);\n    STAMP(22 + 4 * pass_no);\n"
     "    scan_counters(sc, nw, nt);\n    STAMP(23 + 4 * pass_no);\n"),
    ("seg_scan.cuh", "    sync(nt);\n    in_b = !in_b;\n",
     "    sync(nt);\n    STAMP(24 + 4 * pass_no);\n    ++pass_no;\n"
     "    in_b = !in_b;\n"),
    ("param_common.cuh",
     "  const bool in_b = seg::radix_sort(ka, kb, va, vb, n, nt, sc);\n",
     "  STAMP(3);\n"
     "  const bool in_b = seg::radix_sort(ka, kb, va, vb, n, nt, sc);\n"
     "  STAMP(4);\n"),
    ("param_common.cuh",
     "  for (int pass = 0; pass < REFINE_ITERS; ++pass) {\n"
     "    bool f = false;",
     "  STAMP(5);\n  for (int pass = 0; pass < REFINE_ITERS; ++pass) {\n"
     "    bool f = false;"),
    ("param_common.cuh",
     "      bits[k] = (b & (HEAD | LIVE)) | (ok ? CUR : 0);\n    }\n  }\n",
     "      bits[k] = (b & (HEAD | LIVE)) | (ok ? CUR : 0);\n    }\n"
     "    STAMP(6 + pass);\n  }\n"),
    ("param_common.cuh",
     "? 1 : 0;\n  seg::sync(nt);\n",
     "? 1 : 0;\n  seg::sync(nt);\n  STAMP(9);\n"),
    ("cms.cu", "  __shared__ param::Smem sm;\n",
     "  __shared__ param::Smem sm;\n  STAMP(0);\n"),
    ("cms.cu",
     "               (long long)D * W, now, cur, cur_start, interval_ms);\n",
     "               (long long)D * W, now, cur, cur_start, interval_ms);\n"
     "  STAMP(1);\n"),
    ("cms.cu", "  param::admit(a, sm);\n",
     "  STAMP(2);\n  param::admit(a, sm);\n  STAMP(10);\n"),
    ("cms.cu", "  if (threadIdx.x == 0) starts[cur] = cur_start;\n}",
     "  if (threadIdx.x == 0) starts[cur] = cur_start;\n  STAMP(11);\n}"),
)
READ = ('\nextern "C" int sentinel_stamps(long long* out, int clear) {\n'
        '  static const long long zero[64] = {};\n'
        '  if (clear) return (int)cudaMemcpyToSymbol(stamp_clk, zero, '
        'sizeof(zero));\n'
        '  return (int)cudaMemcpyFromSymbol(out, stamp_clk, '
        'sizeof(stamp_clk));\n}\n')


def build(src: str, dst: str, nvcc_cmd) -> str:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, anchor, new in PATCHES:
        path = os.path.join(dst, name)
        with open(path) as fh:
            text = fh.read()
        if text.count(anchor) != 1:
            raise SystemExit(f"{name}: anchor not found once: {anchor!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(anchor, new))
    with open(os.path.join(dst, "cms.cu"), "a") as fh:
        fh.write(READ)
    lib = os.path.join(dst, "libcms_stamps.so")
    out = subprocess.run([*nvcc_cmd, "-o", lib, os.path.join(dst, "cms.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    return lib


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("param_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    import torch_param_check as PC

    from sentinel_tpu_torch.engine.param import ParamConfig, make_param_state
    from sentinel_tpu_torch.ops import _build, cms_cuda

    sizes = [int(a) for a in argv] or [8, 64, 65, 1024, 4096]
    lib = ctypes.CDLL(build(str(_build.CSRC_DIR),
                            str(_build.BUILD_DIR / "phase_clocks"),
                            [_build.nvcc_path(), *_build.NVCC_FLAGS]))
    fn = lib.sentinel_cms_decide
    fn.argtypes, fn.restype = cms_cuda._C_ARGTYPES, ctypes.c_int
    words = lib.sentinel_cms_work_words
    words.argtypes = [ctypes.c_int, ctypes.c_int]
    words.restype = ctypes.c_longlong
    read = lib.sentinel_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    cms_cuda._kernel_lib = lambda: (fn, words)

    dev = torch.device("cuda")
    cfg = ParamConfig(sketch="cms")
    kernel, _ = PC.step_fns("cms")
    print(torch.cuda.get_device_name(0), flush=True)
    for n in sizes:
        batches, nows = PC.kernel_batches(cfg, n, seed=100 + n)
        st = make_param_state(cfg, device=dev)
        cols, now = PC.to_device(batches[-1], dev), nows[-1]
        for _ in range(3):  # the first rolls; then warm
            kernel(st, cols, now, cfg.bucket_ms)
        buf = (ctypes.c_longlong * 64)()
        torch.cuda.synchronize()
        if read(None, 1) != 0:
            raise SystemExit("clearing the stamps failed")
        kernel(st, cols, now, cfg.bucket_ms)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf), 0) != 0:
            raise SystemExit("reading the stamps failed")
        t = {i: buf[i] for i in NAMES if buf[i]}
        order = sorted(t, key=t.get)
        parts, prev = [], t[order[0]]
        for i in order[1:]:
            parts.append(f"{NAMES[i]} {t[i] - prev}")
            prev = t[i]
        print(f"N={n}: {prev - t[order[0]]} cycles: " + ", ".join(parts),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
