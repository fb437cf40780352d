#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sentinel_tpu_torch/csrc`` (one
``nvcc`` per source, started together), then:

1. holds the decide kernel against its plain PyTorch version on the card,
   bitwise (``torch.equal``), at F=100k flows, 64 namespaces, 10 buckets and
   N = 64 / 1024 / 16384 rows, uniform and mixed acquires, over steps that
   cross a namespace guard and span two seconds, so that the 1 s ring wraps
   onto written columns (rolled and masked) and reads expiring buckets
   (``tests/torch_kernel_check.py`` holds the workloads); then on batches
   shaped against the kernel's grid of segment-owning blocks (heads at and
   beside the blocks' bounds, blocks without a head, segments longer than a
   tile and than a block's range, one flow, a flow per row, rows without a
   rule beside slot 0, a padded tail) at N = 64 / 1025 / 16383 / 16384;
   every step is launched 10 times from the same input state and every
   repeat must be bitwise equal;
2. times the kernel and the plain version at those N with CUDA events, and
   at N=16384 also on the one-flow and the flow-per-row batch; prints the
   grid;
3. drives the service path at full size: ``DefaultTokenService`` with 100k
   flow rules (a shaped subset among them), warmed up, answering
   bounded-Zipf (alpha 1.1) pulls of 64, 1024, 16384 and 65536 rows (the
   last takes the fused depth-4 path) over more than three seconds of
   engine clock; its verdicts must equal those of a second service on the
   torch-ops pipeline, fed the same pulls at the same engine clock, and the
   kernel's launch count must rise by exactly one per device step; after
   every other phase, five more 16384-row pulls of that service under
   ``torch.profiler`` give the device time of a pull and the decide
   kernel's share of it (last, so that the profiler's lasting cost on the
   host's launches enters no other phase's times);
4. holds the CMS and SALSA param kernels against their plain versions,
   bitwise, at the service's default sketch (256 rules, depth 2, width
   2048, two 500 ms buckets) and N = 1 / 8 / 32 / 33 / 64 / 65 / 300 /
   1024 / 2048 / 4096 / 4097 / 9000 (each admission path: one warp up to 64
   rows, the sort in shared memory up to 8192, in the global workspace
   above), over seven steps spanning 2.7 s that roll written buckets, mask
   aged ones, reject rows by the in-batch prefix alone and merge SALSA
   pairs, with admitted rows on both cells of one unmerged pair (staying
   unmerged, and merged by their summed adds), on both indices of a merged
   pair, and acquiring 0 (below 8 rows, one row a step: what one row can
   reach); every SALSA pair no admitted row addressed must keep its bits
   (``tests/torch_param_check.py`` holds the workloads); then times them at
   N = 8 / 64 / 1024 / 4096, a step that does not roll and, apart, steps
   that each roll (zeroing the 4 MiB current plane in the same launch);
5. drives the hot-param path: per sketch, a service on the kernel and one on
   the torch-ops core answer the same ``request_params_token`` stream (256
   rules, Zipf values, one reload that frees and reuses slots) over more
   than two seconds of engine clock with equal verdicts and sketches, one
   kernel launch per request, and host p50 / p99 per request;
6. holds the segment-prefix plan kernel bitwise against its plain version
   and the apply kernel against the mask form, at N = 1 / 31 / 32 / 33 /
   1025 / 5000 / 16384 / 16385 / 65536 on every key shape of
   ``torch_kernel_check.prefix_key_shapes`` (Zipf flow ids, one key, a key
   per row, keys equal in their low 8 or 16 bits, negative keys with the
   int32 extremes); times the plan and the apply at N = 64 / 1024 / 16384;
   runs one ungrouped decide step at F=100k with ``prefix_impl="pallas"``
   that must equal the ``"sort"`` step in verdicts and every state leaf, and
   times its prefix work (one plan, its 13 applies) with CUDA events;
7. after every other phase, besides phase 3's profiled pulls, traces 20
   ``request_params_token`` calls per sketch and counts the CUDA kernels
   each call launched, the param kernel's apart from the torch ops around
   it: exactly one param kernel a call;
8. drives completion reports and circuit breaking at the flow
   configuration of phase 3 with 10,000 breakers (every 10th flow; slow
   ratio, error ratio and error count in turn; a third of them sick): a
   service on the decide kernel and one with ``decide_impl="xla"`` take the
   same seeded stream (``tests/torch_outcome_check.py``) over more than 8 s
   of engine clock, each round pulls of 64, 1024, 16384 and a fused 65536
   rows interleaved with ``report_outcomes`` batches of 64, 1024 and 16384
   rows (about 1% invalid). Verdicts and report counts must be equal at
   every step, the flow, outcome and breaker planes (every plane) at the
   end of every round, ``breaker_stats`` every round and ``outcome_stats``
   at the end; the stream must trip, probe, close and reopen breakers, and
   the decide kernel must launch once per device step; then a lease
   sequence on 1,000 flows (grant, pull, renew, return, expiry) must give
   equal results and flow planes; then it times ``report_outcomes`` (host
   p50 / p99) and the outcome step (CUDA events, with and without the
   breaker columns, beside its byte bound), after checking under torch's
   sync debug mode that the step makes no call that waits for the device;
   after every other phase a traced report counts the CUDA kernels a report
   launches; the host sinks: the breaker-transition counters equal the sum
   of the edges every scan returned, and the stat log's
   ``outcome_reported`` lines the rows both services accepted;
9. serves the port through its front door: the native C++ door (built from
   ``native/src`` with ``g++``) and ``NativeTokenServer`` over the flow
   configuration of phase 3 with phase 8's breakers, the default param
   sketch's 256 rules and three concurrency rules, spoken to over raw
   sockets with the port's ``protocol`` (``tests/torch_door_check.py``).
   In lockstep on a manual clock (one connection, one frame at a time:
   BATCH_FLOW pulls of 64 / 1024 / 16384 rows, the last as four frames,
   FLOW, PARAM_FLOW, OUTCOME_REPORT behind a PING barrier, lease grant /
   renew / return, CONCURRENT acquire / release) every reply must equal a
   twin service on the torch-ops cores, the outcome, breaker and lease
   stats must be equal after, and the decide and count-min kernels must
   launch once per device step and per PARAM_FLOW frame; 24 pipelined
   1024-row frames must each come back once; four clients in a closed loop
   on the system clock send pulls of each size for a few seconds (served
   verdicts/s, RTT p50 / p99, the door's fuse depths and overlapped
   dispatches, no error, one decide launch per frame dispatched);
   PARAM_FLOW RTT per sketch; the scrape's sketch block (fat and slim
   bytes); then, with the door stopped and one namespace moving (its rows
   masked out and answered MOVED), a grouped, a fused (depth 4) dispatch
   and a param step up to its verdict read run under torch's sync debug
   mode;
10. high availability at phase 9's widths (``phase_ha``): a primary door
   replicating every 100 ms to two standby doors, one on the kernels and
   its twin on the torch-ops cores; every frame type refused STANDBY before
   promotion; phase 9's lockstep and a closed loop of pulls, reports and
   param requests through the primary, each tick timed (dirty rows, delta
   bytes, ``export_delta`` and the lock it holds, the standby's apply);
   after the last tick the card standby's rows equal the primary's and
   every leaf its twin's; after promotion the lockstep through the card
   standby equals the twin service, one decide launch a device step and
   one count-min launch a PARAM_FLOW frame; ``save_snapshot`` and
   ``restore_latest`` timed at 100k flows; SALSA fed fat delta rows, card
   standby against twin; the slim against the fat param delta bytes; and
   the failover drill: the primary in a child process, SIGKILLed
   mid-window, the standby's watchdog promotes it, the admissions on a
   metered flow summed over both stay within the window plus one ship
   interval's, and the promoted standby blocks;
11. namespace MOVE between two doors at phase 9's widths (``phase_move``):
   the source serves phase 9's configuration, the destination the odd
   namespaces, a torch-ops twin of the destination imports every document
   it imports. ``ns0`` (the Zipf-hottest flow, ~1,563 flows, four param
   rules) moves after phase 9's lockstep: the source answers MOVED with the
   epoch for every ``ns0`` row of a grouped and a fused pull and counts
   none; the destination's document is the source's last; four lockstep
   rounds of ``ns0`` through the destination equal the twin, one decide
   launch a device step and one count-min launch a PARAM_FLOW frame; a
   MOVE_STATE frame lost between the doors (chaos ``frame_drop`` in a
   proxy) aborts a move of ``ns2`` losslessly and a retry commits; ``ns4``
   moves under a closed loop on the system clock with zero over-admission
   summed over both doors; the SALSA variant (fat rows) moves a param
   namespace with equal verdicts and rows, a folded plane that re-encodes
   to itself and one SALSA launch a request. It prints the move's wall
   ms, the export's ms and lock-held ms, the MOVE_STATE bytes, the
   destination's commit and import ms, the MOVED rows and the
   over-admission;
12. the hierarchy tier, the asyncio door and the token clients at phase
   9's widths (``phase_hier``): phase 9's configuration on the card behind
   the port's asyncio ``TokenServer`` and its torch-ops twin behind a
   second one, spoken to by the port's ``TokenClient`` in lockstep (phase
   9's rounds, then ``set_share_hold`` / ``share_holds`` /
   ``demand_rates`` / ``window_budget`` on 16 held flows with pulls, the
   manual clock crossing bucket and window edges): every answer and every
   state leaf equal, one decide launch a device step and one count-min
   launch a PARAM_FLOW frame, and a 16384-row pull's grouped dispatch
   through the door free of synchronizing calls (sync debug mode); the
   port's ``ShmTokenClient`` pulling 1024 rows through a native door's shm
   ring over the same card service, equal to the twin; the reference's
   hierarchy drill (``benchmarks/ha_drill.py::run_hier_drill``) at 100k
   flows on a manual clock: pod A behind the asyncio door hosting the
   ``GlobalBudgetCoordinator``, pod B behind the native door, 16 global
   flows, bootstrap, skew, flip, a decision burst, a live window, a seeded
   ``conn_reset``, the coordinator dark and the recovery, each gate per
   flow; the ledger through ``export_state`` into a card standby; the
   asyncio door's closed loop (one client), shm and TCP pull RTTs, an agent
   tick, ``set_share_hold`` (and its lock hold), ``demand_rates`` and
   ``reconcile_once`` times;
13. the SDK's ``entry()`` (``sentinel_tpu_torch.local``) with cluster-mode
   rules answered by the card (``phase_sdk``, ``tests/torch_sdk_check.py``):
   6,000 resources, each with a local flow rule (QPS, warm-up, pacing,
   THREAD), every 6th in cluster mode on phase 3's flows 0-999, 256
   cluster-mode param rules on phase 5's sketch, breakers on every 10th, an
   inbound system rule and authority rules, traffic bounded-Zipf from 8
   apps with Zipf parameter values and overlapping entries. 13a: 20,000
   entries on a manual clock with the card service embedded
   (``cluster_api.set_embedded_server``), then with its torch-ops twin from
   the same clock: every verdict and every node's counters equal, one
   decide launch per cluster flow check and one count-min launch per
   cluster param check, every SDK dispatch free of synchronizing calls, and
   no exception raised by the service (a proxy in this script records
   them: the cluster branches would hide one behind the local rule); 13b:
   8 threads on the system clock for 3 s, entry p50 / p99 by rule class
   and entries/s, beside the same rules in local mode; 13c: phase 10's
   drill primary (a child process) and a warm standby on the card behind
   the port's ``FailoverTokenClient`` (``cluster_api.set_client``), 8
   threads of ``entry`` on 16 cluster-mode resources, the primary
   SIGKILLed mid-window: no exception leaves ``entry``, the client
   converges on the promoted standby, over-admission on the metered flow
   within the drill's budget, and with both doors dark the fallback
   policy's BLOCK, PASS and THROTTLE answers and ``stats()`` held to what
   the entries saw;
14. the control plane (``phase_control``): 14a, the Envoy RLS service
   (``cluster.envoy_rls``) at phase 3's flow configuration with 100,000
   descriptors in 16 domains (``tests/torch_rls_check.py``): 5,000 seeded
   ``ShouldRateLimit`` requests through the protobuf codec, every
   response's bytes equal to a torch-ops twin's, one decide launch a
   request, each dispatch sync-free, no exception and no failure-mode
   fallback; 1,000 more through ``co_located_rls`` to a native door's shm
   ring; p50 / p99 of each; 14b, the port's ``RoutingTokenClient`` over
   phase 11's two doors at phase 9's widths: FLOW and PARAM_FLOW rounds
   equal to the owning twin's, a MOVE learned from the MOVED answer and the
   source's pushed shard map, stale maps fenced, one decide launch a FLOW
   frame and one count-min launch a PARAM_FLOW frame, then a live move
   under the router's closed loop with zero over-admission; 14c,
   ``sketch.parity`` at ``ParamConfig()``'s widths for both sketches:
   200,000 keys and 1,000,000 events in 4,096-row batches, one launch a
   batch, zero undercounts (fat and slim), final states bitwise equal to
   the plain versions' (and of a 512-row-batch prefix), the reference's
   slim gate at its own configuration (width 512) and stream, and each
   report's error CDF; 14d, the BATCH_FLOW codec (the native library)
   equal to the reference's numpy bodies at 64, 1,024 and 5,040 rows a
   frame, with the host time of each;
15. the adapters and the data sources (``phase_adapters``,
   ``tests/torch_adapter_check.py``): 3,000 routes behind the port's
   gateway over its WSGI and ASGI middleware, ``@sentinel_resource``
   functions with 256 cluster-mode param rules on phase 5's sketch, every
   6th route in cluster mode on phase 3's flows, gateway rules on route
   ids and API definitions (client IP, header and URL parameter items,
   every match strategy), every rule read from files by the port's
   ``FileRefreshableDataSource`` (the token server's 100,000 flow rules
   through a property listener). 15a: 4,000 seeded requests on a manual
   clock with the card service embedded, then with its torch-ops twin:
   every response (status, headers, body) and every node's counters
   equal, one decide launch per cluster flow check and one count-min
   launch per cluster param check, every dispatch sync-free, no exception
   raised by the service; halfway, three rule files pushed (1% of the
   cluster rules lowered, a gateway rule changed, an API definition
   added): the rule epoch one up, the pushed routes' 429s up, no failed
   refresh. 15b: the WSGI stack behind ``wsgiref``'s threading server, 8
   client threads in a child process for 3 s with the cluster rules and
   with the same rules local (requests/s, p50 / p99 by route class), then
   the cluster rule file polled on its data source's thread: the time
   from a write to the first answer that shows it;
16. the operator's surface (``phase_operator``,
   ``tests/torch_operator_check.py``): 16a, on a manual clock with the card
   service and then its torch-ops twin, ``init_default`` (command center,
   heartbeat to a local fake dashboard), ``setClusterMode`` over HTTP
   promoting a ``NativeTokenServer`` with a ``metrics_port`` over phase
   3's 100,000 flow rules and 256 param rules, 200 seeded 1,024-row pulls
   and 200 PARAM_FLOW frames from a ``TokenClient`` (the admitted rows
   reported every 10th pull), 2,000 SDK entries of phase 13's shape, four
   namespace pushes (``modifyFlowRules``, every count changed), a param
   push, ``modifyFlowConfig``, ``modifyNamespaceSet`` and a port move, four
   scrapes of both exporters, the metric log written each second and read
   back through ``metric``, the snapshot fetched and saved,
   ``ClusterStateManager.to_server`` restoring it into a second service,
   and a mode file flipping the node to client and back to server on a new
   port: every verdict, every command response (less times, pids, host
   names and ports), every exposition series (less the families that
   measure host durations) and every metric-log byte equal to the twin's,
   each push shown in the next pull, one decide launch per device step and
   one count-min launch per param check, each dispatch sync-free,
   heartbeats naming the command port, no failed refresh and no logged
   error; 16b, the card alone on the system clock: scrape ms and bytes, one
   client's closed-loop pull RTT with and without a scrape every 100 ms,
   ``modifyFlowRules`` to success and to the first verdict that shows it,
   ``setClusterMode`` and a port move to the first verdict,
   ``cluster/server/metrics`` and the snapshot fetch;
17. the flow axis sharded over a mesh (``phase_mesh``): phase 3's
   configuration with phase 9's breakers and param rules on
   ``make_flow_mesh([cuda:0] * 4)``, against the same service with no
   mesh, on one manual clock. 17a: phase 3's Zipf pulls (the 65,536-row
   pull as four frames through the fused ladder (4, 2)), reports of the
   admitted rows and 300 param requests, every answer equal, then every
   state leaf (gathered across the shards) and the param sketch; 4 decide
   launches a frame on the mesh, each mesh dispatch sync-free (sync debug
   mode). 17b: the mesh primary's snapshot restored onto a 2-shard and an
   unsharded standby, the three ``export_state`` documents equal in every
   key and the next pulls equal. 17c: ``NativeTokenServer`` over the
   4-shard service and over the unsharded standby, one ``TokenClient``'s
   pulls through each equal. It prints the 16384-row pull p50 with and
   without the mesh and, after every other phase, the decide kernel's
   device time a shard. Four shards on one card check correctness; they
   are no scale-out measurement;
18. the dashboard (``phase_dashboard``, ``tests/torch_dashboard_check.py``):
   on a manual clock with phase 16's card service and then its torch-ops
   twin, the port's ``DashboardServer`` over the app's command center: a
   heartbeat registration, rule CRUD on every type through ``v1/rule``,
   gateway API definitions, ``v2/rules`` published into a
   ``FileRuleStore`` the app reads back (cluster-mode rules among them),
   ``cluster/assign`` promoting the app through its ``server_factory`` to
   the 100,000-flow token server, seeded entries and pulls, lowered counts
   published and the entries again, the ``MetricFetcher``'s pull, the
   metric routes, ``cluster/monitor`` and the unassignment: every answer,
   entry and pull equal to the twin's, the dashboard's metric totals equal
   to the app's metric log, one decide launch per device step, each
   dispatch sync-free; it prints the assignment's and a publish's time to
   their first verdict, the monitor's bytes and ms and the fetcher's pull;
19. prints the timings, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.

Any failed check raises and exits non-zero. With no CUDA device, or run from
a directory without the package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F, NS, B = 100_000, 64, 10
SIZES = (64, 1024, 16384)  # the serve ladder's ends and middle
SHAPED_SIZES = (64, 1025, 16383, 16384)  # batches shaped against the grid
REPEATS = 10  # launches per parity step, all bitwise equal
PULLS = (64, 1024, 16384, 65536)  # the last: 4 full frames, fused depth 4
FUSED_DEPTH = 4
# engine-clock ms between served pulls, cycled: same bucket, a roll, a
# short step and a near-full window, so each round spans 1.1 s of the ring
ADVANCES_MS = (5, 130, 45, 930)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
PARAM_SIZES = (8, 64, 1024, 4096)  # 8: what request_params_token sends
# every admission path and its edges: one warp (<= 32, <= 64 rows), the sort
# in shared memory (<= 8192), in the global workspace (above)
PARAM_CHECK_SIZES = (1, 8, 32, 33, 64, 65, 300, 1024, 2048, 4096, 4097, 9000)
PREFIX_SIZES = (64, 1024, 16384)
# the one-block edges of the plan (16384) and the apply (1024 items)
PREFIX_CHECK_SIZES = (1, 31, 32, 33, 1025, 5000, 16384, 16385, 65536)
PROFILED_PARAM_CALLS = 20
PARAM_REQUESTS = 600  # per sketch, half before and half after a reload
PARAM_ADVANCES_MS = (1, 2, 4, 9)  # engine clock between param requests
SKETCHES = ("cms", "salsa")
# phase 8: one round of pulls and reports (a fused 4-frame pull), 500 ms of
# engine clock; 17 rounds span 8.5 s
OUTCOME_PLAN = (("pull", 64), ("report", 64), ("pull", 1024),
                ("report", 1024), ("pull", 16384), ("report", 16384),
                ("pull", 4 * 16384), ("report", 16384))
OUTCOME_ADVANCES_MS = (20, 60, 35, 90, 45, 120, 60, 70)
OUTCOME_ROUNDS = 17
REPORT_SIZES = (64, 1024, 16384)
LEASE_FLOWS = 1000
# phase 9, the front door: lockstep rounds, closed-loop pull sizes and
# seconds per size, client threads, PARAM_FLOW frames timed per sketch
DOOR_ROUNDS = 4
DOOR_PULLS = SIZES  # 16384 rows go out as four frames
DOOR_SECONDS = 1.5
DOOR_CLIENTS = 4
DOOR_PARAM_REQUESTS = 300
DOOR_CONC_FLOWS = (200_001, 200_002, 200_003)
# phase 10: high availability
HA_INTERVAL_MS = 100  # repl_interval_ms of every primary
HA_ROUNDS = 2  # lockstep rounds through the primary, and after promotion
HA_LOOP_SECONDS = 2.0  # the closed loop on the system clock
HA_LOOP_PULL = 1024
HA_SALSA_TICKS = 5
HA_SALSA_REQUESTS = 40  # param requests a tick
# the failover drill: the reference drill's window (five 500 ms buckets
# hold the whole drill), ship interval and silence bound
HA_DRILL_BUCKET_MS = 500
HA_DRILL_QPS = 60.0  # the metered flow's rule: 300 tokens a window
HA_DRILL_ROWS = 4  # rows of the metered flow a pull
HA_DRILL_RATE = 100.0  # pulls a second
HA_PROMOTE_AFTER_MS = 1000.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (warmed).

    A sleep kernel holds the stream while the host enqueues the calls, so
    the events bracket device work only, not the host's launch overhead
    (which :func:`host_ms` reports)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # ~2 GHz: cycles for twice the host time the enqueue loop needs
    torch.cuda._sleep(int(min(2.0 * reps * per_call_s, 5.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int, torch) -> float:
    """Mean wall ms per call of ``fn``, each call synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def decide_bytes(cols, out, rows_touched: int, tails: int,
                 stale_rows: int) -> int:
    """Bytes the decide step must move: each distinct flow row's [B, E]
    window and [B] occupy row read once, every [N] input column read once,
    every [N] output written once, one [E] write per segment tail, and the
    stale column zeroed when the ring rolls."""
    col_bytes = sum(t.numel() * t.element_size() for t in cols.values())
    out_bytes = sum(t.numel() * t.element_size() for t in out)
    return (rows_touched * B * (6 + 1) * 4 + col_bytes + out_bytes
            + tails * 6 * 4 + stale_rows * 6 * 4)


def phase_parity(torch, dev, cfg, table, state):
    """Kernel vs plain version, bitwise, at every N of the serve ladder."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.ops import decide_cuda as K

    rng = np.random.default_rng(2024)
    zipf = DC.ZipfIds(F, alpha=1.1)
    max_err, checked = 0.0, 0
    tight = table.namespace_id[0]  # flow 0, the hottest id, is in it
    for n in SIZES:
        # a guard budget the pulls cross inside the first steps at every N
        table.ns_max_qps[tight] = float(n // 16)
        for uniform in (True, False):
            c = cfg._replace(batch_size=n)
            nows = [30_040 + dt for dt in DC.STEP_OFFSETS_MS]
            batches = [DC.grouped_batch(c, rng, zipf, n, uniform,
                                        unknown=max(1, n // 100))
                       for _ in nows]
            err, bad, _, statuses, reached = DC.check_steps(
                c, table, state, batches, nows, uniform, repeats=REPEATS)
            torch.cuda.synchronize()
            if bad:
                raise AssertionError(
                    f"kernel != plain at N={n} uniform={uniform}: {bad[:8]}"
                )
            if reached != set(DC.COVERAGE):
                raise AssertionError(
                    f"N={n} uniform={uniform}: the steps reached only "
                    f"{sorted(reached)} of {DC.COVERAGE}"
                )
            max_err = max(max_err, err)
            checked += len(nows)
            seen = torch.bincount(torch.cat(statuses).long().cpu(),
                                  minlength=len(TokenStatus))
            hist = {TokenStatus(i).name: int(c)
                    for i, c in enumerate(seen.tolist()) if c}
            if not seen[int(TokenStatus.TOO_MANY_REQUEST)]:
                raise AssertionError(f"N={n}: the namespace guard never "
                                     f"crossed: {hist}")
            log(f"parity N={n} uniform={uniform}: {len(nows)} steps x "
                f"{REPEATS} launches bitwise equal, ring wrapped onto "
                f"written columns; verdicts {hist}")
    for n in SHAPED_SIZES:
        blocks, chunk = K.launch_grid(n)
        c = cfg._replace(batch_size=n)
        for uniform in (True, False):
            named = DC.adversarial_batches(c, rng, chunk, uniform, F)
            nows = [40_040 + dt for dt in DC.STEP_OFFSETS_MS]
            shapes = set()
            for _, batch in named:
                shapes |= DC.shape_coverage(c, batch, chunk, F)
            missing = DC.required_shapes(n) - shapes
            if missing:
                raise AssertionError(
                    f"N={n} uniform={uniform}: the shaped batches never "
                    f"reached {sorted(missing)}")
            err, bad, _, _, reached = DC.check_steps(
                c, table, state, [b for _, b in named], nows, uniform,
                repeats=REPEATS)
            torch.cuda.synchronize()
            if bad:
                raise AssertionError(
                    f"kernel != plain on shaped batches at N={n} "
                    f"uniform={uniform}: {bad[:8]}")
            if "rolled_written_column" not in reached:
                raise AssertionError(f"N={n}: no shaped step rolled a "
                                     f"written column")
            max_err = max(max_err, err)
            checked += len(nows)
            log(f"parity shaped N={n} uniform={uniform} grid {blocks} x "
                f"{chunk} rows: {[name for name, _ in named]} x {REPEATS} "
                f"launches bitwise equal; reached {sorted(shapes)}")
    return max_err, checked


def phase_timing(torch, dev, cfg, table, state):
    """Kernel and plain-version ms per step, with the byte bound."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.state import clone_state
    from sentinel_tpu_torch.ops import decide_cuda as K

    rng = np.random.default_rng(7)
    zipf = DC.ZipfIds(F, alpha=1.1)

    def time_batch(label, n, batch):
        c = cfg._replace(batch_size=n)
        args = DC.kernel_args(c, table, clone_state(state), batch, 50_010,
                              uniform=True)
        cols = args[6]
        kernel_ms = cuda_ms(lambda: K.decide_rows(*args), 50, torch)
        plain_ms = cuda_ms(lambda: K.decide_rows_plain(*args), 5, torch)
        kernel_wall = host_ms(lambda: K.decide_rows(*args), 20, torch)
        out = K.decide_rows(*args)
        slots = cols["safe_slot"].cpu().numpy()
        touched = int(np.unique(slots).size)
        tails = int(cols["write_ok"].sum())
        nbytes = decide_bytes(cols, out, touched, tails, stale_rows=0)
        ops = 60 * n  # per-row admission arithmetic, a few dozen flops
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       ops / PEAK_F32_OPS_PER_S) * 1e3
        blocks, chunk = K.launch_grid(n)
        longest = int(np.bincount(slots).max())
        log(f"timing {label} N={n}: kernel {kernel_ms:.4f} ms on the device "
            f"({kernel_wall:.4f} ms a call with host launch), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({nbytes} B, {touched} distinct flows, longest segment "
            f"{longest} rows); grid {blocks} blocks, {chunk} nominal rows a "
            f"block")
        return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    wall_ms=kernel_wall, bytes=nbytes,
                    rows_touched=touched, longest_segment=longest,
                    blocks=blocks)

    rows = {}
    for n in SIZES:
        c = cfg._replace(batch_size=n)
        batch = DC.grouped_batch(c, rng, zipf, n, uniform=True,
                                 unknown=max(1, n // 100))
        rows[n] = time_batch("zipf", n, batch)
    # the two extremes of segment length at the largest N
    n = SIZES[-1]
    c = cfg._replace(batch_size=n)
    for label, heads in (("one_flow", np.zeros(n, bool)),
                         ("all_distinct", np.ones(n, bool))):
        batch = DC.batch_from_heads(c, rng, heads, True, F)
        rows[n][label] = time_batch(label, n, batch)
    return rows


def service_rules(ClusterFlowRule, ThresholdMode):
    """100k rules as the repo's bench builds them, with a shaped subset."""
    rules = []
    for i in range(F):
        beh = 1 if i % 97 == 0 else 2 if i % 89 == 0 else \
            3 if i % 83 == 0 else 0
        rules.append(ClusterFlowRule(
            flow_id=i, count=100.0 + (i % 100), mode=ThresholdMode.GLOBAL,
            namespace=f"ns{i % 64}", control_behavior=beh,
        ))
    return rules


def phase_service(torch, dev):
    """The service path at full size, kernel vs torch-ops pipeline."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        EngineConfig,
        ThresholdMode,
    )
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.ops import decide_cuda as K

    mc = clock.ManualClock(1_700_000_000_000)
    prev = clock.set_clock(mc)
    try:
        cfg = EngineConfig(max_flows=F, max_namespaces=NS,
                           batch_size=SIZES[-1])
        rules = service_rules(ClusterFlowRule, ThresholdMode)
        svc = DefaultTokenService(cfg, device=dev)
        ref = DefaultTokenService(cfg._replace(decide_impl="xla"),
                                  device=dev)
        for s in (svc, ref):
            s.load_rules(rules, ns_max_qps=1e9)
            s.warmup()
        zipf = DC.ZipfIds(F, alpha=1.1)
        rng = np.random.default_rng(99)
        pulls = PULLS
        steps_per_round = len(pulls) - 1 + FUSED_DEPTH
        valid = {int(s) for s in TokenStatus}

        # --- the main path, read through the launch count ----------------
        rounds = 3
        t_start = mc.now_ms()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        advances = itertools.cycle(ADVANCES_MS)
        for r in range(rounds):
            for n in pulls:
                ids = zipf(rng, n)
                acq = None if r % 2 == 0 else rng.integers(1, 3, n).astype(
                    np.int32)
                st, rem, wait = svc.request_batch_arrays(ids, acq)
                st_r, rem_r, wait_r = ref.request_batch_arrays(ids, acq)
                if st.shape != (n,) or not set(np.unique(st)) <= valid:
                    raise AssertionError(f"bad statuses for n={n}")
                for name, a, b in (("status", st, st_r),
                                   ("remaining", rem, rem_r),
                                   ("wait", wait, wait_r)):
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"service {name} differs from the torch-ops "
                            f"pipeline at n={n} round={r}"
                        )
                mc.advance(next(advances))
        launches = K.LAUNCHES["decide_rows"]
        spanned = mc.now_ms() - t_start
        if spanned < 2 * cfg.n_buckets * cfg.bucket_ms:
            raise AssertionError(f"the pulls spanned only {spanned} ms")
        if launches != rounds * steps_per_round:
            raise AssertionError(
                f"kernel launched {launches} times for "
                f"{rounds * steps_per_round} device steps"
            )
        log(f"service: {rounds} rounds of pulls {pulls} over {spanned} ms "
            f"equal to the torch-ops pipeline; {launches} kernel launches")

        # --- timing: host clock around each pull (materialized) ----------
        lat = {n: [] for n in pulls}
        for r in range(20):
            for n in pulls:
                ids = zipf(rng, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.request_batch_arrays(ids)
                lat[n].append(time.perf_counter() - t0)
                mc.advance(7)
        stats = {}
        for n in pulls:
            a = np.array(lat[n]) * 1e3
            stats[n] = dict(p50_ms=float(np.percentile(a, 50)),
                            p99_ms=float(np.percentile(a, 99)),
                            decisions_per_s=float(n / (a.mean() / 1e3)))
            log(f"service n={n}: p50 {stats[n]['p50_ms']:.3f} ms, p99 "
                f"{stats[n]['p99_ms']:.3f} ms, "
                f"{stats[n]['decisions_per_s']:.0f} decisions/s")

        def profiled_pulls():
            """Left to the end of the run: once the profiler has traced a
            process, its later launches cost the host more."""
            before = clock.set_clock(mc)
            try:
                return pull_device_time(torch, svc, mc, zipf, rng, SIZES[-1])
            finally:
                clock.set_clock(before)

        return launches, stats, profiled_pulls
    finally:
        clock.set_clock(prev)


def pull_device_time(torch, svc, mc, zipf, rng, n: int, pulls: int = 5):
    """Device time of one served ``n``-row pull, the decide kernel's share
    of it, the device operations a pull (kernels, copies, fills) and the
    five that take the most time, from a ``torch.profiler`` trace of
    ``pulls`` pulls (device rows only, each counted once). The profiler slows the host, so the wall time of
    these pulls is not reported."""
    from torch.profiler import ProfilerActivity, profile

    batches = [zipf(rng, n) for _ in range(pulls)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids in batches:
            svc.request_batch_arrays(ids)
            mc.advance(7)
        torch.cuda.synchronize()
    total_us = kernel_us = 0.0
    ops, by_name = 0, []
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            total_us += evt.self_device_time_total
            ops += evt.count
            by_name.append((evt.self_device_time_total, evt.key[:60],
                            evt.count))
            if "decide_kernel" in evt.key or "roll_kernel" in evt.key:
                kernel_us += evt.self_device_time_total
    if total_us <= 0.0 or kernel_us <= 0.0:
        raise AssertionError(
            f"service n={n}: the profiler showed {total_us} us of device "
            f"time over {pulls} pulls, {kernel_us} us of it in the decide "
            f"kernel's launches")
    out = dict(device_ms_a_pull=total_us / pulls / 1e3,
               decide_kernel_ms_a_pull=kernel_us / pulls / 1e3,
               device_ops_a_pull=ops / pulls,
               top=[dict(kernel=name, ms_a_pull=us / pulls / 1e3,
                         a_pull=count / pulls)
                    for us, name, count in sorted(by_name, reverse=True)[:5]])
    log(f"service n={n}: device busy {out['device_ms_a_pull']:.4f} ms a "
        f"pull over {pulls} profiled pulls in {ops / pulls:.1f} device "
        f"operations (kernels, copies, fills), of which the decide "
        f"kernel's launches "
        f"{out['decide_kernel_ms_a_pull']:.4f} ms "
        f"({100 * kernel_us / total_us:.1f}%)")
    return out


def param_bytes(sketch: str, n: int, depth: int, n_buckets: int,
                admitted: int, touched_pairs: int) -> int:
    """Bytes one param step must move: the [N] columns (slot, D indices,
    acquire, threshold, valid in; admit, estimate out), D x B gathered cells
    (a SALSA cell is read as its 4-byte pair), and the admitted rows' D cell
    writes for count-min, or each touched pair's 4 bytes read and written
    for SALSA (the function re-encodes a whole plane only in name: every
    other pair keeps its bits). The timed steps do not roll (no 4 MiB
    zeroing)."""
    cols = n * (4 + 4 * depth + 4 + 4 + 1 + 1 + 4)
    gathered = n * depth * n_buckets * 4
    if sketch == "salsa":
        return cols + gathered + touched_pairs * 2 * 4
    return cols + gathered + admitted * depth * 4


def phase_param_parity(torch, dev):
    """CMS and SALSA kernels vs their plain versions, bitwise."""
    import torch_param_check as PC

    from sentinel_tpu_torch.engine.param import ParamConfig, make_param_state

    if PC.STEP_OFFSETS_MS[-1] - PC.STEP_OFFSETS_MS[0] <= 2000:
        raise AssertionError("the param steps must span more than 2 s")
    out = {}
    for sketch in SKETCHES:
        cfg = ParamConfig(sketch=sketch)
        max_err, steps = 0.0, 0
        for n in PARAM_CHECK_SIZES:
            batches, nows = PC.kernel_batches(cfg, n, seed=n)
            r = PC.check_param_steps(cfg, make_param_state(cfg, device=dev),
                                     batches, nows)
            torch.cuda.synchronize()
            if r.mismatches:
                raise AssertionError(
                    f"{sketch} kernel != plain at N={n}: {r.mismatches[:8]}"
                )
            missing = set(PC.coverage_for(sketch, n)) - r.reached
            if missing:
                raise AssertionError(
                    f"{sketch} N={n}: the steps never reached "
                    f"{sorted(missing)}")
            max_err = max(max_err, r.max_abs_err)
            steps += len(nows)
            log(f"param parity {sketch} N={n}: {len(nows)} steps over "
                f"{nows[-1] - nows[0]} ms bitwise equal; reached "
                f"{sorted(r.reached)}; {r.admitted} rows admitted, "
                f"{r.blocked} blocked")
        out[sketch] = (max_err, steps)
    return out


def phase_param_timing(torch, dev):
    """Param kernel and plain-version ms per step, with the byte bound."""
    import torch_param_check as PC

    from sentinel_tpu_torch.engine.param import ParamConfig, make_param_state

    out = {}
    for sketch in SKETCHES:
        cfg = ParamConfig(sketch=sketch)
        kernel, plain = PC.step_fns(sketch)
        rows = {}
        for n in PARAM_SIZES:
            batches, nows = PC.kernel_batches(cfg, n, seed=100 + n)
            st = make_param_state(cfg, device=dev)
            for cols, now in zip(batches[:-1], nows[:-1]):
                plain(st, PC.to_device(cols, dev), now, cfg.bucket_ms)
            c, now = PC.to_device(batches[-1], dev), nows[-1]
            st_p = PC.clone_param_state(st)
            admit, _ = kernel(st, c, now, cfg.bucket_ms)  # rolls; then none
            admitted = int(admit.sum())
            kernel_ms = cuda_ms(lambda: kernel(st, c, now, cfg.bucket_ms),
                                50, torch)
            plain_ms = cuda_ms(lambda: plain(st_p, c, now, cfg.bucket_ms),
                               5, torch)
            # the same slot a whole window later: every call finds its start
            # stale and zeroes the current plane
            flip = [now, now + cfg.interval_ms]

            def rolling():
                flip.reverse()
                kernel(st, c, flip[0], cfg.bucket_ms)

            rolling_ms = cuda_ms(rolling, 20, torch)
            rows_in = torch.nonzero(admit)[:, 0]
            pair_ids = ((c["rule_slot"][rows_in].long()[:, None] * cfg.depth
                         + torch.arange(cfg.depth, device=dev)[None, :])
                        * cfg.cell_width + c["idx"][rows_in].long() // 2)
            touched = int(torch.unique(pair_ids).numel())
            nbytes = param_bytes(sketch, n, cfg.depth, cfg.n_buckets,
                                 admitted, touched)
            ops = 40 * n  # a few dozen integer and float ops a row
            bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                           ops / PEAK_F32_OPS_PER_S) * 1e3
            rows[n] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bytes=nbytes, admitted=admitted,
                           rolling_ms=rolling_ms)
            log(f"timing {sketch} N={n}: kernel {kernel_ms:.4f} ms "
                f"(rolling {rolling_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.6f} ms ({nbytes} B)")
        out[sketch] = rows
    for n in PARAM_SIZES:
        ratio = out["salsa"][n]["ms"] / out["cms"][n]["ms"]
        log(f"timing N={n}: salsa / cms kernel time {ratio:.3f}")
    return out


def phase_param_service(torch, dev):
    """The hot-param path: a service on the kernel vs one on the torch-ops
    core, per sketch, read through the kernel's launch count. Also returns
    a function that traces more requests of each kernel service (called
    last, as phase 3's profiled pulls are)."""
    from collections import Counter

    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda

    counters = {"cms": (cms_cuda.LAUNCHES, "cms_decide_update"),
                "salsa": (salsa_cuda.LAUNCHES, "salsa_decide_update")}
    out, services = {}, {}
    for sketch in SKETCHES:
        mc = clock.ManualClock(1_700_000_000_000)
        prev = clock.set_clock(mc)
        try:
            rng = np.random.default_rng(11)
            specs = PC.service_rule_specs(256, rng)
            reload = PC.reload_specs(specs, rng, n_new=40)
            half = PARAM_REQUESTS // 2
            streams = (PC.service_stream(specs, rng, half),
                       PC.service_stream(reload, rng, half))
            svc = DefaultTokenService(param_config=ParamConfig(sketch=sketch),
                                      device=dev)
            ref = DefaultTokenService(
                param_config=ParamConfig(sketch=sketch, impl="jax"),
                device=dev)

            def rules_of(sp):
                return [ClusterParamFlowRule(s.flow_id, s.count,
                                             s.item_thresholds) for s in sp]

            for s in (svc, ref):
                s.load_param_rules(rules_of(specs))
                s.warmup()
            slots_before = {f: e[0] for f, e in svc._param_rules.items()}
            launches_of, name = counters[sketch]
            advances = itertools.cycle(PARAM_ADVANCES_MS)
            lat, seen = [], Counter()
            t_start = mc.now_ms()
            # --- the main path, read through the launch count ------------
            launches_of.update(dict.fromkeys(launches_of, 0))
            for part, stream in enumerate(streams):
                if part == 1:
                    for s in (svc, ref):
                        s.load_param_rules(rules_of(reload))
                for fid, acq, hashes in stream:
                    t0 = time.perf_counter()
                    got = svc.request_params_token(fid, acq, hashes)
                    lat.append(time.perf_counter() - t0)
                    want = ref.request_params_token(fid, acq, hashes)
                    if got.status != want.status:
                        raise AssertionError(
                            f"{sketch}: param verdict {got.status} != "
                            f"torch-ops core {want.status}")
                    seen[got.status.name] += 1
                    mc.advance(next(advances))
            launches = launches_of[name]
            spanned = mc.now_ms() - t_start
            n_req = sum(len(s) for s in streams)
            if launches != n_req:
                raise AssertionError(
                    f"{sketch} kernel launched {launches} times for {n_req} "
                    f"requests")
            if spanned <= 2 * svc.param_config.interval_ms:
                raise AssertionError(f"the requests spanned {spanned} ms")
            if not (seen["OK"] and seen["BLOCKED"]):
                raise AssertionError(f"{sketch}: verdicts {dict(seen)}")
            for f, a, b in zip(svc._param_state._fields, svc._param_state,
                               ref._param_state):
                if not torch.equal(a, b):
                    raise AssertionError(f"{sketch}: sketch leaf {f} differs")
            slots_after = {f: e[0] for f, e in svc._param_rules.items()}
            freed = set(slots_before.values()) - {
                slots_before[f] for f in slots_before if f in slots_after}
            reused = freed & {slots_after[f] for f in slots_after
                              if f not in slots_before}
            if not reused:
                raise AssertionError("the reload reused no freed slot")
            a = np.array(lat) * 1e3
            out[sketch] = dict(
                launches=launches, requests=n_req,
                p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)),
                verdicts=dict(seen))
            log(f"param service {sketch}: {n_req} requests over {spanned} ms"
                f" equal to the torch-ops core, sketches equal; reload freed "
                f"{len(freed)} slots and reused {len(reused)}; {launches} "
                f"kernel launches; verdicts {dict(seen)}; p50 "
                f"{out[sketch]['p50_ms']:.3f} ms, p99 "
                f"{out[sketch]['p99_ms']:.3f} ms a request")
            services[sketch] = (svc, mc, PC.service_stream(
                reload, rng, PROFILED_PARAM_CALLS))
        finally:
            clock.set_clock(prev)

    def profiled_params():
        return {sketch: param_call_kernels(torch, sketch, *services[sketch])
                for sketch in SKETCHES}

    return out, profiled_params


def param_call_kernels(torch, sketch, svc, mc, stream):
    """CUDA kernels a ``request_params_token`` call launches, by name, from
    a ``torch.profiler`` trace of ``stream``'s calls: the param kernel's
    (``csrc/<sketch>.cu``) must be exactly one a call; the operations around
    it (the staging copy, the verdict read and, for SALSA, the slim twin's
    torch ops; count-min carries the twin in its launch) are counted
    apart."""
    from sentinel_tpu_torch.core import clock
    from torch.profiler import ProfilerActivity, profile

    prev = clock.set_clock(mc)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fid, acq, hashes in stream:
                svc.request_params_token(fid, acq, hashes)
                mc.advance(3)
            torch.cuda.synchronize()
    finally:
        clock.set_clock(prev)
    calls = len(stream)
    ours, others = {}, {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA") or not evt.count:
            continue
        mine = f"{sketch}_decide_kernel" in evt.key
        (ours if mine else others)[evt.key] = evt.count
    per_call = {re.search(r"\w+_kernel", k).group(0): v / calls
                for k, v in ours.items()}
    if sum(ours.values()) != calls:
        raise AssertionError(
            f"{sketch}: {calls} profiled calls launched {ours} kernels of "
            f"csrc/{sketch}.cu, not one a call")
    out = dict(calls=calls, param_kernels_a_call=per_call,
               torch_kernels_a_call=sum(others.values()) / calls)
    log(f"param service {sketch}: {calls} profiled calls, kernels of "
        f"csrc/{sketch}.cu a call {per_call}; other CUDA kernels a call "
        f"(copies; SALSA's slim twin) "
        f"{out['torch_kernels_a_call']:.2f}")
    return out


def outcome_bytes(k: int, k_valid: int, breakers: bool, rolled: bool,
                  n_flows: int, n_channels: int) -> int:
    """Bytes one outcome step must move: the [K] report columns (slot, rt,
    exception, valid) read once; per valid row a read-modify-write of each
    int32 cell it adds to (RT_SUM, COMPLETE, EXCEPTION, the histogram cell,
    and SLOW with breakers); with breakers, per row the flow's cutoff,
    strategy, breaker state and probe ticket read; and, when the bucket
    turns, the current [F, C] column zeroed."""
    cells = 5 if breakers else 4
    nbytes = k * (4 + 4 + 4 + 1) + k_valid * cells * 4 * 2
    if breakers:
        nbytes += k * (4 + 1 + 1 + 4)
    if rolled:
        nbytes += n_flows * n_channels * 4
    return nbytes


def phase_outcome(torch, dev):
    """Completion reports and circuit breaking at full size: the decide
    kernel's service against the torch-ops service on one stream, a lease
    sequence, then the report path's times. Returns the results and a
    function that traces reports (called last)."""
    import torch_kernel_check as DC
    import torch_outcome_check as OC

    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        DegradeRule,
        DegradeStrategy,
        EngineConfig,
        ThresholdMode,
        outcome_step_donating,
    )
    from sentinel_tpu_torch.engine.state import N_OUTCOME_CHANNELS, make_state
    from sentinel_tpu_torch.metrics.server import server_metrics
    from sentinel_tpu_torch.metrics.stat_logger import (
        CLUSTER_LOG,
        StatEntry,
        stat_logger,
    )
    from sentinel_tpu_torch.ops import decide_cuda as K

    mc = clock.ManualClock(1_700_000_000_040)
    prev = clock.set_clock(mc)
    try:
        cfg = EngineConfig(max_flows=F, max_namespaces=NS,
                           batch_size=SIZES[-1])
        rules = service_rules(ClusterFlowRule, ThresholdMode)
        degrade = [DegradeRule(**{**d, "strategy": DegradeStrategy(
            d["strategy"])}) for d in OC.degrade_specs(
                range(F), lambda fid: f"ns{fid % NS}")]
        svc = DefaultTokenService(cfg, device=dev)
        ref = DefaultTokenService(cfg._replace(decide_impl="xla"),
                                  device=dev)
        for s in (svc, ref):
            s.load_rules(rules, ns_max_qps=1e9)
            s.load_degrade_rules(degrade)
            s.warmup()
        zipf = DC.ZipfIds(F, alpha=1.1)
        rng = np.random.default_rng(31)
        edges = OC.BreakerEdges()
        steps = 0
        verdicts = {}
        # the host sinks: every edge a scan of either service returns, the
        # rows both accepted, against the transition counters and the stat
        # log's outcome_reported lines the run adds
        scanned = {}
        accepted = 0
        for s in (svc, ref):
            def scan(force=False, orig=s._breaker_scan):
                got = orig(force)
                for key, c in got.items():
                    scanned[key] = scanned.get(key, 0) + c
                return got

            s._breaker_scan = scan
        sm = server_metrics()
        transitions0 = sm.breaker_transition_totals()
        stat_log = stat_logger(CLUSTER_LOG)
        stat_log.flush()
        stat_path = stat_log.writer.path
        stat_offset = (os.path.getsize(stat_path)
                       if os.path.exists(stat_path) else 0)

        def check_op(kind, r, i, n, outs):
            nonlocal steps, accepted
            if kind == "pull":
                if not OC.verdicts_equal(outs):
                    raise AssertionError(f"outcome phase: verdicts differ "
                                         f"at round {r} step {i} (n={n})")
                steps += -(-n // cfg.batch_size)
                for code, c in zip(*np.unique(outs[0][0],
                                              return_counts=True)):
                    verdicts[int(code)] = verdicts.get(int(code), 0) + int(c)
            elif outs[0] != outs[1]:
                raise AssertionError(f"outcome phase: report counts "
                                     f"{outs} at round {r} step {i}")
            else:
                accepted += outs[0] + outs[1]
            edges.update(svc.breaker_stats())

        def planes_equal(label):
            bad = [f"{pn}.{f}" for pn, pa, pb in zip(
                       svc._state._fields, svc._state, ref._state)
                   for f, a, b in zip(pa._fields, pa, pb)
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"outcome phase: {bad} differ {label}")

        def check_round(r):
            planes_equal(f"after round {r}")
            if svc.breaker_stats() != ref.breaker_stats():
                raise AssertionError(f"breaker_stats differ after round {r}")

        # --- the main path, read through the launch count ----------------
        t_start = mc.now_ms()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        OC.drive((svc, ref), mc.advance, rng, zipf, OUTCOME_PLAN,
                 OUTCOME_ADVANCES_MS, OUTCOME_ROUNDS, check_op, check_round)
        launches = K.LAUNCHES["decide_rows"]
        spanned = mc.now_ms() - t_start
        torch.cuda.synchronize()
        if launches != steps:
            raise AssertionError(f"the decide kernel launched {launches} "
                                 f"times for {steps} device steps")
        if spanned < 8000:
            raise AssertionError(f"the stream spanned only {spanned} ms")
        o_svc, o_ref = svc.outcome_stats(), ref.outcome_stats()
        if o_svc != o_ref:
            raise AssertionError("outcome_stats differ")
        edges.require(trips=3, probes=3, closes=1, reopens=1)
        names = DefaultTokenService._BR_STATE_NAMES
        counted = {k: v - transitions0.get(k, 0)
                   for k, v in sm.breaker_transition_totals().items()
                   if v != transitions0.get(k, 0)}
        want = {(names[f], names[t]): c for (f, t), c in scanned.items()}
        if counted != want:
            raise AssertionError(f"outcome phase: transition counters "
                                 f"{counted} != the scans' edges {want}")
        stat_log.flush()
        with open(stat_path, encoding="utf-8") as fh:
            fh.seek(stat_offset)
            logged = sum(StatEntry.from_line(line).count for line in fh
                         if line.split("|")[1] == "outcome_reported")
        if logged != accepted:
            raise AssertionError(f"outcome phase: the stat log's "
                                 f"outcome_reported {logged} != {accepted} "
                                 f"accepted rows")
        for s in (svc, ref):
            del s._breaker_scan
        log(f"outcome sinks: transition counters {counted} equal the scans' "
            f"edges; the stat log's outcome_reported {logged} = the rows "
            f"both services accepted")
        degraded = verdicts.get(12, 0)
        log(f"outcome: {OUTCOME_ROUNDS} rounds over {spanned} ms, "
            f"{steps} device steps = {launches} decide launches; verdicts "
            f"and report counts equal every step, every plane equal every "
            f"round; breaker edges {edges.counts}; {degraded} DEGRADED "
            f"verdicts; reported {o_svc['reported']}, dropped "
            f"{o_svc['dropped']}, {len(o_svc['flows'])} flows with "
            f"completions in the window")

        # --- leases on 1,000 plain flows ---------------------------------
        lease_ids = [r.flow_id for r in rules
                     if r.control_behavior == 0
                     and r.flow_id % OC.BREAKER_EVERY][:LEASE_FLOWS]

        def both(op, *args):
            a = getattr(svc, op)(*args)
            b = getattr(ref, op)(*args)
            if a != b:
                raise AssertionError(f"{op}{args}: {a} != {b}")
            return a

        grants = [both("lease_grant", fid, 20) for fid in lease_ids]
        ids = np.repeat(np.array(lease_ids, np.int64), 3)
        if not OC.verdicts_equal([s.request_batch_arrays(ids)
                                  for s in (svc, ref)]):
            raise AssertionError("lease pull verdicts differ")
        mc.advance(150)
        renewed = [both("lease_renew", g.lease_id, fid, 3, 10)
                   for g, fid in zip(grants, lease_ids)]
        for g in renewed[::2]:
            both("lease_return", g.lease_id, 1)
        mc.advance(600)  # past the TTL: the other half expires
        stats = both("lease_stats")
        planes_equal("after the lease sequence")
        ok = sum(g.ok for g in grants)
        expired = sum(g.ok for g in renewed[1::2])
        if not ok or stats["revoked"] != expired or stats["outstanding"]:
            raise AssertionError(f"lease sequence: {ok} grants, {expired} "
                                 f"left to expire, {stats}")
        log(f"leases on {len(lease_ids)} flows: {ok} granted, renewed, "
            f"half returned, half expired; equal results and flow planes; "
            f"{stats}")

        # --- report_outcomes on the host clock ---------------------------
        host = {}
        for n in REPORT_SIZES:
            pool = zipf(rng, n)
            lat = []
            for _ in range(30):
                fl, rt, exc = OC.report_rows(rng, pool, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.report_outcomes(fl, rt, exc)
                lat.append(time.perf_counter() - t0)
                mc.advance(7)
            torch.cuda.synchronize()
            a = np.array(lat) * 1e3
            host[n] = dict(p50_ms=float(np.percentile(a, 50)),
                           p99_ms=float(np.percentile(a, 99)))
            log(f"report_outcomes n={n}: p50 {host[n]['p50_ms']:.3f} ms, "
                f"p99 {host[n]['p99_ms']:.3f} ms on the host (call only, "
                f"device idle before each call)")

        # --- the outcome step on the device ------------------------------
        # A step is ~100-200 small launches: three steps a timed run keep
        # the host's launch queue from filling while the sleep kernel holds
        # the stream (a full queue paces the device at the host's rate, and
        # the events would time the host); the median of 7 such runs.
        def step_ms(fn):
            return float(np.median([cuda_ms(fn, 3, torch)
                                    for _ in range(7)]))

        step = outcome_step_donating(cfg)
        br = (svc._table.br_strategy, svc._table.br_slow_rt_ms)
        device = {}
        st = make_state(cfg, device=dev)
        for n in REPORT_SIZES:
            fl, rt, exc = OC.report_rows(rng, zipf(rng, n), n)
            slots = svc.lookup_slots(fl)
            valid = (slots >= 0) & np.isfinite(rt) & (rt >= 0) & (
                rt <= OC.OUTCOME_MAX_RT_MS)
            cols = [torch.as_tensor(a, device=dev) for a in (
                np.where(valid, slots, 0).astype(np.int32),
                np.where(valid, rt, 0).astype(np.int32),
                (exc & valid).astype(np.int32), valid)]
            now = [60_040, 60_040 + cfg.n_buckets * cfg.bucket_ms]
            row = {}
            for extra in ((), br):
                # the step makes no call that waits for the device (as far
                # as torch's sync debug mode sees)
                step(st, *cols, now[0], *extra)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step(st, *cols, now[1], *extra)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            for label, extra in (("no_breakers", ()), ("breakers", br)):
                row[label] = step_ms(
                    lambda: step(st, *cols, now[0], *extra))

                def rolling():
                    now.reverse()
                    step(st, *cols, now[0], *extra)

                row[label + "_rolling"] = step_ms(rolling)
            k_valid = int(valid.sum())
            nbytes = outcome_bytes(n, k_valid, True, False, F,
                                   N_OUTCOME_CHANNELS)
            roll_bytes = outcome_bytes(n, k_valid, True, True, F,
                                       N_OUTCOME_CHANNELS)
            ops = 40 * n  # bucket compares, masks, index math per row
            row.update(
                bytes=nbytes, rolling_bytes=roll_bytes,
                bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                             ops / PEAK_F32_OPS_PER_S) * 1e3,
                rolling_bound_ms=max(roll_bytes / PEAK_BYTES_PER_S,
                                     ops / PEAK_F32_OPS_PER_S) * 1e3,
                no_breakers_bound_ms=outcome_bytes(
                    n, k_valid, False, False, F, N_OUTCOME_CHANNELS)
                / PEAK_BYTES_PER_S * 1e3)
            device[n] = row
            log(f"outcome step K={n}: no synchronizing call; "
                f"{row['breakers']:.4f} ms with the "
                f"breaker columns, {row['no_breakers']:.4f} ms without; a "
                f"step whose bucket turns {row['breakers_rolling']:.4f} / "
                f"{row['no_breakers_rolling']:.4f} ms; bound "
                f"{row['bound_ms']:.6f} ms ({nbytes} B), turning "
                f"{row['rolling_bound_ms']:.6f} ms ({roll_bytes} B)")

        traced_reports = [OC.report_rows(rng, zipf(rng, SIZES[-1]),
                                         SIZES[-1]) for _ in range(5)]

        def profiled_reports():
            """Left to the end: CUDA kernels a 16384-row report launches."""
            before = clock.set_clock(mc)
            try:
                return report_kernels(torch, svc, mc, traced_reports)
            finally:
                clock.set_clock(before)

        out = dict(launches=launches, device_steps=steps, spanned_ms=spanned,
                   edges=dict(edges.counts), lease=stats, host=host,
                   device=device, verdicts=verdicts)
        return out, profiled_reports
    finally:
        clock.set_clock(prev)


def report_kernels(torch, svc, mc, reports):
    """CUDA kernels a ``report_outcomes`` call launches, from a
    ``torch.profiler`` trace of ``reports`` (the outcome step is torch ops;
    no kernel of ``csrc/`` runs in it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fl, rt, exc in reports:
            svc.report_outcomes(fl, rt, exc)
            mc.advance(3)
        torch.cuda.synchronize()
    launched = busy_us = 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and evt.count:
            launched += evt.count
            busy_us += evt.self_device_time_total
    if not launched:
        raise AssertionError("the traced reports launched no CUDA kernel")
    out = dict(reports=len(reports), kernels_a_report=launched / len(reports),
               device_ms_a_report=busy_us / len(reports) / 1e3)
    log(f"report_outcomes n={reports[0][0].size}: {out['kernels_a_report']:.1f}"
        f" CUDA kernels and {out['device_ms_a_report']:.4f} ms of device "
        f"time a report over {len(reports)} traced reports")
    return out


def flow_rules():
    """Phase 9's rules: ``service_rules``' 100k flows, a breaker on every
    10th (``torch_outcome_check.degrade_specs``) and ``ParamConfig()``'s 256
    param rules (``torch_param_check.service_rule_specs``)."""
    import torch_outcome_check as OC
    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.token_service import ClusterParamFlowRule
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        DegradeRule,
        DegradeStrategy,
        ThresholdMode,
    )

    rules = service_rules(ClusterFlowRule, ThresholdMode)
    degrade = [DegradeRule(**{**d, "strategy": DegradeStrategy(
        d["strategy"])}) for d in OC.degrade_specs(
            range(F), lambda fid: f"ns{fid % NS}")]
    specs = PC.service_rule_specs(256, np.random.default_rng(41))
    param_rules = [ClusterParamFlowRule(s.flow_id, s.count, s.item_thresholds)
                   for s in specs]
    return rules, degrade, param_rules


def door_lease_flows(n: int = 3):
    """Flows a lease may be granted on: plain (no shaping), no breaker, and
    cold in the Zipf pulls (high ids), so they keep headroom."""
    out = []
    for fid in range(F - 1, 0, -1):
        if fid % 97 and fid % 89 and fid % 83 and fid % 10:
            out.append(fid)
            if len(out) == n:
                return out
    raise AssertionError("no leasable flow")


def phase_door(torch, dev):
    """The front door: the port's ``NativeTokenServer`` (the C++ door built
    from ``native/src``) serving the flow configuration of phase 3 with
    phase 8's breakers and the default param sketch on the card, spoken to
    over raw sockets with the port's ``protocol`` (``torch_door_check``).

    1. Lockstep: one connection, one frame at a time on a manual clock;
       every reply equal to a twin service on the torch-ops cores, and the
       stats equal after the sequence; the decide and param kernels launch
       once per device step and per PARAM_FLOW frame.
    2. The xid probe: 24 pipelined 1024-row frames, every xid once.
    3. A closed loop on the system clock: one client, then
       ``DOOR_CLIENTS`` clients, each in a worker process (spawned: no
       interpreter lock shared with the door's lanes) on its own
       connection, sending pulls of each size for ``DOOR_SECONDS``; verdicts/s, RTT,
       the door's fuse depths and overlapped dispatches, no error, and one
       decide launch per frame of each dispatch.
    4. PARAM_FLOW RTT per sketch (a second door, with the param rules only,
       for the other sketch).
    5. With the door stopped (no reply lane running), a grouped, a fused
       (depth 4) dispatch and a param step up to its verdict read under
       torch's sync debug mode: none may wait for the device.
    """
    from collections import Counter

    import torch_door_check as DK
    import torch_kernel_check as DC

    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.concurrent import ConcurrentFlowRule
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.metrics.server import server_metrics
    from sentinel_tpu_torch.native import build as native_build
    from sentinel_tpu_torch.native import lib as native_lib
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    t_phase = t0 = time.perf_counter()
    native_lib.load()
    log(f"door: native library {os.path.basename(native_build.target())} "
        f"ready in {time.perf_counter() - t0:.1f} s")
    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1])
    rules, degrade, param_rules = flow_rules()
    param_flows = [r.flow_id for r in param_rules]

    def service(sketch="cms", twin=False, flows=True):
        c = cfg._replace(decide_impl="xla") if twin else cfg
        pc = ParamConfig(sketch=sketch, impl="jax" if twin else "auto")
        s = DefaultTokenService(c, param_config=pc, device=dev)
        if flows:
            s.load_degrade_rules(degrade)
            s.load_rules(rules, ns_max_qps=1e9)
        s.load_param_rules(param_rules)
        s.load_concurrent_rules([ConcurrentFlowRule(
            f, 2, resource_timeout_ms=600_000) for f in DOOR_CONC_FLOWS])
        return s

    zipf = DC.ZipfIds(F, alpha=1.1)
    flow_ids = np.arange(F, dtype=np.int64)
    # a minute behind the wall clock: the closed loop that follows on the
    # system clock moves engine time forward only
    mc = clock.ManualClock(int(time.time() * 1000) - 60_000)
    prev = clock.set_clock(mc)
    out = {}
    svc = service()
    server = NativeTokenServer(svc, host="127.0.0.1", port=0,
                               idle_ttl_s=None)
    try:
        twin = service(twin=True)
        server.start()  # warms the service up
        twin.warmup()

        # --- 1. lockstep, the main path read through the launch counts ---
        steps = DK.lockstep_plan(
            np.random.default_rng(43), zipf, flow_ids, DOOR_PULLS,
            param_flows, door_lease_flows(), DOOR_CONC_FLOWS, DOOR_ROUNDS,
            P.MAX_BATCH_PER_FRAME, OUTCOME_ADVANCES_MS)
        conn = DK.RawConn(P, server.port)
        try:
            conn.ping(1)
            t_start = mc.now_ms()
            K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
            cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
            t0 = time.perf_counter()
            replies, counts = DK.run_lockstep(P, conn, steps, mc.advance,
                                              twin=twin)
            lockstep_s = time.perf_counter() - t0
            launches = K.LAUNCHES["decide_rows"]
            param_launches = cms_cuda.LAUNCHES["cms_decide_update"]
            pushes = len(conn.pushes)
        finally:
            conn.close()
        if launches != counts["device_steps"]:
            raise AssertionError(
                f"door: decide kernel launched {launches} times for "
                f"{counts['device_steps']} device steps")
        if param_launches != counts["param_frames"]:
            raise AssertionError(
                f"door: param kernel launched {param_launches} times for "
                f"{counts['param_frames']} PARAM_FLOW frames")
        for name in ("outcome_stats", "breaker_stats", "lease_stats"):
            if getattr(svc, name)() != getattr(twin, name)():
                raise AssertionError(f"door: {name} differs from the twin")
        # the scrape's sketch block (PERF.md section 4's sketch bytes)
        scraped = server_metrics().snapshot()["sketch"]
        if (scraped["fatBytes"], scraped["slimBytes"]) != (8_388_608,
                                                           1_048_576) or \
                svc.sketch_stats()["impl"] != "pallas":
            raise AssertionError(f"door: sketch block {scraped}")
        out["sketch_block"] = scraped
        log(f"door scrape: sketch block {scraped}")
        kinds = Counter(s["kind"] for s in steps)
        statuses = Counter()
        for s, r in zip(steps, replies):
            if s["kind"] == "batch":
                statuses.update(P.decode_batch_response(r)[1].tolist())
        lease = svc.lease_stats()
        if not (statuses.get(12) and lease["granted"]
                and svc.outcome_stats()["reported"]):
            raise AssertionError(
                f"door: the lockstep reached too little: verdicts "
                f"{dict(statuses)}, leases {lease}")
        out["lockstep"] = dict(
            steps=len(steps), kinds=dict(kinds), spanned_ms=mc.now_ms() -
            t_start, seconds=lockstep_s, decide_launches=launches,
            param_launches=param_launches, rows=counts["rows"],
            verdicts={int(k): int(v) for k, v in sorted(statuses.items())},
            leases=lease, pushes_seen=pushes)
        log(f"door lockstep: {len(steps)} frames ({dict(kinds)}) over "
            f"{out['lockstep']['spanned_ms']} ms equal to the twin service; "
            f"{launches} decide launches = device steps, {param_launches} "
            f"param launches = PARAM_FLOW frames; verdicts "
            f"{out['lockstep']['verdicts']}; leases {lease}")

        # --- the rest runs on the system clock ----------------------------
        clock.set_clock(prev)

        # --- 2. the xid probe ---------------------------------------------
        probe = DK.xid_probe(P, server.port, flow_ids, frames=24, rows=1024)
        if not probe["exact"]:
            raise AssertionError(f"door: xid probe {probe}")
        out["xid_probe"] = probe
        log(f"door xid probe: {probe}")

        # --- 3. the closed loop --------------------------------------------
        depth_hist = Counter()
        disp = Counter()
        lane_put = server._lane_put
        tracked = server._tracked_dispatch

        def counting_put(q, item, give_up_after_s=None):
            if isinstance(item, tuple) and len(item) == 3:
                depth_hist[len(item[1])] += 1
            return lane_put(q, item, give_up_after_s)

        def counting_dispatch(dispatch, ids, counts_, prios):
            got = tracked(dispatch, ids, counts_, prios)
            disp["dispatches"] += 1
            disp["overlapped"] += bool(got[2])
            disp["frames"] += -(-len(ids) // cfg.batch_size)
            return got

        server._lane_put = counting_put
        server._tracked_dispatch = counting_dispatch
        sm = server_metrics()
        stages = {"intake": sm.intake_ms, "dispatch": sm.dispatch_ms,
                  "materialize": sm.decide_ms, "reply": sm.write_ms}
        loops = {}
        pool = multiprocessing.get_context("spawn").Pool(
            DOOR_CLIENTS, initializer=DK.worker_init,
            initargs=("torch_kernel_check", P.__name__))
        try:
            pool.map(time.sleep, [0.2] * DOOR_CLIENTS)  # workers up
            for clients, n in itertools.product((1, DOOR_CLIENTS),
                                                DOOR_PULLS):
                depth_hist.clear()
                disp.clear()
                for h in stages.values():
                    h.reset()
                K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
                res = DK.closed_loop(P, server.port, flow_ids, zipf, n,
                                     DOOR_SECONDS, clients,
                                     P.MAX_BATCH_PER_FRAME, pool,
                                     seed=50 + n)
                label = f"n={n} clients={clients}"
                if res["errors"]:
                    raise AssertionError(f"door closed loop {label}: "
                                         f"{res['errors'][:5]}")
                if K.LAUNCHES["decide_rows"] != disp["frames"]:
                    raise AssertionError(
                        f"door closed loop {label}: "
                        f"{K.LAUNCHES['decide_rows']} decide launches for "
                        f"{disp['frames']} frames")
                res.update(
                    fuse_depths={int(k): int(v)
                                 for k, v in sorted(depth_hist.items())},
                    dispatches=disp["dispatches"],
                    overlapped_share=(disp["overlapped"] / disp["dispatches"]
                                      if disp["dispatches"] else None),
                    decide_launches=K.LAUNCHES["decide_rows"],
                    # per-lane host ms (histogram bucket edges): a pull's
                    # intake, a group's dispatch, its materialize, its reply
                    stage_p50_ms={k: h.quantile(0.5)
                                  for k, h in stages.items()})
                loops[f"{n}/{clients}"] = res
                log(f"door closed loop {label}: "
                    f"{res['served_verdicts_per_s']:.0f} served verdicts/s "
                    f"({res['verdicts_per_s']:.0f} answered), RTT p50 "
                    f"{res['rtt_p50_ms']:.3f} ms, p99 "
                    f"{res['rtt_p99_ms']:.3f} ms over {res['pulls']} pulls, "
                    f"{len(res['errors'])} errors; fuse depths "
                    f"{res['fuse_depths']}, overlapped "
                    f"{res['overlapped_share']}, stage p50 ms "
                    f"{res['stage_p50_ms']}, statuses {res['statuses']}")
        finally:
            pool.close()
            pool.join()
            server._lane_put = lane_put
            server._tracked_dispatch = tracked
        out["closed_loop"] = loops

        # --- 4. PARAM_FLOW RTT per sketch -----------------------------------
        out["param_rtt"] = {"cms": DK.param_rtt(
            P, server.port, param_flows, DOOR_PARAM_REQUESTS)}
    finally:
        clock.set_clock(prev)
        server.stop()
    salsa_svc = service("salsa", flows=False)  # it times PARAM_FLOW only
    salsa = NativeTokenServer(salsa_svc, host="127.0.0.1", port=0,
                              idle_ttl_s=None)
    salsa.start()
    try:
        salsa_cuda.LAUNCHES.update(dict.fromkeys(salsa_cuda.LAUNCHES, 0))
        out["param_rtt"]["salsa"] = DK.param_rtt(
            P, salsa.port, param_flows, DOOR_PARAM_REQUESTS)
        if salsa_cuda.LAUNCHES["salsa_decide_update"] != DOOR_PARAM_REQUESTS:
            raise AssertionError("door: SALSA kernel launches != frames")
    finally:
        salsa.stop()
    for sk, v in out["param_rtt"].items():
        log(f"door PARAM_FLOW ({sk}): RTT p50 {v['rtt_p50_ms']:.3f} ms, "
            f"p99 {v['rtt_p99_ms']:.3f} ms over {v['requests']} frames")

    # --- 5. dispatch under sync debug mode (no lane running) ---------------
    # with MOVE_NS moving, so that its rows are masked out and the batches
    # prepared again on the masked slots
    rng = np.random.default_rng(47)
    grouped_ids = zipf(rng, SIZES[-1])
    fused_ids = zipf(rng, FUSED_DEPTH * SIZES[-1])
    svc.begin_move(MOVE_NS, "127.0.0.1:1", MOVE_EPOCH)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grouped = svc.dispatch_batch_arrays(grouped_ids)
        fused = svc.dispatch_batch_arrays(fused_ids)
        admit = svc._param_step(param_flows[0], 1, [11, 12, 13])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        svc.abort_move(MOVE_NS)
    for mat, ids in ((grouped, grouped_ids), (fused, fused_ids)):
        st = mat()[0]
        masked = np.array([ns_of(int(f)) == MOVE_NS for f in ids])
        if st.shape != ids.shape or not masked.any() or \
                (st == MOVED_STATUS).tolist() != masked.tolist():
            raise AssertionError("door: a checked dispatch lost rows or "
                                 "masked the wrong ones")
    bool(admit.all())
    out["sync_free"] = ["grouped 16384, MOVED-masked",
                        "fused 4 x 16384, MOVED-masked",
                        "param step to its verdict read"]
    log(f"door: grouped and fused (depth 4) dispatches with {MOVE_NS} "
        f"moving (its rows masked and answered MOVED) and a param step make "
        f"no call that waits for the device (sync debug mode)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"door phase: {out['phase_s']:.1f} s")
    return out


def ha_service(dev, rules=None, twin=False, sketch="cms", slim_width=None,
               bucket_ms=None, conc=False):
    """A service of phase 10 at phase 9's widths: on the kernels, or with
    ``twin`` on the torch-ops cores; ``rules`` is ``flow_rules()``' triple
    (an empty flow list loads the param rules only), or None for a cold
    standby."""
    from sentinel_tpu_torch.cluster.concurrent import ConcurrentFlowRule
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.engine.param import ParamConfig

    # one namespace row more than the rules use: clients join "default",
    # which the snapshot's connected counts carry and a restore must seat
    cfg = EngineConfig(max_flows=F, max_namespaces=NS + 1,
                       batch_size=SIZES[-1],
                       decide_impl="xla" if twin else "auto")
    if bucket_ms is not None:
        cfg = cfg._replace(bucket_ms=bucket_ms)
    pc = ParamConfig(sketch=sketch, impl="jax" if twin else "auto")
    if slim_width is not None:
        pc = pc._replace(slim_width=slim_width)
    s = DefaultTokenService(cfg, param_config=pc, device=dev)
    if rules is not None:
        flow, degrade, params = rules
        if flow:
            s.load_degrade_rules(degrade)
            s.load_rules(flow, ns_max_qps=1e9)
        s.load_param_rules(params)
    if conc:
        s.load_concurrent_rules([ConcurrentFlowRule(
            f, 2, resource_timeout_ms=600_000) for f in DOOR_CONC_FLOWS])
    return s


def ha_drill_primary(conn, drill_flow: int, device: str, flows: int,
                     snap_dir: str) -> None:
    """The failover drill's primary, in a child process that the drill ends
    with SIGKILL (no final ship, no shutdown hook): phase 9's flows with
    ``drill_flow`` metered at ``HA_DRILL_QPS`` over ``HA_DRILL_BUCKET_MS``
    buckets, on ``device``. ``flows`` is the parent's ``F`` (a rehearsal on
    the CPU shrinks it). Builds and warms up its service, saves a snapshot
    into ``snap_dir`` and says "ready", takes the standby's port, starts
    its door replicating to it, sends its own port, and serves until
    killed."""
    import dataclasses

    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.ha.snapshot import save_snapshot

    global F
    F = flows
    flow, degrade, params = flow_rules()
    flow = [dataclasses.replace(r, count=HA_DRILL_QPS)
            if r.flow_id == drill_flow else r for r in flow]
    svc = ha_service(device, (flow, degrade, params),
                     bucket_ms=HA_DRILL_BUCKET_MS)
    svc.warmup()
    save_snapshot(svc, snap_dir)
    conn.send("ready")
    standby_port = conn.recv()
    server = NativeTokenServer(
        svc, port=0, idle_ttl_s=None,
        replicate_to=[("127.0.0.1", standby_port)],
        repl_interval_ms=HA_INTERVAL_MS)
    server.start()
    conn.send(server.port)
    while True:
        time.sleep(3600)


class LockHeld:
    """Stands in for a service's lock and times the holds that one thread
    (``watch``) takes: how long the replication sender's ``export_delta``
    keeps the device lane out."""

    def __init__(self, lock):
        self.lock = lock
        self.watch = None
        self.ms = 0.0
        self._t = None

    def __enter__(self):
        self.lock.acquire()
        # _t is read and written only while the lock is held
        self._t = (time.perf_counter()
                   if threading.get_ident() == self.watch else None)
        return self

    def __exit__(self, *exc):
        if self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
        self.lock.release()


def watch_replication(R, primary_svc, standby_svc):
    """Per-tick records of a running sender and one standby: the primary's
    ``export_delta`` (host ms, the service lock's held ms, dirty rows), the
    blob bytes (``R.encode_delta_blob``), the standby's
    ``apply_replication_delta`` ms and its snapshot ``import_state`` ms.
    Returns ``(ticks, applies, imports, undo)``."""
    ticks, applies, imports = [], [], []
    held = LockHeld(primary_svc._lock)
    export, apply = primary_svc.export_delta, standby_svc.apply_replication_delta
    restore = standby_svc.import_state
    encode = R.encode_delta_blob

    def timed_export():
        held.watch, held.ms = threading.get_ident(), 0.0
        t0 = time.perf_counter()
        d = export()
        ms = (time.perf_counter() - t0) * 1e3
        rows = sum(len(d.get(k, ())) for k in (
            "flow_ids", "ns_names", "outcome_fids", "breaker_fids",
            "param_fids"))
        ticks.append({"export_ms": ms, "lock_ms": held.ms, "rows": rows})
        return d

    def timed_encode(d):
        blob = encode(d)
        if ticks and "bytes" not in ticks[-1]:
            ticks[-1]["bytes"] = len(blob)
        return blob

    def timed_apply(d):
        t0 = time.perf_counter()
        apply(d)
        applies.append((time.perf_counter() - t0) * 1e3)

    def timed_import(state):
        t0 = time.perf_counter()
        restore(state)
        imports.append((time.perf_counter() - t0) * 1e3)

    primary_svc._lock = held
    primary_svc.export_delta = timed_export
    standby_svc.apply_replication_delta = timed_apply
    standby_svc.import_state = timed_import
    R.encode_delta_blob = timed_encode

    def undo():
        primary_svc._lock = held.lock
        del primary_svc.export_delta
        del standby_svc.apply_replication_delta
        del standby_svc.import_state
        R.encode_delta_blob = encode

    return ticks, applies, imports, undo


def wait_for(predicate, what: str, timeout_s: float) -> float:
    """Poll ``predicate`` up to ``timeout_s``; returns the seconds waited,
    raises naming ``what`` at the deadline."""
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"ha: {what} within {timeout_s} s")
        time.sleep(0.005)
    return time.monotonic() - t0


def quantiles(xs) -> dict:
    a = np.asarray(xs, np.float64)
    if a.size == 0:
        return {"n": 0}
    return {"n": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def phase_ha(torch, dev):
    """High availability at phase 9's widths (100k flows, 10,000 breakers,
    256 param rules), through the port's doors on the card.

    1. A primary door with ``replicate_to=`` two standby doors, one on the
       kernels (the card standby) and its twin on the torch-ops cores, with
       ``repl_interval_ms`` = ``HA_INTERVAL_MS``: after the snapshot
       bootstrap each standby refuses every frame type STANDBY; the primary
       takes phase 9's lockstep on a manual clock and a closed loop of
       Zipf pulls, reports and param requests on the system clock, while
       every tick is timed. After the last tick the card standby's flow,
       namespace, outcome, shaping and breaker rows and its slim param rows
       equal the primary's, and every leaf equals the twin's. Both are
       promoted; the lockstep through the card standby then equals the twin
       service's answers, with one decide launch a device step and one
       count-min launch a PARAM_FLOW frame on delta-borne state.
    2. ``save_snapshot`` of the stopped primary and ``restore_latest`` into
       a cold service, timed; the restored rows equal the primary's.
    3. SALSA with fat rows (``slim_width=0``), param rules only: a primary's
       delta blobs feed a card standby and its torch-ops twin, in process;
       after each apply both equal the primary's rows and each other; then
       their verdicts are equal, one SALSA launch a request.
    4. The failover drill: a primary in a child process, metering one flow
       at ``HA_DRILL_QPS`` over a 10 s window, replicates to a standby door
       with ``promote_after_ms``; a client fills half the window, keeps
       admitting until two more deltas land, SIGKILLs the primary and turns
       to the standby. Its watchdog promotes it; the admissions summed over
       both servers stay within the window plus one ship interval's
       admissions and one pull, and the promoted standby blocks.
    """
    import torch_door_check as DK
    import torch_kernel_check as DC
    import torch_outcome_check as OC
    import torch_param_check as PC
    import torch_repl_check as RC

    from sentinel_tpu_torch import interop
    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.ha import replication as R
    from sentinel_tpu_torch.ha import snapshot as S
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    t_phase = time.perf_counter()
    out = {}
    rules = flow_rules()
    param_flows = [r.flow_id for r in rules[2]]
    drill_flow = door_lease_flows(1)[0]
    snap_root = os.path.join(HERE, "sentinel_tpu_torch", "build",
                             "ha_snapshots")
    shutil.rmtree(snap_root, ignore_errors=True)
    # the drill's primary builds and warms up beside parts 1-3
    ctx = multiprocessing.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    child = ctx.Process(target=ha_drill_primary,
                        args=(child_end, drill_flow, str(dev), F,
                              os.path.join(snap_root, "drill")),
                        daemon=True)
    child.start()
    servers = []
    try:
        # --- 1. replication through the doors ------------------------------
        zipf = DC.ZipfIds(F, alpha=1.1)
        flow_ids = np.arange(F, dtype=np.int64)
        mc = clock.ManualClock(int(time.time() * 1000) - 60_000)
        prev = clock.set_clock(mc)
        card_svc = ha_service(dev)
        twin_svc = ha_service(dev, twin=True)
        card = NativeTokenServer(card_svc, port=0, idle_ttl_s=None,
                                 standby_of="primary")
        twin = NativeTokenServer(twin_svc, port=0, idle_ttl_s=None,
                                 standby_of="primary")
        servers += [card, twin]
        card.start()
        twin.start()
        mc.advance(5)  # its own epoch: the primary's HELLO asks a snapshot
        primary_svc = ha_service(dev, rules, conc=True)
        primary = NativeTokenServer(
            primary_svc, port=0, idle_ttl_s=None,
            replicate_to=[("127.0.0.1", card.port), ("127.0.0.1", twin.port)],
            repl_interval_ms=HA_INTERVAL_MS)
        servers.append(primary)
        ticks, applies, imports, undo = watch_replication(R, primary_svc,
                                                          card_svc)
        try:
            primary.start()
            boot_s = wait_for(
                lambda: all(s.applier.status()["snapshotsApplied"]
                            for s in (card, twin)),
                "the standbys' snapshot bootstrap", 120.0)
            for sb, svc in ((card, card_svc), (twin, twin_svc)):
                conn = DK.RawConn(P, sb.port)
                try:
                    RC.standby_refusals(P, conn, svc, zipf(
                        np.random.default_rng(51), 64), param_flows[0],
                        door_lease_flows()[0])
                finally:
                    conn.close()
            log(f"ha: both standbys bootstrapped from the primary's snapshot "
                f"in {boot_s:.1f} s (the card standby's import_state ms: "
                f"{imports}); each answers BATCH_FLOW, FLOW, "
                f"PARAM_FLOW, CONCURRENT, lease and hierarchy frames "
                f"STANDBY, PING still, and drops OUTCOME_REPORT")
            steps = DK.lockstep_plan(
                np.random.default_rng(52), zipf, flow_ids, DOOR_PULLS,
                param_flows, door_lease_flows(), DOOR_CONC_FLOWS, HA_ROUNDS,
                P.MAX_BATCH_PER_FRAME, OUTCOME_ADVANCES_MS)
            conn = DK.RawConn(P, primary.port)
            try:
                conn.ping(1)
                DK.run_lockstep(P, conn, steps, mc.advance)
                clock.set_clock(prev)
                # the closed loop: one client, one request in flight
                rng = np.random.default_rng(53)
                loop = {"pulls": 0, "reports": 0, "params": 0}
                xid = 10_000
                t_end = time.monotonic() + HA_LOOP_SECONDS
                while time.monotonic() < t_end:
                    ids = flow_ids[zipf(rng, HA_LOOP_PULL)]
                    xid += 1
                    conn.send(P.encode_batch_request(xid, ids))
                    st = P.decode_batch_response(conn.recv())[1]
                    fl, rt, exc = OC.report_rows(rng, ids[st == OC.OK], 256)
                    conn.send(P.encode_outcome_report(xid + 1, fl, rt, exc))
                    conn.ping(xid + 2)  # barrier: the report was ingested
                    fid = int(param_flows[int(rng.integers(len(
                        param_flows)))])
                    conn.send(P.encode_request(P.FlowRequest(
                        xid + 3, fid, 1, False, P.MsgType.PARAM_FLOW,
                        [int(h) for h in rng.integers(0, 1 << 40, 3)])))
                    conn.recv()
                    xid += 3
                    for k in loop:
                        loop[k] += 1
            finally:
                conn.close()
            # two more documents on each: one whole export after the last
            # frame
            base = [s.applier.status()["deltasApplied"]
                    for s in (card, twin)]
            wait_for(lambda: all(
                s.applier.status()["deltasApplied"] >= b + 2
                for s, b in zip((card, twin), base)),
                "two deltas after the traffic", 30.0)
            primary.stop()
        finally:
            undo()
            clock.set_clock(prev)
        bad = (RC.flow_rows_diff(primary_svc, card_svc)
               + RC.param_rows_diff(primary_svc, card_svc, "slim"))
        if bad:
            raise AssertionError(f"ha: the card standby differs from the "
                                 f"primary in {bad[:8]}")
        if not bool(card_svc._param_state.slim_auth.all()):
            raise AssertionError("ha: delta slim rows left a bucket "
                                 "without authority")
        if card_svc._index.slot_of != twin_svc._index.slot_of:
            raise AssertionError("ha: the standbys' slots differ")
        a, b = (interop.state_to_numpy(s._state) for s in (card_svc, twin_svc))
        pa, pb = (interop.param_state_to_numpy(s._param_state)
                  for s in (card_svc, twin_svc))
        bad = [k for k in a if not np.array_equal(a[k], b[k])] + [
            f"param.{k}" for k in pa if not np.array_equal(pa[k], pb[k])]
        if bad:
            raise AssertionError(f"ha: the card standby differs from its "
                                 f"twin in {bad}")
        ticks = [t for t in ticks if "bytes" in t]
        out["replication"] = dict(
            bootstrap_s=boot_s, import_ms=imports, closed_loop=loop,
            ticks=len(ticks),
            export_ms=quantiles([t["export_ms"] for t in ticks]),
            lock_held_ms=quantiles([t["lock_ms"] for t in ticks]),
            dirty_rows=quantiles([t["rows"] for t in ticks]),
            delta_bytes=quantiles([t["bytes"] for t in ticks]),
            apply_ms=quantiles(applies), per_tick=ticks,
            per_apply_ms=applies)
        r = out["replication"]
        log(f"ha ticks ({len(ticks)} at {HA_INTERVAL_MS} ms, F={F}): "
            f"dirty rows {r['dirty_rows']}, delta blob bytes "
            f"{r['delta_bytes']}, export_delta ms {r['export_ms']}, lock "
            f"held ms {r['lock_held_ms']}, apply_replication_delta ms "
            f"{r['apply_ms']}")
        log("ha: after the last tick the card standby's flow, namespace, "
            "outcome, shaping and breaker rows and slim param rows equal the "
            "primary's, and every leaf equals its twin's")

        # promotion: the card standby against the twin service, in lockstep
        mc2 = clock.ManualClock(int(time.time() * 1000))
        clock.set_clock(mc2)
        try:
            for sb in (card, twin):
                if not (sb.is_standby and sb.promote("phase 10")
                        and not sb.is_standby):
                    raise AssertionError("ha: promotion failed")
            steps = DK.lockstep_plan(
                np.random.default_rng(54), zipf, flow_ids, DOOR_PULLS,
                param_flows, door_lease_flows(), (), HA_ROUNDS,
                P.MAX_BATCH_PER_FRAME, OUTCOME_ADVANCES_MS)
            conn = DK.RawConn(P, card.port)
            try:
                conn.ping(1)
                K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
                cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
                _replies, counts = DK.run_lockstep(P, conn, steps,
                                                   mc2.advance, twin=twin_svc)
                launches = K.LAUNCHES["decide_rows"]
                param_launches = cms_cuda.LAUNCHES["cms_decide_update"]
            finally:
                conn.close()
        finally:
            clock.set_clock(prev)
        if launches != counts["device_steps"] or not launches:
            raise AssertionError(f"ha: {launches} decide launches for "
                                 f"{counts['device_steps']} device steps")
        if param_launches != counts["param_frames"] or not param_launches:
            raise AssertionError(f"ha: {param_launches} count-min launches "
                                 f"for {counts['param_frames']} frames")
        out["promoted"] = dict(steps=len(steps),
                               decide_launches=launches,
                               param_launches=param_launches)
        log(f"ha: promoted; {len(steps)} lockstep frames through the card "
            f"standby equal the twin service's answers; {launches} decide "
            f"launches = device steps, {param_launches} count-min launches "
            f"= PARAM_FLOW frames")
        for sb in (card, twin):
            sb.stop()

        # --- 2. the snapshot file -------------------------------------------
        snap_dir = os.path.join(snap_root, "file")
        t0 = time.perf_counter()
        path = S.save_snapshot(primary_svc, snap_dir)
        save_ms = (time.perf_counter() - t0) * 1e3
        cold = ha_service(dev)
        t0 = time.perf_counter()
        if not S.restore_latest(cold, snap_dir):
            raise AssertionError("ha: restore_latest found nothing")
        restore_ms = (time.perf_counter() - t0) * 1e3
        out["snapshot_file"] = dict(save_ms=save_ms,
                                    bytes=os.path.getsize(path),
                                    restore_ms=restore_ms)
        bad = (RC.flow_rows_diff(primary_svc, cold)
               + RC.param_rows_diff(primary_svc, cold, "counts")
               + RC.param_rows_diff(primary_svc, cold, "slim"))
        if bad:
            raise AssertionError(f"ha: the restored file differs in {bad[:8]}")
        del cold
        log(f"ha snapshot file at F={F}: save_snapshot "
            f"{save_ms:.1f} ms, {out['snapshot_file']['bytes']} B; "
            f"restore_latest {restore_ms:.1f} ms; the restored rows equal "
            f"the primary's")

        # --- 3. SALSA with fat rows, in process -----------------------------
        only_params = ([], [], rules[2])
        sp = ha_service(dev, only_params, sketch="salsa", slim_width=0)
        sk = ha_service(dev, sketch="salsa", slim_width=0)
        st = ha_service(dev, sketch="salsa", slim_width=0, twin=True)
        mc3 = clock.ManualClock(int(time.time() * 1000))
        clock.set_clock(mc3)
        try:
            sp.replication_enable()
            blob = R.encode_snapshot_blob(sp.export_state())
            for s in (sk, st):
                s.import_state(R.decode_snapshot_blob(blob))
            specs = PC.service_rule_specs(256, np.random.default_rng(41))
            rng = np.random.default_rng(55)
            stream = PC.service_stream(
                specs, rng, (HA_SALSA_TICKS + 1) * HA_SALSA_REQUESTS)
            fat_bytes = []
            for tick in range(HA_SALSA_TICKS):
                for fid, acq, hs in stream[tick * HA_SALSA_REQUESTS:
                                           (tick + 1) * HA_SALSA_REQUESTS]:
                    sp.request_params_token(fid, acq, hs)
                    mc3.advance(int(rng.integers(1, 40)))
                blob = R.encode_delta_blob(sp.export_delta())
                fat_bytes.append(len(blob))
                for s in (sk, st):
                    s.apply_replication_delta(R.decode_delta_blob(blob))
                pa, pb = (interop.param_state_to_numpy(s._param_state)
                          for s in (sk, st))
                bad = RC.param_rows_diff(sp, sk, "counts") + [
                    k for k in pa if not np.array_equal(pa[k], pb[k])]
                if bad:
                    raise AssertionError(f"ha salsa tick {tick}: {bad[:8]}")
            salsa_cuda.LAUNCHES.update(dict.fromkeys(salsa_cuda.LAUNCHES, 0))
            last = stream[HA_SALSA_TICKS * HA_SALSA_REQUESTS:]
            for fid, acq, hs in last:
                a = sk.request_params_token(fid, acq, hs).status
                b = st.request_params_token(fid, acq, hs).status
                if a != b:
                    raise AssertionError("ha salsa: the card standby's "
                                         "verdict differs from its twin's")
                mc3.advance(int(rng.integers(1, 40)))
            salsa_launches = salsa_cuda.LAUNCHES["salsa_decide_update"]
        finally:
            clock.set_clock(prev)
        if salsa_launches != len(last):
            raise AssertionError(f"ha salsa: {salsa_launches} launches for "
                                 f"{len(last)} requests")
        # the reference drill's gate: the slim twin's delta >= 4x under the
        # fat rows' for the same traffic
        pbytes = RC.param_delta_bytes(dev)
        if pbytes["ratio"] < 4.0:
            raise AssertionError(f"ha: param delta bytes {pbytes}")
        out["salsa_fat"] = dict(ticks=HA_SALSA_TICKS,
                                delta_bytes=quantiles(fat_bytes),
                                launches=salsa_launches)
        out["param_delta_bytes"] = pbytes
        log(f"ha salsa (fat rows): {HA_SALSA_TICKS} ticks of "
            f"{HA_SALSA_REQUESTS} requests, the card standby equal to the "
            f"primary's rows and to its twin after every apply; "
            f"{salsa_launches} SALSA launches for as many requests with "
            f"equal verdicts. Param delta bytes (the reference drill's "
            f"measure, 2 x 3000 values): slim {pbytes['slim']}, fat "
            f"{pbytes['fat']}, ratio {pbytes['ratio']}")

        # --- 4. the failover drill -------------------------------------------
        out["drill"] = ha_drill(dev, pipe, child, drill_flow,
                                os.path.join(snap_root, "drill"))
    finally:
        for s in servers:
            s.stop()
        if child.is_alive():
            child.kill()
        child.join(10)
        shutil.rmtree(snap_root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ha phase: {out['phase_s']:.1f} s")
    return out


def ha_drill(dev, pipe, child, drill_flow: int, snap_dir: str) -> dict:
    """Part 4 of ``phase_ha``: SIGKILL the replicating primary mid-window
    and hold the promoted standby to the reference drill's gate
    (``benchmarks/ha_drill.py::run_replication_drill``).

    The standby door bootstraps from the primary's snapshot file
    (``snapshot_dir``: ``restore_latest`` at ``start()``, before its
    watchdog runs), so the primary's HELLO finds one epoch and deltas flow
    at once: a 100k-flow import over the wire outlasts both the sender's
    2 s ack timeout and a 1 s watchdog (ROADMAP §C)."""
    import torch_door_check as DK

    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer

    if not pipe.poll(120):
        raise AssertionError("ha drill: the child primary never got ready")
    if pipe.recv() != "ready":
        raise AssertionError("ha drill: the child primary failed")
    window_tokens = int(HA_DRILL_QPS * HA_DRILL_BUCKET_MS * 10 / 1000)
    svc = ha_service(dev, bucket_ms=HA_DRILL_BUCKET_MS)
    standby = NativeTokenServer(svc, port=0, idle_ttl_s=None,
                                standby_of="primary",
                                promote_after_ms=HA_PROMOTE_AFTER_MS,
                                snapshot_dir=snap_dir,
                                snapshot_period_s=3600.0)
    t0 = time.perf_counter()
    standby.start()  # restores the primary's artifact into the cold service
    boot_ms = (time.perf_counter() - t0) * 1e3
    try:
        if not svc.current_rules():
            raise AssertionError("ha drill: the standby restored nothing")
        pipe.send(standby.port)
        if not pipe.poll(60):
            raise AssertionError("ha drill: the child's door never started")
        primary_port = pipe.recv()
        wait_for(lambda: standby.applier.status()["deltasApplied"] >= 2,
                 "deltas after the file bootstrap", 30.0)
        if standby.applier.status()["snapshotsApplied"]:
            raise AssertionError("ha drill: the HELLO asked a snapshot")
        if not standby.is_standby:
            raise AssertionError("ha drill: the standby promoted itself "
                                 "while its primary lived")
        ids = np.full(HA_DRILL_ROWS, drill_flow, np.int64)
        to_primary = DK.RawConn(P, primary_port, timeout_s=5.0)
        to_standby = DK.RawConn(P, standby.port, timeout_s=5.0)
        to_primary.ping(1)
        to_standby.ping(1)
        xid = [10]

        def pull(conn):
            xid[0] += 1
            conn.send(P.encode_batch_request(xid[0], ids))
            return P.decode_batch_response(conn.recv())[1]

        period = 1.0 / HA_DRILL_RATE
        fill = post = blocks = 0
        converge_ms = None
        try:
            # fill: paced pulls to the middle of the window
            t_fill = next_t = time.monotonic()
            while fill < window_tokens // 2:
                next_t += period
                time.sleep(max(0.0, next_t - time.monotonic()))
                fill += int((pull(to_primary) == 0).sum())
                if time.monotonic() - t_fill > 5.0:
                    raise AssertionError("ha drill: the fill stalled")
            fill_rate = fill / max(time.monotonic() - t_fill, 1e-6)
            # mid-load: keep admitting until two more deltas have landed,
            # the second captured after every fill admission
            base = standby.applier.status()["deltasApplied"]
            t_grace = time.monotonic()
            while standby.applier.status()["deltasApplied"] < base + 2:
                next_t += period
                time.sleep(max(0.0, next_t - time.monotonic()))
                fill += int((pull(to_primary) == 0).sum())
                if time.monotonic() - t_grace > 5.0:
                    raise AssertionError("ha drill: no deltas under load")
            child.kill()  # SIGKILL: no final ship, no shutdown hook
            t_kill = time.monotonic()
            child.join(10)
            standby_answers = 0
            while time.monotonic() - t_kill < (HA_PROMOTE_AFTER_MS / 1000.0
                                               + 1.0):
                next_t += period
                time.sleep(max(0.0, next_t - time.monotonic()))
                st = pull(to_standby)
                if (st == 9).all():  # STANDBY: not promoted yet
                    standby_answers += 1
                    continue
                if converge_ms is None:
                    converge_ms = (time.monotonic() - t_kill) * 1e3
                post += int((st == 0).sum())
                blocks += int((st == 1).sum())
        finally:
            to_primary.close()
            to_standby.close()
    finally:
        standby.stop()
    total = fill + post
    budget = int(fill_rate * HA_INTERVAL_MS / 1000.0) + HA_DRILL_ROWS
    over = max(0, total - window_tokens)
    res = dict(window_tokens=window_tokens, fill_rate_tokens_per_s=fill_rate,
               admitted_before_kill=fill, admitted_after_kill=post,
               over_admission=over, budget=budget,
               kill_to_first_verdict_ms=converge_ms,
               standby_answers_before_promotion=standby_answers,
               standby_blocks=blocks, bootstrap_ms=boot_ms,
               promote_after_ms=HA_PROMOTE_AFTER_MS)
    log(f"ha drill: {fill} admitted before the SIGKILL, {post} after, over "
        f"a {window_tokens}-token window: over-admission {over} against a "
        f"budget of {budget} (one {HA_INTERVAL_MS} ms ship interval at "
        f"{fill_rate:.0f} tokens/s, plus one pull); SIGKILL to the first "
        f"verdict the standby served {converge_ms} ms (promote_after_ms "
        f"{HA_PROMOTE_AFTER_MS:.0f}); {blocks} rows blocked by the promoted "
        f"standby; its start() with restore_latest took {boot_ms:.0f} ms")
    if converge_ms is None:
        raise AssertionError("ha drill: the standby never served")
    if over > budget:
        raise AssertionError(f"ha drill: over-admitted {over} > {budget}")
    if not blocks:
        raise AssertionError("ha drill: the promoted standby never blocked")
    return res


# --- phase 11: namespace MOVE between two doors ------------------------------
MOVE_EPOCH = 7  # the shard-map epoch of the first move
MOVE_NS, ABORT_NS, LIVE_NS = "ns0", "ns2", "ns4"
MOVE_ROUNDS = 4  # the destination's lockstep rounds on the moved namespace
MOVE_PARAM_REQUESTS = 200  # on the moved param rules, before the move
# the lossy move's ack timeout (the reference's test takes 0.5 s): the lost
# frame costs one timeout. The committed moves keep the reference's 5 s
# default; their COMMIT ack waits for the destination's import, which took
# 0.53-0.95 s at 100k flows on the card's host
MOVE_ABORT_ACK_S = 2.0
LIVE_PULL = 1024
LIVE_LEAD_S = 1.0  # closed-loop traffic before the live move begins
LIVE_TAIL_S = 1.0  # and after it commits
MOVED_STATUS = 10
SALSA_ACQUIRE = 2000  # acquire multiplier of the SALSA stream: pairs merge


def move_rules():
    """Phase 9's rules with the param rules whose flow id is 0 mod ``NS``
    in ``MOVE_NS`` (four of the 256), so that param state moves too."""
    import dataclasses

    flow, degrade, params = flow_rules()
    params = [dataclasses.replace(p, namespace=MOVE_NS)
              if p.flow_id % NS == 0 else p for p in params]
    return flow, degrade, params


def ns_of(fid: int) -> str:
    return f"ns{fid % NS}"


def docs_diff(a: dict, b: dict, skip=("wall_ms",)) -> list:
    """The keys in which two export documents differ: rules by the rule
    codec, arrays bitwise with the dtype."""
    from sentinel_tpu_torch.engine.rules import (
        encode_degrade_rule,
        encode_rule,
    )

    bad = sorted(set(a) ^ set(b))
    for key in set(a) & set(b):
        if key in skip:
            continue
        x, y = a[key], b[key]
        if key == "rules":
            same = [encode_rule(r) for r in x] == [encode_rule(r) for r in y]
        elif key == "degrade_rules":
            same = ([encode_degrade_rule(r) for r in x]
                    == [encode_degrade_rule(r) for r in y])
        elif isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            bad.append(key)
    return bad


def over_admission(spans, admitted, thresholds, window_ms: int) -> int:
    """The largest excess over a flow's window threshold of the tokens
    admitted, summed over both doors, within any span shorter than
    ``window_ms`` (the window less one bucket: such a span lies in one
    window of either door). ``spans`` is ``[(sent, received)]`` per pull in
    order, ``admitted`` ``[pulls, flows]`` the OK rows per flow."""
    sent = np.array([s for s, _ in spans])
    recv = np.array([r for _, r in spans])
    cum = np.vstack([np.zeros((1, admitted.shape[1]), np.int64),
                     np.cumsum(admitted, axis=0)])
    worst = 0
    for i in range(len(spans)):
        j = int(np.searchsorted(recv, sent[i] + window_ms, side="left"))
        if j <= i:
            continue
        excess = (cum[j] - cum[i]) - thresholds
        worst = max(worst, int(excess.max()))
    return worst


def phase_move(torch, dev):
    """Namespace MOVE between two port doors at phase 9's widths.

    The source door serves phase 9's configuration (100k flows in
    ``NS`` namespaces, a breaker on every 10th, 256 param rules, four of
    them in ``MOVE_NS``); the destination door already serves the odd
    namespaces (~50k flows) and the param rules outside ``MOVE_NS``; a
    twin of the destination on the torch-ops cores imports every document
    the destination imports, at the same manual clock.

    1. Phase 9's lockstep (2 rounds) and ``MOVE_PARAM_REQUESTS`` param
       requests on the moved rules feed the source; ``MoveCoordinator``
       moves ``MOVE_NS`` at ``MOVE_EPOCH``. Then the source answers MOVED
       with the epoch for every moved row of a grouped 16384-row and a fused
       65536-row Zipf pull and counts none of them (its document is
       bit-equal before and after); the destination's document equals the
       source's last; ``MOVE_ROUNDS`` lockstep rounds of the moved
       namespace's pulls, PARAM_FLOW frames on the moved param rules and a
       1024-row report through the destination door equal the twin's, one
       decide launch a device step and one count-min launch a frame.
    2. A MOVE_STATE frame of a move of ``ABORT_NS`` is lost (chaos
       ``frame_drop`` in a proxy between the doors): the move aborts, the
       source's document is bit-equal, nothing is staged; a retry commits.
    3. ``LIVE_NS`` moves under one client's closed loop of 1024-row Zipf
       pulls on the system clock, its MOVED rows re-sent to the
       destination: the tokens admitted on each of its flows, summed over
       both doors within any span shorter than a window, stay within the
       flow's count (over-admission 0).
    4. SALSA with fat rows (``slim_width=0``), param rules only: a move of
       ``MOVE_NS``'s param rules; the destination's verdicts equal its
       twin's, its folded plane re-encodes to itself, and the SALSA kernel
       launches once a request.
    """
    import torch_door_check as DK
    import torch_kernel_check as DC
    import torch_param_check as PC
    import torch_repl_check as RC

    from sentinel_tpu_torch import chaos
    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.rebalance import (
        MoveCoordinator,
        decode_move_state_blob,
        encode_move_state_blob,
    )
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.metrics.ha import ha_metrics
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K
    from sentinel_tpu_torch.sketch import salsa as SA

    t_phase = time.perf_counter()
    out = {}
    flow, degrade, params = move_rules()
    moved_params = [p.flow_id for p in params if p.namespace == MOVE_NS]
    if len(moved_params) != 4:
        raise AssertionError(f"move: {len(moved_params)} param rules in "
                             f"{MOVE_NS}")
    odd = [r for r in flow if (r.flow_id % NS) % 2]
    dst_rules = (odd, [d for d in degrade if (d.flow_id % NS) % 2],
                 [p for p in params if p.namespace != MOVE_NS])
    zipf = DC.ZipfIds(F, alpha=1.1)
    flow_ids = np.arange(F, dtype=np.int64)
    mc = clock.ManualClock(int(time.time() * 1000) - 60_000)
    prev = clock.set_clock(mc)
    servers = []
    reb0 = ha_metrics().snapshot()["rebalance"]

    def moved_rows(ids, ns):
        return np.array([ns_of(int(f)) == ns for f in ids])

    try:
        src_svc = ha_service(dev, (flow, degrade, params), conc=True)
        dst_svc = ha_service(dev, dst_rules)
        twin = ha_service(dev, dst_rules, twin=True)
        src = NativeTokenServer(src_svc, host="127.0.0.1", port=0,
                                idle_ttl_s=None)
        dst = NativeTokenServer(dst_svc, host="127.0.0.1", port=0,
                                idle_ttl_s=None)
        servers += [src, dst]
        src.start()
        dst.start()
        twin.warmup()
        src_ep = f"127.0.0.1:{src.port}"
        dst_ep = f"127.0.0.1:{dst.port}"
        log(f"move: source {len(flow)} flows, destination {len(odd)} flows "
            f"(the odd namespaces) and a torch-ops twin; doors up in "
            f"{time.perf_counter() - t_phase:.1f} s")

        # the destination's imports, timed, and each document for the twin
        imports = []
        dst_import = dst_svc.import_namespace_state

        def timed_import(doc):
            t0 = time.perf_counter()
            dst_import(doc)
            imports.append(((time.perf_counter() - t0) * 1e3, doc))

        dst_svc.import_namespace_state = timed_import
        commits = []
        dst_commit = dst.move_target._commit

        def timed_commit(*args):
            t0 = time.perf_counter()
            code = dst_commit(*args)
            commits.append((time.perf_counter() - t0) * 1e3)
            return code

        dst.move_target._commit = timed_commit
        exports = []
        held = LockHeld(src_svc._lock)
        src_export = src_svc.export_namespace_state

        def timed_export(ns):
            held.watch, held.ms = threading.get_ident(), 0.0
            t0 = time.perf_counter()
            doc = src_export(ns)
            exports.append({"export_ms": (time.perf_counter() - t0) * 1e3,
                            "lock_ms": held.ms})
            return doc

        def timed_move(coord, ns, epoch=None):
            """One move, timed from the begin to the COMMIT ack; the source's
            export is timed inside it."""
            src_svc._lock = held
            src_svc.export_namespace_state = timed_export
            b0 = ha_metrics().snapshot()["rebalance"]["stateBytesTotal"]
            try:
                t0 = time.perf_counter()
                ok = coord.move_namespace(ns, dst_ep, epoch=epoch)
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                src_svc._lock = held.lock
                del src_svc.export_namespace_state
            return ok, {"move_ms": ms, "state_bytes": ha_metrics().snapshot()[
                "rebalance"]["stateBytesTotal"] - b0, **exports[-1]}

        # --- 1. the source's traffic, then the move ---------------------
        steps = DK.lockstep_plan(
            np.random.default_rng(61), zipf, flow_ids, DOOR_PULLS,
            [p.flow_id for p in params], door_lease_flows(),
            DOOR_CONC_FLOWS, HA_ROUNDS, P.MAX_BATCH_PER_FRAME,
            OUTCOME_ADVANCES_MS)
        conn = DK.RawConn(P, src.port)
        try:
            conn.ping(1)
            DK.run_lockstep(P, conn, steps, mc.advance)
        finally:
            conn.close()
        specs = [s for s in PC.service_rule_specs(256, np.random.default_rng(
            41)) if s.flow_id in moved_params]
        for fid, acq, hashes in PC.service_stream(
                specs, np.random.default_rng(62), MOVE_PARAM_REQUESTS):
            src_svc.request_params_token(fid, acq, hashes)
            mc.advance(1)
        doc_src = src_svc.export_namespace_state(MOVE_NS)
        coord = MoveCoordinator(src_svc, self_endpoint=src_ep)
        ok, first = timed_move(coord, MOVE_NS, epoch=MOVE_EPOCH)
        if not ok:
            raise AssertionError(f"move: {MOVE_NS} did not commit: "
                                 f"{coord.last_error}")
        first.update(commit_ms=commits[-1], import_ms=imports[-1][0])
        twin.import_namespace_state(imports[-1][1])
        bad = (RC.flow_rows_diff(dst_svc, twin)
               + RC.param_rows_diff(dst_svc, twin, "counts"))
        if bad:
            raise AssertionError(f"move: the twin's import differs: {bad}")
        got = dst_svc.export_namespace_state(MOVE_NS)
        bad = docs_diff(doc_src, got)
        if bad:
            raise AssertionError(f"move: the destination's document differs "
                                 f"from the source's last in {bad}")
        # both pulls at the export's clock: no bucket expires between the
        # two documents compared below
        rng = np.random.default_rng(63)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        moved_answers = 0
        for n in (SIZES[-1], FUSED_DEPTH * SIZES[-1]):
            ids = flow_ids[zipf(rng, n)]
            st, rem, _w = src_svc.request_batch_arrays(ids)
            m = moved_rows(ids, MOVE_NS)
            if not (m.any() and (st[m] == MOVED_STATUS).all()
                    and (rem[m] == MOVE_EPOCH).all()
                    and not (st[~m] == MOVED_STATUS).any()):
                raise AssertionError(f"move: a {n}-row pull's MOVED rows "
                                     f"are not the moved namespace's")
            moved_answers += int(m.sum())
        if K.LAUNCHES["decide_rows"] != 1 + FUSED_DEPTH:
            raise AssertionError(f"move: {K.LAUNCHES['decide_rows']} decide "
                                 f"launches for {1 + FUSED_DEPTH} steps")
        bad = docs_diff(doc_src, src_svc.export_namespace_state(MOVE_NS))
        if bad:
            raise AssertionError(f"move: masked rows changed the source's "
                                 f"{bad}")
        ns_ids = flow_ids[flow_ids % NS == 0]
        ns_zipf = DC.ZipfIds(ns_ids.size, alpha=1.1)
        steps = DK.lockstep_plan(
            np.random.default_rng(64), ns_zipf, ns_ids, DOOR_PULLS,
            moved_params, [], [], MOVE_ROUNDS, P.MAX_BATCH_PER_FRAME,
            OUTCOME_ADVANCES_MS)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
        conn = DK.RawConn(P, dst.port)
        try:
            conn.ping(1)
            _replies, counts = DK.run_lockstep(P, conn, steps, mc.advance,
                                               twin=twin)
        finally:
            conn.close()
        if (K.LAUNCHES["decide_rows"] != counts["device_steps"]
                or cms_cuda.LAUNCHES["cms_decide_update"]
                != counts["param_frames"]):
            raise AssertionError(
                f"move: destination launches {K.LAUNCHES['decide_rows']} / "
                f"{cms_cuda.LAUNCHES['cms_decide_update']} for {counts}")
        for name in ("outcome_stats", "breaker_stats"):
            if getattr(dst_svc, name)() != getattr(twin, name)():
                raise AssertionError(f"move: {name} differs from the twin")
        out["move"] = dict(first, moved_rows=int(moved_answers),
                           destination_lockstep=dict(
                               counts, frames=len(steps),
                               decide_launches=K.LAUNCHES["decide_rows"],
                               param_launches=cms_cuda.LAUNCHES[
                                   "cms_decide_update"]),
                           flows=len(doc_src["flow_ids"]),
                           param_rules=len(doc_src["param_fids"]))
        log(f"move {MOVE_NS}: {len(doc_src['flow_ids'])} flows and "
            f"{len(doc_src['param_fids'])} param rules committed in "
            f"{first['move_ms']:.1f} ms (export {first['export_ms']:.1f} ms "
            f"holding the lock {first['lock_ms']:.1f} ms; "
            f"{first['state_bytes']} MOVE_STATE bytes; destination commit {first['commit_ms']:.1f} "
            f"ms, import {first['import_ms']:.1f} ms); the source answered "
            f"{moved_answers} rows MOVED with epoch {MOVE_EPOCH} through a "
            f"grouped and a fused (depth {FUSED_DEPTH}) pull, counting none; "
            f"the destination's document is the source's last; "
            f"{len(steps)} lockstep frames through the destination equal "
            f"the twin's ({counts}), one decide launch a device step, one "
            f"count-min launch a PARAM_FLOW frame")

        # --- 2. a lost MOVE_STATE frame aborts; a retry commits ----------
        doc_abort = src_svc.export_namespace_state(ABORT_NS)
        proxy = DK.FrameDropProxy(P, dst.port, P.MsgType.MOVE_STATE,
                                  should=lambda: chaos.should("frame_drop"))
        try:
            lossy = MoveCoordinator(src_svc, self_endpoint=src_ep,
                                    ack_timeout_s=MOVE_ABORT_ACK_S)
            chaos.arm("frame_drop:n=1", seed=65)
            try:
                t0 = time.perf_counter()
                aborted = lossy.move_namespace(
                    ABORT_NS, f"127.0.0.1:{proxy.port}", epoch=MOVE_EPOCH + 1)
                abort_ms = (time.perf_counter() - t0) * 1e3
                dropped = chaos.fired().get("frame_drop", 0)
            finally:
                chaos.disarm()
        finally:
            proxy.close()
        if aborted or dropped != 1 or proxy.dropped != 1:
            raise AssertionError(f"move: the lossy move of {ABORT_NS} "
                                 f"({aborted}, {dropped} dropped)")
        wait_for(lambda: not dst.move_target.status()["staged"],
                 "the destination's staging to empty", 10.0)
        bad = docs_diff(doc_abort, src_svc.export_namespace_state(ABORT_NS))
        if bad or dst_svc.current_rules(ABORT_NS) or \
                src_svc.moving_namespaces().get(ABORT_NS):
            raise AssertionError(f"move: the abort was not lossless: {bad}")
        ok, retry = timed_move(coord, ABORT_NS, epoch=MOVE_EPOCH + 2)
        if not ok:
            raise AssertionError(f"move: the retry of {ABORT_NS} did not "
                                 f"commit: {coord.last_error}")
        retry.update(commit_ms=commits[-1], import_ms=imports[-1][0])
        if docs_diff(doc_abort, dst_svc.export_namespace_state(ABORT_NS)):
            raise AssertionError("move: the retry's document differs")
        twin.import_namespace_state(imports[-1][1])
        out["abort"] = dict(abort_ms=abort_ms, last_error=lossy.last_error,
                            retry=retry)
        log(f"move {ABORT_NS}: a MOVE_STATE frame lost between the doors "
            f"aborted the move after {abort_ms:.1f} ms ({lossy.last_error}); "
            f"the source's document bit-equal, nothing staged; the retry "
            f"committed in {retry['move_ms']:.1f} ms (import "
            f"{retry['import_ms']:.1f} ms)")

        # --- 3. a live move under a closed loop on the system clock ------
        clock.set_clock(prev)
        live_ids = flow_ids[flow_ids % NS == 4]
        thresholds = np.array([src_svc._rule_of[int(f)].count
                               for f in live_ids], np.int64)
        col_of = np.full(F, -1, np.int64)
        col_of[live_ids] = np.arange(live_ids.size)
        spans, admitted = [], []
        mover, result = None, {}

        blocked = [0]

        def count_ok(row, ids, st):
            cols = col_of[ids[st == 0]]
            np.add.at(row, cols[cols >= 0], 1)
            blocked[0] += int((col_of[ids[st == 1]] >= 0).sum())

        def live():
            result["ok"], result["move"] = timed_move(coord, LIVE_NS,
                                                      epoch=MOVE_EPOCH + 3)

        rng = np.random.default_rng(66)
        a = DK.RawConn(P, src.port)
        b = DK.RawConn(P, dst.port)
        live_moved = 0
        try:
            a.ping(1)
            b.ping(1)
            xid = 0
            t_begin = time.monotonic()
            t_stop = None
            while t_stop is None or time.monotonic() < t_stop:
                if mover is None and time.monotonic() - t_begin > LIVE_LEAD_S:
                    mover = threading.Thread(target=live)
                    mover.start()
                if mover is not None and t_stop is None \
                        and not mover.is_alive():
                    t_stop = time.monotonic() + LIVE_TAIL_S
                ids = flow_ids[zipf(rng, LIVE_PULL)]
                xid += 1
                sent = time.time() * 1e3
                a.send(P.encode_batch_request(xid, ids))
                st = P.decode_batch_response(a.recv())[1]
                row = np.zeros(live_ids.size, np.int64)
                m = st == MOVED_STATUS
                if m.any():
                    live_moved += int(m.sum())
                    xid += 1
                    b.send(P.encode_batch_request(xid, ids[m]))
                    st2 = P.decode_batch_response(b.recv())[1]
                    count_ok(row, ids[m], st2)
                count_ok(row, ids, st)
                spans.append((sent, time.time() * 1e3))
                admitted.append(row)
        finally:
            a.close()
            b.close()
            if mover is not None:
                mover.join(timeout=120)
        if not result.get("ok"):
            raise AssertionError(f"move: the live move of {LIVE_NS} did not "
                                 f"commit: {coord.last_error}")
        live_move = result["move"]
        live_move.update(commit_ms=commits[-1], import_ms=imports[-1][0])
        window = window_less_bucket_ms(src_svc)
        over = over_admission(spans, np.array(admitted), thresholds, window)
        total = int(np.array(admitted).sum())
        if over != 0 or not live_moved:
            raise AssertionError(f"move: live over-admission {over} "
                                 f"({live_moved} rows MOVED)")
        out["live"] = dict(live_move, pulls=len(spans), moved_rows=live_moved,
                           admitted=total, blocked=blocked[0],
                           over_admission=over, span_ms=window)
        log(f"move {LIVE_NS} live: {len(spans)} pulls of {LIVE_PULL} rows; "
            f"the move committed in {live_move['move_ms']:.1f} ms (export "
            f"{live_move['export_ms']:.1f} ms, lock "
            f"{live_move['lock_ms']:.1f} ms, "
            f"{live_move['state_bytes']} B, import "
            f"{live_move['import_ms']:.1f} ms); {live_moved} rows answered "
            f"MOVED and re-sent; {total} tokens admitted and {blocked[0]} "
            f"rows blocked on its flows over both doors; over-admission "
            f"{over} (spans under {window} ms)")
    finally:
        clock.set_clock(prev)
        for s in servers:
            s.stop()

    # --- 4. SALSA, fat rows: a param namespace moves ----------------------
    mc = clock.ManualClock(int(time.time() * 1000) - 30_000)
    prev = clock.set_clock(mc)
    salsa = {}
    try:
        import dataclasses

        # two of the moved rules unbounded, so that SALSA pairs saturate and
        # merge on the source; the other two keep their thresholds
        unbounded = set(moved_params[:2])
        src_p = [dataclasses.replace(p, count=1e9, item_thresholds=None)
                 if p.flow_id in unbounded else p for p in params]
        dst_p = [p for p in params if p.namespace != MOVE_NS]
        s_src = ha_service(dev, ([], [], src_p), sketch="salsa", slim_width=0)
        s_dst = ha_service(dev, ([], [], dst_p), sketch="salsa", slim_width=0)
        s_twin = ha_service(dev, ([], [], dst_p), twin=True, sketch="salsa",
                            slim_width=0)
        door = NativeTokenServer(s_dst, host="127.0.0.1", port=0,
                                 idle_ttl_s=None)
        door.start()
        try:
            stream = PC.service_stream(specs, np.random.default_rng(67),
                                       2 * MOVE_PARAM_REQUESTS)
            half = len(stream) // 2
            for fid, acq, hashes in stream[:half]:
                s_src.request_params_token(fid, acq * SALSA_ACQUIRE, hashes)
                mc.advance(1)
            merges = int(s_src._param_state.merges.sum())
            ok = MoveCoordinator(s_src, self_endpoint="src:1").move_namespace(
                MOVE_NS, f"127.0.0.1:{door.port}", epoch=MOVE_EPOCH)
        finally:
            door.stop()
        if not ok:
            raise AssertionError("move: the SALSA move did not commit")
        doc = s_src.export_namespace_state(MOVE_NS)
        s_twin.import_namespace_state(decode_move_state_blob(
            encode_move_state_blob(doc)))
        counts = s_dst._param_state.counts
        dec, merged = SA.decode_plane(counts)
        again, newly = SA.encode_plane(dec, merged)
        if not torch.equal(again, counts) or bool(newly.any()):
            raise AssertionError("move: the folded SALSA plane does not "
                                 "re-encode to itself")
        salsa_cuda.LAUNCHES.update(dict.fromkeys(salsa_cuda.LAUNCHES, 0))
        verdicts = {}
        for fid, acq, hashes in stream[half:]:
            a_ = s_dst.request_params_token(fid, acq * SALSA_ACQUIRE, hashes)
            b_ = s_twin.request_params_token(fid, acq * SALSA_ACQUIRE, hashes)
            if a_ != b_:
                raise AssertionError(f"move: SALSA verdicts differ: {a_} "
                                     f"!= {b_}")
            verdicts[int(a_.status)] = verdicts.get(int(a_.status), 0) + 1
            mc.advance(1)
        launches = salsa_cuda.LAUNCHES["salsa_decide_update"]
        bad = RC.param_rows_diff(s_dst, s_twin, "counts")
        if bad:
            raise AssertionError(f"move: SALSA rows differ from the twin's: "
                                 f"{bad}")
        if launches != len(stream) - half:
            raise AssertionError(f"move: {launches} SALSA launches for "
                                 f"{len(stream) - half} requests")
        salsa = dict(merges_before=merges, requests=len(stream) - half,
                     launches=launches, verdicts=verdicts)
        log(f"move SALSA (fat rows): {MOVE_NS}'s param rules moved with "
            f"{merges} merges on the source; the folded plane re-encodes "
            f"to itself; {launches} SALSA launches for as many requests, "
            f"verdicts {verdicts} equal to the twin's")
    finally:
        clock.set_clock(prev)
    out["salsa"] = salsa
    reb = ha_metrics().snapshot()["rebalance"]
    out["rebalance"] = {
        "events": {k: v - reb0["events"].get(k, 0)
                   for k, v in reb["events"].items()},
        "redirects": reb["redirectsTotal"] - reb0["redirectsTotal"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"move phase: {out['phase_s']:.1f} s; rebalance events "
        f"{out['rebalance']}")
    return out


HIER_FLOWS = 16  # global flows of the drill: 0-3 and 12 spread over ranks
HIER_ROWS = 64  # rows of each global flow in a drill burst (1024 a pull)
HIER_RECONCILE_MS = 200
HIER_SHARE_TTL_MS = 30_000
HIER_HOLD_ROUNDS = 12  # rounds of 12a's hold sequence
HIER_STEP_MS = 25  # manual-clock step of the drill's flat-out windows
SHM_PULLS = 40  # 12b's lockstep pulls
SHM_ROWS = 1024
RTT_PULLS = 200  # 12b's timed pulls per client
HOLD_TIMED = 20  # timed set_share_hold / demand_rates calls


def hier_flows(rng) -> list:
    """The drill's 16 global flows: the four Zipf-hottest and one seeded
    plain (unshaped) flow in each of 12 geometric rank bands."""
    edges = np.geomspace(4, F, HIER_FLOWS - 3).astype(np.int64)
    out = [0, 1, 2, 3]
    for lo, hi in zip(edges[:-1], edges[1:]):
        while True:
            fid = int(rng.integers(lo, max(lo + 1, hi)))
            if fid % 97 and fid % 89 and fid % 83 and fid not in out:
                out.append(fid)
                break
    return out


def phase_hier(torch, dev):
    """The hierarchy tier, the asyncio door and the token clients at phase
    9's widths (``phase_hier``).

    12a. Phase 9's configuration on the card behind the port's asyncio
       ``TokenServer``, and its torch-ops twin behind a second one; the
       port's ``TokenClient`` sends each phase 9's lockstep rounds
       (``torch_hier_check.client_lockstep``) and then a hold sequence on
       the 16 global flows (``set_share_hold`` / ``share_holds`` /
       ``demand_rates`` / ``window_budget`` with pulls through the doors,
       the manual clock crossing bucket and window edges); every answer and
       at the end every state leaf is equal; decide launches equal device
       steps, count-min launches PARAM_FLOW frames; a 16384-row pull's
       grouped dispatch through the door runs under torch's sync debug
       mode.
    12b. The port's ``ShmTokenClient`` sends 1024-row pulls to a port
       ``NativeTokenServer`` over the same card service (``shm_dir``),
       equal to the same pulls given to the twin in process.
    12c. The reference's hierarchy drill (``benchmarks/ha_drill.py::
       run_hier_drill``) at 100k flows on a manual clock: pod A behind the
       asyncio door hosting the ``GlobalBudgetCoordinator``, pod B behind
       the native door, one ``PodShareAgent`` each through the port's
       ``TokenClient``, 16 global flows each budgeted at its rule count;
       bootstrap, skew, flip, a decision burst, a live flat-out window, a
       seeded ``conn_reset``, the coordinator dark and the recovery, every
       gate per flow; then the ledger through ``export_state`` into a card
       standby and the ``ServerMetrics`` hierarchy block.

    Then timings on the system clock: the asyncio door's closed loop (one
    client, phase 9's client code), shm and TCP pull RTTs at 1024 rows on
    the native door; an agent tick, ``set_share_hold`` (and the ms it
    holds the service lock), ``demand_rates`` and ``reconcile_once``.
    """
    import torch_door_check as DK
    import torch_hier_check as HC
    import torch_kernel_check as DC

    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.cluster.concurrent import ConcurrentFlowRule
    from sentinel_tpu_torch.cluster.server import TokenServer
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.cluster.shm_client import ShmTokenClient
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    t_phase = time.perf_counter()
    ident = gpu_identity()
    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1])
    rules, degrade, param_rules = flow_rules()
    param_flows = [r.flow_id for r in param_rules]
    flows = hier_flows(np.random.default_rng(61))
    zipf = DC.ZipfIds(F, alpha=1.1)
    flow_ids = np.arange(F, dtype=np.int64)
    out = {"flows": flows}

    def service(twin=False):
        c = cfg._replace(decide_impl="xla") if twin else cfg
        pc = ParamConfig(impl="jax" if twin else "auto")
        s = DefaultTokenService(c, param_config=pc, device=dev)
        s.load_degrade_rules(degrade)
        s.load_rules(rules, ns_max_qps=1e9)
        s.load_param_rules(param_rules)
        s.load_concurrent_rules([ConcurrentFlowRule(
            f, 2, resource_timeout_ms=600_000) for f in DOOR_CONC_FLOWS])
        return s

    def fails_in(st) -> int:
        return int((np.asarray(st) == HC.FAIL).sum())

    mc = clock.ManualClock(int(time.time() * 1000) - 60_000)
    prev = clock.set_clock(mc)
    shm_dir = os.path.join(HERE, "sentinel_tpu_torch", "build", "shm12")
    os.makedirs(shm_dir, exist_ok=True)
    t0 = time.perf_counter()
    svc, twin = service(), service(twin=True)
    # push=False: a pushed breaker flip makes a client answer DEGRADED on
    # its own monotonic clock, without a frame; the lockstep holds wire
    # answers at the manual clock, so every request must reach a door
    door = TokenServer(svc, host="127.0.0.1", port=0, idle_ttl_s=None,
                       push=False)
    twin_door = TokenServer(twin, host="127.0.0.1", port=0, idle_ttl_s=None,
                            push=False)
    native = NativeTokenServer(svc, host="127.0.0.1", port=0,
                               idle_ttl_s=None, shm_dir=shm_dir)
    clients = []
    try:
        door.start()
        twin_door.start()
        native.start()
        out["setup_s"] = time.perf_counter() - t0
        c_card = TokenClient("127.0.0.1", door.port, timeout_ms=60_000)
        c_twin = TokenClient("127.0.0.1", twin_door.port, timeout_ms=60_000)
        clients += [c_card, c_twin]

        # --- 12a. lockstep through the asyncio door ---------------------
        steps = DK.lockstep_plan(
            np.random.default_rng(53), zipf, flow_ids, DOOR_PULLS,
            param_flows, door_lease_flows(), DOOR_CONC_FLOWS, DOOR_ROUNDS,
            P.MAX_BATCH_PER_FRAME, OUTCOME_ADVANCES_MS)
        c_card.ping()
        c_twin.ping()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
        t0 = time.perf_counter()
        ls = HC.client_lockstep(P, [c_card, c_twin], steps, mc.advance)
        lockstep_s = time.perf_counter() - t0
        others = [int(f) for f in zipf(np.random.default_rng(59), 16)]
        hold = HC.run_hold_plan(
            [(svc, c_card.request_batch_arrays),
             (twin, c_twin.request_batch_arrays)],
            HC.hold_plan(np.random.default_rng(57), flows, HIER_HOLD_ROUNDS,
                         others=others),
            mc.advance)
        launches = K.LAUNCHES["decide_rows"]
        param_launches = cms_cuda.LAUNCHES["cms_decide_update"]
        if launches != ls["device_steps"] + hold["pulls"]:
            raise AssertionError(
                f"hier: decide kernel launched {launches} times for "
                f"{ls['device_steps']} + {hold['pulls']} device steps")
        if param_launches != ls["param_frames"]:
            raise AssertionError(
                f"hier: count-min launched {param_launches} times for "
                f"{ls['param_frames']} PARAM_FLOW frames")
        if ls["fails"] or hold["fails"]:
            raise AssertionError(f"hier: FAIL answers: lockstep "
                                 f"{ls['fails']}, holds {hold['fails']}")
        if not (ls["statuses"].get(12) and hold["holds"]
                and svc.lease_stats()["granted"]):
            raise AssertionError(
                f"hier: the lockstep reached too little: {ls['statuses']}, "
                f"holds {hold['holds']}")

        # one grouped 16384-row dispatch through the door under sync debug
        # mode: the mode is process-wide, so a lock keeps every
        # materialize out of the window in which it is on
        dispatch = svc.dispatch_batch_arrays
        gate = threading.Lock()
        checked = []

        def checked_dispatch(ids, counts=None, prios=None):
            with gate:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    mat = dispatch(ids, counts, prios)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                checked.append(len(ids))

            def materialize():
                with gate:
                    return mat()
            return materialize

        ids = zipf(np.random.default_rng(67), SIZES[-1])
        torch.cuda.synchronize()
        svc.dispatch_batch_arrays = checked_dispatch
        try:
            a = c_card.request_batch_arrays(ids)
        finally:
            del svc.dispatch_batch_arrays
        b = c_twin.request_batch_arrays(ids)
        if a is None or not all(np.array_equal(x, y) for x, y in zip(a, b)) \
                or fails_in(a[0]) or sum(checked) != ids.size:
            raise AssertionError(f"hier: the sync-checked pull ({checked}) "
                                 f"differs from the twin's or failed")
        bad = [f"{pn}.{f}" for pn, pa, pb in zip(
                   svc._state._fields, svc._state, twin._state)
               for f, x, y in zip(pa._fields, pa, pb) if not torch.equal(x, y)]
        bad += [f"param.{f}" for f, x, y in zip(
                    svc._param_state._fields, svc._param_state,
                    twin._param_state) if not torch.equal(x, y)]
        for name in ("outcome_stats", "breaker_stats", "lease_stats"):
            if getattr(svc, name)() != getattr(twin, name)():
                bad.append(name)
        if bad:
            raise AssertionError(f"hier: {bad} differ from the twin's")
        out["lockstep"] = dict(
            steps=len(steps), kinds=ls["kinds"], seconds=lockstep_s,
            decide_launches=launches, param_launches=param_launches,
            device_steps=ls["device_steps"] + hold["pulls"],
            param_frames=ls["param_frames"], verdicts=ls["statuses"],
            hold_calls=hold["hold_calls"], hold_pulls=hold["pulls"],
            hold_verdicts=hold["statuses"], holds_last=hold["holds"],
            sync_checked_dispatches=len(checked))
        log(f"hier 12a: {len(steps)} frames ({ls['kinds']}) and "
            f"{hold['hold_calls']} share holds with {hold['pulls']} pulls "
            f"through the asyncio door equal to the twin's, every state leaf "
            f"equal; {launches} decide launches = device steps, "
            f"{param_launches} count-min launches = PARAM_FLOW frames; "
            f"verdicts {ls['statuses']}; {len(checked)} grouped dispatches "
            f"of a 16384-row pull make no synchronizing call")

        # --- 12b. the shared-memory client ------------------------------
        shm = ShmTokenClient(shm_dir, timeout_ms=60_000)
        clients.append(shm)
        rng = np.random.default_rng(71)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        shm_statuses = {}
        for _ in range(SHM_PULLS):
            ids = zipf(rng, SHM_ROWS)
            a = shm.request_batch_arrays(ids)
            b = twin.request_batch_arrays(ids)
            if a is None or not all(np.array_equal(x, y)
                                    for x, y in zip(a, b)) or fails_in(a[0]):
                raise AssertionError("hier 12b: shm verdicts differ from "
                                     "the twin's")
            for code, n in zip(*np.unique(a[0], return_counts=True)):
                shm_statuses[int(code)] = shm_statuses.get(int(code), 0) + \
                    int(n)
            mc.advance(int(rng.integers(5, 60)))
        if K.LAUNCHES["decide_rows"] != SHM_PULLS:
            raise AssertionError(f"hier 12b: {K.LAUNCHES['decide_rows']} "
                                 f"decide launches for {SHM_PULLS} pulls")
        out["shm"] = dict(pulls=SHM_PULLS, rows=SHM_ROWS,
                          decide_launches=K.LAUNCHES["decide_rows"],
                          verdicts=shm_statuses)
        log(f"hier 12b: {SHM_PULLS} ShmTokenClient pulls of {SHM_ROWS} rows "
            f"through the native door's shm ring equal to the twin's in "
            f"process; verdicts {shm_statuses}")

        # --- holds and demand reads, timed (manual clock) ---------------
        held = LockHeld(svc._lock)
        held.watch = threading.get_ident()
        svc._lock = held
        hold_ms, hold_lock_ms, rates_ms = [], [], []
        try:
            for k in range(HOLD_TIMED):
                held.ms = 0.0
                t0 = time.perf_counter()
                svc.set_share_hold(flows[k % len(flows)], 40 + k)
                hold_ms.append((time.perf_counter() - t0) * 1e3)
                hold_lock_ms.append(held.ms)
                t0 = time.perf_counter()
                svc.demand_rates(flows)
                rates_ms.append((time.perf_counter() - t0) * 1e3)
                mc.advance(37)
        finally:
            svc._lock = held.lock
        out["hold_ms"] = quantiles(hold_ms)
        out["hold_lock_ms"] = quantiles(hold_lock_ms)
        out["demand_rates_ms"] = quantiles(rates_ms)
        log(f"hier at F={F}: set_share_hold ms {out['hold_ms']}, of it "
            f"under the service lock {out['hold_lock_ms']}; demand_rates "
            f"(16 flows) ms {out['demand_rates_ms']} ({ident})")

        # --- the rest runs on the system clock --------------------------
        clock.set_clock(prev)
        loops = {}
        pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=DK.worker_init,
            initargs=("torch_kernel_check", P.__name__))
        try:
            pool.map(time.sleep, [0.2])
            for n in DOOR_PULLS:
                res = DK.closed_loop(P, door.port, flow_ids, zipf, n,
                                     DOOR_SECONDS, 1, P.MAX_BATCH_PER_FRAME,
                                     pool, seed=80 + n)
                if res["errors"]:
                    raise AssertionError(f"hier asyncio closed loop n={n}: "
                                         f"{res['errors'][:5]}")
                loops[str(n)] = res
                log(f"hier asyncio door closed loop n={n} clients=1: "
                    f"{res['served_verdicts_per_s']:.0f} served verdicts/s, "
                    f"RTT p50 {res['rtt_p50_ms']:.3f} ms, p99 "
                    f"{res['rtt_p99_ms']:.3f} ms over {res['pulls']} pulls, "
                    f"statuses {res['statuses']} ({ident})")
        finally:
            pool.close()
            pool.join()
        out["asyncio_closed_loop"] = loops
        tcp = TokenClient("127.0.0.1", native.port, timeout_ms=60_000)
        clients.append(tcp)
        rtt = {}
        rng = np.random.default_rng(73)
        for name, c in (("shm", shm), ("tcp", tcp)):
            lat = []
            for _ in range(RTT_PULLS):
                ids = zipf(rng, SHM_ROWS)
                t0 = time.perf_counter()
                a = c.request_batch_arrays(ids)
                lat.append((time.perf_counter() - t0) * 1e3)
                if a is None or fails_in(a[0]):
                    raise AssertionError(f"hier: a timed {name} pull failed")
            rtt[name] = quantiles(lat)
        out["native_rtt_1024"] = rtt
        log(f"hier native door, 1024-row pulls: ShmTokenClient RTT p50 "
            f"{rtt['shm']['p50']:.3f} ms, TCP TokenClient p50 "
            f"{rtt['tcp']['p50']:.3f} ms ({RTT_PULLS} each; {ident})")
    finally:
        clock.set_clock(prev)
        for c in clients:
            c.close()
        door.stop()
        twin_door.stop()
        native.stop()
    del svc, twin

    # --- 12c. the hierarchy drill at 100k flows -------------------------
    out["drill"] = hier_drill(torch, dev, flows)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"hier phase: {out['phase_s']:.1f} s ({ident})")
    return out


def hier_drill(torch, dev, flows) -> dict:
    """``benchmarks/ha_drill.py::run_hier_drill``'s stages and gates, per
    flow, over the 16 global flows at 100k flows, on a manual clock (see
    ``phase_hier``). Raises naming every failed gate."""
    import torch_hier_check as HC

    from sentinel_tpu_torch import chaos
    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.cluster.hierarchy import (
        GlobalBudgetCoordinator,
        GlobalFlowBudget,
        PodShareAgent,
    )
    from sentinel_tpu_torch.cluster.server import TokenServer
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
    from sentinel_tpu_torch.engine import ThresholdMode
    from sentinel_tpu_torch.metrics.server import server_metrics

    rules = service_rules(ClusterFlowRule, ThresholdMode)
    # one namespace row more than the rules use: the clients join "default",
    # and the standby's restore seats it
    cfg = EngineConfig(max_flows=F, max_namespaces=NS + 1,
                       batch_size=SIZES[-1])
    count = {r.flow_id: r.count for r in rules}
    budget = np.asarray([int(count[f] * 1.0) for f in flows], np.int64)
    slack = np.maximum(2, (budget * HIER_RECONCILE_MS) // 1000)
    budgets = [GlobalFlowBudget(f, count[f], 1.0) for f in flows]
    window_ms = cfg.bucket_ms * cfg.n_buckets
    fails = []
    out = {"budget_tokens": budget.tolist(), "slack_tokens": slack.tolist(),
           "reconcile_ms": HIER_RECONCILE_MS}
    mc = clock.ManualClock(int(time.time() * 1000) + 5_000)
    prev = clock.set_clock(mc)
    t0 = time.perf_counter()
    # the standby first and pod A last: ServerMetrics scrapes the most
    # recently built service, pod A
    standby = DefaultTokenService(cfg, device=dev)
    standby.attach_hierarchy(GlobalBudgetCoordinator(
        budgets, share_ttl_ms=HIER_SHARE_TTL_MS,
        reconcile_ms=HIER_RECONCILE_MS))
    pods = []
    for _ in range(2):
        s = DefaultTokenService(cfg, device=dev)
        s.load_rules(rules, ns_max_qps=1e9)
        pods.append(s)
    svc_b, svc_a = pods
    coord = GlobalBudgetCoordinator(budgets, share_ttl_ms=HIER_SHARE_TTL_MS,
                                    reconcile_ms=HIER_RECONCILE_MS)
    svc_a.attach_hierarchy(coord)
    srv_a = TokenServer(svc_a, host="127.0.0.1", port=0, idle_ttl_s=None)
    srv_b = NativeTokenServer(svc_b, host="127.0.0.1", port=0,
                              idle_ttl_s=None)
    agents, clients = [], []
    try:
        srv_a.start()
        srv_b.start()
        ep = f"127.0.0.1:{srv_a.port}"
        # the agents' default client: the port's FailoverTokenClient
        ag_a = PodShareAgent(svc_a, [ep], "pod-a", budgets, tick_ms=100,
                             timeout_ms=5000, deadline_ms=5000)
        ag_b = PodShareAgent(svc_b, [ep], "pod-b", budgets, tick_ms=100,
                             timeout_ms=5000, deadline_ms=5000)
        agents += [ag_a, ag_b]
        cl_a = TokenClient("127.0.0.1", srv_a.port, timeout_ms=60_000)
        cl_b = TokenClient("127.0.0.1", srv_b.port, timeout_ms=60_000)
        clients += [cl_a, cl_b]
        out["setup_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(83)
        index = {f: i for i, f in enumerate(flows)}
        tick_ms, reconcile_ms, fail_rows = [], [], [0]

        def burst(cl) -> np.ndarray:
            """One 1024-row pull, HIER_ROWS rows of each global flow;
            returns the tokens admitted per flow."""
            ids = rng.permutation(np.repeat(np.asarray(flows, np.int64),
                                            HIER_ROWS))
            res = cl.request_batch_arrays(ids)
            if res is None:
                raise AssertionError("hier drill: a burst got no answer")
            st = res[0]
            fail_rows[0] += int((st == HC.FAIL).sum())
            pos = np.fromiter((index[int(f)] for f in ids), np.int64,
                              ids.size)
            return np.bincount(pos[st == 0], minlength=len(flows))

        def tick(*ags):
            for ag in ags:
                t = time.perf_counter()
                ag.tick()
                tick_ms.append((time.perf_counter() - t) * 1e3)

        def reconcile():
            t = time.perf_counter()
            coord.reconcile_once()
            reconcile_ms.append((time.perf_counter() - t) * 1e3)

        def round_():
            tick(ag_a, ag_b)
            reconcile()

        def shares():
            a, b = ag_a.shares(), ag_b.shares()
            return (np.asarray([a[f] for f in flows], np.int64),
                    np.asarray([b[f] for f in flows], np.int64))

        def gate(ok, what):
            ok = np.asarray(ok)
            if not ok.all():
                fails.append(f"{what} (flows "
                             f"{[flows[i] for i in np.nonzero(~ok)[0]]})")

        def drain(dark=False):
            # the window empties while the holds are re-topped
            for _ in range(window_ms // HIER_RECONCILE_MS + 2):
                mc.advance(HIER_RECONCILE_MS)
                if dark:
                    tick(ag_a, ag_b)
                else:
                    round_()

        def flat_out(dark=False) -> np.ndarray:
            """Both pods driven flat out for one window less 2.5 buckets,
            the control plane pacing every reconcile interval."""
            admits = np.zeros(len(flows), np.int64)
            drive_ms = window_ms - 5 * cfg.bucket_ms // 2
            since = 0
            for _ in range(drive_ms // HIER_STEP_MS):
                admits += burst(cl_a) + burst(cl_b)
                mc.advance(HIER_STEP_MS)
                since += HIER_STEP_MS
                if since >= HIER_RECONCILE_MS:
                    since = 0
                    if dark:
                        tick(ag_a, ag_b)
                    else:
                        round_()
            return admits

        # bootstrap: no demand, the equal split conserves every budget
        round_()
        round_()
        s_a, s_b = shares()
        out["bootstrap"] = {"share_a": s_a.tolist(), "share_b": s_b.tolist()}
        gate(s_a + s_b == budget, "bootstrap shares do not sum to the budget")
        gate((np.abs(s_a - s_b) <= 1) & (s_a > 0),
             "bootstrap split is not the equal water-fill")

        # skew to A: demand on pod A; A >= 2 B within 3 reconcile ticks of
        # the report landing
        for _ in range(5):
            burst(cl_a)
            mc.advance(10)
        tick(ag_a, ag_b)
        rounds = np.full(len(flows), -1)
        for r in range(1, 7):
            reconcile()
            tick(ag_a, ag_b)
            s_a, s_b = shares()
            rounds[(rounds < 0) & (s_a >= 2 * s_b)] = r
            if (rounds > 0).all():
                break
        out["skew"] = {"rounds": rounds.tolist(), "share_a": s_a.tolist(),
                       "share_b": s_b.tolist()}
        gate((rounds > 0) & (rounds <= 3),
             "skewed demand did not win 2x the share within 3 ticks")
        gate(s_a + s_b <= budget, "post-skew shares exceed the budget")

        # flip to B: A's demand drains from its window; from the re-target,
        # B >= 2 A within 3 ticks
        retarget = np.full(len(flows), -1)
        converged = np.full(len(flows), -1)
        r = 0
        while r < 40 and not (converged > 0).all():
            r += 1
            burst(cl_b)
            tick(ag_a, ag_b)
            reconcile()
            tg = coord.stats()["targets"]
            s_a, s_b = shares()
            for i, f in enumerate(flows):
                t = tg.get(f, {})
                # the re-target favours B by more than the one token an
                # equal water-fill of an odd budget hands the pod named last
                if retarget[i] < 0 and \
                        t.get("pod-b", 0) > t.get("pod-a", 0) + 1:
                    retarget[i] = r
                elif retarget[i] > 0 and converged[i] < 0 and \
                        s_b[i] >= 2 * s_a[i]:
                    converged[i] = r - retarget[i]
            mc.advance(cfg.bucket_ms)
        out["flip"] = {"rounds_total": r, "retarget_round": retarget.tolist(),
                       "rounds_after_retarget": converged.tolist(),
                       "share_a": s_a.tolist(), "share_b": s_b.tolist()}
        gate((converged > 0) & (converged <= 3),
             "the demand flip did not converge within 3 ticks of the "
             "re-target")
        gate(s_a + s_b <= budget, "post-flip shares exceed the budget")

        # a decision burst moves no agent RPC
        rpc0 = ag_a.stats()["agent_rpcs"] + ag_b.stats()["agent_rpcs"]
        for _ in range(2):
            burst(cl_a)
            burst(cl_b)
        out["decision_rpcs"] = (ag_a.stats()["agent_rpcs"]
                                + ag_b.stats()["agent_rpcs"] - rpc0)
        if out["decision_rpcs"]:
            fails.append(f"{out['decision_rpcs']} agent RPCs during a "
                         f"decision burst")

        # live: both pods flat out for a window
        drain()
        admits = flat_out()
        over = np.maximum(0, admits - budget)
        out["live"] = {"admits": admits.tolist(),
                       "over_admission": over.tolist()}
        gate(over <= slack, "live over-admission exceeds the slack")

        # a seeded conn_reset mid-tick: B's agent neither raises nor loses
        # a share
        s_a0, s_b0 = shares()
        chaos.arm("conn_reset:n=1", seed=7)
        try:
            tick(ag_b)
        except Exception as exc:  # the gate: a tick must not raise
            fails.append(f"B's agent tick raised under chaos: {exc!r}")
        finally:
            fired = chaos.fired()
            chaos.disarm()
        s_a, s_b = shares()
        out["chaos"] = {"fired": fired,
                        "report_fail": ag_b.stats()["agent_report_fail"]}
        if not fired.get("conn_reset"):
            fails.append("the chaos conn_reset never fired")
        gate(s_b == s_b0, "the chaos-cut tick lost B's share")

        # the coordinator dark: the last shares hold, degraded is flagged,
        # and a dark window admits at most the shares plus the slack
        svc_a.hierarchy = None
        for _ in range(3):
            tick(ag_a, ag_b)
        s_a, s_b = shares()
        gate((s_a == s_a0) & (s_b == s_b0), "the dark pods moved their shares")
        if not (ag_a.stats()["agent_degraded"]
                and ag_b.stats()["agent_degraded"]):
            fails.append("the dark agents never flagged degraded")
        drain(dark=True)
        admits = flat_out(dark=True)
        over = np.maximum(0, admits - (s_a + s_b))
        out["dark"] = {"admits": admits.tolist(),
                       "share_sum": (s_a + s_b).tolist(),
                       "over_admission": over.tolist()}
        gate(over <= slack, "dark over-admission exceeds the shares plus "
             "the slack")

        # recovery: one round re-leases every pod's share of every flow
        svc_a.attach_hierarchy(coord)
        round_()
        out["recovery_outstanding"] = coord.stats()["outstanding_shares"]
        if out["recovery_outstanding"] != 2 * len(flows):
            fails.append(f"{out['recovery_outstanding']} outstanding shares "
                         f"after the recovery (want {2 * len(flows)})")
        if fail_rows[0]:
            fails.append(f"{fail_rows[0]} FAIL verdicts in the bursts")

        # the ledger rides the snapshot into a card standby
        t0 = time.perf_counter()
        state = svc_a.export_state()
        export_ms = (time.perf_counter() - t0) * 1e3
        doc = coord.export_doc()
        if state.get("hier") != doc:
            fails.append("pod A's export_state hier block is not the "
                         "coordinator's export_doc")
        t0 = time.perf_counter()
        standby.import_state(state)
        import_ms = (time.perf_counter() - t0) * 1e3
        if standby.hierarchy.export_doc() != doc:
            fails.append("the standby's ledger differs from pod A's")
        hs = server_metrics().hier_stats()
        holds = sum(svc_a.share_holds().values())
        for key in ("agent_ticks", "agent_rpcs", "share_grants",
                    "share_renews", "reconciles", "demand_reports"):
            if key not in hs:
                fails.append(f"ServerMetrics hier block lacks {key}")
        if hs.get("hold_tokens") != holds:
            fails.append(f"hier block hold_tokens {hs.get('hold_tokens')} "
                         f"!= {holds}")
        out["snapshot"] = {"export_ms": export_ms, "import_ms": import_ms,
                           "shares": len(next(iter(doc["flows"].values()))[
                               "shares"])}
        out["hier_stats"] = {k: v for k, v in hs.items()
                             if not isinstance(v, dict)}

        # timings: an agent tick (17 RPCs), reconcile_once
        out["agent_tick_ms"] = quantiles(tick_ms)
        out["reconcile_ms"] = quantiles(reconcile_ms)
        out["agent_rpcs_a_tick"] = 1 + len(flows)
    finally:
        clock.set_clock(prev)
        for c in clients:
            c.close()
        for ag in agents:
            ag.close()
        coord.stop()
        srv_a.stop()
        srv_b.stop()
    log(f"hier drill (16 global flows, budgets {out['budget_tokens']}): "
        f"bootstrap {out['bootstrap']}; skew {out['skew']}; flip "
        f"{out['flip']}; decision RPCs {out['decision_rpcs']}; live "
        f"{out['live']}; chaos {out['chaos']}; dark {out['dark']}; recovery "
        f"{out['recovery_outstanding']} shares; ledger through the snapshot "
        f"(export {out['snapshot']['export_ms']:.1f} ms, standby import "
        f"{out['snapshot']['import_ms']:.1f} ms); agent tick ms "
        f"{out['agent_tick_ms']}, reconcile ms {out['reconcile_ms']} "
        f"({gpu_identity()})")
    if fails:
        raise AssertionError("hier drill: " + "; ".join(fails))
    return out


# --- phase 13: the SDK's entry() with cluster-mode rules ----------------------
SDK_RESOURCES = 6000  # the local engine's cap on slot chains
SDK_ENTRIES = 20_000  # 13a's seeded stream, on the manual clock
SDK_SEED = 131
SDK_THREADS = 8
SDK_SECONDS = 3.0  # 13b's timed runs on the system clock, each
SDK_DRILL_FLOWS = 16  # 13c's cluster-mode resources
SDK_DRILL_COUNT = 20.0  # their local rules' count, and the fallback's
SDK_DRILL_METERED_SHARE = 0.8  # of 13c's entries up to the dark doors
SDK_DRILL_AFTER_KILL_S = 2.5  # 13c runs on until the standby blocks it
SDK_DARK_S = 0.45  # 13c's entries with both doors dark: within a bucket
SDK_FALLBACK_BUCKET_MS = 500  # the policy's window: 2 buckets of 500 ms


class Recorded:
    """Stands in for the token service that ``cluster_api`` hands the
    cluster branches (or that ``RlsService`` steps): counts every call and
    records every exception the service raises before passing it on (the
    branches catch it and fall back to the local rule, the RLS service to
    its failure mode, either of which would hide a failed kernel)."""

    def __init__(self, target):
        self.target = target
        self.calls = {"request_token": 0, "request_params_token": 0,
                      "request_batch": 0}
        self.errors = []

    def _call(self, name, *a):
        self.calls[name] += 1
        try:
            return getattr(self.target, name)(*a)
        except Exception as exc:
            self.errors.append(f"{name}{a}: {exc!r}")
            raise

    def request_token(self, flow_id, acquire=1, prioritized=False):
        return self._call("request_token", flow_id, acquire, prioritized)

    def request_params_token(self, flow_id, acquire, param_hashes):
        return self._call("request_params_token", flow_id, acquire,
                          param_hashes)

    def request_batch(self, requests):
        return self._call("request_batch", requests)

    def close(self):
        self.target.close()


def sdk_service(dev, twin=False):
    """Phase 3's flow configuration and 256 param rules at ``ParamConfig()``
    (counts 1-3 a value, so that hot values block), on the kernels or, with
    ``twin``, on the torch-ops cores."""
    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        EngineConfig,
        ThresholdMode,
    )
    from sentinel_tpu_torch.engine.param import ParamConfig

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1],
                       decide_impl="xla" if twin else "auto")
    svc = DefaultTokenService(
        cfg, param_config=ParamConfig(impl="jax" if twin else "auto"),
        device=dev)
    svc.load_rules(service_rules(ClusterFlowRule, ThresholdMode),
                   ns_max_qps=1e9)
    specs = PC.service_rule_specs(256, np.random.default_rng(41))
    svc.load_param_rules([ClusterParamFlowRule(s.flow_id, 1.0 + k % 3)
                          for k, s in enumerate(specs)])
    svc.warmup()
    return svc, [s.flow_id for s in specs]


def phase_sdk(torch, dev):
    """Phase 13: ``sentinel_tpu_torch.local.entry`` with cluster-mode rules
    answered by the card. 13a: the seeded SDK stream on a manual clock with
    the card service embedded, then with the torch-ops twin, every verdict
    and node counter equal, one decide launch per cluster flow check and
    one count-min launch per cluster param check, every SDK dispatch free
    of synchronizing calls. 13b: 8 threads on the system clock, entry
    latency by rule class, against the same rules in local mode. 13c: the
    failover client across phase 10's primary and a warm standby (SIGKILL,
    promotion, both doors dark)."""
    import importlib

    import torch_sdk_check as SDK

    from sentinel_tpu_torch.cluster import api as cluster_api
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    L = importlib.import_module("sentinel_tpu_torch.local")
    sph_mod = importlib.import_module("sentinel_tpu_torch.local.sph")
    t_phase = time.perf_counter()
    out = {}
    snap_root = os.path.join(HERE, "sentinel_tpu_torch", "build",
                             "sdk_snapshots")
    shutil.rmtree(snap_root, ignore_errors=True)
    drill_flows = door_lease_flows(SDK_DRILL_FLOWS)
    # 13c's primary builds and warms up in its own process beside 13a/13b
    ctx = multiprocessing.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    child = ctx.Process(target=ha_drill_primary,
                        args=(child_end, drill_flows[0], str(dev), F,
                              snap_root), daemon=True)
    child.start()
    # a minute boundary two minutes back: bucket-aligned as in every run,
    # so that 13a's verdicts are the same in every run and rehearsal, and
    # behind the system clock that 13b then gives the same service
    t0_ms = int(time.time() * 1000) // 60_000 * 60_000 - 120_000
    mc = clock.ManualClock(t0_ms)
    prev = clock.set_clock(mc)
    try:
        card, param_flows = sdk_service(dev)
        twin, _ = sdk_service(dev, twin=True)
        lay = SDK.layout(SDK_RESOURCES, range(1000), param_flows)
        steps = SDK.stream(np.random.default_rng(SDK_SEED), lay, SDK_ENTRIES)

        # --- 13a: lockstep, card then twin from the same clock -----------
        dispatch = card.dispatch_batch_arrays
        checked = [0]

        def checked_dispatch(ids, counts=None, prios=None):
            torch.cuda.set_sync_debug_mode("error")
            try:
                mat = dispatch(ids, counts, prios)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked[0] += 1
            return mat

        runs = {}
        for name, svc in (("card", card), ("twin", twin)):
            L.reset_for_tests()
            cluster_api.reset_for_tests()
            mc.set_ms(t0_ms)
            rec = Recorded(svc)
            cluster_api.set_embedded_server(rec)
            SDK.load_rules(L, lay)
            torch.cuda.synchronize()
            K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
            cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
            if name == "card":
                card.dispatch_batch_arrays = checked_dispatch
            t0 = time.perf_counter()
            try:
                verdicts = SDK.drive(L, sph_mod, steps, mc.now_ms,
                                     mc.advance)
            finally:
                if name == "card":
                    del card.dispatch_batch_arrays
            runs[name] = dict(
                verdicts=verdicts,
                counters=SDK.node_counters(L.chain, L.context, mc.now_ms()),
                calls=dict(rec.calls), errors=list(rec.errors),
                decide=K.LAUNCHES["decide_rows"],
                cms=cms_cuda.LAUNCHES["cms_decide_update"],
                wall_s=time.perf_counter() - t0, end_ms=mc.now_ms())
        a, b = runs["card"], runs["twin"]
        errors = a["errors"] + b["errors"]
        if errors:
            raise AssertionError(f"sdk: the service raised: {errors[:3]}")
        first = next((k for k, (x, y) in enumerate(zip(a["verdicts"],
                                                       b["verdicts"]))
                      if x != y), None)
        if first is not None or len(a["verdicts"]) != SDK_ENTRIES:
            raise AssertionError(
                f"sdk: verdict {first} differs from the twin's: "
                f"{a['verdicts'][first]} != {b['verdicts'][first]}")
        bad = SDK.diff(a["counters"], b["counters"])
        if bad or a["end_ms"] != b["end_ms"]:
            raise AssertionError(f"sdk: node counters differ: {bad}")
        flow_checks = a["calls"]["request_token"]
        param_checks = a["calls"]["request_params_token"]
        if (a["decide"] != flow_checks or checked[0] != flow_checks
                or a["cms"] != param_checks or b["decide"] or b["cms"]
                or b["calls"] != a["calls"]):
            raise AssertionError(
                f"sdk: launches {a['decide']} decide / {a['cms']} count-min "
                f"(twin {b['decide']} / {b['cms']}) for {flow_checks} flow "
                f"and {param_checks} param checks, {checked[0]} checked "
                f"dispatches")
        kinds = {}
        for v in a["verdicts"]:
            k = v if v == "pass" else v[0]
            kinds[k] = kinds.get(k, 0) + 1
        need = {"pass", "FlowException", "ParamFlowException",
                "DegradeException", "SystemBlockException",
                "AuthorityException"}
        if not need <= set(kinds) or flow_checks < 1000 or param_checks < 100:
            raise AssertionError(f"sdk: the stream reached too little: "
                                 f"{kinds}, {a['calls']}")
        out["lockstep"] = dict(
            entries=SDK_ENTRIES, resources=SDK_RESOURCES, verdicts=kinds,
            nodes=len(a["counters"]), flow_checks=flow_checks,
            param_checks=param_checks, decide_launches=a["decide"],
            cms_launches=a["cms"], sync_free_dispatches=checked[0],
            engine_ms=a["end_ms"] - t0_ms, card_wall_s=a["wall_s"],
            twin_wall_s=b["wall_s"])
        log(f"sdk 13a: {SDK_ENTRIES} entries over {SDK_RESOURCES} resources "
            f"({kinds}) equal to the twin in every verdict and in "
            f"{len(a['counters'])} nodes' counters; {a['decide']} decide "
            f"launches for {flow_checks} cluster flow checks (each dispatch "
            f"sync-free), {a['cms']} count-min launches for {param_checks} "
            f"cluster param checks; {a['wall_s']:.1f} s on the card, "
            f"{b['wall_s']:.1f} s on the twin")

        # --- 13b: timed, 8 threads on the system clock ------------------
        clock.set_clock(clock.SystemClock())
        streams = [SDK.stream(np.random.default_rng(1000 + t), lay, 20_000)
                   for t in range(SDK_THREADS)]
        out["timed"] = {}
        for mode in ("cluster", "local"):
            L.reset_for_tests()
            cluster_api.reset_for_tests()
            rec = Recorded(card)
            cluster_api.set_embedded_server(rec)
            SDK.load_rules(L, lay, cluster=mode == "cluster")
            out["timed"][mode] = sdk_timed(L, sph_mod, SDK, lay, streams)
            if rec.errors:
                raise AssertionError(f"sdk 13b: the service raised: "
                                     f"{rec.errors[:3]}")
            out["timed"][mode]["service_calls"] = dict(rec.calls)
        L.reset_for_tests()
        cluster_api.reset_for_tests()
        for mode, t in out["timed"].items():
            log(f"sdk 13b ({mode} rules, {SDK_THREADS} threads, "
                f"{SDK_SECONDS} s): {t['entries_per_s']:.0f} entries/s; "
                f"entry p50 / p99 ms " + "; ".join(
                    f"{c} {q['p50']:.4f} / {q['p99']:.4f} (n {q['n']})"
                    for c, q in t["entry_ms"].items() if q["n"]))

        # --- 13c: the failover client across a warm standby --------------
        out["failover"] = sdk_failover(dev, pipe, child, drill_flows,
                                       snap_root, L)
    finally:
        clock.set_clock(prev)
        L.reset_for_tests()
        cluster_api.reset_for_tests()
        if child.is_alive():
            child.kill()
        child.join(10)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sdk phase: {out['phase_s']:.1f} s ({gpu_identity()})")
    return out


def sdk_class(lay, i: int) -> str:
    if i in lay["cluster"]:
        return "cluster_flow"
    if i in lay["param"]:
        return "cluster_param"
    return "local"


def sdk_timed(L, sph_mod, SDK, lay, streams) -> dict:
    """13b: ``SDK_THREADS`` threads each drive their own seeded stream
    (``streams``) through ``async_entry`` on the system clock for
    ``SDK_SECONDS``; entry
    latency by the resource's class, entries a second, and any exception
    other than a ``BlockException``."""
    from sentinel_tpu_torch.core import clock

    lats = [[] for _ in range(SDK_THREADS)]
    counts = [0] * SDK_THREADS
    errors = []
    start = threading.Barrier(SDK_THREADS + 1)

    def work(t):
        start.wait()
        try:
            v = SDK.drive(L, sph_mod, streams[t], clock.now_ms, lat=lats[t],
                          until=time.perf_counter() + SDK_SECONDS)
            counts[t] = len(v)
        except Exception as exc:  # reported, and the phase fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(SDK_THREADS)]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(SDK_SECONDS + 120)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"sdk 13b: {errors[:3]}")
    by = {"local": [], "cluster_flow": [], "cluster_param": []}
    for ls in lats:
        for i, s in ls:
            by[sdk_class(lay, i)].append(s * 1e3)
    return dict(entries=sum(counts), wall_s=wall,
                entries_per_s=sum(counts) / wall,
                entry_ms={c: quantiles(v) for c, v in by.items()})


def sdk_failover(dev, pipe, child, drill_flows, snap_root, L) -> dict:
    """13c: ``FailoverTokenClient([primary, standby])`` installed with
    ``cluster_api.set_client``; 8 threads of ``entry`` on 16 cluster-mode
    resources, most entries (80%) on the metered flow of phase 10's drill
    (300 tokens a 5 s window). SIGKILL the primary once it admitted half
    the window and two more deltas landed; after the client converged on
    the promoted standby, stop the standby and hold the fallback policy to
    its rules: BLOCK blocks, PASS passes, a flow without a rule is throttled
    at its local rule's count (the policy's THROTTLE default), and
    ``stats()`` equals what the entries saw."""
    from sentinel_tpu_torch.cluster import api as cluster_api
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock as _clock
    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.ha import (
        FailoverTokenClient,
        FallbackAction,
        FallbackRule,
        LocalFallbackPolicy,
    )

    if not pipe.poll(180):
        raise AssertionError("sdk 13c: the child primary never got ready")
    if pipe.recv() != "ready":
        raise AssertionError("sdk 13c: the child primary failed")
    window_tokens = int(HA_DRILL_QPS * HA_DRILL_BUCKET_MS * 10 / 1000)
    svc = ha_service(dev, bucket_ms=HA_DRILL_BUCKET_MS)
    standby = NativeTokenServer(svc, port=0, idle_ttl_s=None,
                                standby_of="primary",
                                promote_after_ms=HA_PROMOTE_AFTER_MS,
                                snapshot_dir=snap_root,
                                snapshot_period_s=3600.0)
    standby.start()
    metered, blocked_fid, passed_fid = drill_flows[:3]
    names = {fid: f"drill{k}" for k, fid in enumerate(drill_flows)}
    fc = None
    try:
        if not svc.current_rules():
            raise AssertionError("sdk 13c: the standby restored nothing")
        pipe.send(standby.port)
        if not pipe.poll(60):
            raise AssertionError("sdk 13c: the child's door never started")
        primary_port = pipe.recv()
        wait_for(lambda: standby.applier.status()["deltasApplied"] >= 2,
                 "deltas after the file bootstrap", 30.0)
        policy_rules = [FallbackRule(metered, FallbackAction.BLOCK),
                        FallbackRule(blocked_fid, FallbackAction.BLOCK),
                        FallbackRule(passed_fid, FallbackAction.PASS)]
        policy = LocalFallbackPolicy(
            policy_rules, default_action=FallbackAction.THROTTLE,
            default_count=SDK_DRILL_COUNT)
        fc = FailoverTokenClient(
            [("127.0.0.1", primary_port), ("127.0.0.1", standby.port)],
            timeout_ms=200, failure_threshold=1, deadline_ms=500,
            fallback=policy)
        # every member answer, by member: (t, flow, status)
        answers = ([], [])
        member_errors = []
        for idx, member in enumerate(fc._members):
            real = member.client.request_token

            def recorded(flow_id, acquire=1, prioritized=False, _i=idx,
                         _real=real):
                try:
                    r = _real(flow_id, acquire, prioritized)
                except Exception as exc:
                    member_errors.append(repr(exc))
                    raise
                answers[_i].append((time.monotonic(), int(flow_id),
                                    int(r.status)))
                return r

            member.client.request_token = recorded
        rec = Recorded(fc)
        cluster_api.set_client(rec)
        L.FlowRuleManager.load_rules([L.FlowRule(
            resource=names[fid], count=SDK_DRILL_COUNT, cluster_mode=True,
            cluster_config={"flow_id": fid,
                            "fallback_to_local_when_fail": True})
            for fid in drill_flows])

        seen = []  # (t, flow, passed) of every entry
        errors = []
        stop = threading.Event()

        def work(t, share):
            rng = np.random.default_rng(500 + t)
            while not stop.is_set():
                if rng.random() < share:
                    fid = metered
                else:
                    fid = drill_flows[1 + int(rng.integers(
                        len(drill_flows) - 1))]
                try:
                    with L.entry(names[fid]):
                        ok = True
                except L.BlockException:
                    ok = False
                except Exception as exc:  # the gate: none may leave entry
                    errors.append(repr(exc))
                    return
                seen.append((time.monotonic(), fid, ok))

        def run_threads(share):
            stop.clear()
            ths = [threading.Thread(target=work, args=(t, share),
                                    daemon=True)
                   for t in range(SDK_THREADS)]
            for th in ths:
                th.start()
            return ths

        def join(ths):
            stop.set()
            for th in ths:
                th.join(10)
            if any(th.is_alive() for th in ths):
                raise AssertionError("sdk 13c: an entry thread hung")

        def admitted(i):
            return sum(1 for _, f, s in answers[i]
                       if f == metered and s == int(TokenStatus.OK))

        ths = run_threads(SDK_DRILL_METERED_SHARE)
        t_fill = time.monotonic()
        wait_for(lambda: admitted(0) >= window_tokens // 2,
                 "half the metered window through the primary", 10.0)
        fill_s = time.monotonic() - t_fill
        base = standby.applier.status()["deltasApplied"]
        wait_for(lambda: standby.applier.status()["deltasApplied"]
                 >= base + 2, "two deltas under load", 10.0)
        fill = admitted(0)
        fill_rate = fill / max(time.monotonic() - t_fill, 1e-6)
        child.kill()  # SIGKILL: no final ship, no shutdown hook
        t_kill = time.monotonic()
        child.join(10)

        def served_by_standby():
            return [t for t, _, s in answers[1]
                    if s not in (int(TokenStatus.STANDBY),
                                 int(TokenStatus.FAIL))]

        wait_for(lambda: served_by_standby(), "the standby's first answer",
                 HA_PROMOTE_AFTER_MS / 1000.0 + 5.0)
        converge_ms = (served_by_standby()[0] - t_kill) * 1e3
        # run on until the standby blocks the metered flow (the window is
        # spent) or SDK_DRILL_AFTER_KILL_S pass
        def standby_blocks():
            return sum(1 for _, f, s in answers[1]
                       if f == metered and s == int(TokenStatus.BLOCKED))

        wait_for(lambda: standby_blocks()
                 or time.monotonic() - t_kill > SDK_DRILL_AFTER_KILL_S,
                 "the standby's metered verdicts", 10.0)
        join(ths)
        if fc.active_endpoint.port != standby.port:
            raise AssertionError("sdk 13c: the client did not converge on "
                                 "the standby")
        post = admitted(1)
        first_ok = min((t for t, f, s in answers[0] + answers[1]
                        if f == metered and s == int(TokenStatus.OK)),
                       default=t_fill)
        last_ok = max((t for t, f, s in answers[0] + answers[1]
                       if f == metered and s == int(TokenStatus.OK)),
                      default=t_fill)
        span_s = last_ok - first_ok
        before_kill = admitted(0)
        total = before_kill + post
        over = max(0, total - window_tokens)
        budget = int(fill_rate * HA_INTERVAL_MS / 1000.0) + 1
        promotion_fallbacks = dict(policy.stats())

        # --- both doors dark: the fallback policy decides ----------------
        standby.stop()
        before = dict(policy.stats())
        # fresh throttle windows (a reload resets them, not the stats): the
        # promotion's throttled answers must not count against them
        policy.load_rules(policy_rules)
        # start just after a bucket boundary of the policy's clock: the
        # 1 s window then holds every dark entry for a second, so no entry
        # leaves it before the threads are joined
        t_ms = _clock.now_ms()
        time.sleep((SDK_FALLBACK_BUCKET_MS - t_ms % SDK_FALLBACK_BUCKET_MS
                    + 5) / 1000.0)
        n_seen = len(seen)
        ths = run_threads(1.0 / len(drill_flows))
        time.sleep(SDK_DARK_S)
        join(ths)
        dark = seen[n_seen:]
        dark_span_ms = ((dark[-1][0] - dark[0][0]) * 1e3 if dark else 0.0)
        after = dict(policy.stats())
        by_flow = {}
        for _, fid, ok in dark:
            p, bl = by_flow.get(fid, (0, 0))
            by_flow[fid] = (p + ok, bl + (not ok))
        dark_passed = sum(p for p, _ in by_flow.values())
        dark_blocked = sum(bl for _, bl in by_flow.values())
        fails = []
        if errors or member_errors or rec.errors:
            fails.append(f"exceptions: {errors[:2]} {member_errors[:2]} "
                         f"{rec.errors[:2]}")
        if over > budget:
            fails.append(f"over-admitted {over} > {budget}")
        if span_s * 1e3 >= HA_DRILL_BUCKET_MS * 10:
            fails.append(f"the metered admissions spanned {span_s:.2f} s, "
                         f"more than a window")
        if by_flow.get(blocked_fid, (1, 0))[0] or \
                not by_flow.get(blocked_fid, (0, 0))[1]:
            fails.append(f"the BLOCK flow: {by_flow.get(blocked_fid)}")
        if by_flow.get(passed_fid, (0, 1))[1] or \
                not by_flow.get(passed_fid, (0, 0))[0]:
            fails.append(f"the PASS flow: {by_flow.get(passed_fid)}")
        throttled = {fid: by_flow.get(fid, (0, 0))
                     for fid in drill_flows[3:]}
        for fid, (p, bl) in throttled.items():
            if p != min(int(SDK_DRILL_COUNT), p + bl):
                fails.append(f"flow {fid} without a fallback rule passed "
                             f"{p} of {p + bl}, not its local count "
                             f"{SDK_DRILL_COUNT:.0f} (the dark entries "
                             f"spanned {dark_span_ms:.1f} ms)")
        if (after["passed"] - before["passed"] != dark_passed
                or after["blocked"] - before["blocked"] != dark_blocked):
            fails.append(f"policy stats {before} -> {after} against the "
                         f"entries' {dark_passed} passed / {dark_blocked} "
                         f"blocked")
        res = dict(
            window_tokens=window_tokens, fill_s=fill_s,
            fill_rate_tokens_per_s=fill_rate,
            admitted_before_kill=before_kill, admitted_after_kill=post,
            over_admission=over, budget=budget, span_s=span_s,
            kill_to_first_standby_answer_ms=converge_ms,
            standby_metered_blocks=standby_blocks(),
            entries=len(seen), fallback_during_promotion=promotion_fallbacks,
            dark=dict(entries=len(dark), passed=dark_passed,
                      blocked=dark_blocked, span_ms=dark_span_ms,
                      by_flow={str(k): v for k, v in by_flow.items()}),
            policy_stats=after)
        log(f"sdk 13c: {len(seen)} entries; {before_kill} metered admissions "
            f"before the SIGKILL, {post} after, over a {window_tokens}-token "
            f"window: over-admission {over} against a budget of {budget} "
            f"({fill_rate:.0f} tokens/s; the standby blocked "
            f"{standby_blocks()} metered entries); SIGKILL to the first "
            f"entry the "
            f"standby served {converge_ms:.1f} ms; answered by the fallback "
            f"policy through the promotion {promotion_fallbacks}, with both "
            f"doors dark {dark_passed} passed / {dark_blocked} blocked")
        if fails:
            raise AssertionError("sdk 13c: " + "; ".join(fails))
        return res
    finally:
        if fc is not None:
            cluster_api.reset_for_tests()
        standby.stop()


RLS_DESCRIPTORS = 100_000  # EnvoyRlsRule descriptors over RLS_DOMAINS domains
RLS_DOMAINS = 16
RLS_COUNT_BASE = 100  # descriptor i counts RLS_COUNT_BASE + i % 100 a second
RLS_REQUESTS = 5000  # 14a's seeded ShouldRateLimit stream, in process
RLS_SHM_REQUESTS = 1000  # and then through co_located_rls's shm ring
RLS_STEPS_MS = (0, 0, 1, 0)  # manual clock between requests: 1.25 s a 5000
RLS_SEED = 141
ROUTE_ROUNDS = 3  # lockstep rounds before the move, and as many after
ROUTE_FLOWS = 40  # FLOW requests a round, bounded-Zipf over every flow
ROUTE_MOVED_FLOWS = 20  # and on the moved namespace's flows
ROUTE_PARAMS = 10  # PARAM_FLOW requests a round on the param rules
ROUTE_LIVE_S = (1.0, 1.0)  # 14b's live loop before the move and after it
ROUTE_LIVE_FLOWS = 4  # the live namespace's flows the loop hammers
ROUTE_LIVE_ACQUIRE = 8  # tokens a request: the flows' counts bind
SKETCH_KEYS = 200_000  # ClusterParamMetric.java:37
SKETCH_EVENTS = 1_000_000
SKETCH_BATCH = 4096
SKETCH_PREFIX = (65_536, 512)  # events and rows a batch of the prefix
SKETCH_GATE = (128, 4096)  # keys and events of the reference's slim gate
# and its configuration (tests/test_sketch_parity.py's _cfg and slim test)
SKETCH_GATE_CFG = dict(max_param_rules=8, depth=2, width=512, slim_depth=2,
                       slim_width=256)


def phase_control(torch, dev):
    """Phase 14: the control plane on the card. 14a, the Envoy RLS service
    (``cluster.envoy_rls``) at phase 3's flow configuration; 14b, a
    ``RoutingTokenClient`` across namespace MOVEs between two native doors
    at phase 9's widths; 14c, the sketch parity harness
    (``sketch.parity``) through the count-min and SALSA kernels; 14d, the
    BATCH_FLOW codec on the host, native against numpy."""
    t_phase = time.perf_counter()
    out = {"rls": control_rls(torch, dev),
           "routing": control_routing(torch, dev),
           "sketch": control_sketch(torch, dev),
           "codec": control_codec()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"control phase: {out['phase_s']:.1f} s")
    return out


def rls_service(dev, twin=False):
    """Phase 3's flow configuration, empty: on the decide kernel or, with
    ``twin``, on the torch-ops pipeline."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.engine import EngineConfig

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1],
                       decide_impl="xla" if twin else "auto")
    return DefaultTokenService(cfg, device=dev)


def sync_checked(torch, svc, counter):
    """Run ``svc``'s dispatches under torch's sync debug mode (an instance
    attribute over the method; ``del`` it to restore)."""
    dispatch = svc.dispatch_batch_arrays

    def checked(ids, counts=None, prios=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            mat = dispatch(ids, counts, prios)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counter[0] += 1
        return mat

    svc.dispatch_batch_arrays = checked


def control_rls(torch, dev):
    """14a. ``RLS_DESCRIPTORS`` descriptors (all in the ``default``
    namespace, under its 30,000 QPS guard, as in the reference) on a card
    service and its torch-ops twin; ``RLS_REQUESTS`` seeded requests, each
    encoded, decoded, answered by ``RlsService.should_rate_limit`` and
    encoded: every response's bytes equal the twin's, one decide launch a
    request, each dispatch sync-free, no exception (a recording proxy) and
    no failure-mode fallback. Then ``RLS_SHM_REQUESTS`` more through
    ``co_located_rls`` to a native door's shm ring over the card service,
    equal to the twin."""
    import torch_rls_check as RQ

    from sentinel_tpu_torch.cluster import envoy_rls as R
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.metrics.ha import ha_metrics
    from sentinel_tpu_torch.ops import decide_cuda as K

    t0 = time.perf_counter()
    spec = RQ.rule_spec(RLS_DESCRIPTORS, RLS_DOMAINS, base=RLS_COUNT_BASE)
    requests = RQ.stream(spec, RLS_REQUESTS + RLS_SHM_REQUESTS,
                         np.random.default_rng(RLS_SEED))
    t0_ms = int(time.time() * 1000) // 60_000 * 60_000 - 120_000
    mc = clock.ManualClock(t0_ms)
    prev = clock.set_clock(mc)
    out = {}
    try:
        card, twin = rls_service(dev), rls_service(dev, twin=True)
        managers = []
        for svc in (card, twin):
            m = R.EnvoyRlsRuleManager(svc)
            m.load_rules(RQ.build_rules(R, spec))
            svc.warmup()
            managers.append(m)
        if (len(card._rule_of) != RLS_DESCRIPTORS
                or set(card._rules_by_ns) != {"default"}
                or card._ns_max_qps != 30_000.0):
            raise AssertionError(
                f"rls: {len(card._rule_of)} rules in "
                f"{sorted(card._rules_by_ns)} under {card._ns_max_qps} QPS, "
                f"not {RLS_DESCRIPTORS} in 'default' under 30,000")
        ids = np.fromiter(card._rule_of, np.int64, len(card._rule_of))
        if int(ids.max()) < 2**62:
            raise AssertionError("rls: no flow id above 2^62")
        rec = Recorded(card)
        card_rls = R.RlsService(rec, managers[0])
        twin_rls = R.RlsService(twin, managers[1])
        log(f"rls: {RLS_DESCRIPTORS} descriptors in {RLS_DOMAINS} domains "
            f"loaded on the card and the twin in "
            f"{time.perf_counter() - t0:.1f} s")
        fb0 = dict(ha_metrics().fallback_totals())
        checked = [0]
        sync_checked(torch, card, checked)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        lat, responses = [], []
        t_run = time.perf_counter()
        try:
            for i, (domain, descs, hits) in enumerate(
                    requests[:RLS_REQUESTS]):
                t1 = time.perf_counter()
                a = RQ.answer(R, card_rls, domain, descs, hits)
                lat.append(time.perf_counter() - t1)
                b = RQ.answer(R, twin_rls, domain, descs, hits)
                if a != b:
                    raise AssertionError(
                        f"rls: response {i} differs from the twin's: "
                        f"{R.decode_rate_limit_response(a)} != "
                        f"{R.decode_rate_limit_response(b)}")
                responses.append(a)
                mc.advance(RLS_STEPS_MS[i % len(RLS_STEPS_MS)])
        finally:
            del card.dispatch_batch_arrays
        run_s = time.perf_counter() - t_run
        launches = K.LAUNCHES["decide_rows"]
        fb = ha_metrics().fallback_totals()
        fallbacks = {k: fb.get(k, 0) - fb0.get(k, 0)
                     for k in ("rls_allow", "rls_deny")}
        summary = RQ.summary(R, responses)
        if rec.errors:
            raise AssertionError(f"rls: the service raised: "
                                 f"{rec.errors[:3]}")
        if launches != RLS_REQUESTS or checked[0] != RLS_REQUESTS:
            raise AssertionError(f"rls: {launches} decide launches and "
                                 f"{checked[0]} checked dispatches for "
                                 f"{RLS_REQUESTS} requests")
        if any(fallbacks.values()):
            raise AssertionError(f"rls: failure-mode fallbacks {fallbacks}")
        if not (summary["overall"].get(R.CODE_OVER_LIMIT)
                and summary["overall"].get(R.CODE_OK)):
            raise AssertionError(f"rls: the stream never limited: {summary}")
        a = np.array(lat) * 1e3
        out["in_process"] = dict(
            requests=RLS_REQUESTS, launches=launches,
            sync_free_dispatches=checked[0], fallbacks=fallbacks,
            summary=summary, p50_ms=float(np.percentile(a, 50)),
            p99_ms=float(np.percentile(a, 99)), run_s=run_s,
            engine_ms=mc.now_ms() - t0_ms)
        log(f"rls 14a: {RLS_REQUESTS} requests equal to the twin byte for "
            f"byte ({summary}); {launches} decide launches, every dispatch "
            f"sync-free, no exception, fallbacks {fallbacks}; p50 "
            f"{out['in_process']['p50_ms']:.3f} ms, p99 "
            f"{out['in_process']['p99_ms']:.3f} ms in process "
            f"({run_s:.1f} s with the twin)")

        # --- co-located: the shm ring of a native door --------------------
        build = os.path.join(HERE, "sentinel_tpu_torch", "build")
        os.makedirs(build, exist_ok=True)
        shm_dir = tempfile.mkdtemp(prefix="rls_shm_", dir=build)
        door = NativeTokenServer(card, port=0, idle_ttl_s=None,
                                 shm_dir=shm_dir)
        door.start()
        try:
            c_rls, c_rules, client = R.co_located_rls(shm_dir,
                                                      timeout_ms=10_000)
            try:
                c_rules.load_rules(RQ.build_rules(R, spec))
                K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
                lat = []
                for i, (domain, descs, hits) in enumerate(
                        requests[RLS_REQUESTS:]):
                    t1 = time.perf_counter()
                    a = RQ.answer(R, c_rls, domain, descs, hits)
                    lat.append(time.perf_counter() - t1)
                    b = RQ.answer(R, twin_rls, domain, descs, hits)
                    if a != b:
                        raise AssertionError(
                            f"rls: shm response {i} differs from the twin's")
                    mc.advance(RLS_STEPS_MS[i % len(RLS_STEPS_MS)])
                shm_launches = K.LAUNCHES["decide_rows"]
            finally:
                client.close()
        finally:
            door.stop()
            shutil.rmtree(shm_dir, ignore_errors=True)
        if shm_launches != RLS_SHM_REQUESTS:
            raise AssertionError(f"rls: {shm_launches} decide launches for "
                                 f"{RLS_SHM_REQUESTS} shm requests")
        fb = ha_metrics().fallback_totals()
        if any(fb.get(k, 0) - fb0.get(k, 0) for k in fallbacks):
            raise AssertionError("rls: a failure-mode fallback through the "
                                 "shm ring")
        a = np.array(lat) * 1e3
        out["shm"] = dict(requests=RLS_SHM_REQUESTS, launches=shm_launches,
                          p50_ms=float(np.percentile(a, 50)),
                          p99_ms=float(np.percentile(a, 99)))
        log(f"rls 14a co-located: {RLS_SHM_REQUESTS} requests through "
            f"co_located_rls's shm ring equal to the twin; "
            f"{shm_launches} decide launches; p50 "
            f"{out['shm']['p50_ms']:.3f} ms, p99 "
            f"{out['shm']['p99_ms']:.3f} ms")
    finally:
        clock.set_clock(prev)
    out["phase_s"] = time.perf_counter() - t0
    return out


def control_routing(torch, dev):
    """14b. Phase 11's two doors at phase 9's widths (the source serves
    every namespace, the destination the odd ones) and a torch-ops twin of
    each; the port's ``RoutingTokenClient`` routes by namespace (even to the
    source, odd to the destination). On a manual clock: ``ROUTE_ROUNDS``
    lockstep rounds of FLOW and PARAM_FLOW requests, every answer equal to
    the owning twin's; ``MoveCoordinator`` moves ``MOVE_NS`` under the next
    epoch of a ``ShardMapPublisher``; the source answers the router MOVED with the epoch
    (its twin too); the source door pushes the new shard map, which the
    router applies; a stale map, pushed or applied, is fenced out; as many
    rounds again, ``MOVE_NS`` through the destination; one decide launch a
    FLOW frame and one count-min launch a PARAM_FLOW frame. Then on the
    system clock ``LIVE_NS`` moves under the router's closed loop (the
    shape of ``test_move_commits_under_device_stall_with_live_traffic``):
    no request raises, the router follows the pushed map, and the tokens
    admitted on the hammered flows over both doors within any span shorter
    than a window stay within their counts (over-admission 0)."""
    import torch_kernel_check as DC
    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.cluster.rebalance import (
        MoveCoordinator,
        ShardMap,
        ShardMapPublisher,
        encode_shard_map_doc,
    )
    from sentinel_tpu_torch.cluster.routing import RoutingTokenClient
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.metrics.ha import ha_metrics
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    t0 = time.perf_counter()
    out = {}
    flow, degrade, params = move_rules()
    odd = [r for r in flow if (r.flow_id % NS) % 2]
    dst_rules = (odd, [d for d in degrade if (d.flow_id % NS) % 2],
                 [p for p in params if p.namespace != MOVE_NS])
    flow_ids = np.arange(F, dtype=np.int64)
    zipf = DC.ZipfIds(F, alpha=1.1)
    ns0_ids = flow_ids[flow_ids % NS == 0]
    ns0_zipf = DC.ZipfIds(ns0_ids.size, alpha=1.1)
    specs = PC.service_rule_specs(256, np.random.default_rng(41))
    mc = clock.ManualClock(int(time.time() * 1000) // 60_000 * 60_000
                           - 180_000)
    prev = clock.set_clock(mc)
    answers = []  # (perf_counter, door port, kind, status)

    class Tagged(TokenClient):
        """The router's pod client, logging every answer it gets."""

        def request_token(self, fid, acquire=1, prioritized=False):
            r = super().request_token(fid, acquire, prioritized)
            answers.append((time.perf_counter(), self.port, "flow",
                            int(r.status)))
            return r

        def request_params_token(self, fid, acquire, hashes):
            r = super().request_params_token(fid, acquire, hashes)
            answers.append((time.perf_counter(), self.port, "param",
                            int(r.status)))
            return r

    servers, rc = [], None
    try:
        src_svc = ha_service(dev, (flow, degrade, params))
        dst_svc = ha_service(dev, dst_rules)
        twin_src = ha_service(dev, (flow, degrade, params), twin=True)
        twin_dst = ha_service(dev, dst_rules, twin=True)
        for s in (twin_src, twin_dst):
            s.warmup()
        src = NativeTokenServer(src_svc, host="127.0.0.1", port=0,
                                idle_ttl_s=None)
        dst = NativeTokenServer(dst_svc, host="127.0.0.1", port=0,
                                idle_ttl_s=None)
        servers += [src, dst]
        src.start()
        dst.start()
        src_ep, dst_ep = (f"127.0.0.1:{src.port}", f"127.0.0.1:{dst.port}")
        imports = []
        dst_import = dst_svc.import_namespace_state

        def recorded_import(doc):
            dst_import(doc)
            imports.append(doc)

        dst_svc.import_namespace_state = recorded_import
        pub = ShardMapPublisher()
        push_now = [False]
        # the source door pushes each newly published map to its clients;
        # 14b's lockstep move holds the push until the router has read a
        # MOVED answer
        pub.listen(lambda m: push_now[0] and m is not None and m.epoch > 0
                   and src.push_hub.push_shard_map(encode_shard_map_doc(m)))
        rc = RoutingTokenClient(
            timeout_ms=10_000,
            namespace_of={int(f): ns_of(int(f)) for f in np.concatenate(
                [flow_ids, [p.flow_id for p in params]])},
            pod_of={f"ns{k}": dst_ep if k % 2 else src_ep
                    for k in range(NS)},
            endpoints={ep: ("127.0.0.1", int(ep.rpartition(":")[2]))
                       for ep in (src_ep, dst_ep)},
            client_factory=Tagged,
        )
        owner = {f"ns{k}": (twin_dst if k % 2 else twin_src)
                 for k in range(NS)}
        log(f"routing: two doors and their twins up in "
            f"{time.perf_counter() - t0:.1f} s")

        def plan(rng, rounds):
            steps = []
            for _ in range(rounds):
                rows = [("flow", int(f)) for f in flow_ids[zipf(
                    rng, ROUTE_FLOWS)]]
                rows += [("flow", int(f)) for f in ns0_ids[ns0_zipf(
                    rng, ROUTE_MOVED_FLOWS)]]
                rows += [("param", s) for s in PC.service_stream(
                    specs, rng, ROUTE_PARAMS)]
                for k in rng.permutation(len(rows)):
                    steps.append(rows[int(k)])
            return steps

        def lockstep(rng, steps):
            counts = {"flow": 0, "param": 0}
            for kind, row in steps:
                if kind == "flow":
                    acq, pr = int(rng.integers(1, 3)), bool(rng.random()
                                                           < 0.1)
                    a = rc.request_token(row, acq, pr)
                    b = owner[ns_of(row)].request_token(row, acq, pr)
                else:
                    fid, acq, hashes = row
                    a = rc.request_params_token(fid, acq, hashes)
                    b = owner[ns_of(fid)].request_params_token(fid, acq,
                                                               hashes)
                if (a.status, a.remaining, a.wait_ms) != (
                        b.status, b.remaining, b.wait_ms):
                    raise AssertionError(f"routing: {kind} {row}: {a} != "
                                         f"the twin's {b}")
                counts[kind] += 1
                mc.advance(int(rng.integers(0, 4)))
            return counts

        rng = np.random.default_rng(71)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
        before = lockstep(rng, plan(rng, ROUTE_ROUNDS))
        launches = {"decide": K.LAUNCHES["decide_rows"],
                    "cms": cms_cuda.LAUNCHES["cms_decide_update"]}
        if (launches["decide"], launches["cms"]) != (before["flow"],
                                                     before["param"]):
            raise AssertionError(f"routing: launches {launches} for "
                                 f"{before} frames before the move")

        # --- the lockstep move, learned from MOVED and a pushed map ------
        coord = MoveCoordinator(src_svc, self_endpoint=src_ep, publisher=pub)
        epoch = pub.current().epoch + 1
        t1 = time.perf_counter()
        if not coord.move_namespace(MOVE_NS, dst_ep):
            raise AssertionError(f"routing: the move of {MOVE_NS} did not "
                                 f"commit: {coord.last_error}")
        move_ms = (time.perf_counter() - t1) * 1e3
        bad = docs_diff(twin_src.export_namespace_state(MOVE_NS), imports[-1])
        if bad:
            raise AssertionError(f"routing: the twin source's document "
                                 f"differs from the imported one in {bad}")
        twin_dst.import_namespace_state(imports[-1])
        twin_src.begin_move(MOVE_NS, dst_ep, epoch)
        if rc.epoch != 0:
            raise AssertionError("routing: the router moved before a push")
        fb0 = ha_metrics().fallback_totals().get("moved_follow", 0)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
        probe = int(ns0_ids[0])
        a = rc.request_token(probe)
        b = twin_src.request_token(probe)
        t_moved = answers[-1][0]
        if (a.status != TokenStatus.MOVED or a.remaining != epoch
                or (a.status, a.remaining) != (b.status, b.remaining)):
            raise AssertionError(f"routing: the stale route got {a}, the "
                                 f"twin {b}")
        if ha_metrics().fallback_totals().get("moved_follow", 0) != fb0 + 1:
            raise AssertionError("routing: the MOVED answer was not followed")
        push_now[0] = True
        src.push_hub.push_shard_map(encode_shard_map_doc(pub.current()))
        wait_for(lambda: rc.epoch == epoch, "routing: the pushed map", 10.0)
        a = rc.request_token(probe)
        t_dest = answers[-1][0]
        b = twin_dst.request_token(probe)
        if answers[-1][1] != dst.port or (a.status, a.remaining) != (
                b.status, b.remaining):
            raise AssertionError(f"routing: after the push {a}, the twin "
                                 f"{b}")
        moved_to_dest_ms = (t_dest - t_moved) * 1e3
        # the fence: a stale map, pushed or applied, changes nothing
        src.push_hub.push_shard_map(encode_shard_map_doc(
            ShardMap(epoch - 1, {MOVE_NS: src_ep})))
        rc._clients[src_ep].ping()
        fenced = not rc.apply_shard_map(ShardMap(epoch, {MOVE_NS: src_ep}))
        if not fenced or rc.epoch != epoch or \
                rc._state.pod_of[MOVE_NS] != dst_ep:
            raise AssertionError("routing: a stale map moved the route")
        owner[MOVE_NS] = twin_dst
        after = lockstep(rng, plan(rng, ROUTE_ROUNDS))
        after["flow"] += 2
        launches_after = {"decide": K.LAUNCHES["decide_rows"],
                          "cms": cms_cuda.LAUNCHES["cms_decide_update"]}
        if (launches_after["decide"], launches_after["cms"]) != (
                after["flow"], after["param"]):
            raise AssertionError(f"routing: launches {launches_after} for "
                                 f"{after} frames after the move")
        on_dst = sum(1 for t, port, kind, st in answers
                     if t > t_dest and port == dst.port)
        out["lockstep"] = dict(
            before=before, after=after, move_ms=move_ms,
            moved_to_dest_ms=moved_to_dest_ms,
            decide_launches=launches["decide"] + launches_after["decide"],
            param_launches=launches["cms"] + launches_after["cms"],
            answers_from_destination=on_dst)
        log(f"routing 14b: {sum(before.values())} requests before and "
            f"{sum(after.values())} after moving {MOVE_NS} (committed in "
            f"{move_ms:.1f} ms) equal to the owning twin's; the stale route "
            f"got MOVED with epoch {epoch}, the pushed map re-routed "
            f"the router: {moved_to_dest_ms:.1f} ms from the MOVED answer "
            f"to the destination's first; stale maps fenced; "
            f"{out['lockstep']['decide_launches']} decide launches for as "
            f"many FLOW frames, {out['lockstep']['param_launches']} "
            f"count-min launches for as many PARAM_FLOW frames")

        # --- a live move under the router's closed loop --------------------
        clock.set_clock(prev)
        live_ids = flow_ids[flow_ids % NS == int(LIVE_NS[2:])][
            :ROUTE_LIVE_FLOWS]
        thresholds = np.array([src_svc._rule_of[int(f)].count
                               for f in live_ids], np.int64)
        spans, admitted, statuses = [], [], {}
        result, raised = {}, [0]

        def mover():
            result["ok"] = coord.move_namespace(LIVE_NS, dst_ep)

        lrng = np.random.default_rng(72)
        mark = len(answers)
        thread = None
        t_begin = time.monotonic()
        t_stop = None
        while t_stop is None or time.monotonic() < t_stop:
            if thread is None and time.monotonic() - t_begin > \
                    ROUTE_LIVE_S[0]:
                thread = threading.Thread(target=mover)
                thread.start()
            if thread is not None and t_stop is None and \
                    not thread.is_alive():
                t_stop = time.monotonic() + ROUTE_LIVE_S[1]
            k = int(lrng.integers(live_ids.size))
            sent = time.time() * 1e3
            try:
                r = rc.request_token(int(live_ids[k]), ROUTE_LIVE_ACQUIRE)
            except Exception:
                raised[0] += 1
                continue
            row = np.zeros(live_ids.size, np.int64)
            if r.status == TokenStatus.OK:
                row[k] = ROUTE_LIVE_ACQUIRE
            statuses[int(r.status)] = statuses.get(int(r.status), 0) + 1
            spans.append((sent, time.time() * 1e3))
            admitted.append(row)
        thread.join(timeout=120)
        if not result.get("ok") or raised[0]:
            raise AssertionError(f"routing: the live move ({result}, "
                                 f"{raised[0]} raised): {coord.last_error}")
        window = window_less_bucket_ms(src_svc)
        over = over_admission(spans, np.array(admitted), thresholds, window)
        live_answers = answers[mark:]
        moved_t = [t for t, port, kind, st in live_answers
                   if st == int(TokenStatus.MOVED)]
        dest_t = [t for t, port, kind, st in live_answers
                  if port == dst.port and moved_t and t > moved_t[0]]
        if over != 0 or rc.epoch != epoch + 1 or not dest_t:
            raise AssertionError(f"routing: live over-admission {over}, "
                                 f"epoch {rc.epoch}, {len(dest_t)} answers "
                                 f"from the destination")
        out["live"] = dict(
            requests=len(spans), statuses=statuses, over_admission=over,
            span_ms=window, moved_answers=len(moved_t),
            moved_to_dest_ms=((dest_t[0] - moved_t[0]) * 1e3
                              if moved_t else None),
            admitted=int(np.array(admitted).sum()))
        log(f"routing 14b live: {len(spans)} requests of "
            f"{ROUTE_LIVE_ACQUIRE} tokens on {live_ids.size} flows of "
            f"{LIVE_NS}, moved under the loop; statuses {statuses}; "
            f"{len(moved_t)} MOVED answers, "
            f"{out['live']['moved_to_dest_ms']} ms from the first to the "
            f"destination's first; over-admission {over} (spans under "
            f"{window} ms)")
    finally:
        clock.set_clock(prev)
        if rc is not None:
            rc.close()
        for s in servers:
            s.stop()
    out["phase_s"] = time.perf_counter() - t0
    return out


def control_sketch(torch, dev):
    """14c. ``sketch.parity`` at ``ParamConfig()``'s widths, per sketch:
    ``stream_report`` over ``SKETCH_KEYS`` keys and ``SKETCH_EVENTS`` events
    (alpha 1.1) in ``SKETCH_BATCH``-row batches through the kernel, one
    launch a batch, zero undercounts for the fat sketch and the slim twin;
    the final ``ParamState`` of that stream and of a ``SKETCH_PREFIX``
    prefix bitwise equal to the plain versions' on the card; the
    reference's slim gate (p90 within 2x of the fat sketch's, with its
    2-count floor) at the configuration and on the stream it is defined for
    (``SKETCH_GATE_CFG``, ``SKETCH_GATE``: width 512, one the twin can
    hold). The slim-over-fat mean relative error at ``SKETCH_KEYS`` keys is
    reported, not gated."""
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
    from sentinel_tpu_torch.sketch import parity as SP

    t0 = time.perf_counter()
    out = {}
    hashes, _ids = SP.zipf_stream(SKETCH_KEYS, SKETCH_EVENTS)
    for sketch in SKETCHES:
        cfg = ParamConfig(sketch=sketch)
        plain = cfg._replace(impl="jax")
        L, name = ((cms_cuda.LAUNCHES, "cms_decide_update") if sketch == "cms"
                   else (salsa_cuda.LAUNCHES, "salsa_decide_update"))
        L.update(dict.fromkeys(L, 0))
        t1 = time.perf_counter()
        rep = SP.stream_report(cfg, n_keys=SKETCH_KEYS,
                               n_events=SKETCH_EVENTS, batch=SKETCH_BATCH,
                               device=dev)
        report_s = time.perf_counter() - t1
        batches = -(-SKETCH_EVENTS // SKETCH_BATCH)
        launches = L[name]
        if launches != batches:
            raise AssertionError(f"sketch {sketch}: {launches} launches for "
                                 f"{batches} batches")
        if rep["undercounts"] or rep["slim"]["undercounts"]:
            raise AssertionError(f"sketch {sketch}: undercounts "
                                 f"{rep['undercounts']} / "
                                 f"{rep['slim']['undercounts']}")
        merges = None
        for events, batch in ((SKETCH_EVENTS, SKETCH_BATCH), SKETCH_PREFIX):
            a = SP.run_stream(cfg, hashes[:events], batch=batch, device=dev)
            b = SP.run_stream(plain, hashes[:events], batch=batch,
                              device=dev)
            if merges is None:
                merges = int(a.merges.sum())
            for leaf in a._fields:
                if not torch.equal(getattr(a, leaf), getattr(b, leaf)):
                    raise AssertionError(f"sketch {sketch}: {leaf} differs "
                                         f"from the plain version's after "
                                         f"{events} events in {batch}-row "
                                         f"batches")
        gate_cfg = ParamConfig(sketch=sketch, **SKETCH_GATE_CFG)
        gate = SP.stream_report(gate_cfg, n_keys=SKETCH_GATE[0],
                                n_events=SKETCH_GATE[1], device=dev)
        fat_p90, slim_p90 = gate["errCdf"]["p90"], gate["slim"]["errCdf"][
            "p90"]
        if gate["slim"]["undercounts"] or slim_p90 > max(2 * fat_p90, 2.0):
            raise AssertionError(f"sketch {sketch}: the slim gate "
                                 f"({fat_p90}, {slim_p90})")
        ratio = rep["slim"]["meanRelErr"] / rep["meanRelErr"]
        out[sketch] = dict(report=rep, launches=launches, batches=batches,
                           report_s=report_s, merges=merges,
                           gate=dict(fat_p90=fat_p90, slim_p90=slim_p90,
                                     keys=SKETCH_GATE[0],
                                     events=SKETCH_GATE[1],
                                     width=SKETCH_GATE_CFG["width"]),
                           slim_over_fat_mean_rel_err=ratio)
        log(f"sketch 14c {sketch}: {SKETCH_EVENTS} events over "
            f"{SKETCH_KEYS} keys in {batches} launches ({report_s:.1f} s); "
            f"undercounts 0 / 0; fat error CDF {rep['errCdf']}, mean "
            f"relative {rep['meanRelErr']:.3f}; slim CDF "
            f"{rep['slim']['errCdf']}, mean relative "
            f"{rep['slim']['meanRelErr']:.3f} ({ratio:.2f}x the fat); "
            f"states bitwise equal to the plain versions' at "
            f"{SKETCH_BATCH} and {SKETCH_PREFIX[1]} rows; slim gate at "
            f"width {SKETCH_GATE_CFG['width']}, {SKETCH_GATE[0]} keys: p90 "
            f"{slim_p90} vs fat {fat_p90}")
    out["phase_s"] = time.perf_counter() - t0
    return out


CODEC_ROWS = (64, 1024, None)  # None: the most one frame carries (5,040)
CODEC_REPS = 200


def numpy_batch_req(P, payload):
    """The reference's numpy decode of a BATCH_FLOW request payload (its
    fallback when the native library is missing)."""
    xid, _ = P._HEAD.unpack_from(payload, 0)
    (n,) = P._BATCH_N.unpack_from(payload, P._HEAD.size)
    off = P._HEAD.size + P._BATCH_N.size
    rows = np.frombuffer(payload, dtype=P.BATCH_REQ_DTYPE, count=n,
                         offset=off)
    return (xid, rows["flow_id"].astype(np.int64),
            rows["count"].astype(np.int32), rows["prio"].astype(bool))


def numpy_batch_rsp(P, xid, status, remaining, wait_ms):
    """The reference's numpy encode of a BATCH_FLOW response frame."""
    n = status.shape[0]
    rows = np.empty(n, dtype=P.BATCH_RSP_DTYPE)
    rows["status"] = status
    rows["remaining"] = remaining
    rows["wait_ms"] = wait_ms
    return (P._LEN.pack(P._HEAD.size + P._BATCH_N.size
                        + n * P.BATCH_RSP_DTYPE.itemsize)
            + P._HEAD.pack(xid, P.MsgType.BATCH_FLOW)
            + P._BATCH_N.pack(n) + rows.tobytes())


def control_codec():
    """14d. The port's BATCH_FLOW codec (``protocol.decode_batch_request``
    / ``encode_batch_response``, the native library) against the
    reference's numpy bodies at ``CODEC_ROWS`` rows a frame: equal arrays
    and bytes, and the median host time of each over ``CODEC_REPS``
    calls, the two interleaved in blocks of ten."""
    from sentinel_tpu_torch.cluster import protocol as P

    rng = np.random.default_rng(14)
    out = {}
    for n in CODEC_ROWS:
        n = n or P.MAX_BATCH_PER_FRAME
        ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
        cnt = rng.integers(1, 100, size=n).astype(np.int32)
        pri = rng.integers(0, 2, size=n).astype(np.uint8)
        payload = P.encode_batch_request(9, ids, cnt, pri)[2:]
        st = rng.integers(-2, 5, size=n).astype(np.int8)
        rem = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
        wt = rng.integers(0, 10_000, size=n).astype(np.int32)
        a, b = P.decode_batch_request(payload), numpy_batch_req(P, payload)
        if a[0] != b[0] or any(x.dtype != y.dtype or not np.array_equal(x, y)
                               for x, y in zip(a[1:], b[1:])):
            raise AssertionError(f"codec: {n}-row decode differs from "
                                 f"numpy's")
        if (P.encode_batch_response(9, st, rem, wt)
                != numpy_batch_rsp(P, 9, st, rem, wt)):
            raise AssertionError(f"codec: {n}-row encode differs from "
                                 f"numpy's")
        calls = {
            "decode_native": lambda: P.decode_batch_request(payload),
            "decode_numpy": lambda: numpy_batch_req(P, payload),
            "encode_native": lambda: P.encode_batch_response(9, st, rem, wt),
            "encode_numpy": lambda: numpy_batch_rsp(P, 9, st, rem, wt),
        }
        times = {k: [] for k in calls}
        for _ in range(CODEC_REPS // 10):
            for key, call in calls.items():
                for _ in range(10):
                    t = time.perf_counter_ns()
                    call()
                    times[key].append(time.perf_counter_ns() - t)
        us = {k: float(np.median(v)) / 1e3 for k, v in times.items()}
        out[n] = us
        log(f"codec 14d {n} rows: decode native {us['decode_native']:.2f} "
            f"us vs numpy {us['decode_numpy']:.2f} us; encode native "
            f"{us['encode_native']:.2f} us vs numpy {us['encode_numpy']:.2f}"
            f" us (medians of {CODEC_REPS}); arrays and bytes equal")
    return out


ADAPTER_ROUTES = 3000  # routes behind the gateway, every 6th in cluster mode
ADAPTER_REQUESTS = 4000  # 15a's seeded stream, on the manual clock
ADAPTER_SEED = 151
ADAPTER_THREADS = 8
ADAPTER_SECONDS = 3.0  # 15b's timed runs on the system clock, each
ADAPTER_PLAN = 4000  # requests a client thread cycles through in 15b
ADAPTER_POLL_S = 0.2  # 15b's polling data source
ADAPTER_WRITES = 6  # 15b's rule file writes, each awaited in the answers
ADAPTER_RULES = os.path.join(HERE, "sentinel_tpu_torch", "build",
                             "adapter_rules")  # the phase's rule files


def phase_adapters(torch, dev):
    """Phase 15: the adapters and the data sources on the card. 15a: the
    seeded HTTP stream of ``tests/torch_adapter_check.py`` through the
    port's gateway over WSGI and ASGI middleware and ``@sentinel_resource``
    functions, every rule read from files by ``FileRefreshableDataSource``
    (the token server's 100,000 flow rules through a property listener),
    with the card service embedded and then its torch-ops twin from the
    same manual clock: every response and node counter equal, one decide
    launch per cluster flow check and one count-min launch per cluster
    param check, every dispatch sync-free, no service exception, three
    files pushed halfway (the rule epoch one up, the pushed routes'
    answers changed), no failed refresh. 15b: the WSGI stack behind
    ``wsgiref``'s threading server, 8 client threads in a child process
    for 3 s a run (cluster rules, and the same rules local), and the time
    from a rule file's write to the first answer that shows it, the file
    polled by its data source's thread."""
    import torch_adapter_check as AC

    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.datasource import base as ds_base

    t_phase = time.perf_counter()
    root = ADAPTER_RULES
    shutil.rmtree(root, ignore_errors=True)
    P = AC.package("sentinel_tpu_torch")
    # 15a's clock: a minute boundary two minutes back, as phase 13's
    t0_ms = int(time.time() * 1000) // 60_000 * 60_000 - 120_000
    mc = clock.ManualClock(t0_ms)
    prev = clock.set_clock(mc)
    try:
        card, param_flows = sdk_service(dev)
        lay = AC.layout(ADAPTER_ROUTES,
                        np.random.default_rng(ADAPTER_SEED).permutation(F),
                        param_flows)
        out = {"lockstep": adapter_lockstep(torch, dev, AC, P, card, lay,
                                            mc, root)}
        clock.set_clock(clock.SystemClock())
        out["timed"] = adapter_timed(AC, P, card, lay, root)
        failures = ds_base.refresh_failure_totals()
        if failures:
            raise AssertionError(f"adapters: failed refreshes {failures}")
    finally:
        clock.set_clock(prev)
        AC.reset(P)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"adapter phase: {out['phase_s']:.1f} s ({gpu_identity()})")
    return out


def adapter_lockstep(torch, dev, AC, P, card, lay, mc, root) -> dict:
    """15a (see ``phase_adapters``)."""
    import torch_sdk_check as SDK

    from sentinel_tpu_torch.datasource import base as ds_base
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    t0_ms = mc.now_ms()
    twin, _ = sdk_service(dev, twin=True)
    docs = AC.rule_docs(lay, F, NS)
    steps = AC.stream(np.random.default_rng(ADAPTER_SEED + 1), lay,
                      ADAPTER_REQUESTS)
    after = AC.push(docs, lay, steps, np.random.default_rng(ADAPTER_SEED + 2))
    runs = {}
    for name, svc in (("card", card), ("twin", twin)):
        AC.reset(P)
        mc.set_ms(t0_ms)
        rec = Recorded(svc)
        P.api.set_embedded_server(rec)
        rule_dir = os.path.join(root, name)
        AC.write_rules(P, rule_dir, docs)
        t_load = time.perf_counter()
        srcs = AC.open_sources(
            P, rule_dir, lambda rules, svc=svc: svc.load_rules(
                rules, ns_max_qps=1e9))
        load_s = time.perf_counter() - t_load
        stacks = AC.build_stacks(P, lay)
        epochs, push_s = [], []

        def at_half(svc=svc, rule_dir=rule_dir, srcs=srcs):
            AC.write_rules(P, rule_dir, after, AC.PUSHED_FILES)
            gen, t = svc.state_generation(), time.perf_counter()
            AC.refresh(srcs, AC.PUSHED_FILES)
            push_s.append(time.perf_counter() - t)
            epochs.append(svc.state_generation() - gen)

        torch.cuda.synchronize()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        cms_cuda.LAUNCHES.update(dict.fromkeys(cms_cuda.LAUNCHES, 0))
        checked = [0]
        if name == "card":
            sync_checked(torch, card, checked)
        t0 = time.perf_counter()
        try:
            responses = AC.drive(stacks, steps, mc.advance, at_half)
        finally:
            if name == "card":
                del card.dispatch_batch_arrays
        runs[name] = dict(
            responses=responses,
            counters=SDK.node_counters(P.chain, P.context, mc.now_ms()),
            calls=dict(rec.calls), errors=list(rec.errors),
            decide=K.LAUNCHES["decide_rows"],
            cms=cms_cuda.LAUNCHES["cms_decide_update"], checked=checked[0],
            epochs=epochs, load_s=load_s, push_s=push_s[0],
            wall_s=time.perf_counter() - t0, end_ms=mc.now_ms())
    AC.reset(P)
    a, b = runs["card"], runs["twin"]
    errors = a["errors"] + b["errors"]
    if errors:
        raise AssertionError(f"adapters: the service raised: {errors[:3]}")
    if not len(a["responses"]) == len(b["responses"]) == ADAPTER_REQUESTS:
        raise AssertionError(f"adapters: {len(a['responses'])} / "
                             f"{len(b['responses'])} responses")
    first = next((k for k, (x, y) in enumerate(zip(a["responses"],
                                                   b["responses"]))
                  if x != y), None)
    if first is not None:
        raise AssertionError(
            f"adapters: response {first} differs from the twin's: "
            f"{a['responses'][first]} != {b['responses'][first]}")
    bad = SDK.diff(a["counters"], b["counters"])
    if bad or a["end_ms"] != b["end_ms"]:
        raise AssertionError(f"adapters: node counters differ: {bad}")
    flow_checks = a["calls"]["request_token"]
    param_checks = a["calls"]["request_params_token"]
    if (a["decide"] != flow_checks or a["checked"] != flow_checks
            or a["cms"] != param_checks or b["decide"] or b["cms"]
            or b["calls"] != a["calls"]):
        raise AssertionError(
            f"adapters: launches {a['decide']} decide / {a['cms']} "
            f"count-min (twin {b['decide']} / {b['cms']}) for {flow_checks} "
            f"flow and {param_checks} param checks, {a['checked']} checked "
            f"dispatches")
    if a["epochs"] != [1] or b["epochs"] != [1]:
        raise AssertionError(f"adapters: the push moved the rule epoch by "
                             f"{a['epochs']} / {b['epochs']}, not one")
    failures = ds_base.refresh_failure_totals()
    if failures:
        raise AssertionError(f"adapters: failed refreshes {failures}")
    kinds = AC.tally(lay, steps, a["responses"])
    need = ("200", "429", "500", "blocked:ParamFlowException",
            "blocked:DegradeException")
    if (any(not kinds.get(k) for k in need)
            or flow_checks < ADAPTER_REQUESTS // 20
            or param_checks < ADAPTER_REQUESTS // 40):
        raise AssertionError(f"adapters: the stream reached too little: "
                             f"{kinds}, {a['calls']}")
    pushed = set(AC.pushed_routes(lay, docs, after))
    half = ADAPTER_REQUESTS // 2
    before = AC.tally(lay, steps[:half], a["responses"][:half], pushed)
    later = AC.tally(lay, steps[half:], a["responses"][half:], pushed)
    if later.get("429", 0) <= before.get("429", 0):
        raise AssertionError(f"adapters: the push changed no answer of its "
                             f"routes: {before} then {later}")
    asgi = sum(1 for st in steps if st["asgi"])
    out = dict(requests=ADAPTER_REQUESTS, asgi_requests=asgi,
               routes=ADAPTER_ROUTES, responses=kinds,
               nodes=len(a["counters"]), flow_checks=flow_checks,
               param_checks=param_checks, decide_launches=a["decide"],
               cms_launches=a["cms"], sync_free_dispatches=a["checked"],
               pushed_routes=len(pushed), pushed_before=before,
               pushed_after=later, rule_epoch_step=a["epochs"][0],
               engine_ms=a["end_ms"] - t0_ms,
               load_s=a["load_s"], push_s=a["push_s"],
               twin_load_s=b["load_s"], twin_push_s=b["push_s"],
               card_wall_s=a["wall_s"], twin_wall_s=b["wall_s"])
    log(f"adapters 15a: {ADAPTER_REQUESTS} requests ({asgi} through ASGI) "
        f"over {ADAPTER_ROUTES} routes ({kinds}) equal to the twin in every "
        f"response and in {len(a['counters'])} nodes' counters; "
        f"{a['decide']} decide launches for {flow_checks} cluster flow "
        f"checks (each dispatch sync-free), {a['cms']} count-min launches "
        f"for {param_checks} cluster param checks; rule files loaded in "
        f"{a['load_s']:.2f} s, the push of three in {a['push_s']:.2f} s "
        f"(rule epoch +1; 429s on its {len(pushed)} routes "
        f"{before.get('429', 0)} then {later.get('429', 0)}); "
        f"{a['wall_s']:.1f} s on the card, "
        f"{b['wall_s']:.1f} s on the twin")
    return out


def adapter_timed(AC, P, card, lay, root) -> dict:
    """15b (see ``phase_adapters``): the WSGI stack served by ``wsgiref``'s
    server with ``ThreadingMixIn`` on 127.0.0.1, the card service embedded,
    its rule files polled every ``ADAPTER_POLL_S``."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import (
        WSGIRequestHandler,
        WSGIServer,
        make_server,
    )

    class Server(ThreadingMixIn, WSGIServer):
        daemon_threads = True
        request_queue_size = 128  # 8 clients connect at once

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    AC.reset(P)
    rec = Recorded(card)
    P.api.set_embedded_server(rec)
    rule_dir = os.path.join(root, "timed")
    docs = AC.rule_docs(lay, F, NS)
    AC.write_rules(P, rule_dir, docs)
    srcs = AC.open_sources(
        P, rule_dir, lambda rules: card.load_rules(rules, ns_max_qps=1e9),
        refresh_interval_s=ADAPTER_POLL_S)
    stacks = AC.build_stacks(P, lay)
    server = make_server("127.0.0.1", 0, stacks.wsgi, server_class=Server,
                         handler_class=Quiet)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    plans = []
    for t in range(ADAPTER_THREADS):
        steps = AC.stream(np.random.default_rng(2000 + t), lay, ADAPTER_PLAN)
        plans.append([(f"{AC.path(st['route'])}?{AC.query(st)}",
                       AC.headers(st), AC.route_class(lay, st["route"]))
                      for st in steps])
    out = {}
    try:
        for mode in ("cluster", "local"):
            if mode == "local":
                AC.write_rules(P, rule_dir,
                               AC.rule_docs(lay, F, NS, cluster=False),
                               ("flow", "param"))
                AC.refresh(srcs, ("flow",))
                AC.refresh_param_rules(P, srcs)
            rec.calls.update(dict.fromkeys(rec.calls, 0))
            out[mode] = adapter_load(server.server_address[1], plans)
            out[mode]["service_calls"] = dict(rec.calls)
            t = out[mode]
            if (not set(t["statuses"]) <= {200, 429, 500}
                    or (mode == "local") == any(rec.calls.values())):
                raise AssertionError(f"adapters 15b ({mode} rules): "
                                     f"statuses {t['statuses']}, service "
                                     f"calls {rec.calls}")
            log(f"adapters 15b ({mode} rules, {ADAPTER_THREADS} client "
                f"threads, {ADAPTER_SECONDS} s): "
                f"{t['requests_per_s']:.0f} requests/s {t['statuses']}; "
                f"p50 / p99 ms " + "; ".join(
                    f"{c} {q['p50']:.3f} / {q['p99']:.3f} (n {q['n']})"
                    for c, q in t["latency_ms"].items() if q["n"]))
        AC.write_rules(P, rule_dir, docs, ("flow", "param"))
        AC.refresh(srcs, ("flow",))
        AC.refresh_param_rules(P, srcs)
        out["push"] = adapter_push_latency(AC, P, lay, docs, rule_dir,
                                           srcs["cluster"],
                                           server.server_address[1])
    finally:
        srcs["cluster"].close()
        server.shutdown()
        server.server_close()
    if rec.errors:
        raise AssertionError(f"adapters 15b: the service raised: "
                             f"{rec.errors[:3]}")
    q = out["push"]["write_to_answer_ms"]
    log(f"adapters 15b: a write of the {F:,}-rule cluster file to the "
        f"first answer that shows it, polled every {ADAPTER_POLL_S} s: "
        f"p50 {q['p50']:.1f} ms, max {q['max']:.1f} ms over "
        f"{ADAPTER_WRITES} writes")
    return out


def adapter_load(port: int, plans) -> dict:
    """One 15b run: the clients in a spawned child (their own GIL)."""
    ctx = multiprocessing.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    child = ctx.Process(target=adapter_clients,
                        args=(child_end, port, plans, ADAPTER_SECONDS),
                        daemon=True)
    child.start()
    try:
        if not pipe.poll(ADAPTER_SECONDS + 120):
            raise AssertionError("adapters 15b: the clients did not report")
        res = pipe.recv()
    finally:
        child.join(10)
        if child.is_alive():
            child.kill()
            child.join(10)
    if res["errors"]:
        raise AssertionError(f"adapters 15b: {res['errors'][:3]}")
    return dict(requests=res["n"], wall_s=res["wall_s"],
                requests_per_s=res["n"] / res["wall_s"],
                statuses=res["statuses"],
                latency_ms={c: quantiles(v)
                            for c, v in res["lat_ms"].items()})


def adapter_clients(conn, port: int, plans, seconds: float) -> None:
    """15b's clients, in a child process: a thread a plan, each cycling
    through its ``(target, headers, class)`` requests over ``urllib`` (no
    proxy) for ``seconds``; sends back the latencies (ms) by route class,
    the statuses, the count and any error other than an HTTP status."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    lat = {"cluster_flow": [], "cluster_param": [], "local": []}
    statuses = {}
    errors = []
    counts = [0] * len(plans)
    lock = threading.Lock()
    start = threading.Barrier(len(plans) + 1)

    def work(t):
        mine = {c: [] for c in lat}
        codes = {}
        start.wait()
        end = time.perf_counter() + seconds
        try:
            for target, hdrs, cls in itertools.cycle(plans[t]):
                if time.perf_counter() > end:
                    break
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{target}", headers=hdrs)
                t0 = time.perf_counter()
                try:
                    with opener.open(req, timeout=60) as r:
                        r.read()
                        code = r.status
                except urllib.error.HTTPError as e:
                    e.read()
                    e.close()
                    code = e.code
                mine[cls].append((time.perf_counter() - t0) * 1e3)
                codes[code] = codes.get(code, 0) + 1
                counts[t] += 1
        except Exception as exc:  # sent back: the phase fails
            errors.append(repr(exc))
        with lock:
            for c, v in mine.items():
                lat[c].extend(v)
            for code, n in codes.items():
                statuses[code] = statuses.get(code, 0) + n

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(len(plans))]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(seconds + 90)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish")
    conn.send(dict(lat_ms=lat, statuses=statuses, errors=errors,
                   n=sum(counts), wall_s=wall))
    conn.close()


def adapter_push_latency(AC, P, lay, docs, rule_dir, src, port) -> dict:
    """15b: ``src`` (the cluster rule file's data source) polls on its own
    thread; each of ``ADAPTER_WRITES`` writes flips one probe route's flow
    between a count of 0 (every check blocks) and 100,000, and the probe's
    requests time the write to the first answer that shows it."""
    import urllib.error
    import urllib.request

    probe = next(i for i in sorted(lay["cluster"])
                 if i % AC.GROUPS == 0 and i >= 40
                 and i not in lay["authority"] and i not in lay["gateway"])
    fid = lay["cluster"][probe]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    sent = [0]

    def status() -> int:
        sent[0] += 1  # a new user id each time: no param rule binds
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{AC.path(probe)}?uid=p{sent[0]}",
            headers={"X-Real-IP": AC.IPS[0]})
        try:
            with opener.open(req, timeout=60) as r:
                r.read()
                return r.status
        except urllib.error.HTTPError as e:
            e.read()
            e.close()
            return e.code

    src.start()
    waits = []
    for w in range(ADAPTER_WRITES):
        want = 429 if w % 2 == 0 else 200
        count = 0.0 if want == 429 else 100_000.0
        rules = [dict(d, count=count) if d["flowId"] == fid else d
                 for d in docs["cluster"]]
        t0 = time.perf_counter()
        AC.write_rules(P, rule_dir, {"cluster": rules}, ("cluster",))
        while status() != want:
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"adapters 15b: write {w} did not "
                                     f"reach the answers in 60 s")
            time.sleep(0.002)
        waits.append((time.perf_counter() - t0) * 1e3)
    return dict(probe_route=probe, flow_id=fid, writes=ADAPTER_WRITES,
                poll_s=ADAPTER_POLL_S, probes=sent[0], waits_ms=waits,
                write_to_answer_ms=quantiles(waits))


OPERATOR_PULLS = 200  # 16a's BATCH_FLOW pulls, each with a PARAM_FLOW frame
OPERATOR_ROWS = 1024
OPERATOR_RESOURCES = SDK_RESOURCES  # phase 13's SDK shape
OPERATOR_ENTRIES = 2000  # entry() calls, spread over the pulls
OPERATOR_SEED = 161
OPERATOR_HEIR_PULLS = 20  # the restored service's first pulls
OPERATOR_FLIP_PULLS = 10  # after the mode file's flip back to server
OPERATOR_SCRAPES = 20  # 16b's idle scrapes of each exporter
OPERATOR_LOOP_S = 2.0  # 16b's closed loops, without and with scrapes
OPERATOR_SCRAPE_S = 0.1  # the scrape interval under the loop
OPERATOR_PUSHES = 3  # 16b's timed modifyFlowRules
OPERATOR_REPS = 5  # 16b's cluster/server/metrics and snapshot fetches
OPERATOR_ROOT = os.path.join(HERE, "sentinel_tpu_torch", "build",
                             "operator")  # snapshots and the mode file


def phase_operator(torch, dev):
    """Phase 16: the operator's surface (``sentinel_tpu_torch.init``, the
    command center, heartbeat, exporter, metric log, cluster assignment and
    ``ClusterStateManager``) driving a token server on the card. 16a, card
    then twin on one manual clock (``tests/torch_operator_check.py``):
    ``init_default`` with a local fake dashboard, ``setClusterMode`` over
    HTTP promoting a ``NativeTokenServer`` with a ``metrics_port``, phase
    3's 100,000 flow rules and 256 param rules loaded in process, then 200
    seeded 1,024-row pulls and 200 PARAM_FLOW frames from a
    ``TokenClient`` (reports every 10th pull), 2,000 SDK entries, four
    namespace pushes, a param push, ``modifyFlowConfig``,
    ``modifyNamespaceSet`` and a port move through the command center,
    scrapes of both exporters, the metric log, a snapshot fetched and saved,
    ``ClusterStateManager.to_server`` restoring it into a second service,
    and a mode file flipping the node to client and back to server on a new
    port. Every verdict, command response (less times, pids, host names and
    ports), exposition series (less host durations) and metric-log byte must
    equal the twin's; one decide launch per device step and one count-min
    launch per param check on the card, each dispatch sync-free;
    heartbeats received; no failed refresh and no logged error. 16b, the
    card alone on the system clock: scrape and command times, the pull RTT
    of one client's closed loop with and without scrapes every 100 ms, and
    the times from a push, a promotion and a port move to their first
    verdict."""
    import torch_operator_check as OC
    import torch_sdk_check as SDK

    from sentinel_tpu_torch.core import clock

    t_phase = time.perf_counter()
    shutil.rmtree(OPERATOR_ROOT, ignore_errors=True)
    os.makedirs(OPERATOR_ROOT)
    P = OC.package("sentinel_tpu_torch")
    cfg = P.config.SentinelConfig
    props = dict(cfg._props)
    t0_ms = int(time.time() * 1000) // 60_000 * 60_000 - 120_000
    mc = clock.ManualClock(t0_ms)
    prev = clock.set_clock(mc)
    try:
        out = {"lockstep": operator_lockstep(torch, dev, OC, P, SDK, mc)}
        clock.set_clock(clock.SystemClock())
        out["timed"] = operator_timed(torch, dev, OC, P)
    finally:
        clock.set_clock(prev)
        OC.reset(P)
        cfg._props.clear()
        cfg._props.update(props)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"operator phase: {out['phase_s']:.1f} s ({gpu_identity()})")
    return out


def operator_service(dev, twin=False):
    """Phase 3's flow configuration and ``ParamConfig()``, empty, on the
    kernels or, with ``twin``, on the torch-ops cores."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.engine.param import ParamConfig

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1],
                       decide_impl="xla" if twin else "auto")
    return DefaultTokenService(
        cfg, param_config=ParamConfig(impl="jax" if twin else "auto"),
        device=dev)


def operator_rules(svc):
    """Phase 3's 100,000 flow rules and ``sdk_service``'s 256 param rules
    into ``svc``; returns the param rules' flow ids."""
    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.token_service import ClusterParamFlowRule
    from sentinel_tpu_torch.engine import ClusterFlowRule, ThresholdMode

    svc.load_rules(service_rules(ClusterFlowRule, ThresholdMode),
                   ns_max_qps=1e9)
    specs = PC.service_rule_specs(256, np.random.default_rng(41))
    svc.load_param_rules([ClusterParamFlowRule(s.flow_id, 1.0 + k % 3)
                          for k, s in enumerate(specs)])
    return [s.flow_id for s in specs]


def instrument(torch, svc, card: bool, rec: dict) -> None:
    """Wrap ``svc``'s device steps and param checks (instance attributes
    over the methods; ``uninstrument`` removes them): count them, the decide
    and count-min launches each made, record every exception, and run each
    dispatch of a card service under torch's sync debug mode."""
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    dispatch = svc.dispatch_batch_arrays
    params = svc.request_params_token

    def checked(ids, counts=None, prios=None):
        before = K.LAUNCHES["decide_rows"]
        if card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            mat = dispatch(ids, counts, prios)
        except Exception as exc:
            rec["errors"].append(f"dispatch: {exc!r}")
            raise
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
        rec["steps"] += 1
        rec["decide"].add(K.LAUNCHES["decide_rows"] - before)
        return mat

    def param_checked(flow_id, acquire, param_hashes):
        before = cms_cuda.LAUNCHES["cms_decide_update"]
        try:
            res = params(flow_id, acquire, param_hashes)
        except Exception as exc:
            rec["errors"].append(f"request_params_token: {exc!r}")
            raise
        if len(param_hashes):
            rec["param_checks"] += 1
            rec["cms"].add(cms_cuda.LAUNCHES["cms_decide_update"] - before)
        return res

    svc.dispatch_batch_arrays = checked
    svc.request_params_token = param_checked


def uninstrument(svc) -> None:
    del svc.dispatch_batch_arrays
    del svc.request_params_token


def free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("0.0.0.0", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def write_json(path: str, obj) -> None:
    """Atomically, so that a poller never reads half a file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def operator_lockstep(torch, dev, OC, P, SDK, mc) -> dict:
    """16a (see ``phase_operator``)."""
    import importlib

    from sentinel_tpu_torch.cluster.client import TokenClient

    t0_ms = mc.now_ms()
    sph_mod = importlib.import_module("sentinel_tpu_torch.local.sph")
    t_build = time.perf_counter()
    services = {"card": operator_service(dev),
                "twin": operator_service(dev, twin=True)}
    build_s = time.perf_counter() - t_build
    # the plan needs the param rules' flow ids: the same for every service
    import torch_param_check as PC

    param_flows = [s.flow_id for s in PC.service_rule_specs(
        256, np.random.default_rng(41))]
    steps = OC.plan(np.random.default_rng(OPERATOR_SEED), F, param_flows,
                    OPERATOR_PULLS, OPERATOR_ROWS, PC.value_hashes)
    lay = SDK.layout(OPERATOR_RESOURCES, range(1000), param_flows)
    entries = SDK.stream(np.random.default_rng(OPERATOR_SEED + 1), lay,
                         OPERATOR_ENTRIES)
    runs = {}
    for name, svc in services.items():
        runs[name] = operator_run(torch, dev, OC, P, SDK, sph_mod,
                                  TokenClient, name, svc, steps, lay,
                                  entries, mc, t0_ms)
    a, b = runs["card"], runs["twin"]
    for key in ("verdicts", "params", "entries", "probes", "responses",
                "scrapes", "door_scrapes", "metric_files", "metric_text",
                "heir_verdicts", "flip_verdicts", "end_ms"):
        x, y = a[key], b[key]
        if not isinstance(x, list):
            x, y = [x], [y]
        bad = OC.first_difference(x, y)
        if bad:
            raise AssertionError(f"operator 16a: {key} differ from the "
                                 f"twin's: {bad}")
    for name, r in runs.items():
        want = {1} if name == "card" else {0}
        if r["errors"] or r["logged"]:
            raise AssertionError(f"operator 16a ({name}): errors "
                                 f"{r['errors'][:3]}, logged "
                                 f"{r['logged'][:3]}")
        if r["decide"] != want or r["cms"] != want:
            raise AssertionError(
                f"operator 16a ({name}): decide launches a device step "
                f"{r['decide']}, count-min launches a param check "
                f"{r['cms']}, want {want}")
    for ns, admitted in a["probes"]:
        if any(n > OC.pushed_count(f) or n >= OC.PROBE_ROWS
               for f, n in admitted.items()):
            raise AssertionError(f"operator 16a: the first pull after the "
                                 f"push of {ns} admitted {admitted}")
    if len(a["probes"]) != 4 or not a["metric_text"]:
        raise AssertionError(f"operator 16a: {len(a['probes'])} pushes "
                             f"probed, metric log {len(a['metric_text'])} B")
    statuses = {}
    for st, _, _ in a["verdicts"]:
        for s, n in zip(*np.unique(np.frombuffer(st, np.int8),
                                   return_counts=True)):
            statuses[int(s)] = statuses.get(int(s), 0) + int(n)
    out = dict(
        pulls=OPERATOR_PULLS, rows=OPERATOR_ROWS, entries=OPERATOR_ENTRIES,
        service_build_s=build_s, pull_statuses=statuses,
        device_steps=a["steps"], decide_launches=a["steps"],
        param_checks=a["param_checks"], cms_launches=a["param_checks"],
        sync_free_dispatches=a["steps"],  # each under sync debug "error"
        commands=len(a["responses"]), scrapes=len(a["scrapes"]),
        scrape_lines=len(a["scrapes"][-1]),
        excluded_families=list(OC.EXCLUDED_FAMILIES),
        metric_log_bytes=sum(len(v) for _, v in a["metric_files"]),
        metric_lines=a["metric_text"].count("\n") + 1,
        heartbeats=a["heartbeats"], probes=[
            {"namespace": ns, "admitted": {str(f): n for f, n in adm.items()}}
            for ns, adm in a["probes"]],
        snapshot_bytes=a["snapshot_bytes"], engine_ms=a["end_ms"] - t0_ms,
        card=a["times"], twin=b["times"])
    log(f"operator 16a: {OPERATOR_PULLS} pulls of {OPERATOR_ROWS} rows "
        f"({statuses}), {OPERATOR_PULLS} PARAM_FLOW frames, "
        f"{OPERATOR_ENTRIES} entries, {len(a['responses'])} commands, "
        f"{len(a['scrapes'])} scrapes of both exporters "
        f"({len(a['scrapes'][-1])} lines compared), "
        f"{out['metric_log_bytes']} B of metric log, the restored service's "
        f"{OPERATOR_HEIR_PULLS} pulls and {OPERATOR_FLIP_PULLS} after the "
        f"mode flips: equal to the twin; {a['steps']} device steps with one "
        f"decide launch each (sync-free), {a['param_checks']} param checks "
        f"with one count-min launch each; {a['heartbeats']} heartbeats; "
        f"card {a['times']['wall_s']:.1f} s, twin {b['times']['wall_s']:.1f} "
        f"s")
    return out


def operator_run(torch, dev, OC, P, SDK, sph_mod, TokenClient, name, svc,
                 steps, lay, entries, mc, t0_ms) -> dict:
    """One 16a run of ``svc`` (``name`` is card or twin) from ``t0_ms``."""
    import logging

    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core.log import record_log
    from sentinel_tpu_torch.engine.decide import TokenStatus

    card = name == "card"
    OC.reset(P)
    mc.set_ms(t0_ms)
    # one directory for both runs, emptied first: the paths in the answers
    # are the same
    run_root = os.path.join(OPERATOR_ROOT, "run")
    shutil.rmtree(run_root, ignore_errors=True)
    snap_dir = os.path.join(run_root, "snapshots")
    os.makedirs(snap_dir)
    rec = dict(steps=0, param_checks=0, decide=set(), cms=set(), errors=[])
    instrument(torch, svc, card, rec)
    logged = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda r: logged.append(r.getMessage())
    record_log.addHandler(handler)
    metric_dir = P.log.default_metric_dir()
    shutil.rmtree(metric_dir, ignore_errors=True)
    dash = OC.FakeDashboard().start()
    cfg = P.config.SentinelConfig
    cfg.set("csp.sentinel.dashboard.server", f"127.0.0.1:{dash.port}")
    cfg.set("csp.sentinel.heartbeat.interval.ms", "200")
    cfg.set("csp.sentinel.heartbeat.client.ip", "127.0.0.1")
    cfg.set("csp.sentinel.cluster.server.native", "true")
    heirs = []

    def door(cls, host, port):
        # push=False: a client's lockstep sees no push frame (ROADMAP §C)
        return cls(svc, host=host, port=port, metrics_port=0,
                   idle_ttl_s=None, push=False)

    def heir_door(cls, host, port):
        if not heirs:
            heirs.append(operator_service(dev, twin=not card))
            instrument(torch, heirs[0], card, rec)
        return cls(heirs[0], host=host, port=port, metrics_port=0,
                   idle_ttl_s=None, push=False)

    responses, times = [], {}
    rt = P.init.init_default(command_port=0, with_metric_log=False,
                             server_factory=door)
    cc = rt.command_center.port

    def cmd(path, body=None):
        status, text = OC.http(cc, path, body)
        responses.append((path.split("&dir=")[0], status,
                          OC.normalize(text)))
        if status != 200:
            raise AssertionError(f"operator 16a ({name}): {path} answered "
                                 f"{status}: {text[:300]}")
        return text

    clients = []

    def connect(port):
        for c in clients:
            c.close()
        clients[:] = [TokenClient("127.0.0.1", port, timeout_ms=60_000,
                                  namespace="ns0")]
        return clients[0]

    ok = int(TokenStatus.OK)
    verdicts, params, probes, scrapes, door_scrapes = [], [], [], [], []
    sdk_verdicts = []
    wall0 = time.perf_counter()
    try:
        cmd("setClusterMode?mode=1&tokenPort=0")
        server = P.H._EMBEDDED_SERVER["server"]
        if not isinstance(server, NativeTokenServer) or not (
                server.metrics_port and server.service is svc):
            raise AssertionError(f"operator 16a: setClusterMode gave "
                                 f"{server!r}")
        t = time.perf_counter()
        operator_rules(svc)
        times["rule_load_s"] = time.perf_counter() - t
        for path in ("getClusterMode", "cluster/server/info",
                     "cluster/server/fetchConfig",
                     "cluster/server/paramRules?namespace=default"):
            cmd(path)
        SDK.load_rules(P.L, lay)
        timer = P.log.MetricTimer(P.log.MetricWriter())
        client = connect(server.port)
        per = len(entries) // len(steps)
        plan_acts = OC.schedule(len(steps))
        probe = None
        second = mc.now_ms() // 1000
        t_traffic = time.perf_counter()
        for k, st in enumerate(steps):
            mc.advance(st["dt"])
            ids = st["ids"]
            if probe is not None:
                head = OC.probe_rows(probe[1])
                ids = np.concatenate([head, ids[:ids.size - head.size]])
            res = client.request_batch_arrays(ids)
            if res is None:
                raise AssertionError(f"operator 16a: pull {k} got no answer")
            status, remaining, wait = res
            verdicts.append((status.tobytes(), remaining.tobytes(),
                             wait.tobytes()))
            if probe is not None:
                probes.append((probe[0], OC.probe_admitted(
                    ids, status, probe[1], ok)))
                probe = None
            fid, hashes = st["param"]
            r = client.request_params_token(fid, 1, hashes)
            params.append((int(r.status), int(r.remaining), int(r.wait_ms)))
            if st["report"]:
                for i in np.flatnonzero(status == ok):
                    client.record_outcome(int(ids[i]), int(st["rt"][i]),
                                          bool(st["exc"][i]))
                client.flush_outcomes()
                client.ping()  # the barrier: the report is applied
            sdk_verdicts += SDK.drive(P.L, sph_mod,
                                      entries[k * per:(k + 1) * per],
                                      mc.now_ms, mc.advance)
            if mc.now_ms() // 1000 != second:
                second = mc.now_ms() // 1000
                timer.writer.write(timer.collect_once())
            for act in plan_acts.get(k, ()):
                probe, client, server = operator_act(
                    OC, P, act, cmd, cc, svc, probe, client, server,
                    connect, scrapes, door_scrapes)
        times["traffic_s"] = time.perf_counter() - t_traffic
        end_ms = mc.now_ms()
        metric_text = cmd(f"metric?startTime={t0_ms}&endTime={end_ms}")
        app = cfg.app_name()
        searched = "\n".join(n.to_line() for n in P.log.MetricSearcher(
            metric_dir, app).find(t0_ms, end_ms))
        if metric_text != searched:
            raise AssertionError("operator 16a: the metric command's lines "
                                 "are not MetricSearcher's")
        timer.writer.close()
        metric_files = []
        for fname in sorted(os.listdir(metric_dir)):
            with open(os.path.join(metric_dir, fname), "rb") as f:
                metric_files.append((fname, f.read()))
        doc = cmd("cluster/server/snapshot?action=fetch")
        cmd(f"cluster/server/snapshot?action=save&dir={snap_dir}")
        cmd("setClusterMode?mode=-1")
        # the promotion: a cold second service restores 16a's save
        t = time.perf_counter()
        heir = P.manager.ClusterStateManager(heir_door).to_server(
            token_port=0, snapshot_dir=snap_dir)
        times["promote_restore_s"] = time.perf_counter() - t
        if heir is not heirs[0] or len(heir.current_rules()) != F:
            raise AssertionError(f"operator 16a: the promoted service "
                                 f"holds {len(heir.current_rules())} rules")
        cmd("cluster/server/info")
        client = connect(P.H._EMBEDDED_SERVER["server"].port)
        heir_verdicts = []
        for st in steps[:OPERATOR_HEIR_PULLS]:
            mc.advance(st["dt"])
            s, rem, w = client.request_batch_arrays(st["ids"])
            heir_verdicts.append((s.tobytes(), rem.tobytes(), w.tobytes()))
        # a mode file flips the node to client, then back to server on a
        # new port (the same service, its state kept)
        mode_path = os.path.join(run_root, "mode.json")
        write_json(mode_path, {"mode": 0})
        src = P.file.FileRefreshableDataSource(mode_path,
                                               converter=json.loads)
        P.assign.register_cluster_mode_property(src.property, heir_door)
        src.refresh()
        if (P.api.get_mode() != P.api.ClusterMode.CLIENT
                or P.H._EMBEDDED_SERVER["server"] is not None):
            raise AssertionError("operator 16a: mode 0 left a server")
        port = free_port()
        write_json(mode_path, {"mode": 1, "tokenPort": port})
        src.refresh()
        server = P.H._EMBEDDED_SERVER["server"]
        if server is None or server.port != port or server.service is not heir:
            raise AssertionError(f"operator 16a: mode 1 gave {server!r}")
        cmd("getClusterMode")
        client = connect(port)
        flip_verdicts = []
        for st in steps[OPERATOR_HEIR_PULLS:
                        OPERATOR_HEIR_PULLS + OPERATOR_FLIP_PULLS]:
            mc.advance(st["dt"])
            s, rem, w = client.request_batch_arrays(st["ids"])
            flip_verdicts.append((s.tobytes(), rem.tobytes(), w.tobytes()))
        failures = P.base.refresh_failure_totals()
        if failures:
            raise AssertionError(f"operator 16a: failed refreshes {failures}")
        if not rt.heartbeat.send_once():
            raise AssertionError("operator 16a: the dashboard refused a "
                                 "heartbeat")
        beats = [bt for bt in dash.beats if bt["port"] == cc]
        if not beats or len(beats) != len(dash.beats):
            raise AssertionError(f"operator 16a: heartbeats {dash.beats[:3]}")
        end_ms = mc.now_ms()
    finally:
        for c in clients:
            c.close()
        P.init.shutdown()
        OC.reset(P)
        dash.stop()
        record_log.removeHandler(handler)
        uninstrument(svc)
        for h in heirs:
            uninstrument(h)
    times["wall_s"] = time.perf_counter() - wall0
    return dict(
        verdicts=verdicts, params=params, entries=sdk_verdicts,
        probes=probes, responses=responses, scrapes=scrapes,
        door_scrapes=door_scrapes, metric_files=metric_files,
        metric_text=metric_text, heir_verdicts=heir_verdicts,
        flip_verdicts=flip_verdicts, end_ms=end_ms, errors=rec["errors"],
        logged=logged, decide=rec["decide"], cms=rec["cms"],
        steps=rec["steps"], param_checks=rec["param_checks"],
        heartbeats=len(beats),
        snapshot_bytes=len(doc), times=times)


def operator_act(OC, P, act, cmd, cc, svc, probe, client, server, connect,
                 scrapes, door_scrapes):
    """One scheduled 16a action; returns the (probe, client, server) it
    leaves for the next pull."""
    if act[0] == "push":  # every count of one namespace changed
        ns = f"ns{act[1]}"
        rules = json.loads(cmd(f"cluster/server/flowRules?namespace={ns}"))
        body, chosen = OC.pushed(rules)
        cmd(f"cluster/server/modifyFlowRules?namespace={ns}",
            json.dumps(body))
        probe = (ns, chosen)
    elif act[0] == "param":
        rules = json.loads(cmd("cluster/server/paramRules?namespace=default"))
        cmd("cluster/server/modifyParamRules?namespace=default",
            json.dumps([dict(r, count=r["count"] + 1) for r in rules]))
    elif act[0] == "flow_config":
        cmd("cluster/server/modifyFlowConfig",
            json.dumps({"maxAllowedQps": 5e8}))
        cmd("cluster/server/fetchConfig")
    elif act[0] == "namespace_set":
        cmd("cluster/server/modifyNamespaceSet",
            json.dumps([f"ns{i}" for i in range(NS)]))
        cmd("cluster/server/info")
    elif act[0] == "move":
        port = free_port()
        cmd("cluster/server/modifyTransportConfig",
            json.dumps({"port": port}))
        server = P.H._EMBEDDED_SERVER["server"]
        if server.port != port or server.service is not svc:
            raise AssertionError(f"operator 16a: the move gave "
                                 f"{server.port} / {server.service}")
        client = connect(port)
    elif act[0] == "scrape":
        status_a, text_a = OC.http(cc, "metric/prometheus")
        status_b, text_b = OC.http(server.metrics_port, "metrics")
        sa, sb = OC.series(text_a), OC.series(text_b)
        if status_a != 200 or status_b != 200 or sa != sb:
            raise AssertionError(
                f"operator 16a: the two exporters differ: "
                f"{OC.first_difference(sa, sb)}")
        scrapes.append(sa)
        door_scrapes.append(sb)
    elif act[0] == "metrics":
        cmd("cluster/server/metrics")
        cmd("cluster/server/metricList?namespace=ns1")
    return probe, client, server


def operator_timed(torch, dev, OC, P) -> dict:
    """16b (see ``phase_operator``): the card alone on the system clock."""
    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.engine.decide import TokenStatus

    OC.reset(P)
    cfg = P.config.SentinelConfig
    cfg.set("csp.sentinel.cluster.server.native", "true")
    cfg.set("csp.sentinel.dashboard.server", "")
    built = []

    def fresh(cls, host, port):
        # what a promotion costs: the service, its rules, the warm-up
        svc = operator_service(dev)
        operator_rules(svc)
        built.append(svc)
        return cls(svc, host=host, port=port, metrics_port=0,
                   idle_ttl_s=None)

    rng = np.random.default_rng(OPERATOR_SEED + 2)
    pulls = OC.plan(rng, F, [0], 64, OPERATOR_ROWS,
                    lambda f, v: v)  # ids only
    rt = P.init.init_default(command_port=0, with_metric_log=False,
                             server_factory=fresh)
    cc = rt.command_center.port
    out = {}
    clients = []

    def pull(client, ids):
        t = time.perf_counter()
        res = client.request_batch_arrays(ids)
        if res is None:
            raise AssertionError("operator 16b: a pull got no answer")
        return res, (time.perf_counter() - t) * 1e3

    def timed_get(port, path):
        t = time.perf_counter()
        status, text = OC.http(port, path)
        if status != 200:
            raise AssertionError(f"operator 16b: {path} answered {status}")
        return (time.perf_counter() - t) * 1e3, len(text.encode())

    try:
        t = time.perf_counter()
        status, text = OC.http(cc, "setClusterMode?mode=1&tokenPort=0")
        if status != 200 or text != "success":
            raise AssertionError(f"operator 16b: setClusterMode: {text}")
        server = P.H._EMBEDDED_SERVER["server"]
        clients.append(TokenClient("127.0.0.1", server.port,
                                   timeout_ms=60_000, namespace="ns0"))
        pull(clients[-1], pulls[0]["ids"])
        out["set_cluster_mode_to_first_verdict_ms"] = (
            time.perf_counter() - t) * 1e3
        for k in range(1, 8):  # warm the door's lanes
            pull(clients[-1], pulls[k]["ids"])
        for label, port, path in (
                ("metric_prometheus", cc, "metric/prometheus"),
                ("metrics_port", server.metrics_port, "metrics")):
            ms, size = zip(*(timed_get(port, path)
                             for _ in range(OPERATOR_SCRAPES)))
            out[f"{label}_ms"] = quantiles(ms)
            out[f"{label}_bytes"] = max(size)
        out["loop"] = operator_loops(OC, server, cc)
        pushes = []
        for j in range(OPERATOR_PUSHES):
            ns = f"ns{20 + j}"
            _, text = OC.http(cc, f"cluster/server/flowRules?namespace={ns}")
            body, chosen = OC.pushed(json.loads(text))
            t = time.perf_counter()
            status, text = OC.http(
                cc, f"cluster/server/modifyFlowRules?namespace={ns}",
                json.dumps(body))
            success = (time.perf_counter() - t) * 1e3
            ids = OC.probe_rows(chosen)
            (st, _, _), _ = pull(clients[-1], ids)
            first = (time.perf_counter() - t) * 1e3
            admitted = OC.probe_admitted(ids, st, chosen,
                                         int(TokenStatus.OK))
            if text != "success" or any(
                    n > OC.pushed_count(f) for f, n in admitted.items()):
                raise AssertionError(f"operator 16b: push of {ns}: {text}, "
                                     f"then admitted {admitted}")
            pushes.append((success, first))
        out["modify_flow_rules_rules"] = len(body)
        out["modify_flow_rules_success_ms"] = quantiles(
            [p[0] for p in pushes])
        out["modify_flow_rules_first_verdict_ms"] = quantiles(
            [p[1] for p in pushes])
        port = free_port()
        t = time.perf_counter()
        status, text = OC.http(cc, "cluster/server/modifyTransportConfig",
                               json.dumps({"port": port}))
        clients.append(TokenClient("127.0.0.1", port, timeout_ms=60_000,
                                   namespace="ns0"))
        pull(clients[-1], pulls[8]["ids"])
        out["modify_transport_to_first_verdict_ms"] = (
            time.perf_counter() - t) * 1e3
        if text != "success":
            raise AssertionError(f"operator 16b: the move answered {text}")
        for label, path in (("cluster_server_metrics",
                             "cluster/server/metrics"),
                            ("snapshot_fetch",
                             "cluster/server/snapshot?action=fetch")):
            ms, size = zip(*(timed_get(cc, path)
                             for _ in range(OPERATOR_REPS)))
            out[f"{label}_ms"] = quantiles(ms)
            out[f"{label}_bytes"] = max(size)
    finally:
        for c in clients:
            c.close()
        P.init.shutdown()
        OC.reset(P)
    if len(built) != 1:
        raise AssertionError(f"operator 16b: {len(built)} services built")
    lp = out["loop"]
    log(f"operator 16b: setClusterMode to the first verdict "
        f"{out['set_cluster_mode_to_first_verdict_ms']:.0f} ms; scrape p50 / "
        f"p99 ms: metric/prometheus {out['metric_prometheus_ms']['p50']:.2f}"
        f" / {out['metric_prometheus_ms']['p99']:.2f} "
        f"({out['metric_prometheus_bytes']} B), metrics_port "
        f"{out['metrics_port_ms']['p50']:.2f} / "
        f"{out['metrics_port_ms']['p99']:.2f} ({out['metrics_port_bytes']} "
        f"B); pull RTT p50 / p99 ms without scrapes "
        f"{lp['quiet']['rtt_ms']['p50']:.2f} / "
        f"{lp['quiet']['rtt_ms']['p99']:.2f}, with a scrape every "
        f"{OPERATOR_SCRAPE_S} s {lp['scraped']['rtt_ms']['p50']:.2f} / "
        f"{lp['scraped']['rtt_ms']['p99']:.2f}; modifyFlowRules "
        f"({out['modify_flow_rules_rules']} rules) to success p50 "
        f"{out['modify_flow_rules_success_ms']['p50']:.0f} ms, to the first "
        f"verdict {out['modify_flow_rules_first_verdict_ms']['p50']:.0f} ms; "
        f"a port move to the first verdict "
        f"{out['modify_transport_to_first_verdict_ms']:.0f} ms; "
        f"cluster/server/metrics p50 "
        f"{out['cluster_server_metrics_ms']['p50']:.1f} ms "
        f"({out['cluster_server_metrics_bytes']} B); snapshot fetch p50 "
        f"{out['snapshot_fetch_ms']['p50']:.0f} ms "
        f"({out['snapshot_fetch_bytes']} B)")
    return out


def operator_loops(OC, server, cc) -> dict:
    """16b: one client's closed loop of 1,024-row pulls in a spawned child,
    ``OPERATOR_LOOP_S`` without scrapes, then as long with both exporters
    scraped in turn every ``OPERATOR_SCRAPE_S``."""
    ctx = multiprocessing.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    child = ctx.Process(target=operator_client,
                        args=(child_end, server.port, F, OPERATOR_ROWS),
                        daemon=True)
    child.start()
    out = {}
    try:
        if not pipe.poll(120) or pipe.recv() != "ready":
            raise AssertionError("operator 16b: the client did not start")
        for mode in ("quiet", "scraped"):
            scrape_ms, stop = [], threading.Event()

            def scraper():
                targets = ((cc, "metric/prometheus"),
                           (server.metrics_port, "metrics"))
                k = 0
                while not stop.wait(OPERATOR_SCRAPE_S):
                    port, path = targets[k % 2]
                    t = time.perf_counter()
                    status, _ = OC.http(port, path)
                    scrape_ms.append((time.perf_counter() - t) * 1e3)
                    k += 1

            th = threading.Thread(target=scraper, daemon=True)
            if mode == "scraped":
                th.start()
            pipe.send(OPERATOR_LOOP_S)
            if not pipe.poll(OPERATOR_LOOP_S + 120):
                raise AssertionError("operator 16b: the loop did not end")
            res = pipe.recv()
            stop.set()
            if mode == "scraped":
                th.join(30)
            if res["errors"]:
                raise AssertionError(f"operator 16b: {res['errors'][:3]}")
            out[mode] = dict(pulls=len(res["rtt_ms"]),
                             rtt_ms=quantiles(res["rtt_ms"]),
                             scrapes=len(scrape_ms),
                             scrape_ms=quantiles(scrape_ms))
        pipe.send(None)
    finally:
        child.join(30)
        if child.is_alive():
            child.kill()
            child.join(10)
    return out


def operator_client(conn, port: int, flows: int, rows: int) -> None:
    """16b's client, in a child process: a closed loop of ``rows``-row
    bounded-Zipf pulls for the seconds each message names (None ends it);
    sends back each pull's RTT (ms) and any error."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_operator_check as OC

    from sentinel_tpu_torch.cluster.client import TokenClient

    rng = np.random.default_rng(7)
    pulls = [p["ids"] for p in OC.plan(rng, flows, [0], 32, rows,
                                       lambda f, v: v)]
    client = TokenClient("127.0.0.1", port, timeout_ms=60_000,
                         namespace="ns0")
    conn.send("ready")
    while True:
        seconds = conn.recv()
        if seconds is None:
            break
        rtt, errors = [], []
        end = time.perf_counter() + seconds
        k = 0
        while time.perf_counter() < end:
            t = time.perf_counter()
            try:
                if client.request_batch_arrays(pulls[k % len(pulls)]) is None:
                    errors.append("no answer")
            except Exception as exc:  # sent back: the phase fails
                errors.append(repr(exc))
            rtt.append((time.perf_counter() - t) * 1e3)
            k += 1
        conn.send(dict(rtt_ms=rtt, errors=errors))
    client.close()
    conn.close()


MESH_SHARDS = 4  # shards of phase 17's mesh, all on the one card
MESH_ROUNDS = 3  # lockstep rounds of phase 3's pulls, each with reports
MESH_PARAM_REQUESTS = 300
MESH_FUSE_DEPTHS = (4, 2)
MESH_STANDBY_PULLS = 4  # pulls of each size through the restored services
MESH_DOOR_PULLS = 20  # 17c's pulls of each size through each door
MESH_TIMED = 20  # timed 16384-row pulls with and without the mesh
MESH_LAUNCH_REPS = 50  # CUDA-event reps of each captured decide launch
MESH_EMPTY_SHARD = 2  # the shard that owns no row of 17a's last frame


def mesh_slots(svc, ids) -> np.ndarray:
    """The global slot of each flow id of ``ids`` (-1: no rule)."""
    keys, vals = svc._lookup
    pos = np.clip(np.searchsorted(keys, ids), 0, max(len(keys) - 1, 0))
    return np.where(keys[pos] == ids, vals[pos], -1)


def owned_launches(svc, ids, cap: int, shards: int) -> list:
    """The decide launches a mesh of ``shards`` must make for the pull
    ``ids``, as sorted ``(shard, rows)``: per frame of ``cap`` rows (request
    order, as the service cuts them), one for each shard, covering exactly
    the rows it owns (none: the launch only rolls its window)."""
    slots = mesh_slots(svc, ids)
    f_local = svc.config.max_flows // shards
    want = []
    for lo in range(0, len(ids), cap):
        frame = slots[lo:lo + cap]
        for r in range(shards):
            want.append((r, int(((frame >= r * f_local)
                                 & (frame < (r + 1) * f_local)).sum())))
    return sorted(want)


class LaunchLog:
    """Wraps ``decide_cuda.decide_rows`` from ``start`` to ``stop``:
    records each call's
    flow plane and row count, and, while ``capture`` is set, a copy of its
    inputs to replay (the state it updates in place is cloned first)."""

    def __init__(self, K):
        self.K = K
        self.real = K.decide_rows
        self.calls = []
        self.captured = []
        self.capture = False

    def start(self) -> None:
        def recorded(config, flow_counts, occ, fstarts, ostarts, now, cols,
                     uniform):
            self.calls.append((flow_counts.data_ptr(),
                               int(cols["safe_slot"].shape[0])))
            if self.capture:
                self.captured.append((flow_counts.data_ptr(), (
                    config, flow_counts.clone(), occ, fstarts.clone(),
                    ostarts, now, cols, uniform)))
            return self.real(config, flow_counts, occ, fstarts, ostarts,
                             now, cols, uniform)

        self.K.decide_rows = recorded

    def stop(self) -> None:
        self.K.decide_rows = self.real

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def replay_launch(torch, K, args) -> dict:
    """One captured decide launch on copies of its state: the kernel
    against its plain version (bitwise), and the kernel's device ms."""
    def fresh():
        return (args[0], args[1].clone(), args[2], args[3].clone(),
                *args[4:])

    ka, pa = fresh(), fresh()
    got, want = K.decide_rows(*ka), K.decide_rows_plain(*pa)
    bad = [f for f, g, w in zip(K.DecideRows._fields, got, want)
           if not torch.equal(g, w)]
    bad += [name for name, i in (("flow_counts", 1), ("fstarts", 3))
            if not torch.equal(ka[i], pa[i])]
    if bad:
        raise AssertionError(f"mesh: a captured decide launch differs from "
                             f"its plain version in {bad}")
    timed = fresh()
    return dict(rows=int(args[6]["safe_slot"].shape[0]),
                ms=cuda_ms(lambda: K.decide_rows(*timed), MESH_LAUNCH_REPS,
                           torch))


def export_docs_diff(a: dict, b: dict) -> list:
    """The keys in which two ``export_state`` documents differ, a nested
    block (``flow``, ``param``, ...) key by key (``docs_diff`` at each
    level, the wall clock included)."""
    bad = []
    for key in sorted(set(a) | set(b)):
        x, y = a.get(key), b.get(key)
        if isinstance(x, dict) and isinstance(y, dict) and key not in (
                "slot_of", "ns_of", "param_slot_of", "connected"):
            bad += [f"{key}.{k}" for k in docs_diff(x, y, skip=())]
        elif docs_diff({key: x}, {key: y}, skip=()):
            bad.append(key)
    return bad


def mesh_service(dev, mesh=None, rules=None):
    """Phase 3's configuration with the fused ladder ``MESH_FUSE_DEPTHS``,
    on ``mesh`` or on the card alone, with ``rules`` (flow, degrade, param)
    loaded, or empty (a standby)."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.engine import EngineConfig

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1])
    where = dict(device=dev) if mesh is None else dict(mesh=mesh)
    svc = DefaultTokenService(cfg, fuse_depths=MESH_FUSE_DEPTHS, **where)
    if rules is not None:
        flows, degrade, params = rules
        # flows first: a restore reloads them before the breakers, and
        # seats every flow where this service did
        svc.load_rules(flows, ns_max_qps=1e9)
        svc.load_degrade_rules(degrade)
        svc.load_param_rules(params)
    svc.warmup()
    return svc


def phase_mesh(torch, dev):
    """Phase 17: the flow axis sharded over ``make_flow_mesh([cuda:0] *
    4)`` at F = 100,000, against the same service with no mesh, both on the
    decide kernel and on one manual clock. 17a: phase 3's Zipf pulls (64,
    1024, 16384 and 65536 rows, the last four frames through the fused
    ladder (4, 2)), reports of the admitted rows on phase 8's breakers and
    param requests on the 256 param rules: every verdict, report count and
    param answer equal, then every state leaf (gathered across the shards)
    and the param sketch; on the mesh each shard launches the decide kernel
    once a frame for exactly the rows it owns (once a frame with no mesh),
    and each mesh dispatch runs under torch's sync debug mode. The last
    frame, at a new bucket, leaves shard ``MESH_EMPTY_SHARD`` without a
    row: its launch only rolls its window, and is held against its plain
    version. 17b: the mesh primary's snapshot
    restores into a 2-shard standby and a standby with no mesh: the three
    ``export_state`` documents equal in every key, and the next pulls equal.
    17c: ``NativeTokenServer`` over the 4-shard service and over the
    restored standby with no mesh: one ``TokenClient``'s pulls through each
    equal. Then the 16384-row pull p50 with and without the mesh, and
    each shard's decide launch of one such pull beside the launch with no
    mesh: its rows, the kernel against its plain version, its device ms.
    Four shards on one card check correctness; they are no scale-out
    measurement."""
    import torch_kernel_check as DC
    import torch_outcome_check as OCk

    from sentinel_tpu_torch import interop
    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.ops import cms_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K
    from sentinel_tpu_torch.parallel import make_flow_mesh

    t_phase = time.perf_counter()
    # every shard on the one card (the CPU when rehearsed there)
    card0 = (torch.device("cuda", 0) if torch.device(dev).type == "cuda"
             else torch.device(dev))
    mc = clock.ManualClock(1_700_000_000_000)
    prev = clock.set_clock(mc)
    out = {"shards": MESH_SHARDS}
    log_launches = LaunchLog(K)
    try:
        log_launches.start()
        flows, degrade, params = flow_rules()
        # loaded namespace by namespace, the order a restore reloads them
        # in, so that a restored standby seats every flow in the same slot
        flows = sorted(flows, key=lambda r: (int(r.namespace[2:]),
                                             r.flow_id))
        rules = (flows, degrade, params)
        t0 = time.perf_counter()
        svc = mesh_service(dev, make_flow_mesh([card0] * MESH_SHARDS), rules)
        out["mesh_build_s"] = time.perf_counter() - t0
        ref = mesh_service(dev, None, rules)
        zipf = DC.ZipfIds(F, alpha=1.1)
        rng = np.random.default_rng(171)
        param_fids = [r.flow_id for r in params]
        advances = itertools.cycle(ADVANCES_MS)
        frames = launches = owned = empty_frames = 0
        counted = {"mesh": 0, "ref": 0}
        rows_covered = {"mesh": 0, "ref": 0}
        rank_of = {p.data_ptr(): r for r, p in enumerate(
            svc._mesh_state.sharded.flow.counts.parts)}

        def frames_of(n):
            return -(-n // SIZES[-1])

        def step_both(ids, acq=None):
            nonlocal frames, owned, empty_frames
            want_launches = owned_launches(svc, ids, SIZES[-1], MESH_SHARDS)
            before = K.LAUNCHES["decide_rows"]
            log_launches.take()
            torch.cuda.set_sync_debug_mode("error")
            try:
                mat = svc.dispatch_batch_arrays(ids, acq)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = mat()
            counted["mesh"] += K.LAUNCHES["decide_rows"] - before
            seen = sorted((rank_of[ptr], rows)
                          for ptr, rows in log_launches.take())
            if seen != want_launches:
                raise AssertionError(
                    f"mesh: the shards' decide launches covered {seen} "
                    f"(shard, rows) at n={len(ids)}, their own rows are "
                    f"{want_launches}")
            owned += len(want_launches)
            empty_frames += sum(rows == 0 for _, rows in want_launches)
            rows_covered["mesh"] += sum(rows for _, rows in seen)
            before = K.LAUNCHES["decide_rows"]
            want = ref.request_batch_arrays(ids, acq)
            counted["ref"] += K.LAUNCHES["decide_rows"] - before
            rows_covered["ref"] += sum(rows for _, rows in log_launches.take())
            frames += frames_of(len(ids))
            if not OCk.verdicts_equal([got, want]):
                raise AssertionError(
                    f"mesh: verdicts differ from the service with no mesh "
                    f"at n={len(ids)}")
            return got

        # --- 17a: pulls, reports and param requests in lockstep ----------
        per_round = MESH_PARAM_REQUESTS // MESH_ROUNDS
        reported = cms_launches = 0
        for r in range(MESH_ROUNDS):
            for n in PULLS:
                ids = zipf(rng, n)
                acq = None if r % 2 == 0 else rng.integers(1, 3, n).astype(
                    np.int32)
                st = step_both(ids, acq)[0]
                fl, rt, exc = OCk.report_rows(rng, ids[st == OCk.OK],
                                              min(n, 1024))
                got, want = (svc.report_outcomes(fl, rt, exc),
                             ref.report_outcomes(fl, rt, exc))
                if got != want:
                    raise AssertionError(f"mesh: report counts {got} != "
                                         f"{want}")
                reported += got
                mc.advance(next(advances))
            for _ in range(per_round):
                fid = int(rng.choice(param_fids))
                hashes = [int(h) for h in rng.integers(0, 400,
                                                       rng.integers(1, 9))]
                before = cms_cuda.LAUNCHES["cms_decide_update"]
                a = svc.request_params_token(fid, 1, hashes)
                cms_launches += (cms_cuda.LAUNCHES["cms_decide_update"]
                                 - before)
                b = ref.request_params_token(fid, 1, hashes)
                if (a.status, a.remaining) != (b.status, b.remaining):
                    raise AssertionError("mesh: a param answer differs")
                mc.advance(int(rng.integers(0, 3)))
        # --- a frame with no row of one shard, at a new bucket ---------------
        mc.advance(svc.config.bucket_ms)
        f_local = F // MESH_SHARDS
        ids = zipf(rng, 4 * SIZES[1])
        slots = mesh_slots(svc, ids)
        ids = ids[(slots < 0) | (slots // f_local != MESH_EMPTY_SHARD)][
            :SIZES[1]]
        log_launches.capture = True
        try:
            step_both(ids)
        finally:
            log_launches.capture = False
        captured = [args for ptr, args in log_launches.captured
                    if rank_of.get(ptr) == MESH_EMPTY_SHARD]
        log_launches.captured = []
        if len(captured) != 1:
            raise AssertionError(f"mesh: {len(captured)} launches of the "
                                 f"empty shard {MESH_EMPTY_SHARD}")
        args = captured[0]
        sc = K._scalars(args[0], args[5])
        if int(args[3][sc["idx_cur"]]) == sc["cur_start"]:
            raise AssertionError("mesh: the empty shard's frame did not "
                                 "open a new bucket")
        empty = replay_launch(torch, K, args)
        if empty["rows"] != 0:
            raise AssertionError(f"mesh: the empty shard's launch covered "
                                 f"{empty['rows']} rows")
        mc.advance(next(advances))
        log(f"mesh 17a: a frame of {len(ids)} rows with none of shard "
            f"{MESH_EMPTY_SHARD}, at a new bucket: its launch rolled its "
            f"window alone, equal to its plain version, "
            f"{empty['ms']:.4f} ms (CUDA events)")

        if cms_launches != per_round * MESH_ROUNDS:
            raise AssertionError(f"mesh: {cms_launches} count-min launches "
                                 f"for {per_round * MESH_ROUNDS} requests")
        if (counted["mesh"] != owned or owned != MESH_SHARDS * frames
                or counted["ref"] != frames):
            raise AssertionError(
                f"mesh: {counted['mesh']} decide launches on the mesh for "
                f"{owned} shard-frames, and {counted['ref']} without it for "
                f"{frames} frames")
        launches = counted["mesh"]
        a = interop.state_to_numpy(svc._state)
        b = interop.state_to_numpy(ref._state)
        bad = [k for k in a if a[k].dtype != b[k].dtype
               or not np.array_equal(a[k], b[k])]
        pa = interop.param_state_to_numpy(svc._param_state)
        pb = interop.param_state_to_numpy(ref._param_state)
        bad += [f"param.{k}" for k in pa if not np.array_equal(pa[k], pb[k])]
        if bad:
            raise AssertionError(f"mesh: state leaves differ: {bad}")
        if svc.breaker_stats() != ref.breaker_stats():
            raise AssertionError("mesh: breaker stats differ")
        opened = int((a["breaker.state"] != 0).sum())
        out["lockstep"] = dict(frames=frames, decide_launches=launches,
                               shard_frames=owned,
                               empty_shard_frames=empty_frames,
                               empty_shard_launch=empty,
                               rows_covered=rows_covered,
                               twin_launches=counted["ref"],
                               reported=reported,
                               param_requests=per_round * MESH_ROUNDS,
                               cms_launches=cms_launches,
                               breakers_not_closed=opened)
        log(f"mesh 17a: {MESH_ROUNDS} rounds of pulls {PULLS} with reports "
            f"({reported} rows) and {per_round * MESH_ROUNDS} param "
            f"requests on {MESH_SHARDS} shards equal to the service with no "
            f"mesh in every verdict and state leaf; {launches} decide "
            f"launches for {frames} frames, one a shard on its own rows "
            f"({empty_frames} on none), covering {rows_covered['mesh']} rows "
            f"(with no mesh {counted['ref']} launches covering "
            f"{rows_covered['ref']}, padding included), each dispatch "
            f"sync-free")
        del ref

        # --- 17b: the snapshot onto a 2-shard and an unsharded standby ----
        t0 = time.perf_counter()
        snap = svc.export_state()
        out["export_s"] = time.perf_counter() - t0
        standbys = {}
        for name, mesh in (("2 shards", make_flow_mesh([card0] * 2)),
                           ("no mesh", None)):
            s = mesh_service(dev, mesh)
            t0 = time.perf_counter()
            s.import_state(snap)
            out[f"import_s_{name.replace(' ', '_')}"] = (
                time.perf_counter() - t0)
            standbys[name] = s
        docs = {"4 shards": svc.export_state()}
        docs.update({k: s.export_state() for k, s in standbys.items()})
        for name in ("2 shards", "no mesh"):
            diff = export_docs_diff(docs["4 shards"], docs[name])
            if diff:
                raise AssertionError(f"mesh 17b: the {name} standby's "
                                     f"document differs in {diff}")
        restored = [svc, *standbys.values()]
        for _ in range(MESH_STANDBY_PULLS):
            for n in PULLS:
                ids = zipf(rng, n)
                outs = [s.request_batch_arrays(ids) for s in restored]
                if not OCk.verdicts_equal(outs):
                    raise AssertionError(f"mesh 17b: the standbys' verdicts "
                                         f"differ at n={n}")
                mc.advance(next(advances))
        out["snapshot"] = dict(
            keys=len(docs["4 shards"]),
            flow_counts_bytes=int(docs["4 shards"]["flow"]["counts"].nbytes))
        log(f"mesh 17b: a 4-shard snapshot restored onto 2 shards and onto "
            f"no mesh: three documents equal in all "
            f"{len(docs['4 shards'])} keys, then "
            f"{MESH_STANDBY_PULLS * len(PULLS)} pulls equal on all three "
            f"(export {out['export_s']:.2f} s)")
        del snap, docs
        plain = standbys["no mesh"]
        del standbys["2 shards"]

        # --- 17c: the native door over the mesh --------------------------
        doors = [NativeTokenServer(s, port=0, idle_ttl_s=None)
                 for s in (svc, plain)]
        for d in doors:
            d.start()
        clients = []
        try:
            clients = [TokenClient("127.0.0.1", d.port, timeout_ms=60_000)
                       for d in doors]
            served = 0
            for _ in range(MESH_DOOR_PULLS):
                for n in SIZES:
                    ids = zipf(rng, n)
                    outs = [c.request_batch_arrays(ids) for c in clients]
                    if outs[0] is None or not OCk.verdicts_equal(outs):
                        raise AssertionError(
                            f"mesh 17c: the doors' verdicts differ at n={n}")
                    served += n
                    mc.advance(next(advances))
        finally:
            for c in clients:
                c.close()
            for d in doors:
                d.stop()
        out["door"] = dict(pulls=MESH_DOOR_PULLS * len(SIZES),
                           verdicts=served)
        log(f"mesh 17c: {served} verdicts through NativeTokenServer over "
            f"the {MESH_SHARDS}-shard service equal to the door over the "
            f"service with no mesh")

        # --- timing: a 16384-row pull with and without the mesh ----------
        lat = {"mesh": [], "no_mesh": []}
        n = SIZES[-1]
        for _ in range(MESH_TIMED):
            ids = zipf(rng, n)
            for key, s in (("mesh", svc), ("no_mesh", plain)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.request_batch_arrays(ids)
                lat[key].append((time.perf_counter() - t0) * 1e3)
            mc.advance(7)
        out["pull_ms"] = {k: quantiles(v) for k, v in lat.items()}
        log(f"mesh: a {n}-row pull p50 {out['pull_ms']['mesh']['p50']:.3f} "
            f"ms on {MESH_SHARDS} shards of one card, "
            f"{out['pull_ms']['no_mesh']['p50']:.3f} ms with no mesh "
            f"(host clock; four shards on one card check correctness, "
            f"they are no scale-out measurement)")

        # --- each shard's launch of one such pull, beside no mesh ---------
        ids = zipf(rng, n)
        log_launches.capture = True
        try:
            for s in (svc, plain):
                s.request_batch_arrays(ids)
        finally:
            log_launches.capture = False
        captured = log_launches.captured
        log_launches.captured = []
        by_shard = {}
        for ptr, args in captured:
            key = (f"shard_{rank_of[ptr]}" if ptr in rank_of else "no_mesh")
            if key in by_shard:
                raise AssertionError(f"mesh: two decide launches of {key} "
                                     f"in one {n}-row pull")
            by_shard[key] = replay_launch(torch, K, args)
        if "no_mesh" not in by_shard or len(by_shard) < 2:
            raise AssertionError(f"mesh: captured launches {sorted(by_shard)}")
        out["launch_of_pull"] = by_shard
        log(f"mesh: a {n}-row pull's decide launches, each equal to its "
            f"plain version: " + ", ".join(
                f"{k} {v['rows']} rows {v['ms']:.4f} ms"
                for k, v in sorted(by_shard.items()) if k != "no_mesh")
            + f"; with no mesh {by_shard['no_mesh']['rows']} rows "
            f"{by_shard['no_mesh']['ms']:.4f} ms (CUDA events, "
            f"{MESH_LAUNCH_REPS} launches each)")
    finally:
        log_launches.stop()
        clock.set_clock(prev)

    def profiled():
        """Left to the end of the run (see ``phase_service``): the device
        time of a 16384-row pull on the mesh and each shard's share of the
        decide kernel's launches, beside the same pull through the restored
        service with no mesh (the same rules, breakers included)."""
        before = clock.set_clock(mc)
        try:
            got = pull_device_time(torch, svc, mc, zipf, rng, SIZES[-1])
            got["no_mesh"] = pull_device_time(torch, plain, mc, zipf, rng,
                                              SIZES[-1])
        finally:
            clock.set_clock(before)
        got["decide_kernel_ms_a_shard"] = (
            got["decide_kernel_ms_a_pull"] / MESH_SHARDS)
        log(f"mesh: the decide kernel's launches take "
            f"{got['decide_kernel_ms_a_shard']:.4f} ms a shard on average "
            f"a {SIZES[-1]}-row pull")
        return got

    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['phase_s']:.1f} s ({gpu_identity()})")
    return out, profiled


DASH_SEED = 181
DASH_CLUSTER_FLOWS = (0, 1, 2, 3)  # phase 3's flows the SDK's cluster rules
DASH_ROOT = os.path.join(HERE, "sentinel_tpu_torch", "build", "dashboard")


def phase_dashboard(torch, dev):
    """Phase 18: the port's ``DashboardServer`` over phase 16's app surface
    (``tests/torch_dashboard_check.py``), on a manual clock with a token
    service on the card and then with its torch-ops twin: a heartbeat
    registers the app's command center; a rule of every type is created,
    edited and deleted through ``v1/rule``; the gateway API definitions are
    replaced; the SDK's flow rules are published through ``v2/rules`` into
    a ``FileRuleStore`` that the app's ``FileRefreshableDataSource`` reads
    (every third resource in cluster mode); ``cluster/assign`` promotes the
    app through its command center's ``server_factory`` to a token server
    over phase 16's service (phase 3's 100,000 flow rules and 256 param
    rules); seeded entries and pulls from the embedded service run, lowered
    counts are published and the entries run again; the dashboard's
    ``MetricFetcher`` pulls ``/metric``; the metric routes,
    ``cluster/monitor`` and the assignment views are read; the app is
    unassigned. Every answer (less times, pids, host names, the build's
    identity and the server's host latency stats; ports named), entry and
    pull equal the twin's; the dashboard's metric totals equal the app's
    metric-log totals; one decide launch per device step and one count-min
    launch per param check on the card, each dispatch sync-free; no
    exception in the service. Printed: assignment to its first verdict, a
    publish to its first verdict, the monitor's read (bytes, ms) and its
    fetch of ``cluster/server/metrics`` against the ``ApiClient``'s 3 s
    timeout, and the fetcher's pull."""
    import torch_dashboard_check as DSH
    import torch_operator_check as OC

    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.metrics.stat_logger import LOG_DIR_KEY

    t_phase = time.perf_counter()
    shutil.rmtree(DASH_ROOT, ignore_errors=True)
    P = DSH.package("sentinel_tpu_torch")
    cfg = P.config.SentinelConfig
    props = dict(cfg._props)
    t0_ms = int(time.time() * 1000) // 60_000 * 60_000 - 120_000
    t_build = time.perf_counter()
    services = {"card": operator_service(dev),
                "twin": operator_service(dev, twin=True)}
    for svc in services.values():
        operator_rules(svc)
    build_s = time.perf_counter() - t_build
    runs, recs, timed = {}, {}, {}
    try:
        for name, svc in services.items():
            card = name == "card"
            rec = recs[name] = dict(steps=0, decide=set(), param_checks=0,
                                    cms=set(), errors=[])
            instrument(torch, svc, card, rec)

            def factory(cls, host, port, svc=svc):
                return cls(svc, host=host, port=port)

            cfg.set(LOG_DIR_KEY, os.path.join(DASH_ROOT, name, "logs"))
            mc = clock.ManualClock(t0_ms)
            prev = clock.set_clock(mc)
            try:
                runs[name] = DSH.run(
                    P, mc, factory, os.path.join(DASH_ROOT, name),
                    free_port(), list(DASH_CLUSTER_FLOWS), DASH_SEED,
                    timed=(lambda k, v: timed.setdefault(k, v)) if card
                    else None)
            finally:
                clock.set_clock(prev)
                uninstrument(svc)
    finally:
        cfg._props.clear()
        cfg._props.update(props)
    a, b = runs["card"], runs["twin"]
    for key in ("responses", "entries", "pulls", "dashboard_totals",
                "log_totals"):
        x, y = a[key], b[key]
        bad = OC.first_difference(x if isinstance(x, list) else [x],
                                  y if isinstance(y, list) else [y])
        if bad:
            raise AssertionError(f"dashboard 18: {key} differ from the "
                                 f"twin's: {bad}")
    for name, r in runs.items():
        if r["dashboard_totals"] != r["log_totals"]:
            raise AssertionError(
                f"dashboard 18 ({name}): the dashboard's metric totals "
                f"{r['dashboard_totals']} != the metric log's "
                f"{r['log_totals']}")
    if a["dashboard_totals"]["pass"] <= 0 or a["dashboard_totals"][
            "block"] <= 0:
        raise AssertionError(f"dashboard 18: totals {a['dashboard_totals']}")
    for name, r in recs.items():
        want = {1} if name == "card" else {0}
        if r["errors"]:
            raise AssertionError(f"dashboard 18 ({name}): service errors "
                                 f"{r['errors'][:3]}")
        if r["decide"] != want or (r["cms"] and r["cms"] != want):
            raise AssertionError(
                f"dashboard 18 ({name}): decide launches a device step "
                f"{r['decide']}, count-min launches a param check "
                f"{r['cms']}, want {want}")
    answers = {label: text for label, _, text in a["responses"]}
    if '"server": true' not in answers["assign"] or (
            '"unassigned": 1' not in answers["unassign"]):
        raise AssertionError(f"dashboard 18: assign {answers['assign']}, "
                             f"unassign {answers['unassign']}")
    verdicts = [v for rnd in a["entries"] for v in rnd]
    out = dict(
        service_build_s=build_s, answers=len(a["responses"]),
        entries=len(verdicts), entry_blocks=verdicts.count("FlowException"),
        pulls=len(a["pulls"]), device_steps=recs["card"]["steps"],
        decide_launches=recs["card"]["steps"],
        param_checks=recs["card"]["param_checks"],
        cms_launches=recs["card"]["param_checks"],
        sync_free_dispatches=recs["card"]["steps"],
        metric_totals=a["dashboard_totals"],
        assign_to_first_verdict_ms=timed["assign"] * 1e3,
        push_to_first_verdict_ms=timed["push"] * 1e3,
        monitor_ms=timed["monitor"] * 1e3,
        monitor_bytes=int(timed["monitor_bytes"]),
        server_metrics_ms=timed["server_metrics"] * 1e3,
        api_client_timeout_ms=P.dash.api_client.ApiClient().timeout_s * 1e3,
        fetch_ms=timed["fetch"] * 1e3,
        fetch_delay_ms=P.dash.fetcher.FETCH_DELAY_MS,
    )
    log(f"dashboard 18: {out['answers']} answers, {out['entries']} entries "
        f"({out['entry_blocks']} blocked) and {out['pulls']} pulls equal to "
        f"the twin; metric totals {out['metric_totals']} equal to the "
        f"app's metric log; {out['decide_launches']} decide launches for "
        f"{out['device_steps']} device steps, each sync-free")
    log(f"dashboard 18: assign to first verdict "
        f"{out['assign_to_first_verdict_ms']:.1f} ms, a publish to its "
        f"first verdict {out['push_to_first_verdict_ms']:.1f} ms, "
        f"cluster/monitor {out['monitor_bytes']} B in "
        f"{out['monitor_ms']:.1f} ms (its fetch of cluster/server/metrics "
        f"{out['server_metrics_ms']:.1f} ms of the ApiClient's "
        f"{out['api_client_timeout_ms']:.0f} ms timeout), the fetcher's pull "
        f"{out['fetch_ms']:.1f} ms behind its {out['fetch_delay_ms']} ms "
        f"delay (services built in {build_s:.1f} s)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dashboard phase: {out['phase_s']:.1f} s ({gpu_identity()})")
    return out


def window_less_bucket_ms(svc) -> int:
    """A service's window less one bucket, in ms."""
    c = svc.config
    return c.bucket_ms * (c.n_buckets - 1)


def phase_prefix(torch, dev, cfg, table, state):
    """The segment-prefix plan and apply kernels vs their plain versions on
    every key shape, their times, then an ungrouped decide step with
    prefix_impl="pallas" vs "sort" and the device time of its prefix work."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import decide, make_batch
    from sentinel_tpu_torch.ops import prefix_cuda as PK

    rng = np.random.default_rng(5)
    max_err, checked = 0.0, 0
    for n in PREFIX_CHECK_SIZES:
        for shape, keys_np in DC.prefix_key_shapes(rng, n).items():
            keys = torch.as_tensor(keys_np, device=dev)
            contrib = torch.as_tensor(
                rng.integers(0, 4, n).astype(np.float32), device=dev)
            plan = PK.segment_prefix_plan(keys)
            got = PK.segment_prefix_apply(plan, contrib)
            want = PK.segment_prefix_plain(keys, contrib)
            torch.cuda.synchronize()
            if not torch.equal(plan.order,
                               PK.segment_prefix_plan_plain(keys).order):
                raise AssertionError(f"prefix plan != plain at N={n} "
                                     f"({shape})")
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"prefix apply != mask at N={n} "
                                     f"({shape})")
            checked += 1
    log(f"prefix: plan == plain and apply == mask on {checked} key vectors "
        f"(N = {PREFIX_CHECK_SIZES}, shapes {DC.PREFIX_KEY_SHAPES})")

    zipf = DC.ZipfIds(F, alpha=1.1)
    timing = {}
    for n in PREFIX_SIZES:
        keys = torch.as_tensor(zipf(rng, n).astype(np.int32), device=dev)
        contrib = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                                  device=dev)
        plan = PK.segment_prefix_plan(keys)
        plan_ms = cuda_ms(lambda: PK.segment_prefix_plan(keys), 50, torch)
        apply_ms = cuda_ms(lambda: PK.segment_prefix_apply(plan, contrib),
                           50, torch)
        plain_ms = cuda_ms(lambda: PK.segment_prefix_plain(keys, contrib),
                           5, torch)
        nbytes = 12 * n  # a call reads key and contribution, writes out
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       n / PEAK_F32_OPS_PER_S) * 1e3
        timing[n] = dict(ms=apply_ms, plan_ms=plan_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms)
        log(f"prefix N={n}: apply {apply_ms:.4f} ms, plan {plan_ms:.4f} ms, "
            f"plain (mask) {plain_ms:.4f} ms, bound {bound_ms:.6f} ms a call")

    # one ungrouped decide step at F=100k, after two steps that fill state
    n = SIZES[-1]
    c_pal = cfg._replace(batch_size=n, prefix_impl="pallas")
    c_sort = c_pal._replace(prefix_impl="sort")

    def pull():
        slots = zipf(rng, n).astype(np.int32)
        slots[rng.choice(n, size=n // 100, replace=False)] = -1
        return make_batch(c_pal, slots, rng.integers(1, 4, n),
                          rng.random(n) < 0.1)

    st = state
    for now in (60_010, 60_160):
        st, _ = decide(c_sort, st, table, pull(), now)
    batch, now = pull(), 60_420
    PK.LAUNCHES.update(dict.fromkeys(PK.LAUNCHES, 0))
    plans, applies = [], []
    plan_fn, apply_fn = PK.segment_prefix_plan, PK.segment_prefix_apply

    def plan_rec(keys):
        plans.append(keys)
        return plan_fn(keys)

    def apply_rec(plan, contrib):
        applies.append(contrib.to(torch.float32).clone())
        return apply_fn(plan, contrib)

    PK.segment_prefix_plan, PK.segment_prefix_apply = plan_rec, apply_rec
    try:
        st_p, v_p = decide(c_pal, st, table, batch, now)
    finally:
        PK.segment_prefix_plan, PK.segment_prefix_apply = plan_fn, apply_fn
    torch.cuda.synchronize()
    launches = dict(PK.LAUNCHES)
    st_s, v_s = decide(c_sort, st, table, batch, now)
    if launches["segment_prefix_plan"] != 1 or \
            launches["segment_prefix_apply"] < 1:
        raise AssertionError(f"the pallas decide step launched {launches}")
    pairs = [(f"verdict.{f}", a, b) for f, a, b in zip(v_p._fields, v_p, v_s)]
    pairs += [(f"state.{pn}.{f}", a, b)
              for pn, pa, pb in zip(st_p._fields, st_p, st_s)
              for f, a, b in zip(pa._fields, pa, pb)]
    bad = [label for label, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"pallas decide != sort decide: {bad}")

    def step_prefix():
        plan = PK.segment_prefix_plan(plans[0])
        for contrib in applies:
            PK.segment_prefix_apply(plan, contrib)

    step_ms = cuda_ms(step_prefix, 20, torch)
    ok = int((v_p.status == 0).sum())
    log(f"ungrouped decide N={n}: prefix_impl pallas == sort in verdicts "
        f"and every state leaf; prefix launches {launches}; {ok} rows OK; "
        f"the step's prefix work (1 plan, {len(applies)} applies) "
        f"{step_ms:.4f} ms on the device")
    return launches, max_err, timing, step_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # the service's stat logs go beside the build, inside the checkout (the
    # variable reaches the spawned children too)
    stat_dir = os.path.join(HERE, "sentinel_tpu_torch", "build", "stat_logs")
    os.environ["CSP_SENTINEL_LOG_DIR"] = stat_dir
    try:
        import sentinel_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 3
    from sentinel_tpu_torch.engine import EngineConfig, build_rule_table
    from sentinel_tpu_torch.engine.state import make_state, state_nbytes
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_check as DC

    from sentinel_tpu_torch.ops import _build

    from sentinel_tpu_torch.native import build as native_build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # the native door's g++ runs beside the kernels' nvcc processes
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        native = ex.submit(native_build.build)
        logs = _build.build_all()
        native_so = native.result()
    log(f"built {sorted(logs)} and {os.path.basename(native_so)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1])
    rng = np.random.default_rng(1)
    table, index = build_rule_table(cfg, DC.mixed_rules(F, NS, rng),
                                    ns_max_qps=1e9,
                                    connected={"ns1": 4}, device=dev)
    state = make_state(cfg, device=dev)
    log(f"device state: {state_nbytes(state)} B at F={F}, B={B}")

    max_err, checked = phase_parity(torch, dev, cfg, table, state)
    timing = phase_timing(torch, dev, cfg, table, state)
    launches, service, profiled_pulls = phase_service(torch, dev)
    param_parity = phase_param_parity(torch, dev)
    param_timing = phase_param_timing(torch, dev)
    param_service, profiled_params = phase_param_service(torch, dev)
    prefix_launches, prefix_err, prefix_timing, step_ms = phase_prefix(
        torch, dev, cfg, table, state)
    outcome, profiled_reports = phase_outcome(torch, dev)
    door = phase_door(torch, dev)
    ha = phase_ha(torch, dev)
    move = phase_move(torch, dev)
    hier = phase_hier(torch, dev)
    sdk = phase_sdk(torch, dev)
    control = phase_control(torch, dev)
    adapters = phase_adapters(torch, dev)
    operator = phase_operator(torch, dev)
    mesh, profiled_mesh = phase_mesh(torch, dev)
    dashboard = phase_dashboard(torch, dev)
    service[SIZES[-1]].update(profiled_pulls())
    mesh["profiled"] = profiled_mesh()
    for sketch, kernels_a_call in profiled_params().items():
        param_service[sketch]["profiled"] = kernels_a_call
    outcome["profiled"] = profiled_reports()

    ident = gpu_identity()
    main_n = SIZES[-1]
    kernels = [{
        "name": "decide_rows",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/decide.cu",
        "replaces": "sentinel_tpu/ops/decide_pallas.py:88",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[main_n]["ms"],
        "plain_ms": timing[main_n]["plain_ms"],
        "bound_ms": timing[main_n]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parity_steps": checked,
        "by_n": {str(n): timing[n] for n in SIZES},
        "launches_outcome_phase": outcome["launches"],
        "launches_door_phase": door["lockstep"]["decide_launches"],
        "launches_ha_phase": ha["promoted"]["decide_launches"],
        "launches_move_phase": move["move"]["destination_lockstep"][
            "decide_launches"],
        "launches_hier_phase": hier["lockstep"]["decide_launches"],
        "launches_sdk_phase": sdk["lockstep"]["decide_launches"],
        "launches_control_phase": (
            control["rls"]["in_process"]["launches"]
            + control["rls"]["shm"]["launches"]
            + control["routing"]["lockstep"]["decide_launches"]),
        "launches_adapter_phase": adapters["lockstep"]["decide_launches"],
        "launches_operator_phase": operator["lockstep"]["decide_launches"],
        "launches_mesh_phase": mesh["lockstep"]["decide_launches"],
        "launches_dashboard_phase": dashboard["decide_launches"],
    }]
    for sketch, name, line in (("cms", "cms_decide_update", 49),
                               ("salsa", "salsa_decide_update", 37)):
        main_row = param_timing[sketch][PARAM_SIZES[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sentinel_tpu_torch/csrc/{sketch}.cu",
            "replaces": f"sentinel_tpu/ops/{sketch}_pallas.py:{line}",
            "launches": param_service[sketch]["launches"],
            "max_abs_err": param_parity[sketch][0],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "rolling_ms": main_row["rolling_ms"],
            "launches_door_phase": (door["lockstep"]["param_launches"]
                                    if sketch == "cms" else
                                    DOOR_PARAM_REQUESTS),
            "launches_ha_phase": (ha["promoted"]["param_launches"]
                                  if sketch == "cms" else
                                  ha["salsa_fat"]["launches"]),
            "launches_move_phase": (
                move["move"]["destination_lockstep"]["param_launches"]
                if sketch == "cms" else move["salsa"]["launches"]),
            "launches_hier_phase": (hier["lockstep"]["param_launches"]
                                    if sketch == "cms" else 0),
            "launches_sdk_phase": (sdk["lockstep"]["cms_launches"]
                                   if sketch == "cms" else 0),
            "launches_control_phase": (
                control["sketch"][sketch]["launches"]
                + (control["routing"]["lockstep"]["param_launches"]
                   if sketch == "cms" else 0)),
            "launches_adapter_phase": (adapters["lockstep"]["cms_launches"]
                                       if sketch == "cms" else 0),
            "launches_operator_phase": (operator["lockstep"]["cms_launches"]
                                        if sketch == "cms" else 0),
            "launches_mesh_phase": (mesh["lockstep"]["cms_launches"]
                                    if sketch == "cms" else 0),
            "launches_dashboard_phase": (dashboard["cms_launches"]
                                         if sketch == "cms" else 0),
            "parity_steps": param_parity[sketch][1],
            "by_n": {str(n): v for n, v in param_timing[sketch].items()},
        })
    main_row = prefix_timing[PREFIX_SIZES[-1]]
    kernels.append({
        "name": "segment_prefix",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/prefix.cu",
        "replaces": "sentinel_tpu/ops/prefix_pallas.py:32",
        "launches": prefix_launches["segment_prefix_apply"],
        "plan_launches": prefix_launches["segment_prefix_plan"],
        "max_abs_err": prefix_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "plan_ms": main_row["plan_ms"],
        "step_ms": step_ms,
        "by_n": {str(n): v for n, v in prefix_timing.items()},
    })
    log(json.dumps({"service": {str(n): v for n, v in service.items()},
                    "param_service": param_service,
                    "outcome": outcome,
                    "door": door,
                    "ha": ha,
                    "move": move,
                    "hier": hier,
                    "sdk": sdk,
                    "control": control,
                    "adapters": adapters,
                    "operator": operator,
                    "mesh": mesh,
                    "dashboard": dashboard,
                    "gpu": ident}))
    log(ident)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
