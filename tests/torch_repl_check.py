"""Replication checks shared by the CPU tests and ``chip_smoke.py``'s phase
10. Imports neither JAX nor the JAX package; the services compared may be of
either package.

- ``flow_rows_diff`` / ``param_rows_diff``: the state leaves in which a
  standby differs from its primary, rows matched by flow_id, namespace name
  and param flow_id (their slots may differ).
- ``standby_refusals``: every frame type on an unpromoted standby door.
"""

from typing import List

import numpy as np

from sentinel_tpu_torch import interop

STANDBY = 9  # TokenStatus.STANDBY


def _pairs(primary_of, standby_of):
    """``(primary rows, standby rows)`` of the keys both maps hold."""
    pairs = [(primary_of[k], s) for k, s in standby_of.items()
             if k in primary_of]
    return tuple(np.array(x, np.int64).reshape(-1) for x in zip(*pairs))


def flow_rows_diff(primary, standby) -> List[str]:
    """Every per-flow leaf (flow, occupy, outcome, shaping, breaker), the
    namespace rows both seat and every ring's starts of ``standby`` against
    ``primary``'s, bitwise with the dtype; returns the leaves that
    differ."""
    a = interop.state_to_numpy(primary._state)
    b = interop.state_to_numpy(standby._state)
    ps, ss = _pairs(primary._index.slot_of, standby._index.slot_of)
    pn, sn = _pairs(primary._index.ns_of, standby._index.ns_of)
    bad = []
    for key in a:
        if key.endswith(".starts"):
            x, y = a[key], b[key]
        elif key.startswith("ns."):
            x, y = a[key][pn], b[key][sn]
        else:
            x, y = a[key][ps], b[key][ss]
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(key)
    return bad


def param_rows_diff(primary, standby, field: str) -> List[str]:
    """The param rules whose ``field`` row (``counts`` or ``slim``) differs,
    and ``starts`` when the rings differ."""
    a = interop.param_state_to_numpy(primary._param_state)
    b = interop.param_state_to_numpy(standby._param_state)
    bad = [] if np.array_equal(a["starts"], b["starts"]) else ["starts"]
    for fid, (slot, _, _) in primary._param_rules.items():
        sb = standby._param_rules[fid][0]
        x, y = a[field][slot], b[field][sb]
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(f"{field}[{fid}]")
    return bad


def standby_refusals(P, conn, svc, flow_ids, param_flow: int,
                     lease_flow: int) -> None:
    """On an unpromoted standby door, over ``conn`` (a
    ``torch_door_check.RawConn`` of ``P``'s package): a BATCH_FLOW pull of
    ``flow_ids``, FLOW, PARAM_FLOW, CONCURRENT_ACQUIRE, a lease grant and a
    hierarchy share grant are answered STANDBY, PING is answered, and an
    OUTCOME_REPORT is dropped
    (``svc``, the standby's service, counts no report). Raises
    ``AssertionError``."""
    ids = np.asarray(flow_ids, np.int64)
    assert conn.ping(1) >= 1, "PING unanswered"
    conn.send(P.encode_batch_request(2, ids))
    xid, st, _r, _w = P.decode_batch_response(conn.recv())
    assert xid == 2 and st.size == ids.size and (st == STANDBY).all(), (
        "BATCH_FLOW", st[:8])
    for xid, mt, fid, hashes in (
            (3, P.MsgType.FLOW, int(ids[0]), None),
            (4, P.MsgType.PARAM_FLOW, param_flow, [1, 2]),
            (5, P.MsgType.CONCURRENT_ACQUIRE, int(ids[0]), None)):
        conn.send(P.encode_request(P.FlowRequest(xid, fid, 1, False, mt,
                                                 hashes)))
        r = P.decode_response(conn.recv())
        assert (r.xid, r.status) == (xid, STANDBY), (mt, r)
    for xid, mt in ((6, P.MsgType.LEASE_GRANT), (9, P.MsgType.SHARE_GRANT)):
        conn.send(P.encode_lease_request(xid, mt, lease_flow, 4))
        r = P.decode_lease_response(conn.recv())
        assert (r.xid, r.status) == (xid, STANDBY), (mt, r)
    reported = svc.outcome_stats()["reported"]
    n = min(4, ids.size)
    conn.send(P.encode_outcome_report(7, ids[:n], np.full(n, 5, np.int64),
                                      np.zeros(n, np.int64)))
    assert conn.ping(8) >= 1  # barrier: the report was handled
    assert svc.outcome_stats()["reported"] == reported, "OUTCOME_REPORT"


def param_delta_bytes(device, n_values: int = 3000, chunk: int = 60) -> dict:
    """The port's copy of the reference's gate
    (``benchmarks/ha_drill.py::measure_param_delta_bytes``): two services,
    one with the slim twin and one with ``slim_width=0``, absorb the same
    value stream on two param rules and export one delta each through the
    wire codec. Returns ``{"fat": bytes, "slim": bytes, "ratio": float}``;
    the gate is a ratio of at least 4.

    The run holds one ``ManualClock`` reading (restored after), so the
    requests land in one bucket however long the host takes: on the system
    clock a slow host rolled the window mid-stream, and zlib squeezed the
    fat rows' zeroed buckets (4.66 instead of 7.8 with 40 ms a request)."""
    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.ha import replication as R

    cfg = EngineConfig(max_flows=16, max_namespaces=4, batch_size=64)
    rng = np.random.default_rng(0x5A15A)
    vals = rng.integers(-2 ** 63, 2 ** 63 - 1, size=n_values, dtype=np.int64)
    sizes = {}
    prev = clock.set_clock(clock.ManualClock(1_700_000_000_000))
    try:
        for label, slim_width in (("slim", 256), ("fat", 0)):
            svc = DefaultTokenService(
                cfg, param_config=ParamConfig(max_param_rules=32,
                                              slim_width=slim_width),
                device=device)
            svc.load_param_rules([
                ClusterParamFlowRule(flow_id=5, count=1e9),
                ClusterParamFlowRule(flow_id=6, count=1e9)])
            svc.replication_enable()
            for fid in (5, 6):
                for off in range(0, n_values, chunk):
                    svc.request_params_token(
                        fid, 1, [int(h) for h in vals[off:off + chunk]])
            sizes[label] = len(R.encode_delta_blob(svc.export_delta()))
    finally:
        clock.set_clock(prev)
    return {"fat": sizes["fat"], "slim": sizes["slim"],
            "ratio": round(sizes["fat"] / max(sizes["slim"], 1), 2)}
