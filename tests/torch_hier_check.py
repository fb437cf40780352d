"""Shared kit of the hierarchy tier's checks and the token client's
lockstep, used by ``chip_smoke.py`` (phase 12, the port on the card against
a torch-ops twin) and by ``tests/test_torch_hierarchy.py``,
``tests/test_torch_server.py`` and ``tests/test_torch_client.py`` (the JAX
package against the port on the CPU).

Imports numpy and the standard library only: the caller passes the
services, clients and classes of the package it holds.

- :func:`single_endpoint`: a ``PodShareAgent`` ``client_cls`` built on one
  package's ``TokenClient`` for the first endpoint of the agent's list (the
  agent's default client, the failover client, walks the list; it is not
  ported yet).
- :func:`hold_plan` / :func:`run_hold_plan`: a seeded sequence of
  ``set_share_hold`` calls, pulls on the held flows, ``share_holds`` /
  ``demand_rates`` / ``window_budget`` reads and clock steps that cross
  bucket and window edges (so that hold entries decay and migrate), run on
  several services in lockstep with every return value compared exactly.
- :func:`client_lockstep`: ``torch_door_check.lockstep_plan``'s steps sent
  through token clients (one per door) in lockstep, every answer compared
  exactly; the lease steps use the client's lease round trip, the outcome
  steps ``record_outcome`` + ``flush_outcomes`` behind a PING barrier.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

FAIL = 5  # TokenStatus.FAIL on the wire
# clock steps of the hold plan: inside a bucket, across one or several
# buckets (100 ms each at the default geometry) and past a whole window
HOLD_ADVANCES_MS = (7, 45, 93, 100, 130, 260, 450, 1100)


def single_endpoint(client_cls):
    """A ``PodShareAgent`` client factory over ``client_cls`` (a package's
    ``TokenClient``) on the first endpoint, each RPC bounded by the agent's
    ``timeout_ms``."""

    class SingleEndpoint:
        def __init__(self, endpoints, timeout_ms, deadline_ms):
            host, port = endpoints[0]
            self.client = client_cls(host, port, timeout_ms=timeout_ms)

        def share_op(self, msg_type, flow_id, want=0, share_id=0, used=0):
            return self.client.share_op(msg_type, flow_id, want=want,
                                        share_id=share_id, used=used)

        def demand_report(self, pod_id, entries):
            return self.client.demand_report(pod_id, entries)

        def close(self):
            self.client.close()

    return SingleEndpoint


def hold_plan(rng: np.random.Generator, held: Sequence[int], rounds: int,
              others: Sequence[int] = (), pull_rows: int = 64,
              max_hold: int = 120) -> List[dict]:
    """The seeded hold steps: each round re-tops a random half of the held
    flows (a tenth of them to 0), pulls ``pull_rows`` rows over the held
    flows and ``others``, reads the holds, the demand of every held flow and
    of one id without a rule, one flow's window budget, and steps the
    clock by one of ``HOLD_ADVANCES_MS``."""
    held = [int(f) for f in held]
    pool = np.asarray(held + [int(f) for f in others], np.int64)
    unknown = 10**12
    steps: List[dict] = []
    for _ in range(rounds):
        for fid in rng.permutation(held)[: max(1, len(held) // 2)]:
            tokens = 0 if rng.random() < 0.1 else int(
                rng.integers(1, max_hold))
            steps.append(dict(kind="hold", flow_id=int(fid), tokens=tokens))
        steps.append(dict(kind="pull", ids=rng.choice(pool, pull_rows),
                          counts=rng.integers(1, 3, pull_rows).astype(
                              np.int32)))
        steps.append(dict(kind="holds"))
        steps.append(dict(kind="rates", flow_ids=held + [unknown]))
        steps.append(dict(kind="budget",
                          flow_id=int(held[int(rng.integers(len(held)))])))
        steps.append(dict(kind="advance", ms=int(rng.choice(
            HOLD_ADVANCES_MS))))
    return steps


def _hold_answer(svc, pull: Callable, step: dict):
    kind = step["kind"]
    if kind == "hold":
        return svc.set_share_hold(step["flow_id"], step["tokens"])
    if kind == "pull":
        out = pull(step["ids"], step["counts"])
        assert out is not None, "a pull got no answer"
        return tuple(np.asarray(x) for x in out)
    if kind == "holds":
        return svc.share_holds()
    if kind == "rates":
        return svc.demand_rates(step["flow_ids"])
    if kind == "budget":
        return svc.window_budget(step["flow_id"])
    raise ValueError(kind)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def run_hold_plan(targets: Sequence[tuple], steps: List[dict],
                  advance: Callable[[int], None]) -> Dict[str, object]:
    """Drive ``steps`` on every ``(service, pull)`` of ``targets`` (``pull(ids,
    counts)`` answers a pull: the service's own ``request_batch_arrays`` or a
    client's), in lockstep; every answer must equal the first target's,
    exactly (demand rates are floats: compared with ``==``). Returns the
    pulls made, the rows pulled and statuses, the FAIL answers, and the last
    holds read."""
    out = {"pulls": 0, "rows": 0, "fails": 0, "statuses": {},
           "holds": None, "hold_calls": 0}
    for i, step in enumerate(steps):
        if step["kind"] == "advance":
            advance(step["ms"])
            continue
        answers = [_hold_answer(svc, pull, step) for svc, pull in targets]
        for other in answers[1:]:
            if not _same(answers[0], other):
                raise AssertionError(
                    f"hold step {i} ({step['kind']}): {answers[0]!r} vs "
                    f"{other!r}")
        if step["kind"] == "pull":
            st = answers[0][0]
            out["pulls"] += 1
            out["rows"] += int(st.size)
            out["fails"] += int((st == FAIL).sum())
            for code, n in zip(*np.unique(st, return_counts=True)):
                out["statuses"][int(code)] = (
                    out["statuses"].get(int(code), 0) + int(n))
        elif step["kind"] == "holds":
            out["holds"] = answers[0]
        elif step["kind"] == "hold":
            out["hold_calls"] += 1
    return out


def _client_answer(P, client, step: dict, refs: Dict[int, object]) -> tuple:
    kind = step["kind"]
    if kind == "batch":
        out = client.request_batch_arrays(step["ids"], step["counts"],
                                          step["prios"].astype(bool))
        assert out is not None, "a pull got no answer"
        return tuple(np.asarray(x) for x in out)
    if kind == "flow":
        r = client.request_token(step["flow_id"], step["count"],
                                 step["prio"])
        return int(r.status), int(r.remaining), int(r.wait_ms)
    if kind == "param":
        r = client.request_params_token(step["flow_id"], step["count"],
                                        step["hashes"])
        return int(r.status), int(r.remaining), int(r.wait_ms)
    if kind == "outcome":
        for fid, rt, exc in zip(step["ids"].tolist(), step["rts"].tolist(),
                                step["excs"].tolist()):
            client.record_outcome(fid, rt, exc)
        assert client.flush_outcomes(), "outcome frames not sent"
        # the PING behind the report frames on the same connection is
        # answered after the door has taken the report
        return (client.ping_ex(),)
    if kind == "lease_grant":
        r = client._lease_roundtrip(P.MsgType.LEASE_GRANT, step["flow_id"],
                                    want=step["want"])
    elif kind in ("lease_renew", "lease_return"):
        lease_id, flow_id = refs[step["ref"]]
        mt = (P.MsgType.LEASE_RENEW if kind == "lease_renew"
              else P.MsgType.LEASE_RETURN)
        r = client._lease_roundtrip(mt, flow_id, want=step.get("want", 0),
                                    lease_id=lease_id, used=step["used"])
    elif kind == "conc_acquire":
        r = client.request_concurrent_token(step["flow_id"], step["count"],
                                            step["prio"])
        return int(r.status), int(r.remaining), int(r.wait_ms), \
            int(r.token_id)
    elif kind == "conc_release":
        r = client.release_concurrent_token(refs[step["ref"]])
        return (int(r.status),)
    else:
        raise ValueError(kind)
    assert r is not None, f"a {kind} got no answer"
    return int(r.status), int(r.lease_id), int(r.tokens), int(r.ttl_ms)


def client_lockstep(P, clients: Sequence, steps: List[dict],
                    advance: Callable[[int], None]) -> Dict[str, object]:
    """Send ``torch_door_check.lockstep_plan``'s ``steps`` through each of
    ``clients`` (token clients of doors whose services are to stay equal),
    one step at a time after the clock's advance; every answer must equal
    the first client's. Returns the device steps (pulls and FLOW requests,
    one frame each), PARAM_FLOW requests, rows, verdict statuses and FAIL
    answers."""
    refs: Dict[int, object] = {}
    out = {"device_steps": 0, "param_frames": 0, "rows": 0, "fails": 0,
           "statuses": {}, "kinds": {}}
    for i, step in enumerate(steps):
        advance(int(step["advance_ms"]))
        kind = step["kind"]
        answers = [_client_answer(P, c, step, refs) for c in clients]
        for other in answers[1:]:
            if not _same(answers[0], other):
                raise AssertionError(
                    f"client step {i} ({kind}, xid {step['xid']}): "
                    f"{answers[0]!r} vs {other!r}")
        got = answers[0]
        out["kinds"][kind] = out["kinds"].get(kind, 0) + 1
        if kind == "batch":
            out["device_steps"] += 1
            out["rows"] += len(step["ids"])
            st = got[0]
        elif kind == "flow":
            out["device_steps"] += 1
            out["rows"] += 1
            st = np.asarray([got[0]])
        else:
            st = np.asarray([got[0]]) if isinstance(got[0], int) else None
            if kind == "param":
                out["param_frames"] += 1
        if st is not None:
            out["fails"] += int((st == FAIL).sum())
            if kind in ("batch", "flow"):
                for code, n in zip(*np.unique(st, return_counts=True)):
                    out["statuses"][int(code)] = (
                        out["statuses"].get(int(code), 0) + int(n))
        if kind == "lease_grant":
            refs[i] = (int(got[1]), step["flow_id"])
        elif kind == "lease_renew" and int(got[1]):
            refs[step["ref"]] = (int(got[1]), refs[step["ref"]][1])
        elif kind == "conc_acquire":
            refs[i] = int(got[3])
    return out
