"""Envoy Rate Limit Service (RLS) v3 server on the port's token path (the
port's copy of ``sentinel_tpu/cluster/envoy_rls.py``).

Analog of ``sentinel-cluster-server-envoy-rls``:

- ``EnvoyRlsRule`` / converter (``rule/EnvoySentinelRuleConverter.java``):
  domain + descriptor (key/value entries) → deterministic flow id; each
  descriptor becomes a GLOBAL-threshold cluster flow rule.
- ``shouldRateLimit`` semantics (``service/v3/SentinelEnvoyRlsServiceImpl.
  java:32-115``): check each descriptor; NO_RULE → OK (pass-through); any
  non-OK descriptor ⇒ overall OVER_LIMIT; per-descriptor status carries the
  configured limit + remaining.
- The reference compiles the envoy protos; here the two RLS messages are
  (de)coded by a hand-rolled protobuf-wire codec (they are tiny), so the
  gRPC layer needs no generated stubs — ``grpc.GenericRpcHandler`` with
  identity serializers speaks the real wire format.

The decision path is the shared ``DefaultTokenService``: a request's
descriptors are one grouped ``request_batch`` step, the same decide kernel
native token clients ride (the reference's ``SimpleClusterFlowChecker`` is
a simplified copy of the flow checker instead). Flow ids are 63-bit hashes;
the service's rule index and batch prep carry them as int64.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.hashing import stable_param_hash
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.engine.rules import ClusterFlowRule, ThresholdMode
from sentinel_tpu_torch.metrics.ha import ha_metrics
from sentinel_tpu_torch.metrics.server import server_metrics

SEPARATOR = "|"  # EnvoySentinelRuleConverter.SEPARATOR

# RateLimitResponse.Code
CODE_UNKNOWN = 0
CODE_OK = 1
CODE_OVER_LIMIT = 2

# RateLimit.Unit
UNIT_SECOND = 1

RLS_METHOD = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"


# -- rules ------------------------------------------------------------------


@dataclass(frozen=True)
class RlsDescriptor:
    """``EnvoyRlsRule.ResourceDescriptor``: ordered key/value entries + count."""

    entries: Tuple[Tuple[str, str], ...]
    count: float


@dataclass(frozen=True)
class EnvoyRlsRule:
    """``EnvoyRlsRule.java``: one domain, many descriptors."""

    domain: str
    descriptors: Tuple[RlsDescriptor, ...]


def generate_key(domain: str, entries: Sequence[Tuple[str, str]]) -> str:
    """``EnvoySentinelRuleConverter.generateKey``: ``domain|k|v|k|v…``."""
    parts = [domain]
    for k, v in entries:
        parts.append(k)
        parts.append(v)
    return SEPARATOR.join(parts)


def generate_flow_id(key: str) -> int:
    """Deterministic positive flow id from the descriptor key.

    The reference uses Java ``String.hashCode + Integer.MAX_VALUE``
    (``EnvoySentinelRuleConverter.java:70-76``); this build uses its
    process-stable blake2b hash (``core.hashing``) masked positive — same
    contract (stable across restarts and across nodes), better dispersion.
    """
    if not key:
        return -1
    return stable_param_hash(key) & 0x7FFF_FFFF_FFFF_FFFF


class EnvoyRlsRuleManager:
    """``EnvoyRlsRuleManager.java``: converts + publishes RLS rules into the
    token service; keeps the flow-id → (rule, descriptor) map for responses."""

    def __init__(self, service: DefaultTokenService, publish: bool = True):
        # publish=False: keep only the flow-id → descriptor map (the RLS
        # response metadata) without pushing flow rules into the service —
        # co-located mode, where the backing service is a remote token
        # server that owns its own rule set
        self._service = service
        self._publish = publish
        self._lock = threading.Lock()
        self._by_id: Dict[int, Tuple[str, RlsDescriptor]] = {}

    def load_rules(self, rules: Sequence[EnvoyRlsRule]) -> None:
        flow_rules: List[ClusterFlowRule] = []
        by_id: Dict[int, Tuple[str, RlsDescriptor]] = {}
        for rule in rules:
            if not rule.domain:
                record_log.warning("RLS rule with empty domain ignored")
                continue
            for desc in rule.descriptors:
                if not desc.entries or desc.count < 0:
                    record_log.warning(
                        "invalid RLS descriptor ignored: %s", desc
                    )
                    continue
                fid = generate_flow_id(generate_key(rule.domain, desc.entries))
                by_id[fid] = (rule.domain, desc)
                flow_rules.append(
                    ClusterFlowRule(
                        flow_id=fid, count=desc.count, mode=ThresholdMode.GLOBAL
                    )
                )
        with self._lock:
            self._by_id = by_id
        if self._publish:
            self._service.load_rules(flow_rules)

    def lookup(self, flow_id: int) -> Optional[Tuple[str, RlsDescriptor]]:
        with self._lock:
            return self._by_id.get(flow_id)


# -- service logic (transport-free, like the reference's unit tests) --------


@dataclass
class DescriptorStatus:
    code: int
    limit_per_unit: Optional[int] = None
    limit_remaining: int = 0


@dataclass
class RlsVerdict:
    overall_code: int
    statuses: List[DescriptorStatus]


class RlsService:
    """``shouldRateLimit`` without the transport, testable directly.

    ``failure_mode`` is Envoy's RLS failure-mode knob mirrored server-side:
    when the token service errors mid-batch (device fault, service swapped
    out under us, transport layer raising), every descriptor of the request
    resolves to the configured verdict — ``allow`` (fail-open, Envoy's
    ``failure_mode_deny=false`` default) or ``deny`` (fail-closed) — instead
    of the exception tearing down the RPC."""

    def __init__(
        self,
        service: DefaultTokenService,
        rules: EnvoyRlsRuleManager,
        failure_mode: Optional[str] = None,
    ):
        self._service = service
        self._rules = rules
        if failure_mode is None:
            failure_mode = SentinelConfig.get(
                "csp.sentinel.rls.failure.mode", "allow"
            )
        failure_mode = str(failure_mode).lower()
        if failure_mode not in ("allow", "deny"):
            raise ValueError(
                f"failure_mode must be allow|deny, got {failure_mode!r}"
            )
        self.failure_mode = failure_mode

    def _failure_verdict(self, n: int) -> RlsVerdict:
        allow = self.failure_mode == "allow"
        ha_metrics().count_fallback(
            "rls_allow" if allow else "rls_deny", max(1, n)
        )
        code = CODE_OK if allow else CODE_OVER_LIMIT
        return RlsVerdict(code, [DescriptorStatus(code) for _ in range(n)])

    def should_rate_limit(
        self,
        domain: str,
        descriptors: Sequence[Sequence[Tuple[str, str]]],
        hits_addend: int = 1,
    ) -> RlsVerdict:
        if hits_addend < 0:
            raise ValueError(
                f"acquireCount should be positive, but actual: {hits_addend}"
            )
        acquire = hits_addend or 1  # 0 means "not present" → default 1
        blocked = False
        statuses: List[DescriptorStatus] = []
        # one device step for all descriptors of the request (the reference
        # loops per descriptor; the batch is strictly cheaper)
        known = [
            (i, generate_flow_id(generate_key(domain, entries)))
            for i, entries in enumerate(descriptors)
        ]
        requests = [(fid, acquire, False) for _, fid in known]
        try:
            results = self._service.request_batch(requests)
            if len(results) != len(requests):
                raise RuntimeError(
                    f"token service returned {len(results)} results "
                    f"for {len(requests)} descriptors"
                )
        except Exception:
            # token service errored mid-batch: resolve the whole request via
            # the configured failure mode instead of raising through the RPC
            record_log.exception(
                "RLS token service error; failing %s", self.failure_mode
            )
            return self._failure_verdict(len(descriptors))
        for (i, fid), result in zip(known, results):
            entry = self._rules.lookup(fid)
            if entry is None or result.status == TokenStatus.NO_RULE_EXISTS:
                # absent rule → pass (SentinelEnvoyRlsServiceImpl.java:56-58)
                statuses.append(DescriptorStatus(CODE_OK))
                continue
            if result.status == TokenStatus.FAIL:
                # this descriptor's verdict degraded (e.g. the client-side
                # TokenClient timed out): per-descriptor failure mode, not
                # an OVER_LIMIT the rule never issued
                allow = self.failure_mode == "allow"
                ha_metrics().count_fallback(
                    "rls_allow" if allow else "rls_deny"
                )
                blocked = blocked or not allow
                statuses.append(
                    DescriptorStatus(CODE_OK if allow else CODE_OVER_LIMIT)
                )
                continue
            ok = result.status == TokenStatus.OK
            blocked = blocked or not ok
            statuses.append(
                DescriptorStatus(
                    CODE_OK if ok else CODE_OVER_LIMIT,
                    limit_per_unit=int(entry[1].count),
                    limit_remaining=max(0, result.remaining),
                )
            )
        # RLS-shaped view of the same verdicts (sentinel_server_verdicts_
        # total{namespace="rls:<domain>"}); the engine path already counted
        # each descriptor under its rule namespace
        ok_n = sum(1 for st in statuses if st.code == CODE_OK)
        server_metrics().count_rls(domain, ok_n, len(statuses) - ok_n)
        return RlsVerdict(CODE_OVER_LIMIT if blocked else CODE_OK, statuses)


def co_located_rls(
    shm_dir: str,
    timeout_ms: int = 20,
    namespace: str = "rls",
    failure_mode: Optional[str] = None,
    spin_us: Optional[int] = None,
):
    """Opt-in co-located mode: an RLS sidecar sharing a host with a
    ``NativeTokenServer(shm_dir=...)`` rides the shared-memory ring door
    instead of TCP loopback — zero syscalls per verdict batch on the
    steady state.

    Returns ``(rls, rules, client)``. The rule manager is created with
    ``publish=False``: the token server owns the flow rules (load them
    there); ``rules.load_rules(...)`` here only builds the descriptor map
    RLS responses need for limit metadata. Close the returned ``client``
    to unlink the segment.
    """
    from sentinel_tpu_torch.cluster.shm_client import ShmTokenClient

    client = ShmTokenClient(
        shm_dir, timeout_ms=timeout_ms, namespace=namespace,
        spin_us=spin_us,
    )
    rules = EnvoyRlsRuleManager(client, publish=False)
    return RlsService(client, rules, failure_mode), rules, client


# -- protobuf wire codec (hand-rolled; messages are tiny and frozen) --------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _field(tag: int, wire: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | wire) + payload


def _ld(tag: int, payload: bytes) -> bytes:  # length-delimited
    return _field(tag, 2, _varint(len(payload)) + payload)


def _iter_fields(data: bytes):
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            value, off = _read_varint(data, off)
        elif wire == 2:
            n, off = _read_varint(data, off)
            value = data[off : off + n]
            off += n
        elif wire == 5:
            value = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif wire == 1:
            value = struct.unpack_from("<Q", data, off)[0]
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield tag, wire, value


def decode_rate_limit_request(
    data: bytes,
) -> Tuple[str, List[List[Tuple[str, str]]], int]:
    """RateLimitRequest: domain=1, descriptors=2 (RateLimitDescriptor:
    entries=1 (Entry: key=1, value=2)), hits_addend=3."""
    domain = ""
    descriptors: List[List[Tuple[str, str]]] = []
    hits = 0
    for tag, _, value in _iter_fields(data):
        if tag == 1:
            domain = value.decode()
        elif tag == 2:
            entries: List[Tuple[str, str]] = []
            for dtag, _, dval in _iter_fields(value):
                if dtag == 1:
                    k = v = ""
                    for etag, _, eval_ in _iter_fields(dval):
                        if etag == 1:
                            k = eval_.decode()
                        elif etag == 2:
                            v = eval_.decode()
                    entries.append((k, v))
            descriptors.append(entries)
        elif tag == 3:
            hits = value
    return domain, descriptors, hits


def encode_rate_limit_request(
    domain: str, descriptors: Sequence[Sequence[Tuple[str, str]]],
    hits_addend: int = 0,
) -> bytes:
    out = _ld(1, domain.encode())
    for entries in descriptors:
        desc = b""
        for k, v in entries:
            desc += _ld(1, _ld(1, k.encode()) + _ld(2, v.encode()))
        out += _ld(2, desc)
    if hits_addend:
        out += _field(3, 0, _varint(hits_addend))
    return out


def encode_rate_limit_response(verdict: RlsVerdict) -> bytes:
    """RateLimitResponse: overall_code=1, statuses=2 (DescriptorStatus:
    code=1, current_limit=2 (RateLimit: requests_per_unit=1, unit=2),
    limit_remaining=3)."""
    out = b""
    if verdict.overall_code:
        out += _field(1, 0, _varint(verdict.overall_code))
    for st in verdict.statuses:
        body = b""
        if st.code:
            body += _field(1, 0, _varint(st.code))
        if st.limit_per_unit is not None:
            limit = _field(1, 0, _varint(st.limit_per_unit))
            limit += _field(2, 0, _varint(UNIT_SECOND))
            body += _ld(2, limit)
            body += _field(3, 0, _varint(st.limit_remaining))
        out += _ld(2, body)
    return out


def decode_rate_limit_response(data: bytes) -> RlsVerdict:
    overall = CODE_UNKNOWN
    statuses: List[DescriptorStatus] = []
    for tag, _, value in _iter_fields(data):
        if tag == 1:
            overall = value
        elif tag == 2:
            st = DescriptorStatus(CODE_UNKNOWN)
            for stag, _, sval in _iter_fields(value):
                if stag == 1:
                    st.code = sval
                elif stag == 2:
                    for ltag, _, lval in _iter_fields(sval):
                        if ltag == 1:
                            st.limit_per_unit = lval
                elif stag == 3:
                    st.limit_remaining = sval
            statuses.append(st)
    return RlsVerdict(overall, statuses)


# -- gRPC front door --------------------------------------------------------


class SentinelRlsGrpcServer:
    """``SentinelRlsGrpcServer.java:28`` analog: standalone gRPC server
    exposing ``ShouldRateLimit`` (gated on ``grpcio``)."""

    def __init__(self, rls: RlsService, host: str = "127.0.0.1", port: int = 10245,
                 max_workers: int = 8):
        import grpc
        from concurrent import futures

        self._grpc = grpc
        self._rls = rls
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method != RLS_METHOD:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    outer._handle,
                    request_deserializer=bytes,
                    response_serializer=bytes,
                )

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers))
        self._server.add_generic_rpc_handlers([Handler()])
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def _handle(self, request: bytes, context) -> bytes:
        try:
            domain, descriptors, hits = decode_rate_limit_request(request)
            verdict = self._rls.should_rate_limit(domain, descriptors, hits)
        except ValueError as e:
            context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return b""  # pragma: no cover - abort raises
        except Exception:
            record_log.exception("RLS request failed")
            context.abort(self._grpc.StatusCode.INTERNAL, "internal error")
            return b""  # pragma: no cover - abort raises
        return encode_rate_limit_response(verdict)

    def start(self) -> None:
        service = self._rls._service
        if isinstance(service, DefaultTokenService):
            service.warmup()  # first launches before accepting traffic
        self._server.start()
        record_log.info("RLS gRPC server on port %d", self.port)

    def stop(self, grace: Optional[float] = None) -> None:
        self._server.stop(grace)
