"""The port's Envoy RLS service (``sentinel_tpu_torch.cluster.envoy_rls``)
against the JAX package's.

The reference's ``tests/test_envoy_rls.py`` (11 tests: the converter's
golden cases, ``shouldRateLimit`` on a manual clock, the hand-rolled
protobuf codec, a real gRPC round trip) and ``tests/test_ha.py::
TestRlsFailureMode`` (5) on the port's copy, then across packages: one
seeded stream of ``ShouldRateLimit`` requests (``tests/torch_rls_check.py``,
the workload of ``chip_smoke.py``'s phase 14a at a small size) through the
JAX ``RlsService`` and the port's, each on its package's ``ManualClock``:
every response's bytes equal. Also: the codec's bytes equal the
reference's, 63-bit flow ids reach the service uncut, and ``co_located_rls``
through a port door's shm ring answers as the in-process service does.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import envoy_rls as JR  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402

import torch_rls_check as RC  # noqa: E402
from sentinel_tpu_torch.cluster import envoy_rls as R  # noqa: E402
from sentinel_tpu_torch.cluster.envoy_rls import (  # noqa: E402
    CODE_OK,
    CODE_OVER_LIMIT,
    EnvoyRlsRule,
    EnvoyRlsRuleManager,
    RlsDescriptor,
    RlsService,
    decode_rate_limit_request,
    decode_rate_limit_response,
    encode_rate_limit_request,
    encode_rate_limit_response,
    generate_flow_id,
    generate_key,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
    TokenResult,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.metrics.ha import (  # noqa: E402
    ha_metrics,
    reset_ha_metrics_for_tests,
)
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests,
    server_metrics,
)
from torch_ha_check import manual_clocks  # noqa: E402

CFG = EngineConfig(max_flows=32, max_namespaces=2, batch_size=32)


@pytest.fixture(autouse=True)
def clean_metrics():
    reset_ha_metrics_for_tests()
    reset_server_metrics_for_tests()
    yield
    reset_ha_metrics_for_tests()
    reset_server_metrics_for_tests()


@pytest.fixture
def manual_clock():
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture
def rls(manual_clock):
    svc = DefaultTokenService(CFG, device="cpu")
    rules = EnvoyRlsRuleManager(svc)
    rules.load_rules([
        EnvoyRlsRule(
            domain="mydomain",
            descriptors=(
                RlsDescriptor(entries=(("generic_key", "cat"),), count=3),
                RlsDescriptor(entries=(("generic_key", "dog"),), count=1),
            ),
        )
    ])
    return RlsService(svc, rules)


class TestConverter:
    def test_key_format(self):
        key = generate_key("d", [("k1", "v1"), ("k2", "v2")])
        assert key == "d|k1|v1|k2|v2"

    def test_flow_id_deterministic_and_positive(self):
        a = generate_flow_id("d|k|v")
        assert a == generate_flow_id("d|k|v")
        assert a > 0
        assert generate_flow_id("d|k|other") != a
        assert generate_flow_id("") == -1


class TestServiceLogic:
    def test_pass_then_over_limit(self, rls):
        d = [[("generic_key", "cat")]]
        for _ in range(3):
            assert rls.should_rate_limit("mydomain", d).overall_code == \
                CODE_OK
        v = rls.should_rate_limit("mydomain", d)
        assert v.overall_code == CODE_OVER_LIMIT
        assert v.statuses[0].code == CODE_OVER_LIMIT
        assert v.statuses[0].limit_per_unit == 3

    def test_unknown_descriptor_passes(self, rls):
        v = rls.should_rate_limit("mydomain", [[("generic_key", "unknown")]])
        assert v.overall_code == CODE_OK
        assert v.statuses[0].limit_per_unit is None

    def test_any_blocked_descriptor_blocks_overall(self, rls):
        d = [[("generic_key", "cat")], [("generic_key", "dog")]]
        assert rls.should_rate_limit("mydomain", d).overall_code == CODE_OK
        v = rls.should_rate_limit("mydomain", d)  # dog (count=1) exhausted
        assert v.overall_code == CODE_OVER_LIMIT
        assert [s.code for s in v.statuses] == [CODE_OK, CODE_OVER_LIMIT]

    def test_hits_addend(self, rls):
        d = [[("generic_key", "cat")]]
        assert rls.should_rate_limit("mydomain", d,
                                     hits_addend=3).overall_code == CODE_OK
        assert rls.should_rate_limit(
            "mydomain", d, hits_addend=1).overall_code == CODE_OVER_LIMIT

    def test_negative_hits_rejected(self, rls):
        with pytest.raises(ValueError):
            rls.should_rate_limit("mydomain", [], hits_addend=-1)


class TestWireCodec:
    def test_request_roundtrip(self):
        data = encode_rate_limit_request(
            "dom", [[("k1", "v1"), ("k2", "v2")], [("x", "y")]],
            hits_addend=5)
        domain, descriptors, hits = decode_rate_limit_request(data)
        assert domain == "dom"
        assert descriptors == [[("k1", "v1"), ("k2", "v2")], [("x", "y")]]
        assert hits == 5

    def test_response_roundtrip(self):
        v = R.RlsVerdict(
            CODE_OVER_LIMIT,
            [
                R.DescriptorStatus(CODE_OK, limit_per_unit=10,
                                   limit_remaining=4),
                R.DescriptorStatus(CODE_OVER_LIMIT, limit_per_unit=1),
            ],
        )
        out = decode_rate_limit_response(encode_rate_limit_response(v))
        assert out.overall_code == CODE_OVER_LIMIT
        assert out.statuses[0].limit_per_unit == 10
        assert out.statuses[0].limit_remaining == 4
        assert out.statuses[1].code == CODE_OVER_LIMIT

    def test_matches_official_protobuf_if_available(self):
        """Cross-check the hand codec against protobuf's generic parser."""
        pytest.importorskip("google.protobuf")
        from google.protobuf.internal import decoder  # noqa: F401

        data = encode_rate_limit_request("d", [[("a", "b")]], 2)
        # field 1 (domain) must be parseable as a length-delimited string
        assert data[0] == 0x0A and data[1] == 1 and data[2:3] == b"d"


class TestGrpcRoundtrip:
    def test_should_rate_limit_over_grpc(self, rls):
        grpc = pytest.importorskip("grpc")
        from sentinel_tpu_torch.cluster.envoy_rls import (
            RLS_METHOD,
            SentinelRlsGrpcServer,
        )

        server = SentinelRlsGrpcServer(rls, port=0)
        server.start()
        try:
            channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
            stub = channel.unary_unary(
                RLS_METHOD,
                request_serializer=bytes,
                response_deserializer=bytes,
            )
            req = encode_rate_limit_request("mydomain",
                                            [[("generic_key", "dog")]])
            v1 = decode_rate_limit_response(stub(req, timeout=10))
            v2 = decode_rate_limit_response(stub(req, timeout=10))
            assert v1.overall_code == CODE_OK
            assert v2.overall_code == CODE_OVER_LIMIT
            channel.close()
        finally:
            server.stop(0)


class TestRlsFailureMode:
    class _BoomService:
        def request_batch(self, requests):
            raise RuntimeError("device fault")

    class _ShortService:
        def request_batch(self, requests):
            return []  # length mismatch

    class _FailService:
        def request_batch(self, requests):
            return [TokenResult(TokenStatus.FAIL) for _ in requests]

    class _Rules:
        def lookup(self, fid):
            return ("d", RlsDescriptor((("k", "v"),), 10.0))

    def test_error_mid_batch_fails_open_by_default(self):
        rls = RlsService(self._BoomService(), self._Rules())
        verdict = rls.should_rate_limit("d", [[("k", "v")], [("k", "w")]])
        assert verdict.overall_code == CODE_OK
        assert [st.code for st in verdict.statuses] == [CODE_OK, CODE_OK]
        assert ha_metrics().fallback_totals()["rls_allow"] == 2

    def test_error_mid_batch_deny_mode(self):
        rls = RlsService(self._BoomService(), self._Rules(),
                         failure_mode="deny")
        verdict = rls.should_rate_limit("d", [[("k", "v")]])
        assert verdict.overall_code == CODE_OVER_LIMIT
        assert ha_metrics().fallback_totals()["rls_deny"] == 1

    def test_result_length_mismatch_uses_failure_mode(self):
        rls = RlsService(self._ShortService(), self._Rules())
        verdict = rls.should_rate_limit("d", [[("k", "v")]])
        assert verdict.overall_code == CODE_OK

    def test_per_descriptor_fail_status_uses_failure_mode(self):
        allow = RlsService(self._FailService(), self._Rules())
        assert allow.should_rate_limit("d", [[("k", "v")]]).overall_code \
            == CODE_OK
        deny = RlsService(self._FailService(), self._Rules(),
                          failure_mode="deny")
        assert deny.should_rate_limit("d", [[("k", "v")]]).overall_code \
            == CODE_OVER_LIMIT

    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError):
            RlsService(self._BoomService(), self._Rules(),
                       failure_mode="maybe")


# -- across packages ----------------------------------------------------------
N_DESC, DOMAINS = 240, 4
XCFG = dict(max_flows=256, max_namespaces=2, batch_size=64)


def _pair(spec):
    """A JAX and a port RLS service over one rule spec."""
    jsvc = JService(JConfig(**XCFG))
    tsvc = DefaultTokenService(EngineConfig(**XCFG), device="cpu")
    jrules = JR.EnvoyRlsRuleManager(jsvc)
    trules = EnvoyRlsRuleManager(tsvc)
    jrules.load_rules(RC.build_rules(JR, spec))
    trules.load_rules(RC.build_rules(R, spec))
    return (JR.RlsService(jsvc, jrules), RlsService(tsvc, trules),
            jsvc, tsvc)


@pytest.mark.parametrize("seed", (0, 1))
def test_seeded_stream_bytes_equal_the_reference(seed):
    spec = RC.rule_spec(N_DESC, DOMAINS, base=2)
    requests = RC.stream(spec, 300, np.random.default_rng(seed))
    with manual_clocks() as (jc, tc):
        j_rls, t_rls, jsvc, tsvc = _pair(spec)
        # all of them in one namespace, under its guard, on both sides
        assert set(tsvc._rules_by_ns) == {"default"}
        assert tsvc._ns_max_qps == jsvc._ns_max_qps == 30_000.0
        got, want = [], []
        for i, (domain, descs, hits) in enumerate(requests):
            want.append(RC.answer(JR, j_rls, domain, descs, hits))
            got.append(RC.answer(R, t_rls, domain, descs, hits))
            assert got[-1] == want[-1], (i, domain, descs, hits)
            step = (0, 1, 2, 1)[i % 4] * 20
            jc.advance(step)
            tc.advance(step)
    s = RC.summary(R, got)
    # the stream reaches every branch: passes, limits, unknown descriptors
    assert s["overall"].get(CODE_OVER_LIMIT, 0) > 0
    assert s["overall"].get(CODE_OK, 0) > 0
    assert 0 < s["with_limit"] < sum(s["descriptors"].values())
    assert ha_metrics().fallback_totals().get("rls_allow", 0) == 0
    verdicts = server_metrics().snapshot()
    assert verdicts  # the RLS view was counted


def test_codec_bytes_equal_the_reference():
    rng = np.random.default_rng(5)
    spec = RC.rule_spec(64, 3)
    for domain, descs, hits in RC.stream(spec, 50, rng):
        assert R.encode_rate_limit_request(domain, descs, hits) == \
            JR.encode_rate_limit_request(domain, descs, hits)
        sts = [R.DescriptorStatus(int(rng.integers(0, 3)),
                                  None if rng.random() < 0.3
                                  else int(rng.integers(0, 10**6)),
                                  int(rng.integers(0, 10**6)))
               for _ in descs]
        jsts = [JR.DescriptorStatus(s.code, s.limit_per_unit,
                                    s.limit_remaining) for s in sts]
        code = int(rng.integers(0, 3))
        raw = R.encode_rate_limit_response(R.RlsVerdict(code, sts))
        assert raw == JR.encode_rate_limit_response(JR.RlsVerdict(code,
                                                                  jsts))
        assert R.decode_rate_limit_response(raw) == R.RlsVerdict(code, [
            R.DescriptorStatus(s.code, s.limit_per_unit,
                               s.limit_remaining if s.limit_per_unit
                               is not None else 0) for s in sts])


def test_flow_ids_are_63_bit_and_uncut():
    spec = RC.rule_spec(48, 2)
    ids = [generate_flow_id(generate_key(d, e))
           for d, descs in spec for e, _c in descs]
    assert ids == [JR.generate_flow_id(JR.generate_key(d, e))
                   for d, descs in spec for e, _c in descs]
    assert max(ids) > 2**62 and min(ids) > 0 and max(ids) < 2**63
    svc = DefaultTokenService(EngineConfig(**XCFG), device="cpu")
    rules = EnvoyRlsRuleManager(svc)
    rules.load_rules(RC.build_rules(R, spec))
    assert sorted(svc._index.slot_of) == sorted(ids)
    assert all(svc._index.lookup(f) >= 0 for f in ids)
    # an id that differs from a rule's in its low 32 bits only has no rule
    near = ids[0] ^ 1
    assert svc.request_batch([(near, 1, False)])[0].status == \
        TokenStatus.NO_RULE_EXISTS
    assert svc.request_batch([(ids[0], 1, False)])[0].status == \
        TokenStatus.OK
    svc.close()


def test_co_located_rls_through_the_shm_ring(manual_clock, tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the native door")
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer

    spec = RC.rule_spec(120, 3, base=2)
    requests = RC.stream(spec, 60, np.random.default_rng(7))
    svc = DefaultTokenService(EngineConfig(**XCFG), device="cpu")
    twin = DefaultTokenService(EngineConfig(**XCFG), device="cpu")
    EnvoyRlsRuleManager(svc).load_rules(RC.build_rules(R, spec))
    twin_rules = EnvoyRlsRuleManager(twin)
    twin_rules.load_rules(RC.build_rules(R, spec))
    twin_rls = RlsService(twin, twin_rules)
    shm_dir = str(tmp_path / "shm")
    os.makedirs(shm_dir)
    server = NativeTokenServer(svc, port=0, idle_ttl_s=None, shm_dir=shm_dir)
    server.start()
    try:
        rls, rules, client = R.co_located_rls(shm_dir, timeout_ms=5000)
        try:
            rules.load_rules(RC.build_rules(R, spec))
            for domain, descs, hits in requests:
                a = RC.answer(R, rls, domain, descs, hits)
                b = RC.answer(R, twin_rls, domain, descs, hits)
                assert a == b, (domain, descs, hits)
                manual_clock.advance(30)
        finally:
            client.close()
    finally:
        server.stop()
    assert ha_metrics().fallback_totals().get("rls_allow", 0) == 0
