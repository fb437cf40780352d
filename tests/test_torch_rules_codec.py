"""The rule codecs of the port's ``engine/rules.py`` (``encode_rule``,
``decode_rule``, ``encode_degrade_rule``, ``decode_degrade_rule``: the dict
shape of snapshots and MOVE blobs) against the reference's.

For seeded rules of every control behaviour, threshold mode and breaker
strategy, the port's encoding equals the reference's dict, and each package
decodes the other's encoding to an equal rule.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.engine import rules as JR  # noqa: E402

from sentinel_tpu_torch.engine import rules as TR  # noqa: E402


def _flow_fields(rng, k):
    return dict(
        flow_id=int(rng.integers(-2**40, 2**40)),
        count=float(rng.choice([0.0, 0.5, 17.0, 1e9, float(rng.random())])),
        mode=k % 2,
        namespace=f"ns{int(rng.integers(0, 5))}",
        control_behavior=k % 4,
        warm_up_period_sec=int(rng.integers(1, 60)),
        cold_factor=int(rng.integers(2, 6)),
        max_queueing_time_ms=int(rng.integers(0, 5000)),
    )


def _degrade_fields(rng, k):
    return dict(
        flow_id=int(rng.integers(-2**40, 2**40)),
        strategy=k % 3,
        threshold=float(rng.choice([0.5, 20.0, float(rng.random())])),
        slow_rt_ms=int(rng.integers(1, 5000)),
        min_request_amount=int(rng.integers(1, 100)),
        stat_interval_ms=int(rng.integers(100, 60_000)),
        recovery_timeout_ms=int(rng.integers(100, 60_000)),
        namespace=f"ns{int(rng.integers(0, 5))}",
    )


def _pairs(seed):
    rng = np.random.default_rng(seed)
    flows = []
    for k in range(24):  # every behaviour under both modes, three times
        f = _flow_fields(rng, k)
        flows.append((
            JR.ClusterFlowRule(**{**f, "mode": JR.ThresholdMode(f["mode"])}),
            TR.ClusterFlowRule(**{**f, "mode": TR.ThresholdMode(f["mode"])}),
        ))
    degrades = []
    for k in range(12):  # every strategy, four times
        f = _degrade_fields(rng, k)
        degrades.append((
            JR.DegradeRule(**{**f, "strategy": JR.DegradeStrategy(
                f["strategy"])}),
            TR.DegradeRule(**{**f, "strategy": TR.DegradeStrategy(
                f["strategy"])}),
        ))
    return flows, degrades


def _fields(rule):
    return {k: (int(v) if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(rule).items()}


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_encodings_equal_the_reference(seed):
    flows, degrades = _pairs(seed)
    for j, t in flows:
        assert TR.encode_rule(t) == JR.encode_rule(j)
    for j, t in degrades:
        assert TR.encode_degrade_rule(t) == JR.encode_degrade_rule(j)
    # the emit-only-non-default discipline was exercised both ways
    assert any("behavior" in TR.encode_rule(t) for _, t in flows)
    assert any("behavior" not in TR.encode_rule(t) for _, t in flows)
    assert any("slowRtMs" in TR.encode_degrade_rule(t) for _, t in degrades)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_each_package_decodes_the_others_encoding(seed):
    flows, degrades = _pairs(seed)
    plain = dict(warm_up_period_sec=10, cold_factor=3,
                 max_queueing_time_ms=500)
    for j, t in flows:
        back = TR.decode_rule(JR.encode_rule(j))
        fwd = JR.decode_rule(TR.encode_rule(t))
        if int(t.control_behavior) == 0:
            # a plain rule carries no shaping fields: both decoders
            # restore the defaults
            t = dataclasses.replace(t, **plain)
            j = dataclasses.replace(j, **plain)
        assert isinstance(back, TR.ClusterFlowRule)
        assert _fields(back) == _fields(t)
        assert isinstance(fwd, JR.ClusterFlowRule)
        assert _fields(fwd) == _fields(j)
    for j, t in degrades:
        back = TR.decode_degrade_rule(JR.encode_degrade_rule(j))
        fwd = JR.decode_degrade_rule(TR.encode_degrade_rule(t))
        if int(t.strategy) != int(TR.DegradeStrategy.SLOW_REQUEST_RATIO):
            # slow_rt_ms is not carried for the other strategies: both
            # decoders restore the default
            t = dataclasses.replace(t, slow_rt_ms=1000)
            j = dataclasses.replace(j, slow_rt_ms=1000)
        assert isinstance(back, TR.DegradeRule)
        assert _fields(back) == _fields(t)
        assert _fields(fwd) == _fields(j)


def test_decoders_default_the_fields_of_older_payloads():
    old = {"flow_id": 3, "count": 5.0, "mode": 1, "namespace": "a"}
    assert _fields(TR.decode_rule(old)) == _fields(JR.decode_rule(old))
    old = {"flow_id": 3, "strategy": 1, "threshold": 0.5}
    assert (_fields(TR.decode_degrade_rule(old))
            == _fields(JR.decode_degrade_rule(old)))
