"""The HA snapshot across packages: a JAX primary's ``export_state`` restored
by the port's ``import_state``, and the reverse.

Each direction restores the primary's capture into two standbys, one of
each package, that loaded their rules in another order first (so every row
is remapped by flow_id, namespace and param rule). After the restore and
after each of the next pulls, reports and param requests, the standbys'
verdicts, report counts and param verdicts equal each other's and the
primary's, and the two standbys' state leaves (the outcome and breaker
planes included) and param sketches are bit-identical. A geometry mismatch
raises before anything mutates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    EngineConfig,
)
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from torch_ha_check import (  # noqa: E402
    JAX,
    KW,
    PKW,
    PORT,
    assert_standbys_equal as _assert_standbys_equal,
    manual_clocks,
    same as _same,
    traffic as _traffic,
)
from torch_parity import assert_arrays_equal  # noqa: E402


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


@pytest.mark.parametrize("primary_kind", ["jax", "port"])
def test_snapshot_restores_across_packages(primary_kind, clocks):
    kinds = {"jax": JAX, "port": PORT}
    primary = kinds[primary_kind].make()
    rng = np.random.default_rng(3)
    _traffic([primary], clocks, rng, rounds=12, check=lambda k, o: None)
    stats = primary.breaker_stats()["flows"]
    assert {e["state_code"] for e in stats.values()} >= {0, 1}
    snap = primary.export_state()
    # standbys that loaded their rules in the reverse order
    js, ts = JAX.make(order=-1), PORT.make(order=-1)
    assert js._index.slot_of == ts._index.slot_of
    assert ts._index.slot_of != snap["slot_of"]
    for standby in (js, ts):
        standby.import_state(snap)
    _assert_standbys_equal(js, ts, "after the restore")
    assert ts.breaker_stats() == primary.breaker_stats()
    exported = ts.export_state()
    for key in ("flow", "occupy", "ns", "outcome", "shaping", "breaker",
                "param"):
        for leaf, arr in snap[key].items():
            assert np.asarray(exported[key][leaf]).dtype == np.asarray(
                arr).dtype, (key, leaf)

    def check(kind, outs):
        _same(outs)
        _assert_standbys_equal(js, ts, f"after a {kind}")

    _traffic([primary, js, ts], clocks, rng, rounds=5, check=check)


def test_geometry_mismatch_raises_before_mutating(clocks):
    primary = JAX.make()
    _traffic([primary], clocks, np.random.default_rng(4), rounds=2,
             check=lambda k, o: None)
    snap = primary.export_state()
    ts = DefaultTokenService(EngineConfig(**{**KW, "n_buckets": 5}),
                             param_config=ParamConfig(**PKW), device="cpu")
    ts.load_rules([ClusterFlowRule(flow_id=1, count=5.0)])
    before = interop.state_to_numpy(ts._state)
    rules_before = ts.current_rules()
    with pytest.raises(ValueError, match="geometry mismatch"):
        ts.import_state(snap)
    after = interop.state_to_numpy(ts._state)
    for key in before:
        assert_arrays_equal(before[key], after[key], key)
    assert ts.current_rules() == rules_before
    assert ts.current_degrade_rules() == []
    assert ts._epoch_ms is None
