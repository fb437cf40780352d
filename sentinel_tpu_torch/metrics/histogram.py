"""Fixed-bucket latency histogram (log-spaced, lock-light, Prometheus-ready).

The port's copy of ``sentinel_tpu/metrics/histogram.py``.

The serving-path stage timers need a recorder that is cheap enough to sit on
the hot path (one bisect + three integer adds per observation — the SALSA /
"Give Me Some Slack" lesson that always-on measurement must cost less than
the thing measured), yet rich enough for both a Prometheus ``histogram``
exposition (cumulative ``_bucket{le=...}`` counts) and direct p50/p90/p99
snapshot reads for the stats command and the bench artifact.

Buckets are fixed at construction (default: log-spaced, ``per_decade`` steps
per factor of 10), so recording never allocates and two snapshots diff
cleanly. Quantiles interpolate linearly inside the target bucket; the
overflow (+Inf) bucket clamps to the largest observed value so a stray
outlier reports its real magnitude instead of "somewhere above the range".
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple


def log_buckets(
    lo: float, hi: float, per_decade: int = 5
) -> Tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` up to at least ``hi``,
    ``per_decade`` bounds per factor of 10 (e.g. 0.01..1000ms × 5/decade →
    26 bounds)."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    ratio = 10.0 ** (1.0 / per_decade)
    bounds = []
    b = float(lo)
    # round to 4 significant digits so the rendered `le` labels stay stable
    # and human-readable (0.06309573444801933 → 0.0631)
    while b < hi * (1.0 - 1e-9):
        bounds.append(float(f"{b:.4g}"))
        b *= ratio
    bounds.append(float(f"{hi:.4g}"))
    return tuple(bounds)


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram of a nonnegative quantity.

    ``record`` does the bucket search outside the lock and holds it only for
    three scalar updates — contended recorders serialize for ~100ns, not for
    a bisect. Values above the last bound land in the +Inf overflow bucket.
    """

    __slots__ = (
        "bounds", "_counts", "_count", "_sum", "_max", "_lock",
    )

    def __init__(
        self,
        lo: float = 0.001,
        hi: float = 10_000.0,
        per_decade: int = 5,
        bounds: Optional[Sequence[float]] = None,
    ):
        if bounds is not None:
            bs = tuple(float(b) for b in bounds)
            if not bs or any(
                b2 <= b1 for b1, b2 in zip(bs, bs[1:])
            ) or bs[0] <= 0:
                raise ValueError(f"bounds must be positive ascending: {bs}")
            self.bounds = bs
        else:
            self.bounds = log_buckets(lo, hi, per_decade)
        self._counts = [0] * (len(self.bounds) + 1)  # [-1] is +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record(self, value: float, n: int = 1) -> None:
        v = float(value)
        if v < 0 or n <= 0 or math.isnan(v):
            return
        i = bisect_left(self.bounds, v)  # le-inclusive: v == bound fits in it
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += v * n
            if v > self._max:
                self._max = v

    # -- snapshot reads -----------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _frozen(self) -> Tuple[Tuple[int, ...], int, float, float]:
        with self._lock:
            return tuple(self._counts), self._count, self._sum, self._max

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile (0 < q <= 1) with linear interpolation inside the
        target bucket; None when empty."""
        counts, total, _s, vmax = self._frozen()
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = vmax if i == len(self.bounds) else self.bounds[i]
                hi = min(hi, vmax) if vmax > 0 else hi
                if hi <= lo:
                    return hi
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * frac
        return vmax  # pragma: no cover - rank <= total always hits above

    def snapshot(self) -> Dict[str, Optional[float]]:
        """{count, sum, avg, p50, p90, p99, max} — the stats-command /
        bench-artifact shape."""
        counts, total, s, vmax = self._frozen()
        if total == 0:
            return {
                "count": 0, "sum": 0.0, "avg": None,
                "p50": None, "p90": None, "p99": None, "max": None,
            }
        return {
            "count": total,
            "sum": s,
            "avg": s / total,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": vmax,
        }

    def reset(self) -> None:
        with self._lock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._count = 0
            self._sum = 0.0
            self._max = 0.0

    # -- Prometheus exposition ----------------------------------------------
    def render_prometheus(
        self, name: str, help_text: str, labels: str = "",
        header: bool = True,
    ) -> str:
        """0.0.4 ``histogram`` exposition: cumulative ``_bucket{le=...}``
        series + ``_sum`` / ``_count``. ``labels`` is a pre-rendered
        ``key="value"`` list (no braces) merged with the ``le`` label.
        Pass ``header=False`` from the second labelled instance of a
        family on — the text format allows one HELP/TYPE per family."""
        counts, total, s, _vmax = self._frozen()
        sep = "," if labels else ""
        lines = [
            f"# HELP {name} {help_text}",
            f"# TYPE {name} histogram",
        ] if header else []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(
                f'{name}_bucket{{{labels}{sep}le="{bound:g}"}} {cum}'
            )
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {total}')
        brace = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{brace} {s:g}")
        lines.append(f"{name}_count{brace} {total}")
        return "\n".join(lines)
