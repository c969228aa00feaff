"""SLO engine: declarative targets + multi-window burn rates.

Raw histograms answer "how slow was it?"; nobody pages on a histogram.
This module rolls the existing labelled metrics up into the question
the north star actually asks — *is the service healthy enough for
millions of users?* — using the standard SRE formulation:

- an **SLO target** declares an objective over an event stream ("99% of
  updates complete under 50 ms", "99.9% of messages handle without
  error", "the breaker is closed 99% of the time"),
- the **burn rate** over a window is the observed bad-event fraction
  divided by the error budget (1 - objective): burn 1.0 spends the
  budget exactly at the sustainable rate, burn 14.4 exhausts a 30-day
  budget in ~2 days,
- burn is computed over **two windows** (5m and 1h): the long window
  proves the problem is real, the short window proves it is *still*
  happening — a target is `breaching` only when both exceed the alert
  threshold (the Google SRE multi-window, multi-burn-rate rule).

Collectors are cumulative `(total, bad)` callables sampled on a fixed
cadence into a bounded ring; window deltas never touch the hot path.
The engine exports `hocuspocus_tpu_slo_burn_rate{slo=,window=}` /
`_slo_error_rate` / `_slo_breaching` gauges (adopted into the `Metrics`
registry), serves `GET /debug/slo`, and feeds
`Metrics.health_status()` so `Hocuspocus.get_health()` / `/healthz`
tell the same story the SLO dashboard does.
"""

from __future__ import annotations

import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from .metrics import Counter, Gauge, Histogram

# window name -> seconds; ordered short -> long (the breach rule reads
# "every window over threshold")
DEFAULT_WINDOWS = (("5m", 300.0), ("1h", 3600.0))

# burn rate that pages: ~2% of a 30-day budget spent in one hour
DEFAULT_ALERT_BURN_RATE = 14.4


@dataclass
class SloTarget:
    """One declarative objective over a cumulative (total, bad) stream."""

    name: str
    description: str
    objective: float  # e.g. 0.99 -> 1% error budget
    collect: Callable[[], "tuple[float, float]"]
    kind: str = "error_rate"

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


def histogram_good_total(
    histogram: Histogram, threshold: float, **labels
) -> "tuple[int, int]":
    """(total, good) observations of one labelled series, where good
    means value <= threshold (bucket-resolution: the threshold should
    sit on a bucket bound for exact counting)."""
    series = histogram._series.get(tuple(sorted(labels.items())))
    if series is None:
        return 0, 0
    counts, _sum, total = series
    cut = bisect_right(histogram.buckets, threshold)
    return total, sum(counts[:cut])


def snap_to_bucket(histogram: Histogram, threshold: float) -> float:
    """Nearest bucket bound to `threshold`. Good/bad counting is
    bucket-resolution: an off-bound threshold would silently count the
    whole (prev_bound, threshold] range as bad, so thresholds SNAP and
    the effective value is surfaced in the target description."""
    if not histogram.buckets:
        return threshold
    return min(histogram.buckets, key=lambda bound: abs(bound - threshold))


def latency_slo(
    name: str,
    histogram: Histogram,
    threshold_s: float,
    objective: float = 0.99,
    stage: str = "total",
    description: Optional[str] = None,
) -> SloTarget:
    """Quantile-style objective from a labelled histogram: `objective`
    of observations must complete within `threshold_s` (p99 < 50ms ==
    objective 0.99, threshold 0.05). The threshold snaps to the nearest
    bucket bound — counting is exact at bounds and wrong everywhere
    else."""
    effective = snap_to_bucket(histogram, threshold_s)

    def collect() -> "tuple[float, float]":
        total, good = histogram_good_total(histogram, effective, stage=stage)
        return total, total - good

    suffix = (
        ""
        if effective == threshold_s
        else f" (snapped from {threshold_s * 1000:g}ms to a bucket bound)"
    )
    return SloTarget(
        name=name,
        description=description
        or f"{objective:.0%} of '{stage}' observations <= {effective * 1000:g}ms{suffix}",
        objective=objective,
        collect=collect,
        kind="latency",
    )


def counter_ratio_slo(
    name: str,
    total_counter: Counter,
    bad_counter: Counter,
    objective: float = 0.999,
    description: Optional[str] = None,
) -> SloTarget:
    """Error-rate objective from two counters (all label sets summed)."""

    def collect() -> "tuple[float, float]":
        total = sum(total_counter._values.values())
        bad = sum(bad_counter._values.values())
        return total, bad

    return SloTarget(
        name=name,
        description=description or f"{objective:.1%} of events without error",
        objective=objective,
        collect=collect,
        kind="error_rate",
    )


class FractionProbe:
    """Adapts an instantaneous 0/1 probe ("is the breaker open right
    now?") to the cumulative (total, bad) collector contract: each
    engine sample counts one observation, so the window fraction is
    time-in-state at sample resolution."""

    def __init__(self, probe: Callable[[], bool]) -> None:
        self.probe = probe
        self.total = 0
        self.bad = 0

    def __call__(self) -> "tuple[float, float]":
        self.total += 1
        try:
            if self.probe():
                self.bad += 1
        except Exception:
            pass
        return self.total, self.bad


def fraction_slo(
    name: str,
    probe: Callable[[], bool],
    objective: float = 0.99,
    description: Optional[str] = None,
) -> SloTarget:
    return SloTarget(
        name=name,
        description=description
        or f"bad-state fraction under {1 - objective:.1%} of sampled time",
        objective=objective,
        collect=FractionProbe(probe),
        kind="fraction",
    )


@dataclass
class _WindowStat:
    burn_rate: Optional[float]
    error_rate: Optional[float]
    total: float
    bad: float
    covered_s: float


class SloEngine:
    """Samples collectors on a cadence, computes windowed burn rates."""

    def __init__(
        self,
        targets: Sequence[SloTarget] = (),
        windows: Sequence["tuple[str, float]"] = DEFAULT_WINDOWS,
        sample_interval_s: float = 15.0,
        alert_burn_rate: float = DEFAULT_ALERT_BURN_RATE,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.targets: "list[SloTarget]" = list(targets)
        self.windows = tuple(windows)
        self.sample_interval_s = sample_interval_s
        self.alert_burn_rate = alert_burn_rate
        self._clock = clock
        longest = max((secs for _, secs in self.windows), default=3600.0)
        # +2: one spare sample past the window tail so the delta anchor
        # exists, one for the in-progress interval
        self._samples: deque = deque(
            maxlen=int(longest / max(sample_interval_s, 1e-3)) + 2
        )
        self._last_sample: Optional[float] = None
        # exported gauges (adopted into the Metrics registry)
        self.burn_gauge = Gauge(
            "hocuspocus_tpu_slo_burn_rate",
            "SLO burn rate by target and window (1.0 = budget spent exactly "
            "at the sustainable rate)",
        )
        self.error_rate_gauge = Gauge(
            "hocuspocus_tpu_slo_error_rate",
            "Observed bad-event fraction by target and window",
        )
        self.breaching_gauge = Gauge(
            "hocuspocus_tpu_slo_breaching",
            "1 when a target's burn rate exceeds the alert threshold on "
            "every window (multi-window rule)",
        )

    def add(self, target: SloTarget) -> SloTarget:
        self.targets.append(target)
        return target

    def metrics(self):
        return (self.burn_gauge, self.error_rate_gauge, self.breaching_gauge)

    # -- sampling ------------------------------------------------------------

    def maybe_sample(self) -> bool:
        """Sample if the cadence elapsed (the scrape/debug endpoints and
        the background ticker both call this; double-driving is safe)."""
        now = self._clock()
        if (
            self._last_sample is not None
            and now - self._last_sample < self.sample_interval_s
        ):
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        snapshot = {}
        for target in self.targets:
            try:
                total, bad = target.collect()
            except Exception:
                continue
            snapshot[target.name] = (float(total), float(bad))
        self._samples.append((now, snapshot))
        self._last_sample = now
        self._update_gauges(now)

    # -- reading -------------------------------------------------------------

    def _window_stat(
        self, target: SloTarget, window_s: float, now: float
    ) -> _WindowStat:
        """Delta between the newest sample and the newest sample at or
        before the window start (standard rate() anchoring: a partial
        window reports over the time actually covered)."""
        if not self._samples:
            return _WindowStat(None, None, 0.0, 0.0, 0.0)
        newest_t, newest = self._samples[-1]
        anchor_t, anchor = self._samples[0]
        for t, snapshot in reversed(self._samples):
            if t <= now - window_s:
                anchor_t, anchor = t, snapshot
                break
        cur = newest.get(target.name)
        old = anchor.get(target.name)
        if cur is None:
            return _WindowStat(None, None, 0.0, 0.0, 0.0)
        if old is None:
            old = (0.0, 0.0)
        total = max(cur[0] - old[0], 0.0)
        bad = max(cur[1] - old[1], 0.0)
        covered = max(newest_t - anchor_t, 0.0)
        if total <= 0:
            return _WindowStat(None, None, total, bad, covered)
        error_rate = bad / total
        return _WindowStat(
            error_rate / target.error_budget, error_rate, total, bad, covered
        )

    def burn_rate(self, name: str, window: str) -> Optional[float]:
        target = next((t for t in self.targets if t.name == name), None)
        window_s = dict(self.windows).get(window)
        if target is None or window_s is None:
            return None
        return self._window_stat(target, window_s, self._clock()).burn_rate

    def breaching(self, target: SloTarget, now: Optional[float] = None) -> bool:
        """Multi-window rule: every window's burn rate over threshold.
        Windows without traffic don't breach, and neither do windows
        without full coverage — during early uptime the 1h window
        would otherwise degenerate to "since start" and a startup
        reconnect blip could drain a freshly restarted instance. Until
        an hour of samples exists, the long window simply can't vote."""
        if now is None:
            now = self._clock()
        slack = max(self.sample_interval_s, 1.0)
        for _name, window_s in self.windows:
            stat = self._window_stat(target, window_s, now)
            if stat.burn_rate is None:
                return False
            if stat.covered_s + slack < window_s:
                return False  # partial window: not enough history to vote
            if stat.burn_rate < self.alert_burn_rate:
                return False
        return bool(self.windows)

    def status(self) -> dict:
        """JSON-able rollup for /debug/slo and get_health()."""
        now = self._clock()
        slos = {}
        any_breaching = False
        for target in self.targets:
            windows = {}
            for name, window_s in self.windows:
                stat = self._window_stat(target, window_s, now)
                windows[name] = {
                    "burn_rate": None
                    if stat.burn_rate is None
                    else round(stat.burn_rate, 4),
                    "error_rate": None
                    if stat.error_rate is None
                    else round(stat.error_rate, 6),
                    "total": stat.total,
                    "bad": stat.bad,
                    "covered_s": round(stat.covered_s, 1),
                }
            is_breaching = self.breaching(target, now)
            any_breaching = any_breaching or is_breaching
            slos[target.name] = {
                "description": target.description,
                "kind": target.kind,
                "objective": target.objective,
                "error_budget": target.error_budget,
                "breaching": is_breaching,
                "windows": windows,
            }
        return {
            "healthy": not any_breaching,
            "alert_burn_rate": self.alert_burn_rate,
            "sample_interval_s": self.sample_interval_s,
            "samples": len(self._samples),
            "slos": slos,
        }

    def _update_gauges(self, now: float) -> None:
        for target in self.targets:
            for name, window_s in self.windows:
                stat = self._window_stat(target, window_s, now)
                self.burn_gauge.set(
                    stat.burn_rate if stat.burn_rate is not None else 0.0,
                    slo=target.name,
                    window=name,
                )
                self.error_rate_gauge.set(
                    stat.error_rate if stat.error_rate is not None else 0.0,
                    slo=target.name,
                    window=name,
                )
            self.breaching_gauge.set(
                1.0 if self.breaching(target, now) else 0.0, slo=target.name
            )
