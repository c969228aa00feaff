"""Device runtime watch: first launches, cache hits, memory footprint.

The flush engine's stage gauges say where a cycle spent time; this
module says what the device runtime underneath was doing:

- **CompileTracker** classifies every launch of a plane's device steps
  (warm grid, canary probes, live flush batches) per (site, shape) key:
  the first launch of a key is a *compile* (it pays the kernel library's
  nvcc or g++ build at first use, the library's load and the C entry's
  shared-memory setup), every later one is a *hit*. Durations land in
  `hocuspocus_tpu_compile_seconds{kind=}` and counts in
  `hocuspocus_tpu_compile_events_total{kind=,site=,shape=}`, the same
  families as the JAX package's XLA compile tracker, so dashboards read
  both. First launches at shapes the warm grid should have covered are
  the storm signal: past `storm_threshold` of them inside
  `storm_window_s`, the tracker emits a structured WARNING log and a
  `compile_storm` flight-recorder event under `__plane__`. The merge
  plane's `WarmWatch` (tpu/merge_plane.py) is this tracker.
- **tensor_nbytes** sizes the plane's device state and staging buffers
  so arena byte gauges can watch device memory next to the occupancy
  gauges (slots say *rows*; these say *bytes*).

Always cheap: one set lookup and dict increments per launch, no locks
(launches already run under the plane's step lock).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, Optional

from .flight_recorder import get_flight_recorder
from .metrics import Counter, Histogram

_storm_logger = logging.getLogger("hocuspocus_tpu_torch.device_watch")

# compile-oriented buckets: warm launches are sub-millisecond, a first
# launch that builds its kernel library with nvcc takes seconds
COMPILE_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def shape_label(shape) -> str:
    """(16, 4) -> "16x4" — the Prometheus label for a batch shape."""
    if isinstance(shape, (tuple, list)):
        return "x".join(str(int(dim)) for dim in shape)
    return str(shape)


# process-shared metric objects: every plane's tracker feeds the same
# exposition family — which matches the runtime, since each kernel
# library is built and loaded once per process
_compile_seconds = Histogram(
    "hocuspocus_tpu_compile_seconds",
    "Device step launch wall time, by kind (compile = first launch at a "
    "(site, shape) key, hit = a later launch)",
    buckets=COMPILE_BUCKETS,
)
_compile_events = Counter(
    "hocuspocus_tpu_compile_events_total",
    "Device step launches by kind/site/shape",
)
_compile_storms = Counter(
    "hocuspocus_tpu_compile_storms_total",
    "Recompile storms detected (fresh compiles past the warm grid)",
)


def compile_metrics():
    """The shared compile metric objects, for registry adoption."""
    return (_compile_seconds, _compile_events, _compile_storms)


class CompileTracker:
    """First-compile vs cache-hit classification per (site, shape)."""

    def __init__(
        self, storm_window_s: float = 60.0, storm_threshold: int = 3
    ) -> None:
        self.storm_window_s = storm_window_s
        self.storm_threshold = storm_threshold
        self.compile_seconds = _compile_seconds
        self.compile_events = _compile_events
        self.storms = _compile_storms
        self._seen: set = set()
        self._warmed = False
        # timestamps of post-warmup fresh compiles inside the storm window
        self._recent: deque[float] = deque()
        self.fresh_compiles = 0
        self.cache_hits = 0
        self.last_compile_s: Optional[float] = None

    def mark_warmed(self) -> None:
        """The warm grid completed: from here on, first launches are
        unexpected (a shape the grid missed) and count toward the storm
        detector."""
        self._warmed = True

    def seen(self, site: str, shape) -> bool:
        return (site, shape_label(shape)) in self._seen

    def mark_covered(self, site: str, shape) -> None:
        """Another plane of this geometry already launched this (site,
        shape) in this process (tpu/scheduler.py shared warm registry).
        Seed the seen set so this plane's live launches classify as the
        hits they are, without charging a compile this tracker never
        paid (and without the storm detector firing on a shape warmed
        elsewhere)."""
        self._seen.add((site, shape_label(shape)))

    def observe(
        self, site: str, shape, seconds: float, warmup: bool = False
    ) -> str:
        """Record one launch; returns "compile" or "hit"."""
        label = shape_label(shape)
        key = (site, label)
        fresh = key not in self._seen
        if fresh:
            self._seen.add(key)
            self.fresh_compiles += 1
            self.last_compile_s = seconds
        else:
            self.cache_hits += 1
        kind = "compile" if fresh else "hit"
        self.compile_events.inc(kind=kind, site=site, shape=label)
        self.compile_seconds.observe(seconds, kind=kind)
        if fresh and not warmup and self._warmed:
            self._note_unexpected_compile(site, label, seconds)
        return kind

    @contextmanager
    def track(self, site: str, shape, warmup: bool = False) -> Iterator[None]:
        started = time.perf_counter()
        try:
            yield
        finally:
            self.observe(site, shape, time.perf_counter() - started, warmup=warmup)

    def _note_unexpected_compile(self, site: str, label: str, seconds: float) -> None:
        now = time.monotonic()
        self._recent.append(now)
        while self._recent and now - self._recent[0] > self.storm_window_s:
            self._recent.popleft()
        if len(self._recent) < self.storm_threshold:
            return
        count = len(self._recent)
        self._recent.clear()  # one storm per burst, then re-arm
        self.storms.inc()
        try:
            _storm_logger.warning(
                "recompile storm: %d fresh compiles within %.0fs after the "
                "warm grid (latest site=%s shape=%s %.3fs) — the flush "
                "shapes have drifted off the warmed (k, b) buckets",
                count,
                self.storm_window_s,
                site,
                label,
                seconds,
            )
        except Exception:
            pass
        get_flight_recorder().record(
            "__plane__",
            "compile_storm",
            compiles=count,
            window_s=self.storm_window_s,
            site=site,
            shape=label,
        )

    def snapshot(self) -> dict:
        return {
            "fresh_compiles": self.fresh_compiles,
            "cache_hits": self.cache_hits,
            "shapes_seen": len(self._seen),
            "storms": sum(self.storms._values.values()),
            "warmed": self._warmed,
            "last_compile_s": self.last_compile_s,
        }


def tensor_nbytes(tree) -> int:
    """Total bytes of every tensor or array in a (possibly nested)
    structure: torch tensors (`numel() * element_size()`, metadata only,
    no transfer), numpy arrays (`.nbytes`), tuples, lists, dicts and
    namedtuple states; anything else counts zero."""
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, (str, bytes)):
            continue
        numel = getattr(node, "numel", None)
        element_size = getattr(node, "element_size", None)
        if callable(numel) and callable(element_size):
            total += int(numel()) * int(element_size())
            continue
        nbytes = getattr(node, "nbytes", None)
        if nbytes is not None:
            try:
                total += int(nbytes)
            except Exception:
                pass
            continue
        if isinstance(node, (tuple, list)):
            stack.extend(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
    return total
