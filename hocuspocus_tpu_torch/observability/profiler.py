"""Always-on sampling CPU profiler for the host wire path.

A background daemon thread walks ``sys._current_frames()`` at
``--profile-hz`` (default 99 Hz — deliberately co-prime with common
10/100 Hz timer work, the classic anti-lockstep trick) and folds every
thread's stack into a bounded collapsed-stack table (Brendan Gregg's
flamegraph format: ``root;caller;callee count``). The walk touches only
live frame objects already owned by the interpreter — no tracing hooks,
no sys.settrace — so measured overhead stays well under 1% at the
default rate (guarded by tests/observability/test_profiler_costs.py).

Two consumers sit on top:

- ``GET /debug/profile/cpu`` (observability/extension.py) serves the
  folded table as JSON or raw collapsed text for ``flamegraph.pl`` /
  speedscope.
- The Perfetto export (``Tracer.export_chrome_trace``) merges the
  profiler's recent-sample ring as instant events, so flamegraph time
  aligns with the lifecycle spans on one timeline.

**Triggered burst capture**: the overload controller's event-loop-lag
sampler (server/overload.py) feeds every lag reading into
``note_loop_lag``. When lag crosses ``burst_trigger_ms`` the profiler
latches a *lag episode*, grabs one high-rate burst (default 997 Hz for
0.25 s) on a short-lived thread, and attaches the top culprit stack to
a ``__profiler__`` flight-recorder event. The episode re-arms only
after lag decays below half the threshold — one burst per episode, not
one per sampler tick.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from collections import deque
from typing import Optional

from .metrics import Counter, Gauge

DEFAULT_HZ = 99.0
DEFAULT_MAX_STACKS = 4096
DEFAULT_MAX_DEPTH = 64
OVERFLOW_KEY = "__other__"

DEFAULT_BURST_HZ = 997.0
DEFAULT_BURST_S = 0.25
# matches the overload ladder's AMBER loop-lag bound
# (server/overload.py DEFAULT_THRESHOLDS["loop_lag_ms"][1])
DEFAULT_BURST_TRIGGER_MS = 200.0

_DIGITS = re.compile(r"\d+")


def _module_label(filename: str) -> str:
    # "<frozen importlib._bootstrap>" and friends: keep the dotted name,
    # drop the "<frozen >" wrapper whose space would corrupt the
    # collapsed format
    if filename.startswith("<frozen ") and filename.endswith(">"):
        return filename[len("<frozen "):-1]
    base = os.path.basename(filename)
    if base.endswith(".py"):
        base = base[:-3]
    return re.sub(r"\s+", "_", base) or "?"


def _thread_label(name: str) -> str:
    """Stable per-role label: worker pools churn through numbered names
    (``Thread-7``, ``ThreadPoolExecutor-0_3``, ``asyncio_2``); folding
    must aggregate them, not mint one root per short-lived thread.
    CPython 3.10+ appends the target (``Thread-5 (_do_shutdown)``) —
    spaces would corrupt the ``stack count`` collapsed format, so any
    non-identifier run collapses to ``_``."""
    label = _DIGITS.sub("N", name or "Thread")
    return re.sub(r"[^\w.:-]+", "_", label).strip("_") or "Thread"


def _fold(
    frame,
    root: str,
    labels: Optional[dict] = None,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> tuple[str, str]:
    """(folded stack rooted at the thread label, leaf frame label).

    ``labels`` memoizes the ``mod.func`` string per code object — the
    same frames recur sample after sample, and skipping the basename +
    f-string work on every walk is what keeps the 99 Hz steady-state
    sampler under its 1% overhead budget."""
    parts: list[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        code = frame.f_code
        label = labels.get(code) if labels is not None else None
        if label is None:
            label = f"{_module_label(code.co_filename)}.{code.co_name}"
            if labels is not None:
                if len(labels) > 16384:
                    labels.clear()
                labels[code] = label
        parts.append(label)
        frame = frame.f_back
        depth += 1
    leaf = parts[0] if parts else "?"
    parts.append(root)
    parts.reverse()
    return ";".join(parts), leaf


class SamplingProfiler:
    """Process-wide sampling profiler (one instance via get_profiler()).

    Not started by default — the Metrics extension calls
    ``ensure_started()`` at configure time, so bare library use pays
    nothing. ``hz <= 0`` disables the steady-state sampler entirely
    (``--profile-hz=0``); burst capture still works when asked.
    """

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        max_stacks: int = DEFAULT_MAX_STACKS,
        ring_size: int = 512,
    ) -> None:
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.burst_hz = DEFAULT_BURST_HZ
        self.burst_s = DEFAULT_BURST_S
        self.burst_trigger_ms = DEFAULT_BURST_TRIGGER_MS
        self._lock = threading.Lock()
        self._stacks: dict[str, int] = {}
        # per-code-object "mod.func" memo + tid -> normalized root memo:
        # touched only from the sampler threads, rebuilt when the live
        # thread set changes
        self._code_labels: dict = {}
        self._roots: dict[int, str] = {}
        # whole-stack memo: the folded label depends only on the
        # code-object chain (module.func per frame, no line numbers), so
        # an idle thread parked on the same stack costs one frame walk
        # plus one dict hit per tick instead of a 40-way string join
        self._fold_cache: dict = {}
        # parked-thread memo: tid -> ((id(frame), f_lasti, id(f_back)),
        # folded, leaf). A thread blocked in sleep/select keeps the
        # identical top frame between ticks; re-walking its 30-deep
        # stack every 10 ms is where a naive sampler burns its budget
        self._parked: dict[int, tuple] = {}
        # recent samples for the Perfetto merge: (perf_ts, tid, leaf, folded)
        self._ring: deque = deque(maxlen=ring_size)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._samples = 0
        self._dropped = 0
        self._busy_s = 0.0
        self._started_perf: Optional[float] = None
        self._wall_s_prev = 0.0  # accumulated across start/stop cycles
        # burst state
        self._episode_active = False
        self._bursts = 0
        self._burst_thread: Optional[threading.Thread] = None
        self._last_burst: Optional[dict] = None
        # metrics (adopted by the Metrics extension via register())
        self.overhead_gauge = Gauge(
            "hocuspocus_profile_overhead_fraction",
            "Measured sampling-profiler overhead as a fraction of wall time",
            fn=self.overhead_fraction,
        )
        self.samples_gauge = Gauge(
            "hocuspocus_profile_samples_total",
            "Stack samples folded by the CPU profiler since start/reset",
            fn=lambda: float(self._samples),
        )
        self.bursts_counter = Counter(
            "hocuspocus_profile_lag_bursts_total",
            "High-rate burst captures triggered by event-loop-lag episodes",
        )

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def configure(
        self,
        hz: Optional[float] = None,
        burst_trigger_ms: Optional[float] = None,
    ) -> "SamplingProfiler":
        if hz is not None:
            self.hz = float(hz)
        if burst_trigger_ms is not None:
            self.burst_trigger_ms = float(burst_trigger_ms)
        return self

    def ensure_started(self) -> "SamplingProfiler":
        if self.hz > 0 and not self.running:
            self.start()
        return self

    def start(self) -> "SamplingProfiler":
        if self.running or self.hz <= 0:
            return self
        self._stop.clear()
        self._started_perf = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, name="hocuspocus-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=2.0)
        if self._started_perf is not None:
            self._wall_s_prev += time.perf_counter() - self._started_perf
            self._started_perf = None
        self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._ring.clear()
            self._samples = 0
            self._dropped = 0
            self._busy_s = 0.0
            self._wall_s_prev = 0.0
            if self._started_perf is not None:
                self._started_perf = time.perf_counter()
            self._episode_active = False
            self._bursts = 0
            self._last_burst = None

    # -- sampling ------------------------------------------------------------

    def _loop(self) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        next_t = time.perf_counter()
        while not self._stop.is_set():
            next_t += period
            delay = next_t - time.perf_counter()
            if delay > 0:
                if self._stop.wait(delay):
                    break
            else:
                # fell behind (suspend, debugger): re-anchor instead of
                # machine-gunning catch-up samples
                next_t = time.perf_counter()
            # thread_time, not perf_counter: under load the sampler
            # spends most of its wall time queued for the GIL (up to the
            # 5 ms switch interval per sample) — that wait steals nothing
            # from the workers, so the overhead metric charges only the
            # CPU the walk itself burns
            t0 = time.thread_time()
            self._sample_once()
            self._busy_s += time.thread_time() - t0

    def _sample_once(self, into: Optional[dict] = None) -> int:
        """Fold one walk of every live thread (minus the caller's own).
        ``into`` captures into a private dict (burst mode) instead of
        the steady-state table + ring."""
        own = threading.get_ident()
        try:
            frames = sys._current_frames()
        except Exception:
            return 0
        roots = self._roots
        if any(tid not in roots for tid in frames):
            # thread set changed: one enumerate() to refresh the memo
            # (also drops labels for threads that have exited)
            roots = self._roots = {
                t.ident: _thread_label(t.name)
                for t in threading.enumerate()
                if t.ident is not None
            }
            self._parked = {
                tid: hit for tid, hit in self._parked.items() if tid in frames
            }
        now = time.perf_counter()
        captured = 0
        batch: list[tuple[int, str, str]] = []
        labels = self._code_labels
        fold_cache = self._fold_cache
        parked = self._parked
        for tid, frame in frames.items():
            if tid == own:
                continue
            top_key = (id(frame), frame.f_lasti, id(frame.f_back))
            hit = parked.get(tid)
            if hit is not None and hit[0] == top_key:
                folded, leaf = hit[1], hit[2]
                captured += 1
                if into is not None:
                    into[folded] = into.get(folded, 0) + 1
                else:
                    batch.append((tid, leaf, folded))
                continue
            root = roots.get(tid, "Thread")
            codes = []
            depth = 0
            walker = frame
            while walker is not None and depth < DEFAULT_MAX_DEPTH:
                codes.append(walker.f_code)
                walker = walker.f_back
                depth += 1
            key = (root, tuple(codes))
            hit = fold_cache.get(key)
            if hit is not None:
                folded, leaf = hit
            else:
                folded, leaf = _fold(frame, root, labels)
                if len(fold_cache) > 8192:
                    fold_cache.clear()
                fold_cache[key] = (folded, leaf)
            parked[tid] = (top_key, folded, leaf)
            captured += 1
            if into is not None:
                into[folded] = into.get(folded, 0) + 1
            else:
                batch.append((tid, leaf, folded))
        if batch:
            with self._lock:
                for tid, leaf, folded in batch:
                    if (
                        folded not in self._stacks
                        and len(self._stacks) >= self.max_stacks
                    ):
                        self._dropped += 1
                        folded = OVERFLOW_KEY
                    self._stacks[folded] = self._stacks.get(folded, 0) + 1
                    self._samples += 1
                    self._ring.append((now, tid, leaf, folded))
        return captured

    # -- output --------------------------------------------------------------

    def collapsed(self) -> str:
        """Folded-stack text, one ``stack count`` line, sorted by stack
        for deterministic output under thread churn."""
        with self._lock:
            items = sorted(self._stacks.items())
        return "\n".join(f"{stack} {count}" for stack, count in items)

    def overhead_fraction(self) -> float:
        """Sampler-thread CPU seconds spent walking stacks, as a
        fraction of wall time profiled."""
        wall = self._wall_s_prev
        if self._started_perf is not None:
            wall += time.perf_counter() - self._started_perf
        if wall <= 0:
            return 0.0
        return self._busy_s / wall

    def stats(self) -> dict:
        with self._lock:
            unique = len(self._stacks)
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": int(self._samples),
            "unique_stacks": unique,
            "dropped_stacks": int(self._dropped),
            "overhead_fraction": round(self.overhead_fraction(), 6),
            "burst_trigger_ms": self.burst_trigger_ms,
            "bursts_triggered": int(self._bursts),
            "last_burst": self._last_burst,
        }

    def top_stacks(self, n: int = 5) -> list[dict]:
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
            total = self._samples
        return [
            {
                "stack": stack,
                "samples": count,
                "share": round(count / total, 4) if total else 0.0,
            }
            for stack, count in items
        ]

    def chrome_events(self, origin_perf: float, pid: int) -> list[dict]:
        """Recent samples as Perfetto instant events (merged into
        Tracer.export_chrome_trace so stacks land on the span timeline)."""
        with self._lock:
            ring = list(self._ring)
        return [
            {
                "name": f"cpu_sample:{leaf}",
                "cat": "profiler",
                "ph": "i",
                "s": "t",
                "pid": pid,
                "tid": tid,
                "ts": round((ts - origin_perf) * 1e6, 3),
                "args": {"stack": folded},
            }
            for ts, tid, leaf, folded in ring
        ]

    def metrics(self) -> tuple:
        return (self.overhead_gauge, self.samples_gauge, self.bursts_counter)

    # -- triggered burst capture ----------------------------------------------

    def note_loop_lag(self, lag_ms: float) -> None:
        """Fed by the overload controller's loop-lag sampler. Fires ONE
        burst per lag episode: latch at ``burst_trigger_ms``, re-arm at
        half of it (same hysteresis shape as the brownout ladder)."""
        if self.burst_trigger_ms <= 0:
            return
        if lag_ms >= self.burst_trigger_ms:
            if not self._episode_active:
                self._episode_active = True
                self._bursts += 1
                self.bursts_counter.inc()
                self._start_burst(lag_ms)
        elif lag_ms < self.burst_trigger_ms / 2.0:
            self._episode_active = False

    def _start_burst(self, lag_ms: float) -> None:
        if self._burst_thread is not None and self._burst_thread.is_alive():
            return
        thread = threading.Thread(
            target=self._run_burst,
            args=(lag_ms,),
            name="hocuspocus-profiler-burst",
            daemon=True,
        )
        self._burst_thread = thread
        thread.start()

    def _run_burst(self, lag_ms: float) -> None:
        burst: dict[str, int] = {}
        period = 1.0 / max(self.burst_hz, 1.0)
        deadline = time.perf_counter() + max(self.burst_s, period)
        samples = 0
        while time.perf_counter() < deadline:
            samples += self._sample_once(into=burst)
            time.sleep(period)
        top = sorted(burst.items(), key=lambda kv: (-kv[1], kv[0]))
        top_stack, top_count = top[0] if top else ("", 0)
        self._last_burst = {
            "lag_ms": round(lag_ms, 1),
            "samples": samples,
            "top_stack": top_stack,
            "top_share": round(top_count / samples, 4) if samples else 0.0,
        }
        try:
            from .flight_recorder import get_flight_recorder

            get_flight_recorder().record(
                "__profiler__",
                "lag_burst",
                lag_ms=round(lag_ms, 1),
                samples=samples,
                top_stack=top_stack[:400],
                top_share=self._last_burst["top_share"],
            )
        except Exception:
            pass


_default = SamplingProfiler()


def get_profiler() -> SamplingProfiler:
    """Process-wide profiler singleton (same pattern as
    get_wire_telemetry / get_flight_recorder)."""
    return _default
