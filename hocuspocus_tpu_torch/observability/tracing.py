"""Lightweight span tracing for the server hot path.

The reference has no tracing (SURVEY.md §5.1 — closest is the provider's
onMessage/onOutgoingMessage taps, reference
`packages/provider/src/HocuspocusProvider.ts:156-157`, and a commented-out
message logger in `packages/server/src/MessageReceiver.ts:54-59`). This
module is the "real tracing" the TPU build adds: per-message spans, hook
chain spans, merge-plane device-step spans, and — via `UpdateTraceBook`
— end-to-end lifecycle traces that follow one update from the capture
seam through the flush pipeline to broadcast, each stage a span sharing
one monotonically increasing trace id. Spans export as plain dicts or as
Chrome/Perfetto trace-event JSON (`export_chrome_trace`), and device
spans bridge into the JAX profiler when a capture is active.

Design constraints:
- Near-zero cost when disabled: one attribute read + truth test per
  span site, no object allocation.
- No global locks on the hot path: spans complete on the event loop
  thread; the ring buffer is a `collections.deque(maxlen=...)` whose
  append is atomic under the GIL.
- Slow spans survive ring wrap: promotion to a structured log line and
  the `on_slow` callbacks happens at finish time, so a burst that
  overruns `max_spans` cannot hide an outlier.
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

_slow_logger = logging.getLogger("hocuspocus_tpu_torch.tracing")

# ingress mark (see Tracer.ingress_mark): a ContextVar, NOT a tracer
# attribute — the websocket edge awaits hook chains between setting the
# mark and the capture seam consuming it, and concurrent dispatches
# from different sockets run as different asyncio tasks. A shared slot
# would let task B clobber task A's receive timestamp mid-await; the
# context is per-task, so each dispatch sees exactly its own mark.
_ingress_mark: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "hocuspocus_tpu_ingress_mark", default=None
)

# cross-tier trace context (see Tracer.fleet_context): set by the cell's
# relay ingress pump around each relayed frame dispatch, consumed by
# UpdateTraceBook.stamp — a sampled update that crossed the edge tier
# adopts the EDGE's trace id (and skips local sampling: the edge already
# sampled), so the cell's stage spans join the edge's cross-process
# chain. Per-task for the same reason as the ingress mark.
_fleet_ctx: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "hocuspocus_tpu_fleet_trace_ctx", default=None
)


class Span:
    """One completed (or in-flight) span."""

    __slots__ = ("name", "start", "end", "attributes", "trace_id", "tid")

    def __init__(self, name: str, attributes: Optional[dict] = None) -> None:
        self.name = name
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.attributes = attributes
        self.trace_id: Optional[int] = None
        self.tid = threading.get_ident()

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end is None:
            return None
        return (self.end - self.start) * 1000.0

    def set(self, key: str, value: Any) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes[key] = value

    def finish(self) -> "Span":
        self.end = time.perf_counter()
        return self

    def to_dict(self) -> dict:
        record = {
            "name": self.name,
            "start": self.start,
            "duration_ms": self.duration_ms,
            "attributes": self.attributes or {},
        }
        if self.trace_id is not None:
            record["trace_id"] = self.trace_id
        return record


class _NoopSpan:
    __slots__ = ()

    def set(self, key: str, value: Any) -> None:
        pass

    def finish(self) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects spans into a bounded ring buffer.

    Usage::

        tracer = Tracer(enabled=True)
        with tracer.span("message.apply", doc="report") as sp:
            ...
            sp.set("bytes", 123)
        tracer.export()  # -> list of dicts, oldest first

    Extra knobs:
    - `slow_ms`: spans at/above this duration are promoted to a
      structured WARNING log line and the `on_slow` callbacks (the
      Metrics extension binds `hocuspocus_tpu_slow_spans_total{site=...}`
      there) — independent of the ring, so wrap can't hide them.
    - `sample`: 1-in-N sampling for the update-lifecycle traces
      (`take_sample`), so tracing stays viable at 100k-doc load.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 4096) -> None:
        self.enabled = enabled
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._annotation = None  # lazily resolved torch.profiler.record_function
        # slow-span promotion: None disables the check entirely
        self.slow_ms: Optional[float] = None
        self.on_slow: list[Callable[[Span], Any]] = []
        # update-lifecycle trace ids + 1-in-N sampling
        self.sample: int = 1
        self._sample_counter = 0
        self._trace_id = 0
        # perf_counter origin for trace-viewer timestamps (`ts` is
        # microseconds relative to this anchor)
        self._origin_perf = time.perf_counter()

    # -- ingress mark ------------------------------------------------------

    @property
    def ingress_mark(self) -> Optional[float]:
        """The current dispatch's frame-receive timestamp, or None.

        The websocket edge (Connection.handle_message) sets this before
        dispatching and clears it in its finally; UpdateTraceBook.stamp
        reads it at the capture seam, so lifecycle traces born inside
        the dispatch gain an `update.ingress` stage (ws receive ->
        decode -> apply -> capture) and the e2e span truly runs
        socket -> broadcast. Backed by a ContextVar: dispatch tasks
        from different sockets interleave across the hook-chain awaits,
        and each must see only its own mark."""
        return _ingress_mark.get()

    @ingress_mark.setter
    def ingress_mark(self, value: Optional[float]) -> None:
        _ingress_mark.set(value)

    @property
    def fleet_context(self) -> Optional[dict]:
        """The current dispatch's relay trace context (edge-stamped
        trace id + stamps + hop counter), or None when the frame did not
        arrive through the edge tier / was not sampled there."""
        return _fleet_ctx.get()

    @fleet_context.setter
    def fleet_context(self, value: Optional[dict]) -> None:
        _fleet_ctx.set(value)

    # -- recording ---------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attributes: Any) -> Iterator[Any]:
        if not self.enabled:
            yield _NOOP_SPAN
            return
        sp = Span(name, attributes or None)
        try:
            yield sp
        finally:
            self._record(sp.finish())

    @contextmanager
    def device_span(self, name: str, **attributes: Any) -> Iterator[Any]:
        """A span that also shows up in a `torch.profiler` trace when one
        is being captured (merge-plane device steps)."""
        if not self.enabled:
            yield _NOOP_SPAN
            return
        annotation = self._resolve_annotation()
        if annotation is None:
            with self.span(name, **attributes) as sp:
                yield sp
            return
        with annotation(name), self.span(name, **attributes) as sp:
            yield sp

    def event(self, name: str, **attributes: Any) -> None:
        """Record an instantaneous event as a zero-duration span (state
        transitions, breaker trips — things with a moment, not an
        extent; exported as "i" instant events in the Chrome trace).
        Same near-zero disabled cost as span()."""
        if not self.enabled:
            return
        sp = Span(name, attributes or None)
        sp.end = sp.start  # exactly zero duration: a moment, not an extent
        self._spans.append(sp)

    def add_span(
        self,
        name: str,
        start: float,
        end: float,
        trace_id: Optional[int] = None,
        **attributes: Any,
    ) -> Optional[Span]:
        """Record a span with explicit perf_counter boundaries (the
        update trace book reconstructs stage spans after the fact from
        pipeline timestamps)."""
        if not self.enabled:
            return None
        sp = Span(name, attributes or None)
        sp.start = start
        sp.end = end
        sp.trace_id = trace_id
        self._record(sp)
        return sp

    def _record(self, sp: Span) -> None:
        self._spans.append(sp)
        slow_ms = self.slow_ms
        if slow_ms is not None and (sp.end - sp.start) * 1000.0 >= slow_ms:
            self._promote_slow(sp)

    def _promote_slow(self, sp: Span) -> None:
        try:
            _slow_logger.warning(
                "slow span site=%s duration_ms=%.3f trace_id=%s attrs=%s",
                sp.name,
                (sp.end - sp.start) * 1000.0,
                sp.trace_id,
                sp.attributes or {},
            )
        except Exception:
            pass
        for fn in list(self.on_slow):
            try:
                fn(sp)
            except Exception:
                pass

    # -- trace ids + sampling ----------------------------------------------

    def next_trace_id(self) -> int:
        self._trace_id += 1
        return self._trace_id

    def take_sample(self) -> bool:
        """1-in-`sample` admission for update-lifecycle traces. The
        first update after enabling is always sampled, so a lone manual
        test edit produces a trace."""
        if self.sample <= 1:
            return True
        self._sample_counter += 1
        return self._sample_counter % self.sample == 1

    def _resolve_annotation(self):
        if self._annotation is None:
            try:
                from torch.profiler import record_function

                self._annotation = record_function
            except Exception:
                self._annotation = False
        return self._annotation or None

    # -- reading -----------------------------------------------------------

    def export(self, clear: bool = False) -> list[dict]:
        spans = [sp.to_dict() for sp in self._spans]
        if clear:
            self._spans.clear()
        return spans

    def export_chrome_trace(self) -> dict:
        """The span ring as Chrome trace-event JSON (the format Perfetto,
        `chrome://tracing` and `ui.perfetto.dev` all open): complete
        ("X") events with microsecond `ts`/`dur`, instantaneous ("i")
        events for zero-duration spans, one `tid` per recording thread,
        and span attributes (incl. the lifecycle trace id) under `args`.

        Cross-tier spans (attribute `node=<role id>`, stamped by the
        fleet trace plumbing) are merged under one synthetic pid PER
        NODE with a matching process_name record, so a single Perfetto
        view shows the full socket→cell→socket path as separate
        role/cell lanes."""
        pid = os.getpid()
        origin = self._origin_perf
        events: list[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": "hocuspocus_tpu_torch"},
            }
        ]
        node_pids: dict[str, int] = {}
        for sp in list(self._spans):
            args = dict(sp.attributes or {})
            if sp.trace_id is not None:
                args["trace_id"] = sp.trace_id
            node = args.get("node")
            if node is None:
                span_pid = pid
            else:
                span_pid = node_pids.get(node)
                if span_pid is None:
                    # synthetic pid lane per fleet node, well clear of
                    # real pid space so lanes never collide
                    span_pid = node_pids[node] = 1_000_000 + len(node_pids)
                    events.append(
                        {
                            "ph": "M",
                            "name": "process_name",
                            "pid": span_pid,
                            "tid": 0,
                            "args": {"name": str(node)},
                        }
                    )
            ts = (sp.start - origin) * 1e6
            end = sp.end if sp.end is not None else sp.start
            dur = (end - sp.start) * 1e6
            base = {
                "name": sp.name,
                "pid": span_pid,
                "tid": sp.tid,
                "ts": round(ts, 3),
                "args": args,
            }
            if dur > 0:
                base["ph"] = "X"
                base["dur"] = round(dur, 3)
            else:
                base["ph"] = "i"
                base["s"] = "t"
            events.append(base)
        try:
            # merge the sampling profiler's recent-stack ring as instant
            # events on the same clock, so flamegraph samples line up
            # with the lifecycle spans in one Perfetto view
            from .profiler import get_profiler

            events.extend(get_profiler().chrome_events(origin, pid))
        except Exception:
            pass
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        self._spans.clear()

    def __len__(self) -> int:
        return len(self._spans)


class UpdateTraceBook:
    """Causally links one update's pipeline stages under one trace id.

    The capture seam stamps a sampled update (`stamp`: trace id +
    enqueue timestamp, per doc name); the flush engine moves stamped
    docs through drain (`take_drained`) and closes the device stages at
    the cycle's readback barrier (`complete_cycle`); the broadcast pass
    closes the trace (`finish`). Each boundary timestamp is shared by
    adjacent stages, so the per-stage durations are contiguous and sum
    exactly to the end-to-end latency:

        receive → enqueue:   ingress   (ws receive → decode → apply →
                                        capture; present only when the
                                        tracer's ingress_mark was set,
                                        i.e. the update arrived through
                                        the websocket edge)
        enqueue → drain:     queue_wait
        drain → built:       build
        built → uploaded:    upload
        uploaded → dispatched: device
        dispatched → readback: readback
        readback → broadcast:  broadcast

    Stage spans land in the tracer ring (names `update.<stage>`, shared
    `trace_id`); stage durations feed the labelled `histogram`
    (`hocuspocus_tpu_update_e2e_seconds{stage=...}`) when one is bound.
    Bounded: at most MAX_PENDING stamped-not-yet-flushed and MAX_FLUSHED
    flushed-not-yet-broadcast traces are held; excess stamps are dropped
    (counted), and `drop(name)` discards a doc's traces at
    retire/release so degraded docs can't leak entries.
    """

    MAX_PENDING = 4096
    MAX_FLUSHED = 4096

    def __init__(self, tracer: Optional[Tracer] = None) -> None:
        self.tracer = tracer  # None = the process-default tracer
        self.histogram = None  # labelled Histogram, bound by Metrics
        self.on_slow_flush: Optional[Callable[[str, float], Any]] = None
        self.slow_flush_ms: Optional[float] = None
        # fleet node attribution for cross-tier traces: set by the cell
        # ingress at configure time (the process-global identity is
        # last-writer, wrong in a multi-cell process); None falls back
        # to the process identity
        self.node_id: Optional[str] = None
        self.dropped = 0
        # stamp/finish run on the event loop while take_drained/
        # complete_cycle run on the flush executor thread: the compound
        # dict+counter updates must not interleave (a setdefault/append
        # racing a pop would strand entries and drift the bound
        # counters until MAX_PENDING wedges tracing). Reentrant:
        # complete_cycle closes early-broadcast traces via finish().
        # Never touched on the disabled path.
        self._lock = threading.RLock()
        self._pending: dict[str, list] = {}  # doc -> [(trace_id, t_enqueue)]
        self._flushed: dict[str, list] = {}  # doc -> [trace dict]
        self._pending_count = 0
        self._flushed_count = 0
        # docs with any live (stamped, unclosed) trace — gates the
        # early-broadcast bookkeeping below to traced docs only
        self._live: dict[str, int] = {}
        # broadcasts run optimistically ahead of the device flush (host
        # serve logs), so fan-out can complete while a trace is still
        # pending/in-flight: remember the broadcast time per doc and
        # close the trace at the cycle's readback barrier instead
        self._early_broadcast: dict[str, float] = {}

    def _resolve_tracer(self) -> Tracer:
        return self.tracer if self.tracer is not None else _default

    @property
    def enabled(self) -> bool:
        return self._resolve_tracer().enabled

    def active(self) -> bool:
        """Anything stamped and waiting for a flush? (The flush loop's
        cheap guard — one truth test per batch when tracing is idle.)"""
        return bool(self._pending)

    # -- capture seam --------------------------------------------------------

    def stamp(self, name: str) -> Optional[int]:
        """Stamp one enqueued update with a fresh trace id (respecting
        the tracer's 1-in-N sampling). Returns the id, or None when not
        sampled / tracing disabled / the pending set is full.

        A live cross-tier context (`Tracer.fleet_context`, set by the
        relay ingress pump) means the EDGE already sampled this update:
        the stamp adopts the edge's trace id instead of allocating one
        and skips local sampling, so the cell's stage spans extend the
        edge's chain under one id."""
        tracer = self._resolve_tracer()
        if not tracer.enabled:
            return None
        fleet = tracer.fleet_context
        if fleet is not None and fleet.get("id") is None:
            # a versioned-but-id-less aux (foreign producer) carries no
            # edge sampling decision: fall back to local sampling, or
            # every such update would be traced regardless of `sample`
            fleet = None
        if fleet is None and not tracer.take_sample():
            return None
        with self._lock:
            if self._pending_count >= self.MAX_PENDING:
                self.dropped += 1
                return None
            if fleet is not None:
                trace_id = fleet["id"]
            else:
                trace_id = tracer.next_trace_id()
            t_enqueue = time.perf_counter()
            # a live ingress mark anchors the trace at the websocket
            # receive instead of the capture seam (never later than the
            # enqueue: a stale mark from a previous dispatch is cleared
            # by that dispatch's finally)
            t_receive = tracer.ingress_mark
            if t_receive is not None and t_receive > t_enqueue:
                t_receive = None
            self._pending.setdefault(name, []).append(
                (trace_id, t_enqueue, t_receive, fleet)
            )
            self._pending_count += 1
            self._live[name] = self._live.get(name, 0) + 1
        return trace_id

    def unstamp(self, name: str, trace_id: int) -> None:
        """Retract a stamp whose update was not accepted by the queue
        (deduplicated or degraded mid-enqueue): the flush pipeline will
        never drain it, so it must not linger in the pending set."""
        with self._lock:
            entries = self._pending.get(name)
            if not entries:
                return
            for i, (tid, *_times) in enumerate(entries):
                if tid == trace_id:
                    entries.pop(i)
                    self._pending_count -= 1
                    self._unlive(name, 1)
                    if not entries:
                        self._pending.pop(name, None)
                    return

    # -- flush engine --------------------------------------------------------

    def take_drained(self, names, t_drain: float) -> Optional[list]:
        """Move every pending trace of the given doc names into an
        in-flight batch list, recording the drain timestamp. Returns
        None when none of the names had pending traces."""
        out: Optional[list] = None
        with self._lock:
            for name in names:
                if name is None:
                    continue
                entries = self._pending.pop(name, None)
                if not entries:
                    continue
                self._pending_count -= len(entries)
                if out is None:
                    out = []
                for trace_id, t_enqueue, t_receive, fleet in entries:
                    out.append(
                        {
                            "trace_id": trace_id,
                            "doc": name,
                            "t_enqueue": t_enqueue,
                            "t_receive": t_receive,
                            "t_drain": t_drain,
                            "fleet": fleet,
                        }
                    )
        return out

    def complete_cycle(self, trace_batches, t_sync: float) -> None:
        """Close the device-side stages for every trace drained this
        flush cycle. `trace_batches` is a list of (traces, t_build,
        t_upload, t_dispatch) per batch; `t_sync` is the cycle's single
        readback barrier, shared by every batch."""
        tracer = self._resolve_tracer()
        hist = self.histogram
        with self._lock:
            self._complete_cycle_locked(tracer, hist, trace_batches, t_sync)

    def _complete_cycle_locked(self, tracer, hist, trace_batches, t_sync: float) -> None:
        for traces, t_build, t_upload, t_dispatch in trace_batches:
            for trace in traces:
                trace_id = trace["trace_id"]
                name = trace["doc"]
                t_receive = trace.get("t_receive")
                # cross-tier traces carry a node attribute so the
                # Perfetto export groups this cell's stage spans under
                # its own role/cell lane (pid) in the merged view
                node = (
                    (self.node_id or _fleet_node())
                    if trace.get("fleet") is not None
                    else None
                )
                stages = (
                    ("queue_wait", trace["t_enqueue"], trace["t_drain"]),
                    ("build", trace["t_drain"], t_build),
                    ("upload", t_build, t_upload),
                    ("device", t_upload, t_dispatch),
                    ("readback", t_dispatch, t_sync),
                )
                if t_receive is not None:
                    # the websocket edge stamped this update: the trace
                    # opens at the frame receive, not the capture seam
                    stages = (
                        ("ingress", t_receive, trace["t_enqueue"]),
                    ) + stages
                for stage, s0, s1 in stages:
                    if node is None:
                        tracer.add_span(
                            f"update.{stage}", s0, s1, trace_id=trace_id, doc=name
                        )
                    else:
                        tracer.add_span(
                            f"update.{stage}",
                            s0,
                            s1,
                            trace_id=trace_id,
                            doc=name,
                            node=node,
                        )
                    if hist is not None:
                        hist.observe(max(s1 - s0, 0.0), stage=stage)
                trace["t_sync"] = t_sync
                self._flushed.setdefault(name, []).append(trace)
                self._flushed_count += 1
        if self._early_broadcast:
            # the fan-out already happened (broadcasts build from host
            # serve logs, ahead of the device): close those traces now,
            # with a zero-length broadcast stage ending at the barrier
            for traces, *_ in trace_batches:
                for trace in traces:
                    name = trace["doc"]
                    mark = self._early_broadcast.pop(name, None)
                    if mark is not None:
                        self.finish(name, max(mark, t_sync))
        while self._flushed_count > self.MAX_FLUSHED and self._flushed:
            # oldest-doc shedding: a doc that never broadcasts (degraded
            # mid-flight) must not pin the book
            name, entries = next(iter(self._flushed.items()))
            self._flushed.pop(name)
            self._flushed_count -= len(entries)
            self.dropped += len(entries)
            self._unlive(name, len(entries))

    # -- broadcast -----------------------------------------------------------

    def _unlive(self, name: str, count: int) -> None:
        remaining = self._live.get(name, 0) - count
        if remaining > 0:
            self._live[name] = remaining
        else:
            self._live.pop(name, None)

    def finish(self, name: str, t_now: Optional[float] = None) -> int:
        """Close every flushed trace of `name` at broadcast time: emits
        the broadcast stage span (carrying the end-to-end latency) and
        the broadcast/total histogram observations. Returns the number
        of traces closed."""
        if not self._flushed and not self._live:
            return 0  # fast path: nothing traced for any doc
        with self._lock:
            return self._finish_locked(name, t_now)

    def _finish_locked(self, name: str, t_now: Optional[float]) -> int:
        entries = self._flushed.pop(name, None) if self._flushed else None
        if not entries:
            # the broadcast outran the device pipeline for this doc's
            # trace (still pending or mid-cycle): remember the fan-out
            # moment so complete_cycle closes the trace at the barrier
            if name in self._live:
                while len(self._early_broadcast) >= self.MAX_PENDING:
                    # evict the OLDEST mark only: wiping the table would
                    # strand every other doc's already-broadcast traces
                    self._early_broadcast.pop(
                        next(iter(self._early_broadcast))
                    )
                self._early_broadcast[name] = (
                    time.perf_counter() if t_now is None else t_now
                )
            return 0
        self._flushed_count -= len(entries)
        if t_now is None:
            t_now = time.perf_counter()
        tracer = self._resolve_tracer()
        hist = self.histogram
        # slow-flush promotion threshold: explicit override, else the
        # tracer's slow-span threshold (set by --trace-slow-ms)
        slow_ms = (
            self.slow_flush_ms if self.slow_flush_ms is not None else tracer.slow_ms
        )
        for trace in entries:
            # the trace opens at the websocket receive when the ingress
            # stage exists, else at the capture seam — either way the
            # stage spans partition [t_start, t_now] exactly
            t_start = trace.get("t_receive")
            if t_start is None:
                t_start = trace["t_enqueue"]
            e2e_ms = (t_now - t_start) * 1000.0
            fleet = trace.get("fleet")
            extra_attrs = (
                {} if fleet is None else {"node": self.node_id or _fleet_node()}
            )
            tracer.add_span(
                "update.broadcast",
                trace["t_sync"],
                t_now,
                trace_id=trace["trace_id"],
                doc=name,
                e2e_ms=round(e2e_ms, 3),
                **extra_attrs,
            )
            if fleet is not None:
                # cross-tier return context: echo the edge's stamps plus
                # this process's receive/send boundaries (OUR clock) so
                # the originating edge can close the chain — deposited
                # for the relay envelope of this broadcast frame
                # (observability/fleet.py TraceReturnOutbox)
                self._deposit_fleet_return(name, fleet, t_start, t_now)
            if hist is not None:
                hist.observe(max(t_now - trace["t_sync"], 0.0), stage="broadcast")
                hist.observe(max(t_now - t_start, 0.0), stage="total")
            if (
                slow_ms is not None
                and e2e_ms >= slow_ms
                and self.on_slow_flush is not None
            ):
                try:
                    self.on_slow_flush(name, e2e_ms)
                except Exception:
                    pass
        self._unlive(name, len(entries))
        return len(entries)

    def _deposit_fleet_return(
        self, name: str, fleet: dict, t_receive: float, t_send: float
    ) -> None:
        try:
            from .fleet import get_fleet_view

            view = get_fleet_view()
            view.trace_returns.deposit(
                name,
                {
                    "id": fleet.get("id"),
                    "e": str(fleet.get("e", "")),
                    "d": name,
                    "t0": fleet.get("t0"),
                    "t1": fleet.get("t1"),
                    "h": int(fleet.get("h", 1)) + 1,
                    "tr": t_receive,
                    "ts": t_send,
                    "n": self.node_id or view.node_id or "cell",
                },
            )
        except Exception:
            pass  # tracing must never fail a broadcast

    def finish_all(self, t_now: Optional[float] = None) -> int:
        total = 0
        for name in list(self._flushed):
            total += self.finish(name, t_now)
        return total

    def drop(self, name: str) -> None:
        """Discard a doc's traces (retire/release/degrade: the pipeline
        will never complete them)."""
        if not self._live and not self._early_broadcast:
            return  # fast path: nothing ever stamped for any doc
        with self._lock:
            entries = self._pending.pop(name, None)
            if entries:
                self._pending_count -= len(entries)
            entries = self._flushed.pop(name, None)
            if entries:
                self._flushed_count -= len(entries)
            self._live.pop(name, None)
            self._early_broadcast.pop(name, None)


def _fleet_node() -> str:
    """This process's fleet node id (span `node` attribute for the
    merged cross-process Perfetto view). Lazy import: fleet.py imports
    this module."""
    try:
        from .fleet import get_fleet_view

        return get_fleet_view().node_id or "local"
    except Exception:
        return "local"


# The default tracer every instrumentation site uses. Disabled by default:
# span sites cost one attribute read + branch until somebody enables it.
_default = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _default


def enable_tracing(max_spans: Optional[int] = None) -> Tracer:
    """Enable the process-default tracer. `max_spans=None` (the default)
    preserves the current ring — repeat calls no longer silently rebuild
    a caller-sized deque back to the default size."""
    _default.enabled = True
    if max_spans is not None and _default._spans.maxlen != max_spans:
        _default._spans = deque(_default._spans, maxlen=max_spans)
    return _default


def disable_tracing() -> None:
    _default.enabled = False
