"""Process-global loadgen timeline: the live `/debug/loadgen` surface.

A scenario run is only diagnosable if it is observable from the same
`/debug/*` surfaces production uses — a failing storm phase must be
explorable while it runs, not reconstructed from a result artifact
afterwards. The runner drives this singleton (run/phase/op edges); the
`Metrics` extension serves `status()` at `GET /debug/loadgen`; phase
transitions are mirrored into the flight recorder's `__loadgen__` ring
by the runner so the two timelines can be cross-referenced.

Deliberately stdlib-only and tiny: the observability extension imports
it lazily at request time, and recording an op is one dict update plus
a bounded-deque append.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional


class LoadgenTimeline:
    """Bounded live state for the current (and last finished) run."""

    def __init__(self, max_events: int = 256) -> None:
        self.max_events = max_events
        self._run: Optional[dict] = None
        self._last_run: Optional[dict] = None
        self._events: deque = deque(maxlen=max_events)

    # -- run edges -----------------------------------------------------------

    def begin_run(
        self,
        scenario: str,
        seed: int,
        schedule_hash: str,
        phases: "list[dict]",
        time_scale: float,
        ops_total: int,
    ) -> None:
        self._run = {
            "scenario": scenario,
            "seed": seed,
            "schedule_hash": schedule_hash,
            "time_scale": time_scale,
            "started_ts": time.time(),
            "started_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "ops_total": ops_total,
            "ops_done": 0,
            "ops_failed": 0,
            "current_phase": None,
            "verdict": None,
            "phases": [
                {
                    "name": p["name"],
                    "planned_ms": p["planned_ms"],
                    "state": "pending",
                    "started_s": None,
                    "ended_s": None,
                    "ops_done": 0,
                    "ops_failed": 0,
                    "latency_p50_ms": None,
                    "latency_p99_ms": None,
                    "breaching": [],
                }
                for p in phases
            ],
        }
        self._events.clear()
        self._event("run_start", scenario=scenario, schedule_hash=schedule_hash)

    def end_run(self, verdict: str, slo: Optional[dict] = None) -> None:
        if self._run is None:
            return
        self._run["verdict"] = verdict
        self._run["current_phase"] = None
        self._run["ended_ts"] = time.time()
        if slo is not None:
            self._run["slo"] = slo
        self._event("run_end", verdict=verdict)
        self._last_run, self._run = self._run, None

    # -- phase edges ---------------------------------------------------------

    def _phase(self, name: str) -> Optional[dict]:
        if self._run is None:
            return None
        for phase in self._run["phases"]:
            if phase["name"] == name:
                return phase
        return None

    def phase_start(self, name: str) -> None:
        phase = self._phase(name)
        if phase is None:
            return
        phase["state"] = "running"
        phase["started_s"] = round(time.time() - self._run["started_ts"], 3)
        self._run["current_phase"] = name
        self._event("phase_start", phase=name)

    def phase_end(self, name: str, **summary: Any) -> None:
        phase = self._phase(name)
        if phase is None:
            return
        phase["state"] = "done"
        phase["ended_s"] = round(time.time() - self._run["started_ts"], 3)
        for key, value in summary.items():
            phase[key] = value
        if self._run["current_phase"] == name:
            self._run["current_phase"] = None
        self._event("phase_end", phase=name)

    # -- ops -----------------------------------------------------------------

    def op_done(
        self,
        phase: str,
        kind: str,
        ok: bool,
        latency_ms: Optional[float] = None,
    ) -> None:
        if self._run is not None:
            self._run["ops_done"] += 1
            if not ok:
                self._run["ops_failed"] += 1
            row = self._phase(phase)
            if row is not None:
                row["ops_done"] += 1
                if not ok:
                    row["ops_failed"] += 1
        if not ok or latency_ms is not None:
            # measured and failed ops are the interesting ones on a live
            # timeline; fire-and-forget background edits stay aggregate
            self._event(
                "op",
                phase=phase,
                kind=kind,
                ok=ok,
                latency_ms=None if latency_ms is None else round(latency_ms, 3),
            )

    def note_breach(self, phase: str, target: str) -> None:
        row = self._phase(phase)
        if row is not None and target not in row["breaching"]:
            row["breaching"].append(target)
            self._event("slo_breach", phase=phase, target=target)

    def _event(self, event: str, **attrs: Any) -> None:
        entry = {"ts": time.time(), "event": event}
        entry.update(attrs)
        self._events.append(entry)

    # -- reading -------------------------------------------------------------

    def status(self) -> dict:
        """JSON-able rollup for `GET /debug/loadgen`."""
        run = None
        if self._run is not None:
            run = dict(self._run)
            run["elapsed_s"] = round(time.time() - run["started_ts"], 3)
        return {
            "active": self._run is not None,
            "run": run,
            "last_run": self._last_run,
            "events": list(self._events),
        }

    def clear(self) -> None:
        self._run = None
        self._last_run = None
        self._events.clear()


_default = LoadgenTimeline()


def get_loadgen_timeline() -> LoadgenTimeline:
    return _default
