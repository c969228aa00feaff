"""Per-document flight recorder: a bounded ring of lifecycle events.

At 100k docs, aggregate gauges say *that* docs are degrading, never
*which* doc did what when. This recorder keeps the last N lifecycle
events per document — load, unload, evict, hydrate, compact, retire,
recycle, degrade, breaker-degrade, slow flush — so an operator can ask
"what happened to `reports/q3`?" and get a timeline, queryable at
`GET /debug/docs/<name>` (and a busiest-docs table at `/debug/docs`),
both served by the `Metrics` extension.

Always on and deliberately tiny: one OrderedDict move-to-end plus a
deque append per event, recorded only at lifecycle edges (never per
update), with both the per-doc ring and the doc population bounded
(LRU eviction of the least-recently-eventful doc).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Any, Optional


class FlightRecorder:
    """Bounded per-doc event rings with an LRU-bounded doc population."""

    def __init__(self, max_docs: int = 1024, max_events: int = 64) -> None:
        self.max_docs = max_docs
        self.max_events = max_events
        self._docs: "OrderedDict[str, deque]" = OrderedDict()
        self.total_events = 0
        self.evicted_docs = 0

    def record(self, name: str, event: str, **attrs: Any) -> None:
        ring = self._docs.get(name)
        if ring is None:
            while len(self._docs) >= self.max_docs:
                self._docs.popitem(last=False)
                self.evicted_docs += 1
            ring = deque(maxlen=self.max_events)
            self._docs[name] = ring
        else:
            self._docs.move_to_end(name)
        entry = {"ts": time.time(), "event": event}
        if attrs:
            entry.update(attrs)
        ring.append(entry)
        self.total_events += 1

    def events(self, name: str) -> list[dict]:
        ring = self._docs.get(name)
        return [] if ring is None else list(ring)

    def docs(self) -> list[dict]:
        """Per-doc summaries, most-recently-eventful first."""
        out = []
        for name in reversed(self._docs):
            ring = self._docs[name]
            last = ring[-1] if ring else None
            out.append(
                {
                    "doc": name,
                    "events": len(ring),
                    "last_event": None if last is None else last["event"],
                    "last_ts": None if last is None else last["ts"],
                }
            )
        return out

    def forget(self, name: str) -> None:
        self._docs.pop(name, None)

    def clear(self) -> None:
        self._docs.clear()
        self.total_events = 0
        self.evicted_docs = 0

    def __len__(self) -> int:
        return len(self._docs)


_default = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _default
