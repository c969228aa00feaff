"""Keyed debouncer with max-wait (reference `util/debounce.ts` semantics).

Delays are milliseconds to match the reference configuration surface.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Optional


class Debouncer:
    def __init__(self) -> None:
        # id -> {"start": float, "handle": TimerHandle, "func": callable}
        self._timers: dict[str, dict] = {}
        # id -> task scheduled by a fired timer that has not completed.
        # Between the timer popping _timers and the task's coroutine
        # actually running (one loop tick), the work is invisible to
        # is_debounced AND to any mutex the coroutine will take —
        # callers deciding "no pending work, safe to tear down" (the
        # unload path) must consult in_flight() to close that window.
        self._pending_tasks: dict[str, asyncio.Task] = {}

    def debounce(
        self, id: str, fn: Callable[[], Any], delay_ms: float, max_delay_ms: float
    ) -> Optional[asyncio.Task]:
        old = self._timers.pop(id, None)
        start = old["start"] if old else time.monotonic()
        if old:
            old["handle"].cancel()

        def run() -> Optional[asyncio.Task]:
            self._timers.pop(id, None)
            result = fn()
            if asyncio.iscoroutine(result):
                task = asyncio.ensure_future(result)
                self._pending_tasks[id] = task

                def done(t: asyncio.Task) -> None:
                    if self._pending_tasks.get(id) is t:
                        self._pending_tasks.pop(id, None)
                    # timer-fired tasks have no awaiter: retrieve the
                    # exception so a failing store chain (which already
                    # logs itself) doesn't also emit "Task exception was
                    # never retrieved". Callers that DO await still see
                    # the raise.
                    t.cancelled() or t.exception()

                task.add_done_callback(done)
                return task
            return result

        if delay_ms == 0 or (time.monotonic() - start) * 1000 >= max_delay_ms:
            return run()

        loop = asyncio.get_event_loop()
        handle = loop.call_later(delay_ms / 1000, run)
        self._timers[id] = {"start": start, "handle": handle, "func": run}
        return None

    def execute_now(self, id: str) -> Optional[asyncio.Task]:
        old = self._timers.get(id)
        if old:
            old["handle"].cancel()
            return old["func"]()
        return None

    def is_debounced(self, id: str) -> bool:
        return id in self._timers

    def in_flight(self, id: str) -> bool:
        """A fired timer's task is scheduled or running (not completed)."""
        return id in self._pending_tasks
