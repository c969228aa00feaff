"""Injectable storage faults for the durability test harness.

A durability plane that has only ever seen a healthy disk is untested
by definition. This module is the single seam every storage failure
mode flows through: the WAL's write path consults a `FaultInjector`
before fsync and around each batch write, and the store-retry tests
drive hook-level failures through `FlakyStore`. Faults are *armed* with
a count (fail the next N calls) or a predicate, so tests can express
"the first fsync fails, then the disk heals" without monkeypatching
internals.

Everything here is deterministic and process-local — kill -9 crash
testing lives in the subprocess suite (tests/storage/test_crash_recovery.py),
which needs no injection at all: SIGKILL is the fault.
"""

from __future__ import annotations

from typing import Optional


class FaultInjector:
    """Armed failure counters consulted by the WAL write path.

    - `fail_fsync(n)`: the next `n` fsync calls raise OSError.
    - `fail_disk_full(n)`: the next `n` batch writes raise ENOSPC
      before any byte is written.
    - `tear_next_write(fraction)`: the next batch write persists only
      the leading `fraction` of the batch's bytes, then raises — the
      on-disk image is exactly a torn write (partial final record).
    """

    def __init__(self) -> None:
        self._fsync_failures = 0
        self._disk_full = 0
        self._torn_fraction: Optional[float] = None
        self.counters = {
            "fsync_failures_injected": 0,
            "disk_full_injected": 0,
            "torn_writes_injected": 0,
        }

    # -- arming ------------------------------------------------------------

    def fail_fsync(self, count: int = 1) -> None:
        self._fsync_failures += count

    def fail_disk_full(self, count: int = 1) -> None:
        self._disk_full += count

    def tear_next_write(self, fraction: float = 0.5) -> None:
        self._torn_fraction = min(max(fraction, 0.0), 1.0)

    def reset(self) -> None:
        self._fsync_failures = 0
        self._disk_full = 0
        self._torn_fraction = None

    # -- checkpoints consulted by the write path ---------------------------

    def check_fsync(self) -> None:
        if self._fsync_failures > 0:
            self._fsync_failures -= 1
            self.counters["fsync_failures_injected"] += 1
            raise OSError(5, "injected fsync failure")

    def check_disk_full(self) -> None:
        if self._disk_full > 0:
            self._disk_full -= 1
            self.counters["disk_full_injected"] += 1
            raise OSError(28, "injected disk full")  # ENOSPC

    def torn_write_bytes(self, total: int) -> Optional[int]:
        """None = write everything; an int = write only that prefix and
        fail (one-shot)."""
        if self._torn_fraction is None:
            return None
        fraction, self._torn_fraction = self._torn_fraction, None
        self.counters["torn_writes_injected"] += 1
        # land inside a record body whenever possible, so recovery sees
        # a CRC-broken frame rather than a clean end-of-file
        return max(int(total * fraction), 1) if total else 0


class FlakyStore:
    """An async store callable that fails its first `failures` calls —
    the store-retry/quarantine state machine's test double. Use as the
    `store=` callable of the Database extension or call directly from
    an `on_store_document` hook."""

    def __init__(self, failures: int, error: Optional[Exception] = None) -> None:
        self.failures = failures
        self.error = error or RuntimeError("injected store failure")
        self.calls = 0
        self.successes = 0

    async def __call__(self, data) -> None:
        self.calls += 1
        if self.calls <= self.failures:
            raise self.error
        self.successes += 1
