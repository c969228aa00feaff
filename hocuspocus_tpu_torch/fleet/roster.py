"""Cross-host cell admission: host-qualified roster + clock-gated joins.

The relay envelope protocol is already host-agnostic — a cell announces
itself on the control channel and edges route to its cell channel by id,
wherever the process lives. What was missing for cross-host fleets is
POLICY, not dataplane:

* **Identity.** A cell id gains an optional ``host/`` qualifier
  (``host-b/cell-0``). Rendezvous scoring in `CellRouter` and
  `DevicePlacement` hashes the full string, so a qualified id is a
  first-class placement target with zero routing changes.

* **Admission** (`AdmissionGate`, lives on each edge). A local-host
  cell is admitted on its first CELL_UP exactly as before. A FOREIGN
  cell stays **pending** — announced, probed, but *not routable* —
  until its per-peer `ClockOffsetEstimator` (observability/fleet.py)
  has resolved: enough PING/PONG samples at a bounded RTT. The gate
  deliberately judges resolution *quality* (sample count + RTT bound),
  never offset *magnitude*: `perf_counter` origins differ arbitrarily
  across processes, so a huge offset is normal while an unresolved or
  wide-RTT estimate means cross-tier latency attribution (and the
  staleness math in FleetView) would be garbage for that peer.

* **Membership epochs** (`PeerRoster`, mirrored on each cell). Edges
  already version routing through `CellRouter.epoch`; cells had no
  equivalent, which is why `/debug/fleet` could only flag epoch skew
  for the edge role. Each cell now folds control-channel lifecycle
  transitions (CELL_UP of a new peer, CELL_DRAINING, CELL_DOWN) into a
  monotonic roster epoch published in its digest — cells that watched
  the same control stream agree, and a cell that missed a transition
  diverges, which is exactly the skew worth flagging.

Admission never blocks convergence: a pending cell's announcements are
idempotent heartbeats, and once admitted the router's epoch bump heals
any in-flight routes through the existing stale-route/Step1-resync
machinery.
"""

from __future__ import annotations

import time
from typing import Optional

HOST_SEPARATOR = "/"


def cell_host(cell_id: str) -> Optional[str]:
    """The host qualifier of a cell id, or None for a bare (legacy,
    implicitly local) id."""
    if HOST_SEPARATOR in cell_id:
        return cell_id.split(HOST_SEPARATOR, 1)[0]
    return None


def qualify_cell_id(host_id: Optional[str], cell_id: str) -> str:
    """Qualify a bare cell id with its host. Already-qualified ids and
    hostless deployments pass through unchanged."""
    if not host_id or HOST_SEPARATOR in cell_id:
        return cell_id
    return f"{host_id}{HOST_SEPARATOR}{cell_id}"


class AdmissionGate:
    """Edge-side admission policy for announced cells.

    ``evaluate`` is pure (estimator in, verdict out); the pending table
    plus counters around it are what the gateway wires into its CELL_UP
    dispatch and `/debug/fleet` status.
    """

    def __init__(
        self,
        local_host: Optional[str] = None,
        min_samples: int = 2,
        max_rtt_s: float = 0.5,
    ) -> None:
        self.local_host = local_host
        self.min_samples = max(int(min_samples), 1)
        self.max_rtt_s = float(max_rtt_s)
        # cell id -> {"since": monotonic, "reason": last hold reason}
        self.pending: "dict[str, dict]" = {}
        self.counters = {
            "admitted_local": 0,
            "admitted_foreign": 0,
            "held_pending": 0,
            "pending_expired": 0,
        }

    def is_foreign(self, cell_id: str) -> bool:
        host = cell_host(cell_id)
        return host is not None and host != self.local_host

    def evaluate(self, cell_id: str, estimator=None) -> "tuple[bool, str]":
        """(admit, reason). Local cells always admit; foreign cells
        need a RESOLVED clock-offset estimate (samples + RTT bound)."""
        if not self.is_foreign(cell_id):
            return True, "local"
        if estimator is None or estimator.samples < self.min_samples:
            samples = 0 if estimator is None else estimator.samples
            return False, f"clock_unresolved:{samples}/{self.min_samples}"
        rtt = estimator.rtt_s
        if rtt is None or rtt > self.max_rtt_s:
            shown = "none" if rtt is None else f"{rtt:.3f}s"
            return False, f"rtt_unbounded:{shown}"
        return True, "clock_resolved"

    def hold(self, cell_id: str, reason: str) -> bool:
        """Record a held cell; True when it is NEWLY pending."""
        now = time.monotonic()
        entry = self.pending.get(cell_id)
        if entry is None:
            self.pending[cell_id] = {
                "since": now,
                "last_seen": now,
                "reason": reason,
            }
            self.counters["held_pending"] += 1
            return True
        entry["reason"] = reason
        # liveness, not patience: every re-hold (CELL_UP heartbeat or a
        # PONG re-evaluation) proves the peer is alive — expiry must
        # only fire when the announcements STOP
        entry["last_seen"] = now
        return False

    def admit(self, cell_id: str) -> bool:
        """Record an admission; True when the cell had been pending
        (i.e. this is a foreign join completing, not a heartbeat)."""
        was_pending = self.pending.pop(cell_id, None) is not None
        if was_pending and self.is_foreign(cell_id):
            self.counters["admitted_foreign"] += 1
        return was_pending

    def note_local(self, newly_routable: bool) -> None:
        """First-time local admissions, counted by the caller off the
        router's membership-change signal (heartbeats are no-ops)."""
        if newly_routable:
            self.counters["admitted_local"] += 1

    def expire(self, timeout_s: float) -> "list[str]":
        """Drop pending cells that stopped announcing (same liveness
        contract as the router's heartbeat sweep)."""
        now = time.monotonic()
        expired = [
            cell_id
            for cell_id, entry in self.pending.items()
            if now - entry["last_seen"] > timeout_s
        ]
        for cell_id in expired:
            self.pending.pop(cell_id, None)
            self.counters["pending_expired"] += 1
        return expired

    def status(self) -> dict:
        return {
            "local_host": self.local_host,
            "min_samples": self.min_samples,
            "max_rtt_s": self.max_rtt_s,
            "pending": {
                cell_id: entry["reason"]
                for cell_id, entry in sorted(self.pending.items())
            },
            "counters": dict(self.counters),
        }


class PeerRoster:
    """A cell's mirror of fleet membership off the control channel.

    Cells don't route (edges own that), but they DO need a versioned
    view of who is in the fleet so `/debug/fleet` can compare roster
    epochs cell-vs-cell — a cell whose epoch diverges from its peers
    missed (or double-saw) a membership transition. `note` is fed from
    the cell's control-channel dispatch, INCLUDING its own announce
    echo: every subscriber of the same stream then counts the same
    transitions and lands on the same epoch.
    """

    __slots__ = ("peers", "epoch")

    def __init__(self) -> None:
        self.peers: "dict[str, str]" = {}
        self.epoch = 0

    def note(self, cell_id: str, state: str) -> bool:
        """Fold one lifecycle observation; True (and an epoch bump) on
        a real transition, False for heartbeat no-ops."""
        if state == "down":
            if self.peers.pop(cell_id, None) is None:
                return False
            self.epoch += 1
            return True
        if self.peers.get(cell_id) == state:
            return False
        self.peers[cell_id] = state
        self.epoch += 1
        return True

    def table(self) -> dict:
        return {
            "epoch": self.epoch,
            "peers": dict(sorted(self.peers.items())),
        }
