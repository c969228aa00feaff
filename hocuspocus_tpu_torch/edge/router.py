"""Doc → cell placement: rendezvous hashing + an explicit override table.

The router is the edge tier's only routing state, and it is SOFT state:
every entry is reconstructible from the control channel (cells announce
themselves) and every stale answer is healed by the SyncStep1 resync
exchange, never trusted to be right forever. Placement properties:

- **Rendezvous (HRW) hashing.** Each doc scores every healthy cell with
  ``blake2b(doc || cell)`` and picks the max. Adding a cell moves only
  the docs whose new-cell score wins (~1/N of the population, all of
  them TO the new cell); removing a cell moves only the docs that lived
  on it. No ring maintenance, no token math — the minimal-movement
  property the handoff story depends on (pinned by
  tests/edge/test_router.py).
- **Override table.** An explicit ``doc -> cell`` map consulted first —
  the operator's tool for pinning a mega-doc to a dedicated cell or
  draining a hot spot by hand. An override naming an unhealthy or
  unknown cell falls through to rendezvous (a stale pin must degrade to
  correct placement, not to a black hole).
- **Health states.** ``healthy`` cells take traffic; ``draining`` cells
  (the graceful drain announced departure) and ``dead`` cells (missed
  heartbeats / session failures) are excluded from routing, and a
  re-announce heals either state back to healthy. Every change bumps
  ``epoch`` so observers (/debug/edge) can cheaply detect remaps.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"


class CellRouter:
    def __init__(
        self,
        overrides: "Optional[dict[str, str]]" = None,
        heartbeat_timeout_s: float = 10.0,
    ) -> None:
        # cell_id -> {"state": str, "since": float, "seen": float}
        self.cells: "dict[str, dict]" = {}
        self.overrides: "dict[str, str]" = dict(overrides or {})
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.epoch = 0

    # -- membership ----------------------------------------------------------

    def _transition(self, cell_id: str, state: str) -> bool:
        now = time.monotonic()
        entry = self.cells.get(cell_id)
        if entry is None:
            self.cells[cell_id] = {"state": state, "since": now, "seen": now}
            self.epoch += 1
            return True
        entry["seen"] = now
        if entry["state"] != state:
            entry["state"] = state
            entry["since"] = now
            self.epoch += 1
            return True
        return False

    def add_cell(self, cell_id: str) -> bool:
        """A cell announced itself (CELL_UP / heartbeat). Returns True
        when membership or health changed — the caller's cue to rebind
        parked docs. A draining/dead cell that re-announces heals."""
        return self._transition(cell_id, HEALTHY)

    def mark_draining(self, cell_id: str) -> bool:
        return self._transition(cell_id, DRAINING)

    def mark_dead(self, cell_id: str) -> bool:
        return self._transition(cell_id, DEAD)

    def remove_cell(self, cell_id: str) -> bool:
        if self.cells.pop(cell_id, None) is not None:
            self.epoch += 1
            return True
        return False

    def expire_stale(self) -> "list[str]":
        """Cells whose heartbeat went quiet past the timeout flip to
        dead (returned so the caller can trigger handoffs)."""
        now = time.monotonic()
        expired = [
            cell_id
            for cell_id, entry in self.cells.items()
            if entry["state"] == HEALTHY
            and now - entry["seen"] > self.heartbeat_timeout_s
        ]
        for cell_id in expired:
            self.mark_dead(cell_id)
        return expired

    def healthy_cells(self) -> "list[str]":
        return sorted(
            cell_id
            for cell_id, entry in self.cells.items()
            if entry["state"] == HEALTHY
        )

    def state_of(self, cell_id: str) -> "Optional[str]":
        entry = self.cells.get(cell_id)
        return entry["state"] if entry is not None else None

    # -- overrides -----------------------------------------------------------

    def set_override(self, doc_name: str, cell_id: str) -> None:
        self.overrides[doc_name] = cell_id
        self.epoch += 1

    def clear_override(self, doc_name: str) -> None:
        if self.overrides.pop(doc_name, None) is not None:
            self.epoch += 1

    def promote(self, doc_name: str, cell_id: str) -> None:
        """Follower → owner promotion (hot-doc replication): make
        `cell_id` the doc's owner and CLEAR any stale placement entry
        first — a stranded override naming the dead owner would shadow
        the promotion the moment that cell re-announced, re-splitting
        the doc across two owners. When the promoted cell is already
        the rendezvous winner no override is needed at all (the natural
        map IS the promotion); otherwise a fresh override pins it."""
        self.overrides.pop(doc_name, None)
        entry = self.cells.get(cell_id)
        if entry is not None and entry["state"] == HEALTHY:
            natural = self.route(doc_name)
            if natural != cell_id:
                self.overrides[doc_name] = cell_id
        self.epoch += 1

    # -- placement -----------------------------------------------------------

    @staticmethod
    def _score(doc_name: str, cell_id: str) -> int:
        digest = hashlib.blake2b(
            doc_name.encode() + b"\x00" + cell_id.encode(), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big")

    def route(self, doc_name: str) -> "Optional[str]":
        """The owning cell for `doc_name`, or None when no healthy cell
        exists (callers park the doc and rebind on the next CELL_UP).
        Override precedence: an override naming a HEALTHY cell wins;
        anything else (unknown cell, draining, dead) falls through to
        rendezvous so a stale pin degrades to correct placement."""
        override = self.overrides.get(doc_name)
        if override is not None:
            entry = self.cells.get(override)
            if entry is not None and entry["state"] == HEALTHY:
                return override
        cells = self.healthy_cells()
        if not cells:
            return None
        # deterministic tie-break on the id keeps the map stable across
        # processes even in the astronomically unlikely score collision
        return max(cells, key=lambda cell: (self._score(doc_name, cell), cell))

    def route_set(self, doc_name: str, followers: int) -> "list[str]":
        """Audience-aware placement (hot-doc replication): the owner
        plus up to `followers` follower cells, owner first, followers
        in rendezvous order. Override-aware — position 0 is always
        exactly `route(doc_name)`, so the replicated and unreplicated
        answers can never disagree about the owner. Followers inherit
        HRW's minimal-movement property: cell churn moves only the
        follower slots the churned cell occupied."""
        owner = self.route(doc_name)
        if owner is None:
            return []
        if followers <= 0:
            return [owner]
        ranked = sorted(
            self.healthy_cells(),
            key=lambda cell: (self._score(doc_name, cell), cell),
            reverse=True,
        )
        return [owner] + [c for c in ranked if c != owner][:followers]

    def table(self) -> dict:
        """The `/debug/edge` routing view."""
        return {
            "epoch": self.epoch,
            "cells": {
                cell_id: {
                    "state": entry["state"],
                    "since_s": round(time.monotonic() - entry["since"], 1),
                    "seen_s": round(time.monotonic() - entry["seen"], 1),
                }
                for cell_id, entry in sorted(self.cells.items())
            },
            "overrides": dict(sorted(self.overrides.items())),
        }
