"""Multi-device merge cells: one plane, lane and governor per device.

The port of the JAX package's `tpu/cells.py`. Documents never interact
(the doc axis is the data-parallel dimension), so a deployment scales
past one card by running one full merge cell per GPU:

- its own `MergePlane` on its device (`TpuMergeExtension(device=)`),
- its own `DeviceLane` (`get_device_lane(i)`): N cells are N independent
  dispatch queues, so a flush on cell 3 never waits behind a compaction
  sweep on cell 0,
- its own `BatchGovernor`, warm grid and residency clock.

**Placement.** A doc maps to a cell by rendezvous (HRW) hashing over the
healthy cells, plus an override table holding migrated docs: the same
hash, table and epochs as the JAX package's, so both place a name alike.

**Load-aware rebalancing.** A maintenance timer samples per-cell load
(dispatched work per doc, arena-row occupancy, lane queue depth, device
bytes). When one cell runs hot relative to its peers, docs migrate over
the evict-snapshot→hydrate rail (tpu/residency.py): the source cell
evicts (declining while anything is un-broadcast), the target adopts the
snapshot and hydrates through its admission queue, and a live-document
tail replay (known-clock dedup) closes the gap: no acknowledged update
is lost and no client sees a disconnect; during the window updates ride
the CPU fan-out like any degrade transient.

**Failure scope.** The plane supervisor (tpu/supervisor.py) probes each
cell's plane through that cell's lane and keeps one breaker per cell: a
late cell degrades its docs to the CPU path and drops out of placement
(`degrade_cell`) while the others keep serving; a passing half-open
probe restores the cell and re-onboards its docs. On the card an error
a cell raises stops the server instead (tpu/supervisor.py).

**Devices.** Cells run on the card unless the caller asks for the CPU
(`device="cpu"`): `devices` cells over the visible cards, wrapping when
there are fewer cards than cells, so one card holds several cells, each
with its own arena and lane. The C entries launch on the current device,
so every device touch this module adds (the migration snapshot's serve,
the hydration flush, the canary) runs inside the owning plane's
`device_scope()`.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
from typing import Any, Optional

from ..aio import spawn_tracked
from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge
from ..server.types import Extension, Payload
from .merge_plane import TpuMergeExtension


class DevicePlacement:
    """Doc → device-cell map: rendezvous hashing + an override table.

    The same placement discipline as the edge tier's `CellRouter`
    (edge/router.py), over cell indices instead of cell ids: adding or
    removing a healthy cell moves ~1/N of the population (all of it
    to/from that cell), an override (a migrated or operator-pinned doc)
    wins while its cell is healthy and falls through to rendezvous
    otherwise, and every change bumps `epoch` so observers can detect
    remaps cheaply."""

    def __init__(self, cells: int, salt: str = "cell") -> None:
        if cells < 1:
            raise ValueError("cells must be >= 1")
        self.cells = cells
        self.salt = salt
        self.healthy: "set[int]" = set(range(cells))
        self.overrides: "dict[str, int]" = {}
        self.epoch = 0

    def _score(self, doc_name: str, index: int) -> int:
        digest = hashlib.blake2b(
            doc_name.encode() + b"\x00" + f"{self.salt}-{index}".encode(),
            digest_size=8,
        ).digest()
        return int.from_bytes(digest, "big")

    def place(self, doc_name: str) -> int:
        """The owning cell index. Overrides naming a healthy cell win;
        anything else falls through to rendezvous over the healthy set
        (a stale pin degrades to correct placement, never a black
        hole). With NO healthy cell, rendezvous runs over all cells —
        hooks still need a deterministic owner, and the cell itself
        degrades the doc to the CPU path."""
        override = self.overrides.get(doc_name)
        if override is not None and override in self.healthy:
            return override
        alive = sorted(self.healthy) if self.healthy else list(range(self.cells))
        # deterministic tie-break on the index keeps the map stable in
        # the astronomically unlikely score collision
        return max(alive, key=lambda i: (self._score(doc_name, i), -i))

    def set_override(self, doc_name: str, index: int) -> None:
        if self.overrides.get(doc_name) != index:
            self.overrides[doc_name] = index
            self.epoch += 1

    def clear_override(self, doc_name: str) -> None:
        if self.overrides.pop(doc_name, None) is not None:
            self.epoch += 1

    def mark_down(self, index: int) -> None:
        if index in self.healthy:
            self.healthy.discard(index)
            self.epoch += 1

    def mark_up(self, index: int) -> None:
        if index not in self.healthy:
            self.healthy.add(index)
            self.epoch += 1

    def placement_hash(self) -> str:
        """Content hash of the live placement map (cell count, healthy
        set, overrides): two captures with equal hashes routed docs
        identically, so runs are attributable to a placement."""
        payload = {
            "cells": self.cells,
            "salt": self.salt,
            "healthy": sorted(self.healthy),
            "overrides": dict(sorted(self.overrides.items())),
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()

    def table(self) -> dict:
        return {
            "cells": self.cells,
            "epoch": self.epoch,
            "healthy": sorted(self.healthy),
            "overrides": dict(sorted(self.overrides.items())),
            "hash": self.placement_hash(),
        }


def plan_migrations(
    cell_work: "list[float]",
    doc_work: "list[dict[str, float]]",
    healthy: "set[int]",
    ratio: float = 2.0,
    min_excess: float = 1.0,
    batch: int = 8,
) -> "list[tuple[str, int, int]]":
    """Pure rebalance policy: which docs move where, from per-cell and
    per-doc work totals. Greedy: take the hottest cell past
    `ratio`×mean (and at least `min_excess` above it), move its
    heaviest docs to the currently-coldest cell — but only moves that
    IMPROVE the imbalance (a mega-doc heavier than everything else on
    its cell stays put; relocating it would just move the hotspot).
    Bounded at `batch` migrations per tick so a skewed storm rebalances
    incrementally instead of thrashing."""
    alive = sorted(healthy)
    if len(alive) < 2:
        return []
    work = {i: float(cell_work[i]) for i in alive}
    mean = sum(work.values()) / len(alive)
    moves: "list[tuple[str, int, int]]" = []
    for src in sorted(alive, key=lambda i: -work[i]):
        if len(moves) >= batch:
            break
        if work[src] <= ratio * mean or work[src] - mean < min_excess:
            continue
        for name, weight in sorted(
            doc_work[src].items(), key=lambda kv: (-kv[1], kv[0])
        ):
            if weight <= 0:
                continue
            dst = min(alive, key=lambda i: (work[i], i))
            if dst == src or work[dst] + weight >= work[src]:
                continue  # moving this doc would not improve the skew
            moves.append((name, src, dst))
            work[src] -= weight
            work[dst] += weight
            if len(moves) >= batch or work[src] - mean < min_excess:
                break
    return moves


class MultiDeviceMergeExtension(Extension):
    """Routes per-document hooks to one of N per-device merge cells.

    Each cell is a full serve-mode `TpuMergeExtension` pinned to its
    device with its own lane/governor/residency; this router owns only
    the placement map, the rebalance timer and the aggregate
    observability surface. Exposes the same runtime surface the
    supervisor and Metrics extension already speak (`planes()`,
    `servings()`, `degrade_all()`, `counters`, `shards` alias…), plus
    the per-cell seams the supervisor's per-device breakers drive
    (`cells`, `lanes()`, `degrade_cell`, `restore_cell`) and the
    warm-spare lifecycle (`park_cell`, `activate_cell`)."""

    priority = 900

    def __init__(
        self,
        devices: int = 0,
        rebalance_interval_s: float = 5.0,
        rebalance_ratio: float = 2.0,
        rebalance_min_units: float = 256.0,
        migrate_batch: int = 8,
        occupancy_watermark: float = 0.85,
        lane=None,
        device=None,
        **extension_kwargs: Any,
    ) -> None:
        """devices: cells to build (0 = one per visible device; a count
        above the roster wraps, so one card or the CPU still runs an
        N-cell plane). device: the roster's kind, None or "cuda" for the
        cards (raises without CUDA, before any cell is built), "cpu"
        for CPU cells. rebalance_interval_s <= 0
        disables the rebalancer (placement stays pure rendezvous).
        rebalance_ratio: a cell hotter than this multiple of the mean
        sheds docs. rebalance_min_units: ignore imbalances smaller than
        this many dispatched units (noise floor). migrate_batch: docs
        migrated per tick. occupancy_watermark: arena-row occupancy
        fraction that triggers a shed even when dispatched work looks
        balanced (row exhaustion retires docs — spread before that)."""
        from .sharding import enumerate_devices

        roster = enumerate_devices(devices, device)
        if not roster:
            raise RuntimeError("no device visible to the cell plane")
        self.devices = roster
        self.rebalance_interval_s = float(rebalance_interval_s)
        self.rebalance_ratio = max(float(rebalance_ratio), 1.0)
        self.rebalance_min_units = float(rebalance_min_units)
        self.migrate_batch = max(int(migrate_batch), 1)
        self.occupancy_watermark = float(occupancy_watermark)
        extension_kwargs.setdefault("serve", True)
        extension_kwargs.pop("phase_offset_ms", None)
        interval = float(extension_kwargs.get("flush_interval_ms", 5.0))
        n = len(roster)
        from .scheduler import get_device_lane

        self.cells: "list[TpuMergeExtension]" = [
            TpuMergeExtension(
                device=device,
                # one arbiter per cell, never lane 0 alone (that
                # serialization is what this plane ends); an explicit
                # lane= (tests) wins
                lane=get_device_lane(index) if lane is None else lane,
                # phase-stagger the host side: the cells are
                # independent, but N flush builds landing on one event
                # loop tick still contend for the loop and the executor
                phase_offset_ms=(index * interval / n if n > 1 else None),
                **extension_kwargs,
            )
            for index, device in enumerate(roster)
        ]
        # every cell needs a residency manager: it IS the migration
        # path (evict-snapshot → hydrate). Cells whose policy knobs are
        # all zero don't get one from TpuMergeExtension, so build a
        # policy-neutral manager (no auto-eviction, no compaction)
        # purely for the migration rail.
        from .residency import ResidencyManager

        for cell in self.cells:
            if cell.residency is None and cell.serve:
                cell.residency = ResidencyManager(cell)
        self.placement = DevicePlacement(n)
        self.migration_stats: "dict[str, int]" = {
            "docs_migrated": 0,
            "migrations_declined": 0,
            "rebalance_ticks": 0,
            "cell_degrades": 0,
            "cell_recoveries": 0,
            "cells_parked": 0,
            "cells_activated": 0,
        }
        # cells a `park_cell` is draining: no migration may land on one
        self._parking: "set[int]" = set()
        self._rebalance_handle: Optional[asyncio.TimerHandle] = None
        self._rebalance_inflight = False
        # set by cancel_timers/on_destroy: an in-flight tick must not
        # re-arm the timer after teardown (its finally-reschedule would
        # otherwise run rebalance over destroyed cells forever)
        self._rebalance_stopped = False
        self._instance = None
        self._tasks: set = set()
        # -- exposition (adopted by the Metrics extension) ---------------
        self.migrations_total = Counter(
            "hocuspocus_tpu_cell_migrations_total",
            "Docs migrated between device cells, by (from, to) cell index",
        )
        self.cell_docs_gauge = Gauge(
            "hocuspocus_tpu_cell_docs",
            "Plane-served docs per device cell",
        )
        self.cell_rows_gauge = Gauge(
            "hocuspocus_tpu_cell_rows_in_use",
            "Arena rows allocated per device cell",
        )
        self.cell_lane_depth_gauge = Gauge(
            "hocuspocus_tpu_cell_lane_queue_depth",
            "Device-lane waiters queued per device cell",
        )
        self.cell_pending_gauge = Gauge(
            "hocuspocus_tpu_cell_pending_ops",
            "Queued (undispatched) ops per device cell",
        )
        self.cell_hbm_gauge = Gauge(
            "hocuspocus_tpu_cell_hbm_bytes",
            "Device memory per cell: runtime HBM bytes-in-use where the "
            "backend reports them, else the plane's arena+staging bytes",
        )
        self.cell_work_gauge = Gauge(
            "hocuspocus_tpu_cell_work_units",
            "Cumulative insert units dispatched to each device cell",
        )
        self.placement_epoch_gauge = Gauge(
            "hocuspocus_tpu_cell_placement_epoch",
            "Placement-map epoch (bumps on overrides and health changes)",
            fn=lambda: self.placement.epoch,
        )

    # -- routing -------------------------------------------------------------

    def cell_index_for(self, document_name: str) -> int:
        """The cell that currently OWNS the doc (registered or served),
        falling back to placement. Owner-first matters mid-migration and
        across placement changes: a hook for a doc still living on its
        old cell must reach that cell, not the map's new answer."""
        for index, cell in enumerate(self.cells):
            if document_name in cell._docs or document_name in cell.plane.docs:
                return index
        index = self.placement.place(document_name)
        survivors = sorted(self.placement.healthy - self._parking)
        if index in self._parking and survivors:
            # a new load while its cell drains for a park goes where the
            # park would migrate it (the JAX package loads it onto the
            # draining cell, which then parks holding it)
            index = max(
                survivors,
                key=lambda i: (self.placement._score(document_name, i), -i),
            )
        return index

    def cell_for(self, document_name: str) -> TpuMergeExtension:
        return self.cells[self.cell_index_for(document_name)]

    def residency_for(self, document_name: str):
        """The owning cell's ResidencyManager, or None when residency is
        off. Hot-doc replication (edge/replica.py) snapshots an owner's
        doc (`replica_snapshot`, no evict) and seeds a follower's arena
        (`adopt_snapshot` + `request_hydration`) through this handle —
        the same rail cross-cell migration rides."""
        return self.cell_for(document_name).plane.residency

    # -- lifecycle hooks (broadcast) -----------------------------------------

    async def on_listen(self, data: Payload) -> None:
        self._instance = data.instance
        self._rebalance_stopped = False
        for cell in self.cells:
            await cell.on_listen(data)
        self._schedule_rebalance()

    async def on_destroy(self, data: Payload) -> None:
        self._rebalance_stopped = True
        if self._rebalance_handle is not None:
            self._rebalance_handle.cancel()
            self._rebalance_handle = None
        for cell in self.cells:
            await cell.on_destroy(data)

    # -- per-document hooks (routed) -----------------------------------------

    async def after_load_document(self, data: Payload) -> None:
        self._instance = data.instance
        await self.cell_for(data.document_name).after_load_document(data)

    async def on_change(self, data: Payload) -> None:
        await self.cell_for(data.document_name).on_change(data)

    async def after_unload_document(self, data: Payload) -> None:
        name = data.document_name
        await self.cell_for(name).after_unload_document(data)
        # a fully unloaded doc sheds its migration override: the next
        # load places by pure rendezvous again (minimal-movement map)
        if not self.is_served(name) and all(
            name not in cell.plane.docs for cell in self.cells
        ):
            self.placement.clear_override(name)

    # -- supervisor surface (tpu/supervisor.py) ------------------------------

    def planes(self) -> list:
        return [cell.plane for cell in self.cells]

    def servings(self) -> list:
        return [
            cell.serving for cell in self.cells if cell.serving is not None
        ]

    def lanes(self) -> list:
        return [cell.lane for cell in self.cells if cell.lane is not None]

    def degrade_all(self) -> None:
        for cell in self.cells:
            cell.degrade_all()

    def cancel_timers(self) -> None:
        self._rebalance_stopped = True
        if self._rebalance_handle is not None:
            self._rebalance_handle.cancel()
            self._rebalance_handle = None
        for cell in self.cells:
            cell.cancel_timers()

    async def reonboard(self, document, instance=None) -> None:
        await self.cell_for(document.name).reonboard(document, instance)

    def is_served(self, document_name: str) -> bool:
        return any(document_name in cell._docs for cell in self.cells)

    def served_docs(self) -> int:
        return sum(len(cell._docs) for cell in self.cells)

    def pending_ops(self) -> int:
        return sum(cell.plane.pending_ops() for cell in self.cells)

    # -- per-cell failure scope (driven by the supervisor's breakers) --------

    def degrade_cell(self, index: int) -> None:
        """One late cell degrades ITS docs, not the plane: pause + abort
        that cell's serving, park its lane, drop it out of placement
        (new loads route to the survivors) and drain its served docs to
        the CPU path with the usual full-state fallback broadcast."""
        cell = self.cells[index]
        for serving in cell.servings():
            serving.paused = True
            serving.abort_pending()
        if cell.lane is not None:
            cell.lane.pause()
        self.placement.mark_down(index)
        self.migration_stats["cell_degrades"] += 1
        get_flight_recorder().record(
            "__plane__", "cell_degraded", cell=index, device=self.device_label(index)
        )
        cell.degrade_all()

    async def restore_cell(self, index: int, instance=None) -> None:
        """A half-open probe passed: resume the cell's lane + serving,
        rejoin placement, and re-onboard the live docs that place onto
        this cell (they degraded to CPU at trip time). A re-onboard that
        raises on a card cell propagates (the supervisor stops the
        server); on a CPU cell the doc stays on the CPU path."""
        cell = self.cells[index]
        if cell.lane is not None:
            cell.lane.resume()
        for serving in cell.servings():
            serving.paused = False
        self.placement.mark_up(index)
        self.migration_stats["cell_recoveries"] += 1
        get_flight_recorder().record(
            "__plane__", "cell_restored", cell=index, device=self.device_label(index)
        )
        instance = instance if instance is not None else self._instance
        if instance is None:
            return
        for name, document in list(instance.documents.items()):
            if self.is_served(name):
                continue
            if self.placement.place(name) != index:
                continue
            try:
                await cell.reonboard(document, instance)
            except Exception:
                if cell.plane.device.type == "cuda":
                    raise
                from ..server import logger as _logger_mod

                _logger_mod.log_error(
                    f"cell {index} re-onboard failed for {name!r}; "
                    "doc stays on the CPU path"
                )

    # -- elastic-fleet warm-spare lifecycle (fleet/controller.py) ------------

    async def park_cell(self, index: int) -> dict:
        """Scale-down to a WARM SPARE: migrate every served doc off the
        cell over the evict-snapshot→hydrate rail, then drop it out of
        placement. Ordering is the placement-epoch-safety contract:
        each migration lands its override (its own epoch bump) while
        the source is still healthy, so no epoch ever routes a doc at a
        cell that still owns it. Unlike `degrade_cell` (the late-cell
        path), nothing is torn down — the arena stays allocated, the
        registry warm, the lane merely quiesced — so `activate_cell`
        rejoins in one epoch bump with zero rebuild cost."""
        cell = self.cells[index]
        migrated = declined = 0
        # while it drains nothing may land here: the rebalancer's plan
        # and placement still count the cell healthy (the JAX package
        # lets such a move or a new load in, and the doc stays on the
        # parked cell); `migrate_doc` and `cell_index_for` read this
        self._parking.add(index)
        try:
            for name in list(cell._docs):
                survivors = sorted(self.placement.healthy - {index})
                if not survivors:
                    declined += len(cell._docs)
                    break
                # rendezvous over the survivors — the same score the map
                # will compute once this cell is gone, minus the override
                dst = max(
                    survivors,
                    key=lambda i: (self.placement._score(name, i), -i),
                )
                if await self.migrate_doc(name, index, dst):
                    migrated += 1
                else:
                    declined += 1
            self.placement.mark_down(index)
        finally:
            self._parking.discard(index)
        drained = not cell._docs
        if drained:
            # fully drained: quiesce the serving loop — a warm spare
            # burns no flush ticks. Stragglers (declined migrations)
            # keep their serving live; owner-first routing still finds
            # them and the controller can retry the park next tick.
            for serving in cell.servings():
                serving.paused = True
        if cell.residency is not None:
            # warm-spare residency path: drop queued background work
            # (hydrations/compactions for docs that just left) so the
            # spare holds nothing but its warm arena
            quiesce = getattr(cell.residency, "quiesce", None)
            if quiesce is not None:
                quiesce()
        self.migration_stats["cells_parked"] += 1
        get_flight_recorder().record(
            "__plane__",
            "cell_parked",
            cell=index,
            device=self.device_label(index),
            migrated=migrated,
            declined=declined,
        )
        return {
            "cell": index,
            "migrated": migrated,
            "declined": declined,
            "drained": drained,
        }

    async def activate_cell(self, index: int, instance=None) -> None:
        """Scale-up from a warm spare: rejoin placement (one epoch
        bump — rendezvous immediately routes ~1/N of new loads here)
        and resume the quiesced serving/lane. Existing docs stay where
        they are; the rebalancer drifts them over as load justifies."""
        await self.restore_cell(index, instance)
        self.migration_stats["cells_activated"] += 1
        get_flight_recorder().record(
            "__plane__",
            "cell_activated",
            cell=index,
            device=self.device_label(index),
        )

    def device_label(self, index: int) -> str:
        """The cell's device index (`cuda:i` -> "i"); the cell index for
        a CPU cell."""
        device = self.devices[index]
        return str(index if device.index is None else device.index)

    # -- load sampling + rebalancing -----------------------------------------

    def _doc_loads(
        self, cell: TpuMergeExtension
    ) -> "tuple[dict[str, float], dict[str, float]]":
        """Per-doc load on one cell, two attributions: cumulative WORK
        (insert units dispatched to the device — the mega-doc signal —
        plus queued undispatched ops) and ROWS held (what migration
        frees when occupancy/HBM is the hot signal). O(served docs)
        dict walks — the rebalance tick's budget, not the capture or
        scrape path's."""
        plane = cell.plane
        work: "dict[str, float]" = {}
        rows: "dict[str, float]" = {}
        for name in cell._docs:
            doc = plane.docs.get(name)
            if doc is None or doc.retired:
                continue
            slots = set(doc.seqs.values())
            if doc.lane_slot is not None:
                slots.add(doc.lane_slot)
            total = 1.0  # every served doc carries a floor weight
            for slot in slots:
                total += float(plane.dispatched_units[slot])
                queue = plane.queues.get(slot)
                if queue:
                    total += len(queue)
            work[name] = total
            rows[name] = float(max(len(slots), 1))
        return work, rows

    def _cell_hbm_bytes(self, index: int) -> int:
        """Device bytes for the cell: `torch.cuda.memory_allocated` of a
        card cell's device (passed explicitly), else the plane's own
        arena+staging accounting. Cells wrapped onto one card all read
        that card's total, as the JAX package's cells wrapped onto one
        device do."""
        device = self.devices[index]
        if device.type == "cuda":
            import torch

            return int(torch.cuda.memory_allocated(device))
        memory = self.cells[index].plane.memory_stats()
        return int(memory["arena_bytes"]) + int(memory["staging_bytes"])

    def cell_stats(self, include_doc_loads: bool = False) -> "list[dict]":
        """Per-device load snapshot: the /debug/scheduler + metrics
        surface, and (with include_doc_loads — the rebalance tick's
        policy input) the per-doc work/row attributions. The default
        form is aggregate-only: a 15s Prometheus scrape must not walk
        every served doc at the 100k-doc design point (the vectorized
        dispatched-units sum reads one array)."""
        stats = []
        for index, cell in enumerate(self.cells):
            plane = cell.plane
            lane_depth = 0
            if cell.lane is not None:
                lane_depth = sum(cell.lane.queue_depths())
            pending = plane.pending_ops()
            if include_doc_loads:
                doc_work, doc_rows = self._doc_loads(cell)
                work = round(sum(doc_work.values()), 1)
            else:
                doc_work = doc_rows = None
                # aggregate proxy of the per-doc sum: dispatched units
                # over all rows + queued ops + the per-doc floor weight
                work = round(
                    float(plane.dispatched_units.sum())
                    + pending
                    + len(cell._docs),
                    1,
                )
            entry = {
                "cell": index,
                "device": self.device_label(index),
                "healthy": index in self.placement.healthy,
                "docs": len(cell._docs),
                "rows_in_use": plane.num_docs - len(plane.free),
                "occupancy": round(
                    (plane.num_docs - len(plane.free))
                    / max(plane.num_docs, 1),
                    4,
                ),
                "pending_ops": pending,
                "lane_queue_depth": lane_depth,
                "work_units": work,
                # monotonic, migration-invariant (hydration never
                # credits it): what the autoscaler diffs for a rate
                "dispatched_total": int(getattr(plane, "dispatched_total", 0)),
                "hbm_bytes": self._cell_hbm_bytes(index),
            }
            if include_doc_loads:
                entry["doc_work"] = doc_work
                entry["doc_rows"] = doc_rows
            stats.append(entry)
        return stats

    def _wants_rebalance(self, stats: "list[dict]") -> bool:
        """Any hot signal relative to the healthy peers: dispatched
        work, arena occupancy past the watermark, lane queue depth, or
        device bytes (where the runtime reports real per-card numbers)."""
        alive = [s for s in stats if s["healthy"]]
        if len(alive) < 2:
            return False
        for key, floor in (
            ("work_units", self.rebalance_min_units),
            ("lane_queue_depth", 4.0),
            ("hbm_bytes", 1.0),
        ):
            values = [float(s[key]) for s in alive]
            mean = sum(values) / len(values)
            if mean <= 0:
                continue
            if max(values) > self.rebalance_ratio * mean and (
                max(values) - mean >= floor
            ):
                return True
        return any(
            s["occupancy"] >= self.occupancy_watermark for s in alive
        )

    @staticmethod
    def _signal_skew(stats: "list[dict]", key: str) -> float:
        values = [float(s[key]) for s in stats if s["healthy"]]
        if not values:
            return 0.0
        mean = sum(values) / len(values)
        return max(values) / mean if mean > 0 else 0.0

    def rebalance_plan(
        self, stats: "Optional[list[dict]]" = None
    ) -> "list[tuple[str, int, int]]":
        """The tick's migration plan (pure given `stats`; tests drive
        it directly with synthetic snapshots).

        Two attribution modes, chosen by which signal is actually hot:
        **work mode** (dispatched-unit skew — the mega-doc case) moves
        docs by cumulative work; **rows mode** (occupancy past the
        watermark, HBM or lane-depth skew while work looks balanced)
        moves docs by the arena rows they hold — freeing rows/HBM on
        the hot cell is what those signals need, and dispatched work
        says nothing about it."""
        if stats is None:
            stats = self.cell_stats(include_doc_loads=True)
        if not self._wants_rebalance(stats):
            return []
        work_skew = self._signal_skew(stats, "work_units")
        rows_skew = self._signal_skew(stats, "rows_in_use")
        occupancy_hot = any(
            s["occupancy"] >= self.occupancy_watermark
            for s in stats
            if s["healthy"]
        )
        if (occupancy_hot and rows_skew > 1.0) or rows_skew > work_skew:
            cell_load = [float(s["rows_in_use"]) for s in stats]
            doc_load = [s.get("doc_rows") or {} for s in stats]
            min_excess = 2.0  # rows, not units
        else:
            cell_load = [float(s["work_units"]) for s in stats]
            doc_load = [s.get("doc_work") or {} for s in stats]
            min_excess = self.rebalance_min_units
        return plan_migrations(
            cell_load,
            doc_load,
            self.placement.healthy,
            ratio=self.rebalance_ratio,
            min_excess=min_excess,
            batch=self.migrate_batch,
        )

    async def migrate_doc(self, name: str, src: int, dst: int) -> bool:
        """Move one doc between cells via the evict-snapshot→hydrate
        rail (tpu/residency.py): zero acked-update loss — the eviction
        declines while anything is un-broadcast, the snapshot is the
        serving path's own byte stream, and the target's hydration
        replays the live-document tail on top — and no client-visible
        disconnect: sockets never move, updates ride the CPU fan-out
        during the window exactly like any degrade transient."""
        source, target = self.cells[src], self.cells[dst]
        document = source._docs.get(name)
        if document is None or source.residency is None or target.residency is None:
            return False
        # a target being parked, or out of placement since the plan was
        # made, takes nothing: the doc stays where it is
        closed = lambda: dst in self._parking or dst not in self.placement.healthy  # noqa: E731
        if closed():
            self.migration_stats["migrations_declined"] += 1
            return False
        # background-class admission on the SOURCE cell: the eviction
        # snapshot may flush pending ops through the serving path — a
        # device dispatch like any other, and it must never bypass the
        # lane or displace interactive work
        ticket = await source.residency._admit_background("migrate")
        if ticket is False or closed():
            if ticket is not None and ticket is not False:
                ticket.release()
            self.migration_stats["migrations_declined"] += 1
            return False
        try:
            snapshot = await source.residency.evict_for_migration(name, document)
        finally:
            if ticket is not None:
                ticket.release()
        if snapshot is None:
            self.migration_stats["migrations_declined"] += 1
            return False
        self.placement.set_override(name, dst)
        target.residency.adopt_snapshot(name, snapshot)
        target.residency.request_hydration(name, document)
        self.migration_stats["docs_migrated"] += 1
        self.migrations_total.inc(**{"from": str(src), "to": str(dst)})
        get_flight_recorder().record(
            name, "doc_migrated", src=src, dst=dst, bytes=len(snapshot)
        )
        return True

    async def _rebalance_tick(self) -> None:
        self.migration_stats["rebalance_ticks"] += 1
        # brownout ladder: rebalancing is exactly the deferrable
        # background device work BROWNOUT-1 parks first
        from ..server.overload import get_overload_controller

        if not get_overload_controller().maintenance_allowed():
            return
        for name, src, dst in self.rebalance_plan():
            await self.migrate_doc(name, src, dst)

    def _schedule_rebalance(self) -> None:
        if (
            self._rebalance_stopped
            or self.rebalance_interval_s <= 0
            or self._rebalance_handle is not None
        ):
            return

        def fire() -> None:
            self._rebalance_handle = None
            if self._rebalance_inflight:
                self._schedule_rebalance()
                return
            self._rebalance_inflight = True

            async def tick() -> None:
                try:
                    await self._rebalance_tick()
                except Exception:
                    from ..server import logger as _logger_mod

                    _logger_mod.log_error("cell rebalance tick failed (continuing)")
                finally:
                    self._rebalance_inflight = False
                    self._schedule_rebalance()

            spawn_tracked(self._tasks, tick())

        self._rebalance_handle = asyncio.get_event_loop().call_later(
            self.rebalance_interval_s, fire
        )

    # -- aggregate observability ---------------------------------------------

    @property
    def shards(self) -> "list[TpuMergeExtension]":
        """Shard-compatible view: the Metrics extension's summed plane
        gauges and the loadgen harness speak the sharded router's
        `.shards` surface: cells are shards whose arenas may live on
        different devices."""
        return self.cells

    @property
    def counters(self) -> dict:
        total: dict = {}
        for cell in self.cells:
            for key, value in cell.plane.counters.items():
                total[key] = total.get(key, 0) + value
        return total

    def cell_metrics(self) -> tuple:
        """Metric objects for MetricsRegistry.register adoption (the
        Metrics extension refreshes the labelled series per scrape via
        refresh_cell_metrics)."""
        return (
            self.migrations_total,
            self.cell_docs_gauge,
            self.cell_rows_gauge,
            self.cell_lane_depth_gauge,
            self.cell_pending_gauge,
            self.cell_hbm_gauge,
            self.cell_work_gauge,
            self.placement_epoch_gauge,
        )

    def refresh_cell_metrics(self) -> None:
        """Re-label the per-device gauges from a fresh load snapshot
        (called at scrape time by the Metrics extension)."""
        for stat in self.cell_stats():
            labels = {"device": stat["device"], "cell": str(stat["cell"])}
            self.cell_docs_gauge.set(stat["docs"], **labels)
            self.cell_rows_gauge.set(stat["rows_in_use"], **labels)
            self.cell_lane_depth_gauge.set(stat["lane_queue_depth"], **labels)
            self.cell_pending_gauge.set(stat["pending_ops"], **labels)
            self.cell_hbm_gauge.set(stat["hbm_bytes"], **labels)
            self.cell_work_gauge.set(stat["work_units"], **labels)

    def scheduler_snapshot(self) -> dict:
        """`/debug/scheduler`: one section per device (lane + governor +
        load), plus the placement map and migration accounting."""
        per_device = []
        for index, cell in enumerate(self.cells):
            plane = cell.plane
            per_device.append(
                {
                    "cell": index,
                    "device": self.device_label(index),
                    "healthy": index in self.placement.healthy,
                    "lane": None if cell.lane is None else cell.lane.snapshot(),
                    "governor": (
                        None if cell.governor is None else cell.governor.snapshot()
                    ),
                    "phase_offset_ms": cell.phase_offset_ms,
                    "docs": len(cell._docs),
                    "rows_in_use": plane.num_docs - len(plane.free),
                    "pending_ops": plane.pending_ops(),
                }
            )
        return {
            "devices": per_device,
            "placement": self.placement.table(),
            "migrations": dict(self.migration_stats),
            "rebalance": {
                "interval_s": self.rebalance_interval_s,
                "ratio": self.rebalance_ratio,
                "min_units": self.rebalance_min_units,
                "batch": self.migrate_batch,
                "occupancy_watermark": self.occupancy_watermark,
            },
        }

    def per_device_latency(self) -> "list[dict]":
        """Per-device latency evidence for run artifacts: each cell's
        interactive lane-wait p99 and last flush cycle's device-side
        stage times."""
        out = []
        for index, cell in enumerate(self.cells):
            wait_p99 = None
            if cell.lane is not None and cell.lane.wait_seconds.series_count(
                **{"class": "interactive"}
            ):
                wait_p99 = round(
                    cell.lane.wait_seconds.quantile(0.99, **{"class": "interactive"})
                    * 1000.0,
                    3,
                )
            stats = cell.plane.flush_stats
            out.append(
                {
                    "cell": index,
                    "device": self.device_label(index),
                    "lane_interactive_wait_p99_ms": wait_p99,
                    "flush_device_sync_ms": stats["device_sync_ms"],
                    "flush_dispatch_ms": stats["dispatch_ms"],
                    "flush_batches": stats["batches"],
                    "flush_batch_shape": [stats["batch_k"], stats["batch_b"]],
                }
            )
        return out

    def utilization_spread(self) -> dict:
        """Per-device doc/work spread for run artifacts: max/mean doc
        and work ratios over the healthy cells (the multi_device_storm
        scenario records these in extra)."""
        stats = [s for s in self.cell_stats() if s["healthy"]]
        if not stats:
            return {"docs_max_over_mean": None, "work_max_over_mean": None}
        docs = [s["docs"] for s in stats]
        work = [s["work_units"] for s in stats]

        def ratio(values):
            mean = sum(values) / len(values)
            return None if mean <= 0 else round(max(values) / mean, 3)

        return {
            "docs_per_device": docs,
            "work_per_device": work,
            "docs_max_over_mean": ratio(docs),
            "work_max_over_mean": ratio(work),
        }
