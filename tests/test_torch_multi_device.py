"""The port's multi-device merge cells (tpu/cells.py) against the JAX package's.

Twins of tests/tpu/test_multi_device.py and of the park/activate test of
tests/fleet/test_warm_spare.py, with the port's cells on the CPU
(`device="cpu"`). What is deterministic runs through both packages and
must be equal: placement tables and hashes, migration plans, the flags,
the scenario, and the served bytes of a scripted workload (also equal to
a single plane's). What depends on a live server's timing (a migration
under concurrent edits, the rebalancer spreading a hot cell, the
supervisor's per-cell breakers, the scrape endpoints, the warm-spare
park) runs the port's body. The port-only tests hold its own rules: a
late canary trips only its cell, a raised cell canary on a plane marked
as on the card stops the server, the device roster wraps as the JAX
package's does, and every device touch the cells add runs inside the
owning plane's `device_scope()`. Every wait polls with a deadline.
"""

import asyncio
import contextlib
import json
import threading
import time

import pytest
import torch

import hocuspocus_tpu.tpu.cells as jax_cells
from hocuspocus_tpu.crdt import apply_update as jax_apply_update
from hocuspocus_tpu.tpu.scheduler import reset_device_lane as jax_reset_lanes
from hocuspocus_tpu_torch.crdt import Doc, apply_update
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu import MultiDeviceMergeExtension, TpuMergeExtension
from hocuspocus_tpu_torch.tpu import cells as port_cells
from hocuspocus_tpu_torch.tpu.scheduler import DeviceLane, reset_device_lane
from hocuspocus_tpu_torch.tpu.sharding import enumerate_devices
from hocuspocus_tpu_torch.tpu.supervisor import (
    STATE_BROKEN,
    STATE_READY,
    PlaneSupervisor,
    SupervisedTpuMergeExtension,
)
from tests.test_torch_server import Served, _assert, until
from tests.tpu.test_scheduler import _ServedDoc as JaxServedDoc
from tests.tpu.test_scheduler import _scripted_workload

CELLS = {"jax": jax_cells, "port": port_cells}


@pytest.fixture(autouse=True)
def _fresh_lanes():
    """Per-device lanes are process-global (`get_device_lane(i)`): one
    test's dispatches must not reach the next test's lane accounting."""
    reset_device_lane()
    jax_reset_lanes()
    yield
    reset_device_lane()
    jax_reset_lanes()


def _cells_ext(package="port", devices=4, **kwargs):
    kwargs.setdefault("num_docs", 16)
    kwargs.setdefault("capacity", 2048)
    kwargs.setdefault("flush_interval_ms", 1)
    kwargs.setdefault("rebalance_interval_s", 0)  # tests tick manually
    if package == "port":
        kwargs.setdefault("device", "cpu")
    return CELLS[package].MultiDeviceMergeExtension(devices=devices, **kwargs)


# -- placement ----------------------------------------------------------------


def _placement_story(module) -> list:
    """The JAX test's placement body, recording every answer."""
    placement = module.DevicePlacement(8)
    names = [f"doc-{i}" for i in range(400)]
    owners = {name: placement.place(name) for name in names}
    counts = [0] * 8
    for owner in owners.values():
        counts[owner] += 1
    assert max(counts) < 2 * len(names) / 8 and min(counts) > 0, counts
    seen = [owners, placement.table()]
    placement.mark_down(3)
    moved = {n for n in names if placement.place(n) != owners[n]}
    assert moved == {n for n, o in owners.items() if o == 3}
    assert all(placement.place(n) != 3 for n in moved)
    seen.append(placement.table())
    placement.mark_up(3)
    assert all(placement.place(n) == owners[n] for n in names)
    placement.set_override("doc-0", 5)
    assert placement.place("doc-0") == 5
    seen.append(placement.table())
    placement.mark_down(5)
    assert placement.place("doc-0") == owners["doc-0"]
    placement.mark_up(5)
    before = placement.placement_hash()
    placement.clear_override("doc-0")
    assert placement.placement_hash() != before
    seen += [before, placement.table(), placement.epoch]
    return seen


def test_placement_spreads_docs_and_moves_minimally():
    assert _placement_story(port_cells) == _placement_story(jax_cells)


def _projected(cell_work, moves, doc_work):
    work = [float(w) for w in cell_work]
    for name, src, dst in moves:
        work[src] -= doc_work[src][name]
        work[dst] += doc_work[src][name]
    return work


def test_plan_migrations_moves_small_docs_not_an_unimprovable_mega():
    doc_work = [
        {"mega": 5000.0, "s1": 60.0, "s2": 50.0, "s3": 40.0},
        {"a": 300.0},
        {"b": 250.0},
        {"c": 280.0},
    ]
    cell_work = [sum(w.values()) for w in doc_work]
    plans = {
        name: module.plan_migrations(
            cell_work, doc_work, healthy={0, 1, 2, 3}, ratio=1.5, min_excess=10.0, batch=8
        )
        for name, module in CELLS.items()
    }
    moves = plans["port"]
    assert moves == plans["jax"] and moves
    assert {name for name, _s, _d in moves} <= {"s1", "s2", "s3"}
    assert all(src == 0 for _n, src, _d in moves)
    assert max(_projected(cell_work, moves, doc_work)) <= max(cell_work)


def test_plan_migrations_spreads_stacked_hot_docs():
    doc_work = [{"hot-a": 1000.0, "hot-b": 900.0}, {"x": 10.0}, {"y": 5.0}]
    cell_work = [1900.0, 10.0, 5.0]
    plans = {
        name: module.plan_migrations(
            cell_work, doc_work, healthy={0, 1, 2}, ratio=1.2, min_excess=10.0, batch=4
        )
        for name, module in CELLS.items()
    }
    moves = plans["port"]
    assert moves == plans["jax"]
    assert {"hot-a", "hot-b"} & {name for name, _s, _d in moves}, moves
    projected = _projected(cell_work, moves, doc_work)
    assert max(projected) < max(cell_work) and max(projected) <= 1100.0, projected


def _occupancy_stats() -> list:
    stats = []
    for i in range(4):
        hot = i == 0
        stats.append({
            "cell": i, "device": str(i), "healthy": True,
            "docs": 8 if hot else 2, "rows_in_use": 14 if hot else 2,
            "occupancy": 0.875 if hot else 0.125, "pending_ops": 0,
            "lane_queue_depth": 0, "work_units": 100.0, "hbm_bytes": 1000,
            "doc_work": {f"d{i}-{j}": 12.5 for j in range(8 if hot else 2)},
            "doc_rows": {f"d{i}-{j}": (2.0 if hot else 1.0) for j in range(8 if hot else 2)},
        })
    return stats


def test_rebalance_plan_sheds_rows_when_occupancy_is_the_hot_signal():
    plans = {}
    for package in CELLS:
        ext = _cells_ext(package, devices=4, num_docs=16)
        try:
            plans[package] = ext.rebalance_plan(_occupancy_stats())
        finally:
            ext.cancel_timers()
    moves = plans["port"]
    assert moves == plans["jax"] and moves
    assert all(src == 0 for _n, src, _d in moves)


async def test_rebalance_timer_never_rearms_after_teardown():
    for package in CELLS:
        ext = _cells_ext(package, devices=2, num_docs=8, rebalance_interval_s=0.01)
        ext._schedule_rebalance()
        assert ext._rebalance_handle is not None, package
        ext.cancel_timers()
        assert ext._rebalance_handle is None, package
        ext._schedule_rebalance()  # what an in-flight tick's finally does
        assert ext._rebalance_handle is None, package


# -- the devices and lanes ----------------------------------------------------


def test_cells_pin_arenas_to_distinct_devices():
    """One lane per cell, each plane on its roster device, and a flush
    keeps the state there; the text equals the JAX cell's."""
    ext = _cells_ext(devices=8, num_docs=8, capacity=256)
    twin = _cells_ext("jax", devices=8, num_docs=8, capacity=256)
    try:
        assert len({id(cell.lane) for cell in ext.cells}) == 8, "one arbiter per cell"
        for i, cell in enumerate(ext.cells):
            assert cell.plane.device == ext.devices[i] == torch.device("cpu")
            assert cell.plane.state.id_client.device == ext.devices[i]
            assert cell.phase_offset_ms == i * 1 / 8
        source = Doc()
        source.get_text("t").insert(0, "pinned")
        from hocuspocus_tpu_torch.crdt import encode_state_as_update

        update = encode_state_as_update(source)
        texts = []
        for cells in (ext, twin):
            cell = cells.cells[5]
            cell.plane.register("pin-doc")
            cell.plane.enqueue_update("pin-doc", update)
            cell.plane.flush(None)
            texts.append(cell.plane.text("pin-doc"))
        assert ext.cells[5].plane.state.id_client.device == ext.devices[5]
        assert texts == ["pinned", "pinned"]
        assert ext.scheduler_snapshot()["devices"][5]["phase_offset_ms"] == 5 / 8
    finally:
        ext.cancel_timers()
        twin.cancel_timers()


def test_enumerate_devices_wraps_as_the_jax_package_does(monkeypatch):
    """The roster's index pattern equals the JAX package's over its eight
    forced-host devices: 0 = every device, fewer = the first, more wrap."""
    import jax

    from hocuspocus_tpu.tpu.sharding import enumerate_devices as jax_enumerate

    assert len(jax.local_devices()) == 8  # tests/conftest.py's forced-host mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for count in (0, 1, 3, 8, 12, 20):
        port = [device.index for device in enumerate_devices(count)]
        assert port == [device.id for device in jax_enumerate(count)], count
        assert all(device.type == "cuda" for device in enumerate_devices(count))
    assert enumerate_devices(5, "cpu") == [torch.device("cpu")] * 5
    assert enumerate_devices(0, "cpu") == [torch.device("cpu")]


def test_cells_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(port_cells, "TpuMergeExtension", lambda **kw: built.append(kw))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        MultiDeviceMergeExtension(devices=2, serve=True)
    assert built == []  # it raised before any cell was built


# -- multi vs single differential ---------------------------------------------


class _ServedDoc(Doc):
    """The port's twin of the JAX test's server-document double."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = name
        self.sync_source = None
        self.broadcast_source = None
        self.broadcast_frames: list = []

    def get_connections_count(self) -> int:
        return 1

    def queue_broadcast(self, update: bytes, on_complete=None) -> None:
        self.broadcast_frames.append(update)
        if on_complete is not None:
            on_complete(time.perf_counter())

    def broadcast_update_frame(self, update: bytes) -> None:
        self.broadcast_frames.append(update)


async def _run_workload(exts, doc_cls, apply, names, updates, payload=Payload):
    """Load every doc on its cell (or the one plane), capture every
    update through the owning cell's seam, drain and close the window."""
    docs = {}
    for name in names:
        docs[name] = doc_cls(name)
        await exts.after_load_document(payload(instance=None, document_name=name, document=docs[name]))
    cell_for = getattr(exts, "cell_for", lambda _name: exts)
    for i, (name, update) in enumerate(updates):
        apply(docs[name], update)
        assert cell_for(name).try_capture(docs[name], update, origin=None), f"update {i} fell off"
        if i % 7 == 0:
            await asyncio.sleep(0.002)
    for cell in getattr(exts, "cells", [exts]):
        await cell._flush_now(max_batches=None, final=True)
        cell._broadcast_served(cross_instance=False)
    return docs


async def test_multi_device_state_matches_single_device_plane():
    """The same scripted workload through the port's 8 cells, the JAX
    package's 8 cells and the port's single plane serves the same bytes
    for every doc, and the work spread over several cells."""
    from hocuspocus_tpu.server.types import Payload as JaxPayload

    names, updates, sources = _scripted_workload(seed=11, docs=6, edits=80)
    multi = _cells_ext(devices=8, num_docs=8, capacity=2048, native_lane=False)
    twin = _cells_ext("jax", devices=8, num_docs=8, capacity=2048, native_lane=False)
    single = TpuMergeExtension(serve=True, num_docs=16, capacity=2048, flush_interval_ms=1,
                               lane=DeviceLane(), native_lane=False, device="cpu")
    try:
        docs_multi = await _run_workload(multi, _ServedDoc, apply_update, names, updates)
        docs_twin = await _run_workload(twin, JaxServedDoc, jax_apply_update, names, updates,
                                        payload=JaxPayload)
        docs_single = await _run_workload(single, _ServedDoc, apply_update, names, updates)
        for name in names:
            want = sources[name].get_text("t").to_string()
            assert multi.cell_for(name).plane.text(name) == want == single.plane.text(name)
            assert multi.cell_index_for(name) == twin.cell_index_for(name)
            served = multi.cell_for(name).serving.encode_state_as_update(name, docs_multi[name])
            assert served is not None
            assert served == twin.cell_for(name).serving.encode_state_as_update(name, docs_twin[name])
            assert served == single.serving.encode_state_as_update(name, docs_single[name])
        assert sum(len(cell.plane.docs) > 0 for cell in multi.cells) > 1
        assert multi.placement.placement_hash() == twin.placement.placement_hash()
    finally:
        multi.cancel_timers()
        twin.cancel_timers()
        single.cancel_timers()


# -- migration under live traffic ---------------------------------------------


async def test_migration_under_concurrent_edits_loses_nothing():
    """A doc migrates between cells while its writer edits: every
    acknowledged update survives, neither client sees a close, and the
    target cell serves the doc."""
    ext = _cells_ext(devices=4)
    async with Served(ext) as served:
        a, b = served.provider("mig-doc"), served.provider("mig-doc")
        closes = []
        for p in (a, b):
            p.on("close", lambda *_a, **_k: closes.append(1))
        await served.synced(a, b)
        src = ext.cell_index_for("mig-doc")
        a.document.get_text("t").insert(0, "before;")
        await until(lambda: _assert(b.document.get_text("t").to_string() == "before;"))
        dst = (src + 1) % len(ext.cells)

        async def edits():
            for i in range(20):
                a.document.get_text("t").insert(0, f"e{i};")
                await asyncio.sleep(0.002)

        edit_task = asyncio.ensure_future(edits())
        moved = False
        for _ in range(100):
            if await ext.migrate_doc("mig-doc", src, dst):
                moved = True
                break
            await asyncio.sleep(0.01)
        await edit_task
        assert moved, ext.migration_stats
        assert ext.migration_stats["docs_migrated"] == 1
        assert ext.placement.overrides["mig-doc"] == dst
        await until(lambda: _assert("mig-doc" in ext.cells[dst]._docs))
        assert "mig-doc" not in ext.cells[src]._docs
        a.document.get_text("t").insert(0, "after;")
        await until(lambda: _assert(
            b.document.get_text("t").to_string() == a.document.get_text("t").to_string()
            and "after;" in b.document.get_text("t").to_string()
        ))
        text = b.document.get_text("t").to_string()
        assert "before;" in text
        for i in range(20):
            assert f"e{i};" in text, f"acked update e{i} lost in migration"
        assert a.synced and b.synced and not closes
        assert ext.cells[src].plane.residency_stats.get("migration_cpu_snapshots", 0) == 0


async def test_rebalance_spreads_hot_cell_and_no_lane_bypass():
    """Hot-doc skew through a live server: big inserts on the fullest
    cell's docs, rebalance ticks until the docs spread (no cell over 2x
    the mean), with every dispatch admitted in its own cell's lane."""
    ext = _cells_ext(devices=4, num_docs=24, capacity=8192, rebalance_ratio=1.5,
                     rebalance_min_units=64.0, migrate_batch=8)
    async with Served(ext) as served:
        names = [f"spread-{i}" for i in range(16)]
        providers = [served.provider(name) for name in names]
        await served.synced(*providers)
        by_cell: "dict[int, list[str]]" = {}
        for name in names:
            by_cell.setdefault(ext.cell_index_for(name), []).append(name)
        hot = max(by_cell, key=lambda i: len(by_cell[i]))
        assert len(by_cell[hot]) >= 2, by_cell
        for name in by_cell[hot]:
            providers[names.index(name)].document.get_text("t").insert(0, "z" * 600)
        plane = ext.cells[hot].plane
        await until(lambda: _assert(sum(
            plane.dispatched_units[s] for d in plane.docs.values() for s in d.seqs.values()
        ) > 0))
        migrated = 0
        for _ in range(30):
            await ext._rebalance_tick()
            migrated = ext.migration_stats["docs_migrated"]
            docs = [s["docs"] for s in ext.cell_stats() if s["healthy"]]
            if migrated > 0 and max(docs) <= 2 * sum(docs) / len(docs):
                break
            await asyncio.sleep(0.05)
        assert migrated > 0, ext.migration_stats
        await until(lambda: _assert(ext.served_docs() == len(names), ext.cell_stats()))
        spread = ext.utilization_spread()
        assert spread["docs_max_over_mean"] is not None
        assert spread["docs_max_over_mean"] <= 2.0, spread
        for i, cell in enumerate(ext.cells):
            assert cell.lane.counters["dispatches_bypass"] == 0, (i, cell.lane.snapshot())
            assert cell.lane.counters["dispatches_in_lane"] > 0, (i, "cell never dispatched")


# -- per-cell breaker scope ----------------------------------------------------


def _cell_supervisor(ext, core, canary_deadline, threshold=2):
    supervisor = PlaneSupervisor(lambda: ext, watchdog_interval=60.0,
                                 breaker_threshold=threshold, canary_deadline=canary_deadline)
    supervisor.runtime = ext
    supervisor._instance = core
    supervisor.state = STATE_READY
    return supervisor


async def _two_cell_server(served, count=8, prefix="breaker"):
    names = [f"{prefix}-{i}" for i in range(count)]
    providers = [served.provider(name) for name in names]
    await served.synced(*providers)
    ext = served.ext
    sick_docs = [n for n in names if ext.cell_index_for(n) == 0]
    well_docs = [n for n in names if ext.cell_index_for(n) == 1]
    assert sick_docs and well_docs, "placement stacked one cell"
    return names, providers, sick_docs, well_docs


async def test_supervisor_degrades_one_sick_cell_not_the_plane():
    """A CPU cell whose canary raises degrades alone (lane parked,
    placement routes around it, its docs on the CPU documents) while the
    other cell serves and the supervisor stays READY; a passing probe
    restores it and re-onboards its docs. The deadline is wide: the
    injected fault is an error, not a late probe."""
    ext = _cells_ext(devices=2, num_docs=16)
    async with Served(ext) as served:
        names, providers, sick_docs, well_docs = await _two_cell_server(served)
        supervisor = _cell_supervisor(ext, served.core, canary_deadline=10.0)
        sick, healthy = 0, 1

        def broken_probe():
            raise RuntimeError("cell wedged")

        original = ext.cells[sick].plane.canary_probe
        ext.cells[sick].plane.canary_probe = broken_probe
        for _ in range(3):
            await supervisor._watchdog_cells(ext)
        assert supervisor.cell_breakers[sick].state == "open"
        assert supervisor.cell_states[sick] != STATE_READY
        assert ext.cells[sick].lane.paused and sick not in ext.placement.healthy
        assert all(name not in ext.cells[sick]._docs for name in sick_docs)
        assert all(name in ext.cells[healthy]._docs for name in well_docs)
        assert not ext.cells[healthy].lane.paused
        assert supervisor.cell_breakers[healthy].state == "closed"
        assert supervisor.state == STATE_READY
        index = names.index(sick_docs[0])
        providers[index].document.get_text("t").insert(0, "degraded-ok")
        ext.cells[sick].plane.canary_probe = original
        for _ in range(3):
            await supervisor._watchdog_cells(ext)
        assert supervisor.cell_breakers[sick].state == "closed"
        assert supervisor.cell_states[sick] == STATE_READY
        assert not ext.cells[sick].lane.paused and sick in ext.placement.healthy
        await until(lambda: _assert(all(ext.is_served(n) for n in sick_docs)))
        assert supervisor.snapshot()["cells"][sick]["breaker"] == "closed"


async def test_a_late_cell_canary_trips_only_that_cell():
    """A canary past the deadline on one cell opens that cell's breaker
    alone, on the CPU as on the card; the supervisor stays READY."""
    ext = _cells_ext(devices=2, num_docs=16)
    async with Served(ext) as served:
        _names, _providers, sick_docs, well_docs = await _two_cell_server(served, prefix="late")
        supervisor = _cell_supervisor(ext, served.core, canary_deadline=1.0)
        supervisor.on_card = True  # a late cell degrades alone even on the card
        release = threading.Event()
        original = ext.cells[0].plane.canary_probe

        def late_probe():
            release.wait(5.0)
            return original()

        ext.cells[0].plane.canary_probe = late_probe
        try:
            for _ in range(2):
                await supervisor._watchdog_cells(ext)
            assert supervisor.cell_breakers[0].state == "open"
            assert supervisor.cell_breakers[1].state == "closed"
            assert supervisor.state == STATE_READY and supervisor.fault is None
            assert all(not ext.is_served(name) for name in sick_docs)
            assert all(ext.is_served(name) for name in well_docs)
        finally:
            release.set()
            ext.cells[0].plane.canary_probe = original
        await until(lambda: _assert(supervisor._cell_probes[0][0].done()))
        for _ in range(3):
            await supervisor._watchdog_cells(ext)
        assert supervisor.cell_breakers[0].state == "closed"
        await until(lambda: _assert(all(ext.is_served(n) for n in sick_docs)))


async def test_a_raised_cell_canary_on_the_card_stops_the_server():
    """On a plane marked as on the card, a cell canary that raises goes
    to `_fail_stop`: the supervisor is BROKEN with the error and nothing
    moves to the CPU documents."""
    ext = _cells_ext(devices=2, num_docs=16)
    async with Served(ext) as served:
        _names, _providers, sick_docs, _well = await _two_cell_server(served, prefix="card")
        supervisor = _cell_supervisor(ext, served.core, canary_deadline=10.0)
        supervisor.on_card = True

        def broken_probe():
            raise RuntimeError("illegal memory access")

        ext.cells[0].plane.canary_probe = broken_probe
        with pytest.raises(RuntimeError, match="illegal memory access"):
            await supervisor._watchdog_cells(ext)
        assert supervisor.state == STATE_BROKEN
        assert "illegal memory access" in repr(supervisor.fault)
        assert supervisor.counters["card_faults"] == 1
        assert supervisor.cell_breakers[0].state == "closed"  # no degrade
        assert all(ext.is_served(name) for name in sick_docs)


# -- the device scope ---------------------------------------------------------


async def test_every_device_touch_of_the_cells_runs_in_its_planes_device_scope():
    """Each cell's `device_scope()` is recorded per thread; every step
    seam (the C entries' launch points), every migration snapshot serve
    and every canary asserts that its own plane's scope is the current
    one, through loads, edits, a migration, a hydration and canaries."""
    ext = _cells_ext(devices=3, num_docs=16)
    current = threading.local()
    touches = []

    def recording_scope(plane):
        @contextlib.contextmanager
        def scope():
            outer = getattr(current, "plane", None)
            current.plane = plane
            try:
                yield
            finally:
                current.plane = outer
        return scope

    def checked(plane, what, fn):
        def call(*args, **kwargs):
            touches.append((what, getattr(current, "plane", None) is plane))
            return fn(*args, **kwargs)
        return call

    for cell in ext.cells:
        plane = cell.plane
        plane.device_scope = recording_scope(plane)
        for seam in ("_step_fn", "_sparse_step_fn", "_append_step_fn"):
            real = getattr(plane, seam)
            setattr(plane, seam, lambda real=real, plane=plane, seam=seam: checked(plane, seam, real()))
        cell.residency._snapshot = checked(plane, "snapshot", cell.residency._snapshot)
    async with Served(ext) as served:
        names = [f"scope-{i}" for i in range(9)]
        providers = [served.provider(name) for name in names]
        await served.synced(*providers)
        for p in providers:
            p.document.get_text("t").insert(0, "hello ")
        name = names[0]
        src = ext.cell_index_for(name)
        dst = (src + 1) % 3
        for _ in range(100):
            if await ext.migrate_doc(name, src, dst):
                break
            await asyncio.sleep(0.01)
        await until(lambda: _assert(name in ext.cells[dst]._docs))
        providers[0].document.get_text("t").insert(0, "moved ")
        supervisor = _cell_supervisor(ext, served.core, canary_deadline=10.0)
        await supervisor._watchdog_cells(ext)
        await until(lambda: _assert(all(ext.cells[i].plane.pending_ops() == 0 for i in range(3))))
    kinds = {what for what, _ok in touches}
    assert {"snapshot", "_sparse_step_fn"} <= kinds, kinds
    assert all(ok for _what, ok in touches), [t for t in touches if not t[1]]


# -- observability + the entry points ----------------------------------------


async def test_debug_scheduler_and_per_device_metrics():
    """`/debug/scheduler` has one section per cell, the placement and the
    migration books; `/metrics` has the cells' labelled gauges, equal to
    the cells' own books, beside the summed plane gauges."""
    from chip_smoke import parse_prometheus, scrape
    from hocuspocus_tpu_torch.observability import Metrics
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus

    ext = _cells_ext(devices=4, num_docs=8, capacity=512)
    metrics = Metrics()
    served = Served(ext)
    served.core = Hocuspocus(Configuration(quiet=True, extensions=[metrics, ext]))
    async with served:
        a = served.provider("cells-debug-doc")
        await served.synced(a)
        a.document.get_text("t").insert(0, "observed")
        owner = ext.cell_for("cells-debug-doc")
        await until(lambda: _assert(owner.lane.counters["admissions"] > 0))
        await until(lambda: _assert(owner.plane.pending_ops() == 0))
        status, body = await scrape(metrics, "/debug/scheduler")
        assert status == 200
        body = json.loads(body)
        status, text = await scrape(metrics, "/metrics")
        assert status == 200
        books = ext.cell_stats()
    assert len(body["devices"]) == 4
    index = ext.cell_index_for("cells-debug-doc")
    section = body["devices"][index]
    assert section["lane"]["classes"]["interactive"]["admissions"] > 0
    assert section["docs"] == 1 and body["placement"]["hash"]
    assert "migrations" in body and "rebalance" in body
    series = parse_prometheus(text, "scrape")
    for stat in books:
        label = (("cell", str(stat["cell"])), ("device", stat["device"]))
        assert series[("hocuspocus_tpu_cell_docs", label)] == stat["docs"]
        assert series[("hocuspocus_tpu_cell_rows_in_use", label)] == stat["rows_in_use"]
        assert series[("hocuspocus_tpu_cell_work_units", label)] == stat["work_units"]
    assert series[("hocuspocus_tpu_cell_docs", (("cell", str(index)), ("device", str(index))))] == 1
    for family in ("hocuspocus_tpu_cell_hbm_bytes", "hocuspocus_tpu_cell_lane_queue_depth",
                   "hocuspocus_tpu_cell_placement_epoch", "hocuspocus_tpu_plane_broadcasts"):
        assert family in text, family


def test_cli_exposes_multi_device_flags():
    from hocuspocus_tpu.cli import build_parser as jax_parser
    from hocuspocus_tpu_torch.cli import build_parser as port_parser

    argv = ["--tpu-serve", "--tpu-devices", "8", "--tpu-rebalance-interval", "2.5",
            "--tpu-rebalance-ratio", "1.75", "--tpu-migrate-batch", "4"]
    seen = []
    for build in (jax_parser, port_parser):
        args = build().parse_args(argv)
        seen.append((args.tpu_devices, args.tpu_rebalance_interval, args.tpu_rebalance_ratio,
                     args.tpu_migrate_batch))
    assert seen[0] == seen[1] == (8, 2.5, 1.75, 4)


def test_supervised_factory_builds_cell_plane():
    supervised = SupervisedTpuMergeExtension(devices=2, serve=True, num_docs=8, capacity=256,
                                             rebalance_interval_s=0, device="cpu")
    runtime = supervised.supervisor.factory()
    try:
        assert isinstance(runtime, MultiDeviceMergeExtension)
        assert len(runtime.cells) == 2 and len({id(lane) for lane in runtime.lanes()}) == 2
    finally:
        runtime.cancel_timers()
    with pytest.raises(ValueError):
        SupervisedTpuMergeExtension(devices=2, shards=4, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 7b"):
        SupervisedTpuMergeExtension(shards=4, device="cpu")


def test_multi_device_storm_scenario_compiles_deterministically():
    from hocuspocus_tpu.loadgen import get_scenario as jax_scenario
    from hocuspocus_tpu_torch.loadgen import get_scenario
    from hocuspocus_tpu_torch.loadgen.scenarios import BENCH_SUITE

    assert "multi_device_storm" in BENCH_SUITE
    scenario = get_scenario("multi_device_storm")
    a, b = scenario.compile(3), scenario.compile(3)
    assert a.schedule_hash == b.schedule_hash == jax_scenario("multi_device_storm").compile(3).schedule_hash
    assert a.population["devices"] == 4
    assert scenario.params["multi_device"]["rebalance_interval_s"] > 0
    assert [spec["name"] for spec in a.phases] == ["steady", "storm", "rebalanced"]


# -- the warm-spare park (twin of tests/fleet/test_warm_spare.py) -------------


async def test_park_cell_drains_under_live_edits_and_activate_rejoins():
    """Park the doc's cell while a writer edits: every acknowledged update
    survives the migration, no client closes, the parked cell leaves
    placement drained, and activation is one epoch bump."""
    ext = _cells_ext(devices=4)
    async with Served(ext) as served:
        a, b = served.provider("park-doc"), served.provider("park-doc")
        closes = []
        for p in (a, b):
            p.on("close", lambda *_a, **_k: closes.append(1))
        await served.synced(a, b)
        a.document.get_text("t").insert(0, "acked-before-park;")
        await until(lambda: _assert("acked-before-park" in b.document.get_text("t").to_string()))
        src = ext.cell_index_for("park-doc")

        async def live_edits():
            for i in range(15):
                a.document.get_text("t").insert(0, f"e{i};")
                await asyncio.sleep(0.002)

        edit_task = asyncio.ensure_future(live_edits())
        result = await ext.park_cell(src)
        for _ in range(50):
            if result["drained"]:
                break
            await asyncio.sleep(0.02)
            result = await ext.park_cell(src)
        await edit_task
        assert result["drained"], result
        assert src not in ext.placement.healthy and "park-doc" not in ext.cells[src]._docs
        assert ext.migration_stats["cells_parked"] >= 1
        a.document.get_text("t").insert(0, "post-park;")
        await until(lambda: _assert(
            a.document.get_text("t").to_string() == b.document.get_text("t").to_string()
            and "post-park" in b.document.get_text("t").to_string()
        ))
        text = b.document.get_text("t").to_string()
        assert "acked-before-park" in text
        for i in range(15):
            assert f"e{i};" in text, f"acked update e{i} lost in park"
        assert a.synced and b.synced and not closes
        epoch = ext.placement.epoch
        await ext.activate_cell(src)
        assert src in ext.placement.healthy and ext.placement.epoch == epoch + 1
        assert ext.migration_stats["cells_activated"] == 1


@pytest.mark.parametrize("package", ["jax", "port"])
async def test_a_migration_onto_a_cell_being_parked_is_declined_in_the_port(package):
    """A rebalancer's move onto the cell that a park is draining: the JAX
    package takes it (the move returns True, and the doc can land on a
    cell that leaves placement, which no controller tick retries); the
    port declines it (`migrations_declined`), the doc stays on its cell
    and the parked cell ends empty (ROADMAP Queue C)."""
    from tests.utils import new_hocuspocus, new_provider, wait_synced

    ext = _cells_ext(package, devices=4)
    names = [f"parking-{i}" for i in range(12)]
    park = ext.placement.place(names[0])
    rival = next(n for n in names if ext.placement.place(n) != park)
    if package == "port":
        served = Served(ext)
        await served.__aenter__()
        providers = [served.provider(n) for n in names]
        await served.synced(*providers)
    else:
        server = await new_hocuspocus(extensions=[ext])
        providers = [new_provider(server, name=n) for n in names]
        await wait_synced(*providers)
    try:
        for p in providers:
            p.document.get_text("t").insert(0, "x")
        await until(lambda: _assert(all(n in ext.cells[ext.placement.place(n)]._docs for n in names)))
        await until(lambda: _assert(not any(c.plane.pending_ops() or c._flush_inflight for c in ext.cells)))
        home = ext.cell_index_for(rival)
        declined = ext.migration_stats["migrations_declined"]
        result, moved = await asyncio.gather(ext.park_cell(park), ext.migrate_doc(rival, home, park))
        assert park not in ext.placement.healthy
        if package == "port":
            assert moved is False and ext.migration_stats["migrations_declined"] == declined + 1, (
                result, ext.migration_stats)
            assert rival in ext.cells[home]._docs and result["drained"] and not ext.cells[park]._docs
        else:
            assert moved is True
    finally:
        for p in providers:
            p.destroy()
        if package == "port":
            await served.__aexit__(None, None, None)
        else:
            await server.destroy()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_new_load_while_its_cell_drains_for_a_park(package):
    """A doc that loads while its placed cell drains for a park: the JAX
    package routes it onto the draining cell (which then parks holding
    it); the port routes it to the survivor the park would migrate it to,
    and back to plain placement once the park is over."""
    ext = _cells_ext(package, devices=4)
    park = 1
    fresh = next(f"fresh-{i}" for i in range(200) if ext.placement.place(f"fresh-{i}") == park)
    survivors = sorted(ext.placement.healthy - {park})
    survivor = max(survivors, key=lambda i: (ext.placement._score(fresh, i), -i))
    draining = getattr(ext, "_parking", set())
    draining.add(park)
    try:
        routed = ext.cell_index_for(fresh)
    finally:
        draining.discard(park)
    assert routed == (park if package == "jax" else survivor)
    assert ext.cell_index_for(fresh) == park
