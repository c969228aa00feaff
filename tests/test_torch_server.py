"""The port's TpuMergeExtension inside the port's server core, on the CPU.

Twins of the JAX package's extension tests (tests/tpu/test_extension_e2e.py,
tests/tpu/test_serving.py) and of a few DeviceLane / BatchGovernor cases
(tests/tpu/test_scheduler.py), run against the port with device="cpu".
Clients are the port's HocuspocusProviders on in-process sockets, which
drive the real `Hocuspocus.handle_connection` pipeline. Every wait polls
with a deadline; no sleep decides a result.
"""

import asyncio
import time

import pytest

from hocuspocus_tpu_torch.aio import await_synced
from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu import TpuMergeExtension
from hocuspocus_tpu_torch.tpu.scheduler import (
    CLASS_CATCHUP,
    CLASS_INTERACTIVE,
    CLASS_WARM,
    BatchGovernor,
    DeviceLane,
    LaneDeferred,
    get_device_lane,
    reset_device_lane,
    reset_warm_registry,
)

DEADLINE_S = 30.0


async def until(fn, timeout: float = DEADLINE_S, interval: float = 0.01):
    """Poll until `fn` stops raising AssertionError, at most `timeout` s."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except AssertionError:
            if time.monotonic() > deadline:
                raise
            await asyncio.sleep(interval)


def _assert(condition, detail=None):
    assert condition, detail


class Served:
    """The port's server core with `ext`, and providers on in-process
    sockets (one socket per provider, as one browser tab each)."""

    def __init__(self, ext, **config) -> None:
        self.ext = ext
        self.core = Hocuspocus(Configuration(quiet=True, extensions=[ext], **config))
        self.providers = []

    async def __aenter__(self) -> "Served":
        await self.core.ensure_configured()
        return self

    async def __aexit__(self, *exc) -> None:
        for provider in self.providers:
            provider.destroy()
            provider.websocket_provider.destroy()
        await self.core.hooks("on_destroy", Payload(instance=self.core))

    def provider(self, name: str, **options) -> HocuspocusProvider:
        provider = HocuspocusProvider(
            name=name, websocket_provider=InProcessProviderSocket(self.core), **options
        )
        provider.attach()
        self.providers.append(provider)
        return provider

    async def synced(self, *providers) -> None:
        await await_synced(providers, timeout=DEADLINE_S)

    def text(self, name: str) -> str:
        return self.core.documents[name].get_text("t").to_string()


def _served_ext(**kwargs) -> TpuMergeExtension:
    kwargs.setdefault("num_docs", 8)
    kwargs.setdefault("capacity", 1024)
    kwargs.setdefault("flush_interval_ms", 1)
    reset_device_lane()  # each test's extension gets a lane of its own
    return TpuMergeExtension(serve=True, device="cpu", **kwargs)


# -- twins of tests/tpu/test_extension_e2e.py ----------------------------------


async def test_extension_mirrors_live_documents():
    ext = TpuMergeExtension(num_docs=8, capacity=1024, flush_interval_ms=1, device="cpu")
    async with Served(ext) as served:
        a, b = served.provider("mirrored"), served.provider("mirrored")
        await served.synced(a, b)
        a.document.get_text("t").insert(0, "hello ")
        b.document.get_text("t").insert(0, "world ")

        def mirrored():
            ext.plane.flush()
            cpu = served.text("mirrored")
            assert ext.plane.text("mirrored") == cpu and len(cpu) == 12

        await until(mirrored)


async def test_extension_releases_slot_on_unload():
    ext = TpuMergeExtension(num_docs=2, capacity=256, flush_interval_ms=1, device="cpu")
    async with Served(ext) as served:
        provider = served.provider("transient")
        await served.synced(provider)
        assert "transient" in ext.plane.docs
        provider.destroy()
        await until(lambda: _assert("transient" not in ext.plane.docs))
        assert len(ext.plane.free) == 2


# -- twins of tests/tpu/test_serving.py ----------------------------------------


async def test_sync_reply_served_from_device_state(monkeypatch):
    """A late joiner syncs entirely from plane state: the CPU SyncStep2
    encoder is poisoned, so a successful sync proves device serving."""
    import hocuspocus_tpu_torch.server.message_receiver as mr

    ext = _served_ext()
    async with Served(ext) as served:
        a = served.provider("served")
        await served.synced(a)
        a.document.get_text("body").insert(0, "from the device")
        await until(lambda: _assert(served.core.documents["served"].get_text("body").to_string()))

        def poisoned(encoder, doc, sv=None):
            raise AssertionError("CPU write_sync_step2 used for a plane-served doc")

        monkeypatch.setattr(mr, "write_sync_step2", poisoned)
        b = served.provider("served")
        await served.synced(b)
        await until(lambda: _assert(b.document.get_text("body").to_string() == "from the device"))
        assert ext.plane.counters["sync_serves"] >= 1
        assert ext.plane.counters["cpu_fallbacks"] == 0


async def test_broadcast_is_batched_through_coalescing_window():
    """Under sustained traffic an edit waits for the coalescing window:
    the per-update CPU fan-out is suppressed. An awareness change sent
    after the edit reaches the peer through the same fan-out tick while
    the edit is still held; closing the window delivers it."""
    ext = _served_ext(broadcast_interval_ms=60_000)
    async with Served(ext) as served:
        a, b = served.provider("batched"), served.provider("batched")
        await served.synced(a, b)
        text_b = b.document.get_text("body")
        # primer: the first edit after idle broadcasts on the next tick
        a.document.get_text("body").insert(0, "now:")
        await until(lambda: _assert(text_b.to_string() == "now:"))
        a.document.get_text("body").insert(4, "deferred")
        a.awareness.set_local_state_field("cursor", 4)
        await until(
            lambda: _assert(
                b.awareness.get_states().get(a.document.client_id, {}).get("cursor") == 4
            )
        )
        assert served.core.documents["batched"].get_text("body").to_string() == "now:deferred"
        assert text_b.to_string() == "now:"
        assert ext._broadcast_handle is not None  # the window is open
        ext._broadcast_handle.cancel()
        ext._broadcast_handle = None
        ext._broadcast_served()
        await until(lambda: _assert(text_b.to_string() == "now:deferred"))
        assert ext.plane.counters["plane_broadcasts"] >= 2


async def test_read_only_connection_with_serve_mode():
    """Read-only rejection composes with plane serving: the viewer's
    writes are refused while it still receives plane broadcasts."""

    async def on_authenticate(data):
        if data.token == "viewer":
            data.connection_config.read_only = True

    ext = _served_ext()
    async with Served(ext, on_authenticate=on_authenticate) as served:
        writer = served.provider("ro", token="editor")
        viewer = served.provider("ro", token="viewer")
        await served.synced(writer, viewer)
        writer.document.get_text("t").insert(0, "from the writer")
        await until(
            lambda: _assert(viewer.document.get_text("t").to_string() == "from the writer")
        )
        viewer.document.get_text("t").insert(0, "REJECTED ")
        # a frame the viewer sends after the edit: once the server holds
        # it, the server has handled the edit (one socket, in order)
        viewer.awareness.set_local_state_field("seen", True)
        document = served.core.documents["ro"]
        await until(
            lambda: _assert(
                document.awareness.get_states().get(viewer.document.client_id, {}).get("seen")
            )
        )
        assert served.text("ro") == "from the writer"
        assert ext.plane.counters["cpu_fallbacks"] == 0
        assert "ro" in ext._docs
        writer.document.get_text("t").insert(0, "still flowing: ")
        await until(
            lambda: _assert("still flowing: " in viewer.document.get_text("t").to_string())
        )
        assert served.text("ro") == "still flowing: from the writer"


async def test_direct_connection_edits_ride_the_plane():
    ext = _served_ext()
    async with Served(ext) as served:
        provider = served.provider("direct")
        await served.synced(provider)
        direct = await served.core.open_direct_connection("direct")
        try:
            await direct.transact(lambda doc: doc.get_text("t").insert(0, "from the server"))
            await until(
                lambda: _assert(provider.document.get_text("t").to_string() == "from the server")
            )
            assert ext.plane.counters["cpu_fallbacks"] == 0
            assert ext.plane.counters["plane_broadcasts"] >= 1
            assert "direct" in ext._docs
        finally:
            await direct.disconnect()


async def test_concurrent_edits_converge_through_plane():
    ext = _served_ext()
    async with Served(ext) as served:
        a, b = served.provider("conv"), served.provider("conv")
        await served.synced(a, b)
        a.document.get_text("body").insert(0, "alpha ")
        b.document.get_text("body").insert(0, "beta ")

        def converged():
            ta = a.document.get_text("body").to_string()
            tb = b.document.get_text("body").to_string()
            cpu = served.core.documents["conv"].get_text("body").to_string()
            assert ta == tb == cpu and len(cpu) == 11

        await until(converged)
        a.document.get_text("body").delete(0, 5)

        def deleted():
            ta = a.document.get_text("body").to_string()
            assert ta == b.document.get_text("body").to_string() and len(ta) == 6

        await until(deleted)
        # deletes flow through the device tombstones: a late joiner's
        # SyncStep2 is served from them
        c = served.provider("conv")
        await served.synced(c)
        await until(lambda: _assert(c.document.get_text("body").to_string() == a.document.get_text("body").to_string()))
        assert ext.plane.counters["cpu_fallbacks"] == 0


async def test_map_content_served_from_plane():
    """Map edits are host-side LWW records on the plane: the doc stays
    served, broadcasts ride the plane, late joiners sync from it."""
    ext = _served_ext()
    async with Served(ext) as served:
        a, b = served.provider("mapdoc"), served.provider("mapdoc")
        await served.synced(a, b)
        a.document.get_map("m").set("k", "v")
        await until(lambda: _assert(b.document.get_map("m").get("k") == "v"))
        assert ext.plane.counters["docs_retired_unsupported"] == 0
        b.document.get_map("m").set("k", "v2")
        b.document.get_map("m").set("k2", "w")
        await until(
            lambda: _assert(
                a.document.get_map("m").get("k") == "v2" and a.document.get_map("m").get("k2") == "w"
            )
        )
        # a tombstone-only update still broadcasts through the plane
        a.document.get_map("m").delete("k2")
        await until(lambda: _assert(b.document.get_map("m").get("k2") is None))
        assert ext.plane.counters["cpu_fallbacks"] == 0
        assert "mapdoc" in ext._docs
        serves_before = ext.plane.counters["sync_serves"]
        c = served.provider("mapdoc")
        await served.synced(c)
        await until(lambda: _assert(c.document.get_map("m").get("k") == "v2"))
        assert c.document.get_map("m").get("k2") is None
        assert ext.plane.counters["sync_serves"] > serves_before


async def test_forced_desync_detected_and_recovered():
    """A host tally that claims a unit the device never integrated: the
    next flush's sweep retires the doc (counted), ships the full CPU
    state, and serving detaches; the CPU path carries on."""
    ext = _served_ext()
    async with Served(ext) as served:
        a, b = served.provider("desynced"), served.provider("desynced")
        await served.synced(a, b)
        a.document.get_text("body").insert(0, "healthy")
        await until(lambda: _assert(b.document.get_text("body").to_string() == "healthy"))
        await until(lambda: _assert(ext.plane.pending_ops() == 0 and not ext._flush_inflight))
        (slot,) = ext.plane.docs["desynced"].seqs.values()
        ext.plane.dispatched_units[slot] += 1
        a.document.get_text("body").insert(7, " again")

        def recovered():
            assert ext.plane.counters["docs_retired_desync"] == 1
            assert ext.plane.counters["cpu_fallbacks"] == 1
            assert "desynced" not in ext._docs
            assert b.document.get_text("body").to_string() == "healthy again"

        await until(recovered)
        b.document.get_text("body").insert(0, ">> ")
        await until(
            lambda: _assert(a.document.get_text("body").to_string() == ">> healthy again")
        )


async def test_device_fault_between_capture_and_flush_loses_nothing():
    """The device step dies after an update was captured for a plane
    broadcast but before the flush integrates it: every served doc
    degrades to the CPU path with a full-state broadcast."""
    ext = _served_ext()
    async with Served(ext) as served:
        a, b = served.provider("faulty"), served.provider("faulty")
        await served.synced(a, b)
        a.document.get_text("body").insert(0, "before fault")
        await until(lambda: _assert(b.document.get_text("body").to_string() == "before fault"))
        real_flush = ext.plane.flush
        fired = {"n": 0}

        def dying_flush(max_batches=None):
            fired["n"] += 1
            raise RuntimeError("simulated device fault mid-flush")

        ext.plane.flush = dying_flush
        a.document.get_text("body").insert(12, " + captured edit")

        def degraded_whole():
            assert fired["n"] >= 1
            assert ext.plane.counters["cpu_fallbacks"] == 1
            assert ext.plane.counters["docs_retired_fallback"] == 1
            assert "faulty" not in ext._docs
            assert b.document.get_text("body").to_string() == "before fault + captured edit"

        await until(degraded_whole)
        ext.plane.flush = real_flush
        b.document.get_text("body").insert(0, "b: ")
        await until(
            lambda: _assert(
                a.document.get_text("body").to_string() == "b: before fault + captured edit"
            )
        )
        c = served.provider("faulty")
        await served.synced(c)
        await until(
            lambda: _assert(
                c.document.get_text("body").to_string() == "b: before fault + captured edit"
            )
        )


async def test_failed_flush_inside_a_sync_serve_falls_back_to_the_cpu_document():
    """Under the extension, a device step that dies inside a batched sync
    degrades the served docs (counted) and the CPU document answers the
    joiner: the client's sync never fails."""
    ext = _served_ext(flush_interval_ms=60_000, governor=False)
    async with Served(ext) as served:
        a = served.provider("joined")
        await served.synced(a)
        a.document.get_text("t").insert(0, "queued, not flushed")
        await until(lambda: _assert(ext.plane.pending_ops() > 0))

        def dying_flush(max_batches=None):
            raise RuntimeError("simulated device fault in a sync serve")

        ext.plane.flush = dying_flush
        b = served.provider("joined")
        await served.synced(b)
        await until(
            lambda: _assert(b.document.get_text("t").to_string() == "queued, not flushed")
        )
        assert ext.plane.counters["cpu_fallbacks"] >= 1
        assert "joined" not in ext._docs


async def test_device_fault_on_a_card_plane_raises_instead_of_degrading():
    """On the card a failed device step propagates out of the flush and
    out of the sync serve, and nothing moves to the CPU document. The
    plane here is on the CPU, with its device reported as the card so
    the extension takes the card's branch; the dying flush never touches
    a device."""
    import torch

    ext = _served_ext(flush_interval_ms=60_000, governor=False)
    async with Served(ext) as served:
        a = served.provider("card")
        await served.synced(a)
        document = served.core.documents["card"]
        real_flush, real_device = ext.plane.flush, ext.plane.device

        def dying_flush(max_batches=None):
            raise RuntimeError("simulated kernel launch failure")

        ext.plane.flush = dying_flush
        ext.plane.device = torch.device("cuda")
        try:
            a.document.get_text("t").insert(0, "queued, not flushed")
            await until(lambda: _assert(ext.plane.pending_ops() > 0))
            with pytest.raises(RuntimeError, match="kernel launch failure"):
                await ext._flush_now(max_batches=None, final=True)
            a.document.get_text("t").insert(0, "again: ")
            await until(lambda: _assert(ext.plane.pending_ops() > 0))
            with pytest.raises(RuntimeError, match="kernel launch failure"):
                document.sync_source.encode_state_as_update(None)
            with pytest.raises(RuntimeError, match="kernel launch failure"):
                await document.sync_source.encode_state_as_update_async(None)
            assert ext.plane.counters["cpu_fallbacks"] == 0
            assert not any(
                v for k, v in ext.plane.counters.items() if k.startswith("docs_retired_")
            )
            assert "card" in ext._docs
        finally:
            ext.plane.flush, ext.plane.device = real_flush, real_device


@pytest.mark.parametrize("card", [False, True])
async def test_failed_lane_demote_rebuild_is_a_fault_not_a_content_verdict(card):
    """A map edit demotes a lane doc and the extension rebuilds it on the
    Python path in place. When the rebuild itself fails (here the pending
    lane window's encode), a card plane raises out of the rebuild and
    keeps the doc off the CPU document; a CPU plane degrades that doc
    alone. Neither drops the window quietly and rebuilds over it."""
    import torch

    ext = _served_ext(flush_interval_ms=60_000, governor=False)
    assert ext.native_lane
    async with Served(ext) as served:
        a, b = served.provider("demote"), served.provider("demote")
        await served.synced(a, b)
        a.document.get_text("t").insert(0, "plain ")
        await until(lambda: _assert(b.document.get_text("t").to_string() == "plain "))
        assert ext.plane.docs["demote"].lane_slot is not None
        real_device = ext.plane.device

        def failing_pair(name):
            raise RuntimeError("simulated window encode failure")

        ext.serving.build_broadcast_pair = failing_pair
        if card:
            ext.plane.device = torch.device("cuda")
        try:
            a.document.get_map("m").set("k", "v")
            await until(lambda: _assert(ext.plane.counters["docs_retired_lane_demote"] == 1))
            if card:
                # the capture seam spawned the rebuild already; run it
                # here too to see it raise
                with pytest.raises(RuntimeError, match="window encode failure"):
                    await ext._rebuild_lane_doc(served.core.documents["demote"])
                assert ext.plane.counters["cpu_fallbacks"] == 0
                assert "demote" in ext._docs
                # the window is still pending: nothing was rebuilt over it
                doc = ext.plane.docs["demote"]
                assert doc.retire_reason == "lane_demote" and doc.lane_slot is not None
            else:
                await until(lambda: _assert(ext.plane.counters["cpu_fallbacks"] == 1))
            # the update that demoted the doc rode the CPU fan-out
            await until(lambda: _assert(b.document.get_map("m").get("k") == "v"))
        finally:
            ext.plane.device = real_device


async def test_catchup_storm_batches_sync_triage_on_device(monkeypatch):
    """Concurrent SyncStep1s share state_vector_diff calls."""
    import hocuspocus_tpu_torch.tpu.serving as serving_mod

    ext = _served_ext(num_docs=32)
    num_docs, joiners_per_doc = 4, 4
    async with Served(ext) as served:
        seeders = [served.provider(f"storm-{d}") for d in range(num_docs)]
        await served.synced(*seeders)
        for d, p in enumerate(seeders):
            p.document.get_text("body").insert(0, f"doc {d} content before the storm")
        await until(lambda: _assert(ext.plane.counters["plane_broadcasts"] >= 1))
        calls = {"n": 0}
        real_diff = serving_mod.state_vector_diff

        def counted(a, b):
            calls["n"] += 1
            return real_diff(a, b)

        monkeypatch.setattr(serving_mod, "state_vector_diff", counted)
        serves_before = ext.plane.counters["sync_serves"]
        storm = [
            served.provider(f"storm-{d}") for d in range(num_docs) for _ in range(joiners_per_doc)
        ]
        await served.synced(*storm)
        for d in range(num_docs):
            for j in range(joiners_per_doc):
                text = storm[d * joiners_per_doc + j].document.get_text("body")
                await until(
                    lambda text=text, d=d: _assert(
                        text.to_string() == f"doc {d} content before the storm"
                    )
                )
        assert ext.plane.counters["sync_serves"] - serves_before >= num_docs * joiners_per_doc
        assert 1 <= calls["n"] < num_docs * joiners_per_doc, calls


async def test_serve_mode_survives_doc_churn_under_load():
    """Load/unload churn concurrent with edits and executor-side
    flushes: no flush crashes on registry mutation, no edit is lost."""
    ext = _served_ext(num_docs=32, capacity=512)
    async with Served(ext) as served:
        stable_a, stable_b = served.provider("stable"), served.provider("stable")
        await served.synced(stable_a, stable_b)
        text = stable_a.document.get_text("body")
        expect = []
        for wave in range(6):
            churners = [served.provider(f"churn-{wave}-{i}") for i in range(4)]
            token = f"w{wave};"
            expect.append(token)
            text.insert(len(text.to_string()), token)
            await served.synced(*churners)
            for i, p in enumerate(churners):
                p.document.get_text("t").insert(0, f"c{wave}-{i}")

            def known(name):
                doc = ext.plane.docs.get(name)
                if doc is None:
                    return False
                ext.plane.materialize_lane(doc)  # lane docs keep known in C++
                return bool(doc.lowerer.known)

            await until(
                lambda wave=wave: _assert(sum(known(f"churn-{wave}-{i}") for i in range(4)) == 4)
            )
            for p in churners:
                p.destroy()
        await until(
            lambda: _assert(stable_b.document.get_text("body").to_string() == "".join(expect))
        )
        assert "stable" in ext._docs
        assert ext.plane.counters["cpu_fallbacks"] == 0
        assert ext.plane.counters["docs_retired_desync"] == 0


async def test_listen_warms_the_grid_through_the_lane():
    """on_listen launches every flush shape once, at the lane's lowest
    priority; live flushes then take warm shapes only, and no device
    dispatch bypasses the lane."""
    reset_warm_registry()
    ext = _served_ext()
    lane = ext.lane
    assert lane is get_device_lane()
    async with Served(ext) as served:
        await served.core.hooks("on_listen", Payload(instance=served.core, port=None))
        await ext.warmup_task
        watch = ext.plane.compile_watch
        grid = ext.plane.warmup_shapes() + ext.plane.warmup_aux_shapes()
        assert watch.warmed and watch.first_launches == len(grid)
        a, b = served.provider("lane-doc"), served.provider("lane-doc")
        await served.synced(a, b)
        a.document.get_text("t").insert(0, "through the lane;")
        await until(
            lambda: _assert(b.document.get_text("t").to_string() == "through the lane;")
        )
        await until(lambda: _assert(ext.plane.pending_ops() == 0 and not ext._flush_inflight))
        assert watch.unwarmed_launches == 0
        assert lane.counters["dispatches_in_lane"] > len(grid)
        assert lane.counters["dispatches_bypass"] == 0, lane.snapshot()
        assert lane.class_admissions[CLASS_WARM] > 0, "the warm grid rode the lane"
        assert lane.class_admissions[CLASS_INTERACTIVE] > 0


def test_shared_warm_registry_skips_covered_shapes():
    from hocuspocus_tpu_torch.tpu import MergePlane

    reset_warm_registry()
    first = MergePlane(num_docs=8, capacity=128, device="cpu")
    grid = first.warmup_shapes() + first.warmup_aux_shapes()
    assert first.warmup_compiles(shared=True) is True
    assert first.compile_watch.first_launches == len(grid)
    second = MergePlane(num_docs=8, capacity=128, device="cpu")
    assert second.warmup_compiles(shared=True) is False
    assert second.compile_watch.first_launches == 0 and second.compile_watch.warmed
    other = MergePlane(num_docs=8, capacity=256, device="cpu")
    assert other.warmup_compiles(shared=True) is True


async def test_teardown_drain_goes_on_when_the_lane_stays_held():
    """on_destroy's final drain waits for the lane at most its deadline,
    then flushes without it: no captured op is left queued."""
    ext = _served_ext(flush_interval_ms=60_000, governor=False)
    async with Served(ext) as served:
        a = served.provider("held")
        await served.synced(a)
        a.document.get_text("t").insert(0, "queued at teardown")
        await until(lambda: _assert(ext.plane.pending_ops() > 0))
        holder = await ext.lane.admit(CLASS_CATCHUP, site="test")
        deferrals = ext.lane.counters["deferrals"]
        loop = asyncio.get_event_loop()
        started = loop.time()
        real_admit = ext.lane.admit

        async def short_deadline(lane_class, site="", deadline_s=None):
            return await real_admit(lane_class, site, None if deadline_s is None else 0.05)

        ext.lane.admit = short_deadline
        await ext._flush_now(max_batches=None, final=True)
        assert loop.time() - started < DEADLINE_S
        assert ext.lane.counters["deferrals"] == deferrals + 1
        assert ext.plane.pending_ops() == 0
        assert ext.plane.text("held") == "queued at teardown"
        holder.release()


def test_extension_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TpuMergeExtension(device="cpu", mesh=object())
    for knob in ("evict_idle_secs", "compact_threshold"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TpuMergeExtension(device="cpu", **{knob: 1.0})
    # the native text lane is ported: on by default in serve mode, off in
    # shadow mode and when the caller asks for the Python host path
    assert TpuMergeExtension(device="cpu", serve=True).native_lane is True
    assert TpuMergeExtension(device="cpu", serve=True, native_lane=False).native_lane is False
    assert TpuMergeExtension(device="cpu", serve=False).native_lane is False


# -- DeviceLane / BatchGovernor (twins of tests/tpu/test_scheduler.py) ----------


async def test_lane_grants_by_priority_then_fifo():
    lane = DeviceLane()
    holder = await lane.admit(CLASS_INTERACTIVE, site="t")
    order = []

    async def wait_for(cls, tag):
        ticket = await lane.admit(cls, site=tag)
        order.append(tag)
        ticket.release()

    tasks = [
        asyncio.ensure_future(wait_for(CLASS_WARM, "warm-1")),
        asyncio.ensure_future(wait_for(CLASS_CATCHUP, "recycle")),
        asyncio.ensure_future(wait_for(CLASS_INTERACTIVE, "live-1")),
        asyncio.ensure_future(wait_for(CLASS_WARM, "warm-2")),
        asyncio.ensure_future(wait_for(CLASS_INTERACTIVE, "live-2")),
    ]
    await asyncio.sleep(0)  # queue them all
    assert lane.contended() and lane.queue_depths() == [2, 1, 2]
    holder.release()
    await asyncio.gather(*tasks)
    assert order == ["live-1", "live-2", "recycle", "warm-1", "warm-2"]
    assert lane.counters["admissions"] == 6
    assert not lane.contended()


async def test_lane_deadline_defers_a_waiter_and_keeps_the_queue():
    lane = DeviceLane()
    holder = await lane.admit(CLASS_INTERACTIVE)
    queued = asyncio.ensure_future(lane.admit(CLASS_CATCHUP, site="queued"))
    await asyncio.sleep(0)
    with pytest.raises(LaneDeferred) as deferred:
        await lane.admit(CLASS_INTERACTIVE, deadline_s=0.01)
    assert deferred.value.lane_class == CLASS_INTERACTIVE
    assert lane.counters["deferrals"] == 1
    assert lane.queue_depths() == [0, 1, 0], "the deferred waiter left the queue"
    holder.release()
    ticket = await queued
    ticket.release()
    assert lane.counters["admissions"] == 2 and not lane.contended()


async def test_lane_dispatch_accounting():
    lane = DeviceLane()
    lane.note_dispatch("flush")
    assert lane.counters["dispatches_bypass"] == 1
    ticket = await lane.admit(CLASS_INTERACTIVE)
    lane.note_dispatch("flush", batches=3)
    ticket.release()
    ticket.release()  # idempotent
    assert lane.counters["dispatches_in_lane"] == 3
    snapshot = lane.snapshot()
    assert not snapshot["held"] and snapshot["classes"]["interactive"]["admissions"] == 1


def test_governor_regimes():
    governor = BatchGovernor(base_interval_ms=5.0, max_stretch=4.0, drain_watermark=100)
    assert governor.flush_delay_s(pending_ops=1) == pytest.approx(0.02)  # sparse: stretched
    now = time.monotonic()
    for i in range(50):
        governor.note_arrival(8, now=now + i * 0.001)
    assert governor.flush_delay_s(pending_ops=1) == pytest.approx(0.005)  # steady: base
    assert governor.flush_delay_s(pending_ops=100) == 0.0  # past the watermark: drain
    assert governor.max_batches(pending_ops=100) == 8
    assert governor.max_batches(pending_ops=500, congested=True) == 1
    governor.note_cycle({"batches": 1, "dispatch_ms": 0.0, "device_sync_ms": 10.0})
    assert governor.max_batches(pending_ops=1000) == 2  # 5 ms budget / 2.5 ms a batch
    assert governor.arrival_rate(now=now + 30.0) < 1.0
