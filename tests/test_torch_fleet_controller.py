"""The port's fleet autoscaler (`fleet/controller.py`) against the JAX package's.

Twins of the controller tests of tests/fleet/test_controller.py: each
runs the JAX test's own body twice, as written against the JAX package
and with its module's names pointed at the port's (through
tests/test_torch_edge.py's `run_reference_test`). Every decision core the
body makes is recorded with the decisions it returned, and the two runs
must agree tick for tick: decisions, counters and `status()`, and the
extensions' `status()` too. The twin of
tests/fleet/test_warm_spare.py::test_controller_extension_boots_warm_spares_parked
boots both packages' controller over four cells (the port's on the CPU)
and compares their status. The port-only tests hold a scale-down under
live edits to the JAX test's park contract (no acknowledged edit lost,
the parked cell's lane admitting nothing but canaries afterwards) and a
card plane's raised actuation to the supervisor's stop.
"""

import asyncio
import copy

import pytest

import hocuspocus_tpu.fleet as jax_fleet
import hocuspocus_tpu_torch.fleet as port_fleet
import tests.fleet.test_controller as jax_controller_tests
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu.scheduler import CLASS_CANARY, reset_device_lane
from tests.test_torch_edge import JAX, PORT, run_reference_test
from tests.test_torch_server import _assert, until

FLEET = {"jax": jax_fleet, "port": port_fleet}

CONTROLLER_TESTS = [
    "test_cell_load_takes_the_hottest_signal_not_the_mean",
    "test_scale_up_needs_hold_ticks_then_targets_the_first_spare",
    "test_scale_up_holds_without_spare_capacity",
    "test_scale_down_targets_the_coldest_cell",
    "test_scale_down_projection_guard_keeps_survivors_in_band",
    "test_scale_down_respects_min_cells",
    "test_oscillating_signal_never_flaps",
    "test_brownout_parks_scaling_and_unpark_rearms_cooldown",
    "test_extension_tick_actuates_through_the_overrides",
    "test_extension_parks_while_the_ladder_is_at_brownout",
]


def _recording(pkg, made: list):
    """`pkg` with its fleet classes replaced by subclasses that keep every
    instance made in `made`, each core with the decisions it returned."""
    fleet = FLEET[pkg.key]

    class Core(fleet.FleetController):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.returned = []
            made.append(self)

        def observe(self, *args, **kwargs):
            decision = super().observe(*args, **kwargs)
            self.returned.append(dict(decision))
            return decision

    class Driver(fleet.FleetControllerExtension):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    recorded = copy.copy(pkg)
    recorded.names = dict(pkg.names, FleetController=Core, FleetControllerExtension=Driver)
    recorded.names["get_overload_controller"] = pkg.names["get_overload_controller"]
    return recorded


def _story(made: list) -> list:
    story = []
    for obj in made:
        if hasattr(obj, "returned"):
            story.append(("core", obj.returned, dict(obj.counters), obj.status()))
        else:
            story.append(("extension", dict(obj.actuation), obj.status()))
    return story


@pytest.mark.parametrize("name", CONTROLLER_TESTS)
def test_controller_twin(name):
    """The JAX test's body on both packages, and the same decisions,
    counters and status from the same injected digests."""
    test = getattr(jax_controller_tests, name)
    stories = {}
    for pkg in (JAX, PORT):
        made: list = []
        run_reference_test(test, _recording(pkg, made))
        assert made, "the test made no controller"
        stories[pkg.key] = _story(made)
    assert stories["port"] == stories["jax"]


def test_the_decision_core_is_the_jax_packages_word_for_word():
    """Apart from the module docstring, the port's `FleetController` is the
    reference's code: the same decision table, reasons and counters."""
    import inspect

    assert inspect.getsource(port_fleet.FleetController) == inspect.getsource(
        jax_fleet.FleetController
    )


def test_a_random_digest_stream_gives_the_same_decisions_in_both_packages():
    """Three hundred ticks of seeded digests (a drifting fleet, brownout
    windows, cells joining and leaving) through both cores."""
    import numpy as np

    rng = np.random.default_rng(7)
    stream = []
    active = 2
    for tick in range(300):
        active = int(np.clip(active + rng.integers(-1, 2), 1, 4))
        level = 0.5 + 0.45 * np.sin(tick / 17.0)
        cells = [
            {
                "cell": i,
                "healthy": i < active,
                "work_rate": float(rng.uniform(0.5, 1.5) * level * 150.0) if i < active else 0.0,
                "lane_queue_depth": float(rng.integers(0, 40)),
                "occupancy": float(rng.uniform(0.0, 0.6)),
            }
            for i in range(4)
        ]
        allowed = not (120 <= tick < 135 or 250 <= tick < 252)
        stream.append((cells, allowed))
    out = {}
    for key, fleet in FLEET.items():
        core = fleet.FleetController(num_cells=4, hold_ticks=2, cooldown_ticks=3, lane_target=64.0)
        decisions = [
            core.observe(copy.deepcopy(cells), scaling_allowed=allowed,
                         park_reason=None if allowed else "brownout:brownout1")
            for cells, allowed in stream
        ]
        out[key] = (decisions, dict(core.counters), core.status())
    assert out["port"] == out["jax"]
    assert out["port"][1]["scale_ups"] > 0 and out["port"][1]["scale_downs"] > 0


# -- warm spares on the cell plane (twin of tests/fleet/test_warm_spare.py) ----


async def _boot(package: str, **fleet_kwargs):
    """A core with four cells and the fleet controller, its listen fired."""
    import importlib

    root = {"jax": "hocuspocus_tpu", "port": "hocuspocus_tpu_torch"}[package]
    server = importlib.import_module(f"{root}.server")
    payload_cls = importlib.import_module(f"{root}.server.types").Payload
    importlib.import_module(f"{root}.tpu.scheduler").reset_device_lane()
    plane = importlib.import_module(f"{root}.tpu.cells").MultiDeviceMergeExtension(
        devices=4, num_docs=16, capacity=2048, flush_interval_ms=1, rebalance_interval_s=0,
        **({"device": "cpu"} if package == "port" else {}),
    )
    fleet = FLEET[package].FleetControllerExtension(**fleet_kwargs)
    core = server.Hocuspocus(server.Configuration(quiet=True, extensions=[plane, fleet]))
    await core.ensure_configured()
    await core.hooks("on_listen", payload_cls(instance=core, port=None))
    return core, plane, fleet, payload_cls


def _without_clocks(status: dict) -> dict:
    status = copy.deepcopy(status)
    for entry in status["timeline"]:
        entry.pop("t_s")
    return status


def test_controller_extension_boots_warm_spares_parked():
    """`--fleet-warm-spares 2`: the last two cells boot built but out of
    placement, the controller finds the plane by duck type, publishes its
    status through the fleet view, and samples digest-shaped stats, in
    both packages alike."""
    out = {}
    for package in ("jax", "port"):
        async def body(package=package):
            core, plane, fleet, payload_cls = await _boot(
                package, interval_s=60.0, warm_spares=2, min_cells=1
            )
            view = FLEET[package].controller.get_fleet_view()
            try:
                assert fleet.plane is plane
                assert fleet.active_cells() == [0, 1]
                assert plane.placement.healthy == {0, 1}
                status = fleet.status()
                assert status["roster"] == {"active": [0, 1], "total": 4}
                assert status["bounds"] == {"min_cells": 1, "max_cells": 4}
                assert view.status()["autoscale"]["roster"]["active"] == [0, 1]
                cells = fleet.sample_cells()
                assert [c["cell"] for c in cells] == [0, 1, 2, 3]
                assert all("work_rate" in c and "dispatched_total" in c for c in cells)
                assert sum(c["healthy"] for c in cells) == 2
                return _without_clocks(status), [
                    (c["cell"], c["healthy"], c["work_rate"], c["docs"]) for c in cells
                ]
            finally:
                await core.hooks("on_destroy", payload_cls(instance=core))
                view.reset()

        out[package] = asyncio.run(body())
    assert out["port"] == out["jax"]


def test_a_scale_down_under_live_edits_loses_nothing_and_the_parked_lane_admits_nothing():
    """The controller's own scale-down (an injected cold digest naming the
    doc's cell the coldest) while a writer edits: every acknowledged edit
    survives the migrations, no client closes, the cell leaves placement
    drained, and its lane admits nothing but canaries afterwards while
    edits go on."""
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket

    async def body():
        core, plane, fleet, _ = await _boot("port", interval_s=60.0, min_cells=1)
        fleet.controller = port_fleet.FleetController(
            num_cells=4, hold_ticks=1, cooldown_ticks=0, work_target=100.0
        )
        providers = []

        def provider(name):
            p = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(core))
            p.attach()
            providers.append(p)
            return p

        closes = []
        try:
            names = [f"scale-{i}" for i in range(8)]
            pairs = {name: (provider(name), provider(name)) for name in names}
            for p in providers:
                p.on("close", lambda *_a, **_k: closes.append(1))
            await until(lambda: _assert(all(p.synced for p in providers)))
            for name, (a, _b) in pairs.items():
                a.document.get_text("t").insert(0, f"{name}-acked;")
            await until(lambda: _assert(all(
                f"{name}-acked" in b.document.get_text("t").to_string()
                for name, (_a, b) in pairs.items()
            )))
            src = plane.cell_index_for(names[0])
            held = [name for name in names if plane.cell_index_for(name) == src]

            async def live_edits():
                for i in range(15):
                    for name in held:
                        pairs[name][0].document.get_text("t").insert(0, f"e{i};")
                    await asyncio.sleep(0.002)

            edits = asyncio.ensure_future(live_edits())
            cold = [
                {"cell": i, "healthy": True, "work_rate": 0.0 if i == src else 20.0}
                for i in range(4)
            ]
            decision = await fleet.tick_once(cells=cold)
            assert decision["action"] == "scale_down" and decision["cell"] == src
            # a migration declines while its doc's window is dirty; the
            # park is retried as the JAX park test does
            for _ in range(50):
                if not plane.cells[src]._docs:
                    break
                await asyncio.sleep(0.02)
                await plane.park_cell(src)
            await edits
            assert not plane.cells[src]._docs and src not in plane.placement.healthy
            assert fleet.actuation["parks"] == 1 and fleet.actuation["docs_migrated"] >= 1
            lane = plane.cells[src].lane
            before = list(lane.class_admissions)
            for name in held:
                pairs[name][0].document.get_text("t").insert(0, "post-park;")
            await until(lambda: _assert(all(
                a.document.get_text("t").to_string() == b.document.get_text("t").to_string()
                and "post-park" in b.document.get_text("t").to_string()
                for name, (a, b) in pairs.items() if name in held
            )))
            for name in held:
                text = pairs[name][1].document.get_text("t").to_string()
                assert f"{name}-acked" in text
                for i in range(15):
                    assert f"e{i};" in text, f"acked update e{i} of {name} lost"
            after = list(lane.class_admissions)
            after[CLASS_CANARY] = before[CLASS_CANARY]
            assert after == before, (before, lane.class_admissions)
            assert all(p.synced for p in providers) and not closes
            assert [entry["action"] for entry in fleet.timeline] == ["boot", "scale_down"]
            assert fleet.timeline[-1]["active"] == sorted({0, 1, 2, 3} - {src})
        finally:
            for p in providers:
                p.destroy()
                p.websocket_provider.destroy()
            await core.hooks("on_destroy", Payload(instance=core))
            port_fleet.controller.get_fleet_view().reset()

    asyncio.run(body())


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_a_raised_scale_down_on_the_card_stops_the_supervised_server(on_card):
    """On a card plane an actuation that raises (here a migration whose
    eviction faults) goes to the supervisor's fault path
    (`PlaneSupervisor.card_fault`): BROKEN with the error, the tick loop
    ended; it is never counted and retried as a CPU plane's failure is.
    On a CPU plane the failure is counted and the loop ticks on, as in
    the JAX package. The plane is marked as on the card the way
    tests/test_torch_supervisor.py does."""
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.tpu.supervisor import STATE_BROKEN, STATE_READY, SupervisedTpuMergeExtension

    async def body():
        reset_device_lane()
        host = SupervisedTpuMergeExtension(
            devices=4, num_docs=16, capacity=2048, serve=True, device="cpu",
            rebalance_interval_s=0, watchdog_interval=60.0,
        )
        fleet = port_fleet.FleetControllerExtension(interval_s=0.05, min_cells=1)
        core = Hocuspocus(Configuration(quiet=True, extensions=[host, fleet]))
        await core.ensure_configured()
        await core.hooks("on_listen", Payload(instance=core, port=None))
        try:
            await until(lambda: _assert(host.supervisor.state == STATE_READY and fleet.plane is not None))
            plane = fleet.plane
            host.supervisor.on_card = on_card
            fleet.controller = port_fleet.FleetController(
                num_cells=4, hold_ticks=1, cooldown_ticks=0, work_target=1e9, occupancy_target=1e9,
            )

            async def faulting_park(index):
                raise RuntimeError("migration serve faulted on the card")

            plane.park_cell = faulting_park
            if on_card:
                await until(lambda: _assert(fleet._task.done()))
                assert isinstance(fleet._task.exception(), RuntimeError)
                assert host.supervisor.state == STATE_BROKEN
                assert host.supervisor.counters["card_faults"] == 1
                assert fleet.actuation["failures"] == 1 and fleet.actuation["parks"] == 0
            else:
                await until(lambda: _assert(fleet.actuation["failures"] >= 2))
                assert not fleet._task.done()
                assert host.supervisor.state == STATE_READY
                assert host.supervisor.counters["card_faults"] == 0 and fleet.actuation["parks"] == 0
        finally:
            await core.hooks("on_destroy", Payload(instance=core))
            port_fleet.controller.get_fleet_view().reset()

    asyncio.run(body())
