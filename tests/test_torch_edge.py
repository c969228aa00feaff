"""The port's edge tier (`hocuspocus_tpu_torch/edge/`) against the JAX package's.

Twins of tests/edge/ (the end-to-end topology tests, the replica tests,
the router, the scenarios and the CLI roles). Each twin runs the JAX
test's own body twice: as written, against the JAX package, and with
its module's names (the edge classes, MiniRedis, the server, the
provider, the overload controller, the fleet view, the flight recorder,
the CRDT encoder) pointed at the port's, so the port is held to every
assertion of the reference test. The port's cells run without a plane
and with a served CPU plane beside their `CellIngressExtension`
(`TpuMergeExtension(serve=True, device="cpu", compact_threshold=0.75)`:
K1's plain version on the edge path, and the residency manager's replica
seams).

Every provider's document gets a client id fixed by the order it was
made, in both runs, so the two packages' documents can be compared: their
whole encoded state where the test's edits do not race each other, their
state vectors where concurrent inserts raced (an insert's origins follow
which remote edits had arrived), and only the writer's where the test
does not wait for its readers to converge. `test_rounds_converge_to_the_jax_packages_bytes`
gates each round on convergence, so every doc's bytes must be equal.

The twins are plain tests over `asyncio.run`: two topologies can outlast
the 60 s that tests/conftest.py gives one coroutine test when the suite
runs in parallel.
"""

import asyncio
import contextlib
import importlib
import os
import signal
import socket
import sys
import time
from pathlib import Path

import pytest

import tests.edge.test_edge_cli as jax_cli_tests
import tests.edge.test_edge_e2e as jax_e2e
import tests.edge.test_edge_scenarios as jax_scenario_tests
import tests.edge.test_replica as jax_replica_tests
import tests.edge.test_router as jax_router_tests

ROOT = Path(__file__).resolve().parent.parent
ROOTS = {"jax": "hocuspocus_tpu", "port": "hocuspocus_tpu_torch"}
PLANES = ["none", "cpu"]
CLIENT_BASE = 1000  # the first provider's client id; each later one adds 1


class Pkg:
    """One package's names, as the reference tests import them."""

    def __init__(self, key: str) -> None:
        root = ROOTS[key]

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.key = key
        edge = mod("edge")
        self.names = {
            "CellIngressExtension": edge.CellIngressExtension,
            "EdgeGatewayExtension": edge.EdgeGatewayExtension,
            "EdgeServer": edge.EdgeServer,
            "relay": edge.relay,
            "MiniRedis": mod("net.mini_redis").MiniRedis,
            "get_wire_telemetry": mod("observability.wire").get_wire_telemetry,
            "get_fleet_view": mod("observability.fleet").get_fleet_view,
            "get_flight_recorder": mod("observability.flight_recorder").get_flight_recorder,
            "InProcessProviderSocket": mod("provider.inprocess").InProcessProviderSocket,
            "Configuration": mod("server").Configuration,
            "Server": mod("server").Server,
            "OverloadExtension": mod("server.overload").OverloadExtension,
            "get_overload_controller": mod("server.overload").get_overload_controller,
            "encode_state_as_update": mod("crdt").encode_state_as_update,
            "AdmissionGate": mod("fleet.roster").AdmissionGate,
            "PeerRoster": mod("fleet.roster").PeerRoster,
            "cell_host": mod("fleet.roster").cell_host,
            "qualify_cell_id": mod("fleet.roster").qualify_cell_id,
            "CellRouter": mod("edge.router").CellRouter,
        }
        self.provider_cls = mod("provider").HocuspocusProvider
        self.doc_cls = mod("crdt").Doc
        self.encode_state_vector = mod("crdt").encode_state_vector
        self.await_synced = mod("aio").await_synced

    def reset(self) -> None:
        self.names["get_overload_controller"]().reset()
        self.names["get_fleet_view"]().reset()

    def recording_provider(self, record: list):
        """The package's provider, each document's client id fixed by the
        order it was made, every provider kept in `record`."""
        doc_cls = self.doc_cls

        class Recorded(self.provider_cls):
            def __init__(self, name, *args, **kwargs):
                if kwargs.get("document") is None:
                    document = doc_cls()
                    document.client_id = CLIENT_BASE + len(record)
                    kwargs["document"] = document
                super().__init__(name, *args, **kwargs)
                record.append(self)

        return Recorded

    def wait_synced(self):
        async def wait_synced(*providers, timeout: float = 30.0) -> None:
            await self.await_synced(providers, timeout=timeout, what="wait_synced")

        return wait_synced


JAX, PORT = Pkg("jax"), Pkg("port")


class Planes:
    """The port's `Configuration`, giving every cell a served CPU plane."""

    def __init__(self) -> None:
        self.exts = []

    def configuration(self, configuration_cls, ingress_cls):
        from hocuspocus_tpu_torch.tpu import TpuMergeExtension

        def configuration(*args, **kwargs):
            extensions = list(kwargs.get("extensions") or [])
            if any(isinstance(ext, ingress_cls) for ext in extensions):
                plane = TpuMergeExtension(
                    num_docs=64, capacity=1024, serve=True, device="cpu", compact_threshold=0.75
                )
                self.exts.append(plane)
                kwargs["extensions"] = extensions + [plane]
            return configuration_cls(*args, **kwargs)

        return configuration

    def served_edits(self) -> int:
        """Ops the planes integrated, and broadcasts they served (an edit
        that a plane broadcast but had not flushed yet when the test tore
        its cells down)."""
        return sum(
            ext.plane.counters[key]
            for ext in self.exts
            for key in ("flush_fast_ops", "flush_slow_ops", "plane_broadcasts")
        )


def run_reference_test(test, pkg: Pkg, plane: str = "none", modules=()) -> dict:
    """Run a reference test's body with its modules' names pointed at
    `pkg` (and at its recording provider): the documents each provider
    held at the end, and the planes the cells ran."""
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    record: list = []
    planes = Planes()
    names = dict(pkg.names)
    names["HocuspocusProvider"] = pkg.recording_provider(record)
    names["wait_synced"] = pkg.wait_synced()
    if plane == "cpu":
        names["Configuration"] = planes.configuration(
            pkg.names["Configuration"], pkg.names["CellIngressExtension"]
        )
    targets = [sys.modules[test.__module__], *modules]
    saved = []
    for module in targets:
        for name, value in names.items():
            if name in vars(module):
                saved.append((module, name, vars(module)[name]))
                setattr(module, name, value)
    pkg.reset()
    reset_device_lane()
    try:
        result = test()
        if asyncio.iscoroutine(result):
            asyncio.run(result)
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)
        pkg.reset()
    return {
        "providers": [
            (p.name, pkg.encode_state_vector(p.document), pkg.names["encode_state_as_update"](p.document))
            for p in record
        ],
        "planes": planes,
    }


_REFERENCE: dict = {}


def reference(test, modules=()) -> dict:
    """The JAX package's run of `test` (once a process)."""
    key = (test.__module__, test.__name__)
    if key not in _REFERENCE:
        _REFERENCE[key] = run_reference_test(test, JAX, modules=modules)
    return _REFERENCE[key]


def twin(test, plane: str, compare: str, edits: bool = True, modules=()) -> dict:
    """The reference test on the port (cells with `plane`) beside its JAX
    run: the same providers, and their documents compared as `compare`
    says: "state" byte-identical documents, "sv" equal state vectors
    (every provider converged, but concurrent inserts raced), "writer"
    only the first provider's document (the test does not wait for the
    others to converge). With a plane, the planes served the edits
    (`edits`)."""
    jax = reference(test, modules)
    port = run_reference_test(test, PORT, plane, modules)
    assert [name for name, _sv, _state in port["providers"]] == [
        name for name, _sv, _state in jax["providers"]
    ]
    pairs = list(zip(port["providers"], jax["providers"]))
    for (name, port_sv, port_state), (_name, jax_sv, jax_state) in pairs[:1] if compare == "writer" else pairs:
        assert port_sv == jax_sv, name
        if compare != "sv":
            assert port_state == jax_state, name
    if plane == "cpu":
        assert port["planes"].exts, "no cell ran a plane"
        if edits:
            assert port["planes"].served_edits() > 0
    return port


# -- relay envelopes ------------------------------------------------------------


def test_envelope_roundtrip():
    run_reference_test(jax_e2e.test_envelope_roundtrip, PORT)


@pytest.mark.parametrize(
    "kind,session,aux,payload",
    [
        (1, "edge-0:ab:1", "", b"\x01\x02payload\xff"),
        (0, "edge-7:s:2", '{"edge":"edge-7","tenant":"acme"}', b""),
        (31, "cell-1", '{"d":"viral","s":4}', bytes(range(256)) * 3),
        (13, "cell-0", "", b'{"node":"cell-0"}'),
    ],
)
def test_envelopes_are_byte_identical_with_and_without_trace_aux(kind, session, aux, payload):
    """Every envelope the port writes is the JAX package's, byte for
    byte, with and without a cross-tier trace context on a FRAME, through
    the zero-copy segment writer too; each package parses the other's."""
    jax_relay, port_relay = JAX.names["relay"], PORT.names["relay"]
    context = {"v": 1, "id": "edge-0:17", "t0": 12.5, "h": 1, "e": "edge-0"}
    auxes = [aux, port_relay.encode_trace_aux(context)]
    assert auxes[1] == jax_relay.encode_trace_aux(context)
    for each in auxes:
        port_bytes = port_relay.encode_envelope(kind, session, each, payload)
        assert port_bytes == jax_relay.encode_envelope(kind, session, each, payload)
        assert b"".join(bytes(seg) for seg in port_relay.encode_envelope_view(kind, session, each, payload)) == port_bytes
        assert port_relay.decode_envelope(port_bytes) == jax_relay.decode_envelope(port_bytes) == (
            kind, session, each, payload
        )
    assert port_relay.decode_trace_aux(auxes[1]) == jax_relay.decode_trace_aux(auxes[1])
    for foreign in ("", "not json", '{"v": 99}'):
        assert port_relay.decode_trace_aux(foreign) == jax_relay.decode_trace_aux(foreign)
    raws = [port_relay.encode_envelope(kind, session, aux, payload), b"\xff\xff", b""]
    assert port_relay.decode_envelopes_batch(raws, skip_malformed=True) == jax_relay.decode_envelopes_batch(
        raws, skip_malformed=True
    )
    with pytest.raises(Exception):
        port_relay.decode_envelopes_batch(raws)
    assert port_relay.decode_envelopes_batch([]) == []


def test_the_relay_has_no_python_parser_to_fall_back_to():
    """The port parses envelopes with its native codec only: there is no
    Python decoder in `relay.py` to run when the codec is missing."""
    import inspect

    port_relay = PORT.names["relay"]
    source = inspect.getsource(port_relay)
    assert "Decoder" not in source and "codec is None" not in source
    assert port_relay.decode_envelope.__code__.co_names.count("get_codec") == 1


# -- the end-to-end topology (tests/edge/test_edge_e2e.py) -----------------------

# test: (how its documents compare across the packages, whether it edits
# through a cell)
E2E = {
    "test_cross_edge_convergence_fuzz": ("sv", True),
    "test_cell_drain_hands_off_without_client_visible_disconnect": ("state", True),
    "test_heartbeat_expiry_drives_router_and_handoff": ("state", True),
    "test_stale_route_refused_by_cell_and_healed": ("state", False),
    "test_relay_queue_bounded_with_overflow_accounting": ("state", False),  # edits before any cell
    "test_door_admission_refuses_at_edge_without_touching_cells": ("state", False),
    "test_drain_red_and_edge_503_three_way_parity": ("state", False),
}


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", list(E2E))
def test_end_to_end_twin(name, plane):
    compare, edits = E2E[name]
    twin(getattr(jax_e2e, name), plane, compare, edits)


@pytest.mark.parametrize("plane", PLANES)
def test_rounds_converge_to_the_jax_packages_bytes(plane):
    """Writers on edge 0 and readers on edge 1 of 6 docs over 2 cells,
    3 rounds of one edit by each, every round converged before the next:
    each doc's bytes equal the JAX package's run of the same rounds."""

    async def body():
        topo = await jax_e2e.Topology().start(cells=2, edges=2)
        try:
            writers = [topo.provider(0, f"round-{i}") for i in range(6)]
            readers = [topo.provider(1, f"round-{i}") for i in range(6)]
            await jax_e2e.wait_synced(*(writers + readers))
            for round_no in range(3):
                for i, (writer, reader) in enumerate(zip(writers, readers)):
                    text = writer.document.get_text("body")
                    text.insert(len(text) // 2, f"w{round_no}.{i} ")
                    reader.document.get_text("body").insert(0, f"r{round_no}.{i} ")
                    if round_no and len(text) > 8:
                        text.delete(1, 2)
                for writer, reader in zip(writers, readers):
                    await jax_e2e.wait_for(
                        lambda a=writer.document, b=reader.document: jax_e2e.encode_state_as_update(a)
                        == jax_e2e.encode_state_as_update(b),
                        timeout=15,
                    )
            owned = set()
            for server, _ in topo.cells:
                owned.update(server.hocuspocus.documents)
            assert owned == {f"round-{i}" for i in range(6)}
            for server, _ in topo.edges:
                assert not server.hocuspocus.documents
        finally:
            await topo.close()

    body.__module__ = jax_e2e.__name__
    body.__name__ = "rounds"
    twin(body, plane, "state")


# -- hot-doc replicas (tests/edge/test_replica.py) --------------------------------

REPLICA = {
    "test_below_watermark_stays_single_owner": ("state", False),
    "test_owner_vs_follower_byte_identical_convergence_fuzz": ("sv", True),
    "test_lost_tick_heals_via_resync_never_silently": ("writer", True),
    "test_owner_death_promotes_freshest_follower_zero_loss": ("state", True),
    "test_replica_metrics_and_fleet_rollup_surface": ("state", False),
}


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", list(REPLICA))
def test_replica_twin(name, plane):
    compare, edits = REPLICA[name]
    twin(getattr(jax_replica_tests, name), plane, compare, edits, modules=(jax_e2e,))


@pytest.mark.parametrize("plane", PLANES)
def test_midstream_follower_join_converges(plane):
    """tests/edge/test_replica.py's test of that name is a known JAX-side
    failure (ROADMAP.md, Queue C): it compares the late follower with the
    owner right after the writer's last insert, and both may still lack
    it. The port alone is held to its assertions, with the wait taken
    until the owner holds that insert: a follower that joins after ticks
    flowed bootstraps the whole history and rides the live stream."""
    r = jax_replica_tests

    async def body():
        topo = await jax_e2e.Topology().start(cells=4, edges=2, replica_watermark=2)
        try:
            writer = topo.provider(0, "viral")
            await r.wait_synced(writer)
            await r._grow_audience(topo, 1, "viral", 4)
            gateway = topo.edges[1][1].gateway
            owner_id = gateway.router.route("viral")
            owner_ext = r._cell_ext(topo, owner_id)
            await jax_e2e.wait_for(
                lambda: len((owner_ext.replicas.owned.get("viral") or {"followers": {}})["followers"]) >= 2,
                timeout=15,
            )
            first_wave = set(owner_ext.replicas.owned["viral"]["followers"])
            for i in range(3):
                text = writer.document.get_text("body")
                text.insert(len(text), f"early-{i} ")
                await asyncio.sleep(0.03)
            await jax_e2e.wait_for(lambda: owner_ext.replicas.counters["ticks_out"] >= 1)
            await r._grow_audience(topo, 1, "viral", 4)
            await jax_e2e.wait_for(
                lambda: len(owner_ext.replicas.owned["viral"]["followers"]) == 3, timeout=15
            )
            late = set(owner_ext.replicas.owned["viral"]["followers"]) - first_wave
            assert len(late) == 1
            late_id = late.pop()
            writer.document.get_text("body").insert(0, "after-join ")
            owner_doc = r._cell_doc(topo, owner_id, "viral")
            await jax_e2e.wait_for(
                lambda: "after-join" in str(owner_doc.get_text("body"))
                and r._cell_doc(topo, late_id, "viral") is not None
                and r.encode_state_as_update(r._cell_doc(topo, late_id, "viral"))
                == r.encode_state_as_update(owner_doc),
                timeout=15,
            )
            late_text = str(r._cell_doc(topo, late_id, "viral").get_text("body"))
            assert "early-0" in late_text and "after-join" in late_text
        finally:
            await topo.close()

    body.__module__ = r.__name__
    run_reference_test(body, PORT, plane, modules=(jax_e2e,))


def _with_a_served_owner(check):
    """Two port cells with served CPU planes behind one edge, a writer of
    doc "viral" and one edit: runs `check(topo, owner_ext, plane_ext,
    document)`, `plane_ext` being the owner cell's merge extension and
    `document` its copy of the doc."""
    record = []
    pkg = PORT
    planes = Planes()
    saved = []
    names = dict(pkg.names)
    names["HocuspocusProvider"] = pkg.recording_provider(record)
    names["wait_synced"] = pkg.wait_synced()
    names["Configuration"] = planes.configuration(
        pkg.names["Configuration"], pkg.names["CellIngressExtension"]
    )
    for name, value in names.items():
        if name in vars(jax_e2e):
            saved.append((name, vars(jax_e2e)[name]))
            setattr(jax_e2e, name, value)

    async def body():
        topo = await jax_e2e.Topology().start(cells=2, edges=1, replica_watermark=2)
        try:
            writer = topo.provider(0, "viral")
            await jax_e2e.wait_synced(writer)
            writer.document.get_text("body").insert(0, "history ")
            gateway = topo.edges[0][1].gateway
            owner_id = gateway.router.route("viral")
            owner_index = next(i for i, (_, ext) in enumerate(topo.cells) if ext.cell_id == owner_id)
            owner_server, owner_ext = topo.cells[owner_index]
            plane_ext = planes.exts[owner_index]
            await jax_e2e.wait_for(
                lambda: "viral" in plane_ext._docs
                and "history" in str(owner_server.hocuspocus.documents["viral"].get_text("body")),
                timeout=15,
            )
            await check(topo, owner_ext, plane_ext, owner_server.hocuspocus.documents["viral"])
        finally:
            await topo.close()

    pkg.reset()
    try:
        asyncio.run(body())
    finally:
        for name, value in saved:
            setattr(jax_e2e, name, value)
        pkg.reset()


def test_a_card_fault_in_the_follow_bootstrap_is_not_served_by_the_cpu():
    """A cold follower's bootstrap goes through the owner's
    `replica_snapshot`. On the card a failed plane serve raises out of
    the residency seam, and the replica manager counts it, logs it and
    fails the follow: no CPU-encoded bootstrap goes out in the card's
    place. The fault is injected into the owner plane's serving path, and
    `on_card` makes the CPU plane take the card's rails."""

    async def check(topo, owner_ext, plane_ext, document):
        residency = plane_ext.residency
        residency.on_card = True

        def dead_serve(*_args, **_kwargs):
            raise RuntimeError("DEVICE_FAULT (injected)")

        plane_ext.serving.encode_state_as_update = dead_serve
        bootstraps = owner_ext.replicas.counters["bootstraps"]
        for _ in range(4):
            topo.provider(0, "viral")
        await jax_e2e.wait_for(lambda: owner_ext.replicas.card_faults >= 1, timeout=15)
        assert owner_ext.replicas.counters["bootstraps"] == bootstraps
        with pytest.raises(RuntimeError, match="DEVICE_FAULT"):
            residency.replica_snapshot("viral", document)
        with pytest.raises(RuntimeError, match="DEVICE_FAULT"):
            residency.replica_catchup("viral", document, b"\x00")
        # a CPU plane declines instead: the CPU document answers the
        # snapshot, and the catch-up says the plane does not serve it;
        # each of the two is a CPU fallback of a doc the plane holds
        residency.on_card = False
        fallbacks = plane_ext.plane.counters["cpu_fallbacks"]
        assert residency.replica_snapshot("viral", document) == PORT.names["encode_state_as_update"](document)
        assert residency.replica_catchup("viral", document, b"\x00") is None
        assert plane_ext.plane.counters["cpu_fallbacks"] == fallbacks + 2
        assert residency.replica_serves == {"snapshot": 0, "catchup": 0}

    _with_a_served_owner(check)


@pytest.mark.parametrize("seam", ["snapshot", "catchup"])
def test_replica_seams_count_the_plane_serves_and_the_cpu_answers(seam):
    """Each replica seam answers a doc the plane holds from the plane
    (counted in `replica_serves`, the bytes rebuilding the owner's doc).
    Where the plane holds the doc and its serve declines (here: the
    serving path paused, as a supervisor drain does), the CPU answers
    and `cpu_fallbacks` counts it, as for a joiner's SyncStep1. A doc the
    plane does not hold is answered from the CPU and counts nothing."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_as_update

    async def check(topo, owner_ext, plane_ext, document):
        residency = plane_ext.residency
        counters = plane_ext.plane.counters
        fallbacks = counters["cpu_fallbacks"]
        serves = dict(residency.replica_serves)

        def ask(name, doc):
            if seam == "snapshot":
                return residency.replica_snapshot(name, doc)
            return residency.replica_catchup(name, doc, b"\x00")

        served = ask("viral", document)
        assert residency.replica_serves[seam] == serves[seam] + 1
        assert counters["cpu_fallbacks"] == fallbacks
        rebuilt = Doc()
        apply_update(rebuilt, served)
        assert encode_state_as_update(rebuilt) == encode_state_as_update(document)

        plane_ext.serving.paused = True
        try:
            declined = ask("viral", document)
        finally:
            plane_ext.serving.paused = False
        assert declined == (encode_state_as_update(document) if seam == "snapshot" else None)
        assert counters["cpu_fallbacks"] == fallbacks + 1
        assert residency.replica_serves[seam] == serves[seam] + 1

        elsewhere = Doc()
        elsewhere.get_text("body").insert(0, "not on this plane")
        answer = ask("elsewhere", elsewhere)
        assert answer == (encode_state_as_update(elsewhere) if seam == "snapshot" else None)
        assert counters["cpu_fallbacks"] == fallbacks + 1

    _with_a_served_owner(check)


# -- the router (tests/edge/test_router.py) ---------------------------------------


@pytest.mark.parametrize(
    "name", sorted(n for n in vars(jax_router_tests) if n.startswith("test_"))
)
def test_router_twin(name):
    run_reference_test(getattr(jax_router_tests, name), PORT)


def test_router_places_docs_and_follower_sets_like_the_jax_package():
    cells = [f"host-{i % 2}/cell-{i}" for i in range(5)]
    routers = {key: pkg.names["CellRouter"]() for key, pkg in (("jax", JAX), ("port", PORT))}
    for router in routers.values():
        for cell in cells:
            router.add_cell(cell)
        router.mark_draining(cells[1])
        router.set_override("doc-7", cells[3])
    docs = [f"doc-{i}" for i in range(300)]
    for key in ("route", "route_set"):
        got = {
            pkg: [getattr(router, key)(doc) if key == "route" else router.route_set(doc, 3) for doc in docs]
            for pkg, router in routers.items()
        }
        assert got["port"] == got["jax"], key
    assert routers["port"].table() == routers["jax"].table()


# -- the scenarios (tests/edge/test_edge_scenarios.py) ----------------------------


def _scenario_names(pkg: Pkg, record: dict) -> dict:
    loadgen = importlib.import_module(f"{ROOTS[pkg.key]}.loadgen")

    async def run_scenario(scenario, seed=0, time_scale=1.0):
        if pkg.key == "port":
            runner = loadgen.ScenarioRunner(scenario.compile(seed), time_scale=time_scale, device="cpu")
            result = await runner.run()
        else:
            result = await loadgen.run_scenario(scenario, seed=seed, time_scale=time_scale)
        record.setdefault("results", []).append(result)
        return result

    return {
        "get_scenario": loadgen.get_scenario,
        "run_scenario": run_scenario,
        "BENCH_SUITE": loadgen.BENCH_SUITE,
        "get_overload_controller": pkg.names["get_overload_controller"],
    }


def _run_scenario_test(test, pkg: Pkg) -> dict:
    record: dict = {}
    module = jax_scenario_tests
    saved = [(name, vars(module)[name]) for name in _scenario_names(pkg, record) if name in vars(module)]
    for name, value in _scenario_names(pkg, record).items():
        setattr(module, name, value)
    pkg.reset()
    try:
        result = test()
        if asyncio.iscoroutine(result):
            asyncio.run(result)
    finally:
        for name, value in saved:
            setattr(module, name, value)
        pkg.reset()
    return record


@pytest.mark.parametrize(
    "name",
    [
        "test_edge_scenarios_registered_and_deterministic",
        "test_edge_handoff_scenario_smoke",
        "test_edge_fanout_scenario_full",
    ],
)
def test_scenario_twin(name):
    """The scenario tests (edge_fanout's full run is slow in the JAX
    suite, so only its schedule is held to the JAX package's there) on
    the port's runner with CPU planes, and the schedules they ran equal
    to the JAX package's."""
    port = _run_scenario_test(getattr(jax_scenario_tests, name), PORT)
    jax_hashes = [
        importlib.import_module("hocuspocus_tpu.loadgen").get_scenario(result["scenario"], **params)
        .compile(result["seed"]).schedule_hash
        for result, params in (
            (r, {"num_docs": 4, "phase_ms": 600} if r["scenario"] == "edge_handoff" else {})
            for r in port.get("results", [])
        )
    ]
    assert [r["schedule_hash"] for r in port.get("results", [])] == jax_hashes
    for result in port.get("results", []):
        assert all(h["cpu_fallbacks"] == 0 for h in result["extra"]["plane_health"])


# -- the CLI roles (tests/edge/test_edge_cli.py) ----------------------------------


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


@contextlib.asynccontextmanager
async def _launch_role(module: str, port: int, *extra_args: str):
    process = await asyncio.create_subprocess_exec(
        sys.executable, "-m", module, "--port", str(port), "--host", "127.0.0.1", *extra_args,
        cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
        stdout=asyncio.subprocess.DEVNULL,
        stderr=asyncio.subprocess.DEVNULL,
    )
    try:
        yield process
    finally:
        if process.returncode is None:
            process.send_signal(signal.SIGTERM)
            try:
                await asyncio.wait_for(process.wait(), 40)
            except asyncio.TimeoutError:
                process.kill()
                await process.wait()


async def _cli_roles(pkg: Pkg, cell_args: tuple) -> tuple:
    """A cell and an edge process of `pkg`'s CLI over a MiniRedis relay
    bus, a websocket provider on the edge: (the provider's state, the
    processes' exit codes after SIGTERM)."""
    module = f"{ROOTS[pkg.key]}.cli"
    redis = await pkg.names["MiniRedis"]().start()
    relay = ("--relay-redis-host", "127.0.0.1", "--relay-redis-port", str(redis.port))
    provider = None
    codes = []
    try:
        cell_port, edge_port = _free_port(), _free_port()
        async with _launch_role(module, cell_port, "--role", "cell", "--cell-id", "cli-cell",
                                *relay, *cell_args) as cell:
            async with _launch_role(module, edge_port, "--role", "edge", *relay) as edge:
                document = pkg.doc_cls()
                document.client_id = CLIENT_BASE
                provider = pkg.provider_cls(
                    name="cli-edge-doc", url=f"ws://127.0.0.1:{edge_port}", document=document
                )
                await jax_e2e.wait_for(lambda: provider.synced, timeout=60)
                provider.document.get_text("t").insert(0, "via edge cli")
                await jax_e2e.wait_for(lambda: not provider.has_unsynced_changes, timeout=30)
                state = pkg.names["encode_state_as_update"](provider.document)
                provider.destroy()
                provider = None
            codes.append(edge.returncode)
        codes.append(cell.returncode)
        return state, codes
    finally:
        if provider is not None:
            provider.destroy()
        await asyncio.sleep(0)
        await redis.stop()


def test_cli_edge_and_cell_roles_serve_a_provider():
    """`--role cell` (with `--tpu-serve --tpu-device cpu`: the supervised
    plane beside the cell ingress) and `--role edge` as processes of the
    port's CLI serve a websocket provider end to end, as the JAX CLI's
    roles do (tests/edge/test_edge_cli.py, run here too), with the same
    document bytes; both exit 0 on SIGTERM."""
    jax_state, _jax_codes = asyncio.run(_cli_roles(JAX, ()))
    port_state, port_codes = asyncio.run(_cli_roles(PORT, ("--tpu-serve", "--tpu-device", "cpu")))
    assert port_state == jax_state
    assert port_codes == [0, 0], port_codes
    plain_state, _codes = asyncio.run(_cli_roles(PORT, ()))
    assert plain_state == jax_state


def test_teardown_stops_the_warm_grid_before_its_next_shape():
    """The `--role cell` process waited out the plane's whole warm grid
    after SIGTERM: each shape runs in the loop's default executor, whose
    shutdown at exit waits for it, and on a loaded CPU the grid took
    longer than the 40 s the test above gives the exit. Teardown now
    stops the grid before its next shape: with every shape slowed to
    0.2 s, a destroy during the first shape lets exactly that one finish
    and starts no other."""
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    async def body():
        reset_device_lane()
        ext = TpuMergeExtension(num_docs=8, capacity=1024, serve=True, device="cpu")
        core = Hocuspocus(Configuration(quiet=True, extensions=[ext]))
        await core.ensure_configured()
        started = []
        real = ext.plane.warmup_compiles

        def slow(*args, **kwargs):
            started.append(time.monotonic())
            time.sleep(0.2)
            return real(*args, **kwargs)

        ext.plane.warmup_compiles = slow
        await core.hooks("on_listen", Payload(instance=core, port=None))
        while not started:
            await asyncio.sleep(0.01)
        t0 = time.monotonic()
        await core.hooks("on_destroy", Payload(instance=core))
        await asyncio.wait_for(ext.warmup_task, 5)
        assert len(started) == 1, len(started)
        assert time.monotonic() - t0 < 2.0
        assert len(ext.plane.warmup_shapes()) > 1  # the grid had more to run

    asyncio.run(body())


def test_cli_roles_reference_body_on_the_port():
    """The JAX test itself, its MiniRedis and provider the port's, and its
    processes started from the port's CLI module."""
    saved = (jax_cli_tests.MiniRedis, jax_cli_tests.HocuspocusProvider, jax_cli_tests._launch_role)

    @contextlib.asynccontextmanager
    async def port_role(port, *extra_args):
        async with _launch_role("hocuspocus_tpu_torch.cli", port, *extra_args) as process:
            yield process

    jax_cli_tests.MiniRedis = PORT.names["MiniRedis"]
    jax_cli_tests.HocuspocusProvider = PORT.provider_cls
    jax_cli_tests._launch_role = port_role
    started = time.monotonic()
    try:
        asyncio.run(jax_cli_tests.test_cli_edge_and_cell_roles_serve_a_provider())
    finally:
        jax_cli_tests.MiniRedis, jax_cli_tests.HocuspocusProvider, jax_cli_tests._launch_role = saved
    assert time.monotonic() - started < 120


def test_each_cell_of_a_process_attributes_its_plane_traces_to_itself():
    """Two cells in one process, each with a served CPU plane: each plane's
    update-trace book carries its own cell's id (the process-wide fleet
    identity is the last role configured), as the JAX cells pin theirs."""
    planes = Planes()
    ingress_cls = PORT.names["CellIngressExtension"]
    configuration = planes.configuration(PORT.names["Configuration"], ingress_cls)

    async def body():
        redis = await PORT.names["MiniRedis"]().start()
        servers = []
        try:
            for i in range(2):
                ingress = ingress_cls(cell_id=f"trace-cell-{i}", port=redis.port, announce_interval_s=0.2)
                server = PORT.names["Server"](configuration(quiet=True, extensions=[ingress]))
                await server.listen(port=0)
                servers.append(server)
            assert [ext.plane.update_traces.node_id for ext in planes.exts] == [
                "trace-cell-0", "trace-cell-1"
            ]
        finally:
            for server in servers:
                await server.destroy()
            await redis.stop()

    PORT.reset()
    try:
        asyncio.run(body())
    finally:
        PORT.reset()
