"""The port's durability plane (`hocuspocus_tpu_torch/storage/`) against
the JAX package's, on the CPU.

The same seeded operations go through both packages' write-ahead logs:
record framing, segment and journal files byte for byte under each fsync
mode (appends, checkpoints, truncations, forgets and injected disk
faults), each package's reader replaying the other's log, torn tail
included; `Durability` beside each package's served plane over direct
connections, through eviction, hydration and reload; and a kill -9 of
the port's websocket server mid-storm, after which a restart on the same
WAL directory holds every update a client was shown. The crash server is
this file run as a script:

    python tests/test_torch_storage.py <wal_dir>
"""

import asyncio
import os
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ != "__main__":
    from hocuspocus_tpu import crdt as jax_crdt
    from hocuspocus_tpu import storage as jax_storage
    from hocuspocus_tpu.server import Configuration as JaxConfiguration
    from hocuspocus_tpu.server import Hocuspocus as JaxHocuspocus
    from hocuspocus_tpu.tpu import TpuMergeExtension as JaxExtension
    from hocuspocus_tpu_torch import crdt as port_crdt
    from hocuspocus_tpu_torch import storage
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from tests.test_torch_parity_isolation import resolve_jax_codec
    from tests.test_torch_server_parity import _editors, _round

NAMES = ["a", "reports/q3", "näme ünïcode", "x" * 40]
# stats that follow the commit batches' timing, not the operations (a
# batch that carries a checkpoint rotates the journal once)
TIMING_STATS = (
    "fsyncs", "commit_batches", "commit_batch_records_last", "commit_last_ms", "journal_rotations",
)


def _tree(root) -> dict:
    """Every file under `root`: {relative path: bytes}."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _stats(wal) -> dict:
    return {k: v for k, v in wal.stats.items() if k not in TIMING_STATS}


# -- record framing -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_framing_matches_jax(seed):
    rng = np.random.default_rng(seed)
    blob = b""
    for _ in range(40):
        payload = rng.bytes(int(rng.integers(0, 300)))
        rec_type = int(rng.choice([storage.REC_UPDATE, storage.REC_SNAPSHOT]))
        framed = storage.encode_record(payload, rec_type)
        assert framed == jax_storage.encode_record(payload, rec_type)
        blob += framed
    assert storage.decode_records(blob) == jax_storage.decode_records(blob)
    # a cut anywhere, and a flipped byte anywhere, decode alike
    for _ in range(30):
        cut = blob[: int(rng.integers(0, len(blob)))]
        assert storage.decode_records(cut) == jax_storage.decode_records(cut)
        flipped = bytearray(blob)
        flipped[int(rng.integers(0, len(blob)))] ^= 0xFF
        assert storage.decode_records(bytes(flipped)) == jax_storage.decode_records(bytes(flipped))


# -- the logs on disk -----------------------------------------------------------


async def _script(rng, wals, steps: int) -> None:
    """Apply one seeded sequence of WAL operations to every manager in
    `wals` alike, committing after each step, and hold their files and
    deterministic stats equal after each step."""
    roots = [wal.directory for wal in wals]
    for step in range(steps):
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        kind = rng.random()
        payload = rng.bytes(int(rng.integers(1, 200)))
        if kind < 0.55:
            for wal in wals:
                wal.append(name, payload, storage.REC_UPDATE)
        elif kind < 0.65:
            for wal in wals:
                wal.checkpoint(name, payload)
        elif kind < 0.75:
            positions = {wal.position(name) for wal in wals}
            assert len(positions) == 1
            cover = positions.pop() - int(rng.integers(0, 3))
            assert len({wal.truncate_through(name, cover - 1) for wal in wals}) == 1
        elif kind < 0.8:
            for wal in wals:
                wal.forget(name)
        elif kind < 0.85:
            # a full disk for the next write, or an fsync that fails
            fault = "fail_disk_full" if rng.random() < 0.5 else "fail_fsync"
            for wal in wals:
                getattr(wal.faults, fault)(1)
                wal.append(name, payload, storage.REC_UPDATE)
        else:
            for wal in wals:
                wal.faults.tear_next_write(0.5)
                wal.append(name, payload, storage.REC_UPDATE)
        await asyncio.gather(*(wal.flush() for wal in wals))
        trees = [_tree(root) for root in roots]
        assert all(tree == trees[0] for tree in trees), f"step {step}: the files differ"
        stats = [_stats(wal) for wal in wals]
        assert all(s == stats[0] for s in stats), f"step {step}: {stats}"


def _managers(tmp_path, fsync):
    kwargs = {"fsync": fsync, "segment_max_bytes": 600, "journal_max_bytes": 1500}
    return (
        jax_storage.WalManager(str(tmp_path / "jax"), **kwargs),
        storage.WalManager(str(tmp_path / "port"), **kwargs),
    )


@pytest.mark.parametrize("fsync", ["tick", "always", "off"])
async def test_wal_files_are_byte_identical(tmp_path, fsync):
    rng = np.random.default_rng(11)
    wals = _managers(tmp_path, fsync)
    await _script(rng, wals, 120)
    for wal in wals:
        wal.close()


async def _replay_all(manager_cls, root, fsync):
    wal = manager_cls(root, fsync=fsync)
    out = {}
    for name in NAMES:
        out[name] = await wal.replay(name)
    stats = _stats(wal)
    wal.close()
    return out, stats


@pytest.mark.parametrize("fsync", ["tick", "always", "off"])
async def test_each_package_replays_the_others_log(tmp_path, fsync):
    rng = np.random.default_rng(5)
    wals = _managers(tmp_path, fsync)
    await _script(rng, wals, 60)
    for wal in wals:
        wal.close()
    # a write cut by a kill -9: the newest segment of one doc loses its
    # last bytes, and the journal gains half a frame
    for wal in wals:
        segments = sorted(
            (e for e in os.listdir(os.path.join(wal.directory, "a")) if e.endswith(".wal")),
        )
        path = os.path.join(wal.directory, "a", segments[-1])
        with open(path, "r+b") as fh:
            fh.truncate(max(os.path.getsize(path) - 3, 0))
        journal = os.path.join(wal.directory, "journal%")
        if os.path.isdir(journal):
            for entry in sorted(os.listdir(journal)):
                with open(os.path.join(journal, entry), "ab") as fh:
                    fh.write(b"\x99" * 7)
    jax_root, port_root = (wal.directory for wal in wals)
    assert _tree(jax_root) == _tree(port_root)
    # a reader repairs the torn tail it finds: each reads a copy of its own
    replays = {}
    for writer, root in (("jax", jax_root), ("port", port_root)):
        for reader, manager_cls in (("jax", jax_storage.WalManager), ("port", storage.WalManager)):
            copy = str(tmp_path / f"{writer}-read-by-{reader}")
            shutil.copytree(root, copy)
            replays[writer, reader] = await _replay_all(manager_cls, copy, fsync)
    reference = replays["jax", "jax"]
    assert all(replay == reference for replay in replays.values())
    records, _stats_ = reference
    assert any(report["torn_tail_records"] for _records, report in records.values())


def test_fault_injector_and_flaky_store_match_jax():
    ours, theirs = storage.FaultInjector(), jax_storage.FaultInjector()
    for injector in (ours, theirs):
        injector.fail_fsync(2)
        injector.fail_disk_full(1)
        injector.tear_next_write(0.25)
    seen = []
    for injector in (ours, theirs):
        row = []
        for check in ("check_fsync", "check_fsync", "check_fsync", "check_disk_full", "check_disk_full"):
            try:
                getattr(injector, check)()
                row.append("ok")
            except OSError as error:
                row.append(f"{type(error).__name__}:{error.errno}")
        row.append(injector.torn_write_bytes(100))
        row.append(injector.torn_write_bytes(100))
        row.append(dict(injector.counters))
        seen.append(row)
    assert seen[0] == seen[1]
    assert "ok" in seen[0] and any(str(v).startswith("OSError") for v in seen[0])

    async def run(store_cls):
        store = store_cls(failures=2)
        outcomes = []
        for _ in range(3):
            try:
                await store(None)
                outcomes.append("stored")
            except Exception as error:
                outcomes.append(type(error).__name__)
        return outcomes, store.calls, store.successes

    assert asyncio.run(run(storage.FlakyStore)) == asyncio.run(run(jax_storage.FlakyStore))


# -- the residency manager's eviction checkpoint ------------------------------


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_eviction_checkpoints_wal_like_jax(tmp_path, arena):
    """The port's twin of the JAX package's `test_eviction_checkpoints_wal`:
    an eviction folds the doc's snapshot into its log as a checkpoint that
    subsumes the per-update history, in files byte-identical to the JAX
    package's, and the checkpoint alone rebuilds the evicted doc."""
    from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
    from hocuspocus_tpu.tpu.residency import ResidencyManager as JaxManager
    from hocuspocus_tpu.tpu.serving import PlaneServing as JaxServing
    from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing, ResidencyManager
    from tests.test_torch_residency import _fingerprint, _random_edits

    rng = np.random.default_rng(11)
    sides = []
    for plane_cls, serving_cls, manager_cls, wal_cls, crdt, kwargs, root in (
        (JaxPlane, JaxServing, JaxManager, jax_storage.WalManager, jax_crdt, {}, "jax"),
        (MergePlane, PlaneServing, ResidencyManager, storage.WalManager, port_crdt,
         {"device": "cpu"}, "port"),
    ):
        plane = plane_cls(num_docs=4, capacity=4096, arena=arena, **kwargs)
        serving = serving_cls(plane)
        manager = manager_cls(plane=plane, serving=serving, hydrate_batch=4)
        wal = wal_cls(str(tmp_path / root), fsync="tick")
        ref = crdt.Doc()
        ref.client_id = 4242
        ref.wal_checkpoint = lambda snapshot, wal=wal: wal.checkpoint("wal-evict", snapshot)
        plane.register("wal-evict")
        plane.enqueue_update("wal-evict", crdt.encode_state_as_update(ref), presync=True)
        sides.append(SimpleNamespace(plane=plane, serving=serving, manager=manager, wal=wal, ref=ref,
                                     crdt=crdt, updates=[]))
    for side in sides:
        side.ref.on("update", lambda update, *rest, box=side.updates: box.append(update))
    # the same edits on both replicas: the JAX side's updates drive both
    _random_edits(rng, sides[0].ref, 20)
    for update in sides[0].updates:
        port_crdt.apply_update(sides[1].ref, update)
    sides[1].updates.clear()
    for side in sides:
        for update in sides[0].updates:
            side.wal.append("wal-evict", update)
            side.plane.enqueue_update("wal-evict", update)
        side.plane.flush()
        side.serving.refresh()
        await side.wal.flush()
    sides[0].updates.clear()
    assert _tree(str(tmp_path / "jax")) == _tree(str(tmp_path / "port"))
    for side in sides:
        records, _report = await side.wal.replay("wal-evict")
        assert len(records) >= 5, "the edit history is in the log before the eviction"
        assert await side.manager.evict("wal-evict", side.ref)
        assert side.manager.is_evicted("wal-evict")
        await side.wal.flush()
    assert _tree(str(tmp_path / "jax")) == _tree(str(tmp_path / "port"))
    for side in sides:
        records, report = await side.wal.replay("wal-evict")
        assert [rec_type for rec_type, _ in records] == [storage.REC_SNAPSHOT]
        assert report["torn_tail_records"] == 0
        rebuilt = side.crdt.Doc()
        side.crdt.apply_update(rebuilt, records[0][1])
        assert _fingerprint(rebuilt) == _fingerprint(side.ref)
        side.wal.close()


# -- Durability beside the served plane ----------------------------------------


class _DurableSide:
    """One package's core with Durability and its served plane (residency
    on, no timers), fed through direct connections."""

    def __init__(self, pkg, wal_dir, arena) -> None:
        ext_cls, config_cls, core_cls, crdt, durability_cls, extra = pkg
        self.crdt = crdt
        self.durability = durability_cls(wal_dir=wal_dir, fsync="tick")
        self.ext = ext_cls(
            num_docs=32, capacity=512, serve=True, arena=arena, governor=False,
            flush_interval_ms=1e6, evict_idle_secs=3600.0, hydrate_batch=8, **extra,
        )
        self.ext._schedule_broadcast = lambda: None
        self.core = core_cls(
            config_cls(quiet=True, extensions=[self.durability, self.ext], debounce=60_000,
                       max_debounce=60_000)
        )
        self.directs = {}

    async def open(self, names) -> None:
        await self.core.ensure_configured()
        for name in names:
            self.directs[name] = await self.core.open_direct_connection(name)

    async def feed(self, name, update) -> None:
        apply_update = self.crdt.apply_update
        await self.directs[name].transact(lambda doc: apply_update(doc, update, "storage-test"))

    async def flush(self) -> None:
        self.ext._broadcast_served()
        await self.ext._flush_now(max_batches=None, final=True)
        while self.ext._flush_tasks:
            await asyncio.gather(*list(self.ext._flush_tasks))
        await self.durability.wal.flush()

    async def evict(self, name) -> None:
        assert await self.ext.residency.evict(name, self.core.documents[name])

    async def hydrate(self, names) -> None:
        manager = self.ext.residency
        for name in names:
            manager.request_hydration(name, self.core.documents[name])
        for _ in range(200):
            await self.flush()
            if all(self.ext.is_served(name) for name in names):
                return
            await asyncio.sleep(0.01)
        raise AssertionError("the docs never hydrated")

    async def close_all(self) -> None:
        for direct in self.directs.values():
            await direct.disconnect()
        self.directs.clear()
        for _ in range(500):
            if not self.core.documents:
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"docs never unloaded: {sorted(self.core.documents)}")

    def text(self, name) -> str:
        return self.core.documents[name].get_text("t").to_string()


def _jax_pkg():
    return (JaxExtension, JaxConfiguration, JaxHocuspocus, jax_crdt, jax_storage.Durability, {})


def _port_pkg():
    return (TpuMergeExtension, Configuration, Hocuspocus, port_crdt, storage.Durability,
            {"device": "cpu"})


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_durability_beside_the_served_plane_matches_jax(tmp_path, arena):
    resolve_jax_codec()
    rng = np.random.default_rng(29)
    names = [f"doc-{i}" for i in range(6)]
    sides = (
        _DurableSide(_jax_pkg(), str(tmp_path / "jax"), arena),
        _DurableSide(_port_pkg(), str(tmp_path / "port"), arena),
    )
    groups = _editors(rng)[: len(names)]

    async def edit_round(step):
        for name, group in zip(names, groups):
            for update in _round(rng, group, step, plain=True):
                for side in sides:
                    await side.feed(name, update)
        for side in sides:
            await side.flush()

    def logs(side) -> dict:
        # doc segments by path; the commit journal by content (its file
        # index counts rotations, one per commit batch carrying a
        # checkpoint, which follows the batches' timing)
        tree = _tree(side.durability.wal.directory)
        journal = b"".join(tree.pop(path) for path in sorted(tree) if path.startswith("journal%"))
        return {**tree, "journal": journal}

    def same_logs(what):
        assert logs(sides[0]) == logs(sides[1]), what
        assert _stats(sides[0].durability.wal) == _stats(sides[1].durability.wal), what

    for side in sides:
        await side.open(names)
    for step in range(3):
        await edit_round(step)
    same_logs("served edits")
    # eviction folds each doc's snapshot into its log as a checkpoint
    for side in sides:
        for name in names:
            await side.evict(name)
        await side.durability.wal.flush()
    same_logs("eviction checkpoints")
    for side in sides:
        for name in names:
            records, _report = await side.durability.wal.replay(name)
            assert [rec_type for rec_type, _ in records] == [storage.REC_SNAPSHOT]
    # cold edits on the CPU documents, then the hydration rounds
    await edit_round(3)
    for side in sides:
        await side.hydrate(names)
    await edit_round(4)
    same_logs("hydration")
    texts = {name: sides[0].text(name) for name in names}
    assert texts == {name: sides[1].text(name) for name in names}
    # reload: every doc unloads, and Durability replays its log at load
    for side in sides:
        await side.close_all()
        await side.open(names)
        await side.flush()
    for side in sides:
        assert {name: side.text(name) for name in names} == texts
        assert sorted(side.durability.last_recovery) == sorted(names)
    assert sides[0].durability.last_recovery == sides[1].durability.last_recovery
    same_logs("reload")
    for side in sides:
        await side.close_all()
        await side.ext.on_destroy(None)
        side.durability.wal.close()


# -- kill -9 mid-storm -----------------------------------------------------------


async def _spawn_server(wal_dir):
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), wal_dir,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
    )
    line = await asyncio.wait_for(proc.stdout.readline(), timeout=40)
    assert line.startswith(b"PORT "), line
    return proc, int(line.split()[1])


async def _synced(*providers) -> None:
    for _ in range(1000):
        if all(p.synced for p in providers):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("providers never synced")


async def test_sigkill_mid_storm_loses_no_acknowledged_update(tmp_path):
    from hocuspocus_tpu_torch.crdt import Doc, encode_state_as_update, encode_state_vector
    from hocuspocus_tpu_torch.provider import HocuspocusProvider

    wal_dir = str(tmp_path / "wal")
    proc, port = await _spawn_server(wal_dir)
    url = f"ws://127.0.0.1:{port}"
    writer = HocuspocusProvider(name="storm-doc", url=url)
    observer = HocuspocusProvider(name="storm-doc", url=url)
    received = asyncio.Event()
    observer.document.on("update", lambda *args: received.set())
    try:
        await _synced(writer, observer)
        text = writer.document.get_text("t")
        killed = False
        for round_no in range(200):
            for burst in range(4):
                text.insert(len(str(text)), f"[{round_no}.{burst}]")
            await asyncio.sleep(0.005)
            # killed once the observer has been shown a chunk of the storm
            if round_no >= 25 and received.is_set():
                proc.send_signal(signal.SIGKILL)
                await proc.wait()
                killed = True
                break
        assert killed, "the server outlived the storm without showing it"
    finally:
        writer.destroy()
        observer.destroy()
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    await asyncio.sleep(0.1)
    shown = encode_state_as_update(observer.document)
    assert len(str(observer.document.get_text("t"))) > 0

    # both packages' readers rebuild a superset of what was shown
    for manager_cls, crdt in ((storage.WalManager, port_crdt), (jax_storage.WalManager, jax_crdt)):
        wal = manager_cls(wal_dir)
        records, _report = await wal.replay("storm-doc")
        wal.close()
        rebuilt = crdt.Doc()
        for _rec_type, payload in records:
            crdt.apply_update(rebuilt, payload)
        assert crdt.encode_state_as_update(observer.document if crdt is port_crdt else _as(crdt, shown),
                                           crdt.encode_state_vector(rebuilt)) == b"\x00\x00"

    # a restart on the same directory serves every update that was shown
    proc2, port2 = await _spawn_server(wal_dir)
    reader = HocuspocusProvider(name="storm-doc", url=f"ws://127.0.0.1:{port2}")
    try:
        await _synced(reader)
        missing = None
        for _ in range(300):
            missing = encode_state_as_update(observer.document, encode_state_vector(reader.document))
            if missing == b"\x00\x00":
                break
            await asyncio.sleep(0.01)
        assert missing == b"\x00\x00", f"the recovered doc lacks shown updates ({len(missing)} B)"
        merged = Doc()
        port_crdt.apply_update(merged, encode_state_as_update(reader.document))
        before = encode_state_as_update(merged)
        port_crdt.apply_update(merged, shown)
        assert encode_state_as_update(merged) == before
    finally:
        reader.destroy()
        proc2.kill()
        await proc2.wait()


def _as(crdt, update):
    doc = crdt.Doc()
    crdt.apply_update(doc, update)
    return doc


async def _crash_server(wal_dir: str) -> None:
    """The port's websocket server with Durability alone (no store: the
    WAL is the only durable state), on an OS-assigned port."""
    from hocuspocus_tpu_torch.server import Configuration, Server
    from hocuspocus_tpu_torch.storage import Durability

    server = Server(
        Configuration(
            extensions=[Durability(wal_dir=wal_dir)],
            quiet=True,
            debounce=600_000,
            max_debounce=600_000,
        )
    )
    await server.listen(port=0)
    print(f"PORT {server.port}", flush=True)
    await asyncio.Event().wait()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    asyncio.run(_crash_server(sys.argv[1]))
