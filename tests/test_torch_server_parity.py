"""The port's served path against the JAX package's, on the CPU.

The same seeded stream of Yjs updates (16 docs, 4 concurrent editors
each, mixed content) goes through the JAX package's Hocuspocus core with
its TpuMergeExtension (serve mode, with and without the native text
lane, no governor, no timers: broadcasts and flushes are explicit) and
through the port's with the same settings, in the same order, over
direct connections. After every flush the arena
tensors must be equal element for element, the broadcast frames and the
SyncStep2 bytes served for an empty and a mid-stream state vector equal
byte for byte, and the plane counters equal. Cross-wire tests run each
package's provider against the other package's websocket server, and the
protocol writers are held byte for byte.
"""

import asyncio

import numpy as np
import pytest

from hocuspocus_tpu import crdt as jax_crdt
from hocuspocus_tpu.server import Configuration as JaxConfiguration
from hocuspocus_tpu.server import Hocuspocus as JaxHocuspocus
from hocuspocus_tpu.tpu import TpuMergeExtension as JaxExtension
from hocuspocus_tpu_torch import crdt as port_crdt
from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
from hocuspocus_tpu_torch.tpu import TpuMergeExtension
from tests.test_torch_parity_isolation import resolve_jax_codec
from tests.test_torch_plane import COUNTERS, assert_planes_equal
from tests.tpu.test_plane_fuzz import WORDS, _doc_fingerprint, _pair_align, _random_edit

DOCS = 16
CLIENTS = 4
ROUNDS = 6
ORIGIN = "parity-client"


class _Recorder:
    """Records every frame the extension hands to a document's broadcast
    tick and every cross-instance window it publishes."""

    def __init__(self) -> None:
        self.frames: list = []
        self.cross: list = []

    async def on_plane_broadcast(self, data) -> None:
        self.cross.append((data.document_name, bytes(data.update)))

    def wrap(self, document) -> None:
        queue = document.queue_broadcast

        def recorded(update, *args, **kwargs):
            self.frames.append((document.name, bytes(update)))
            return queue(update, *args, **kwargs)

        document.queue_broadcast = recorded


class _Side:
    """One package's core + extension, fed through direct connections."""

    def __init__(self, ext_cls, config_cls, core_cls, crdt, arena, native_lane, **kwargs) -> None:
        self.crdt = crdt
        self.ext = ext_cls(
            num_docs=256,
            capacity=512,
            serve=True,
            arena=arena,
            native_lane=native_lane,
            governor=False,
            flush_interval_ms=1e6,
            **kwargs,
        )
        # broadcasts only when the test runs a pass
        self.ext._schedule_broadcast = lambda: None
        assert self.ext.native_lane is native_lane
        self.recorder = _Recorder()
        self.core = core_cls(config_cls(quiet=True, extensions=[self.ext, self.recorder]))
        self.directs = {}

    async def open(self, names) -> None:
        await self.core.ensure_configured()
        for name in names:
            self.directs[name] = await self.core.open_direct_connection(name)
            self.recorder.wrap(self.core.documents[name])

    async def feed(self, name: str, update: bytes) -> None:
        apply_update = self.crdt.apply_update
        await self.directs[name].transact(lambda doc: apply_update(doc, update, ORIGIN))

    async def broadcast(self) -> None:
        self.ext._broadcast_served()
        await self._settle()

    async def flush(self) -> None:
        await self.ext._flush_now(max_batches=None, final=True)
        await self._settle()

    async def _settle(self) -> None:
        while self.ext._flush_tasks:
            await asyncio.gather(*list(self.ext._flush_tasks))

    async def serve(self, name: str, sv):
        source = self.core.documents[name].sync_source
        assert source is not None, f"{name} left the plane for the CPU document"
        return await source.encode_state_as_update_async(sv)

    async def close(self) -> None:
        for direct in self.directs.values():
            await direct.disconnect()
        await self.ext.on_destroy(None)


def _editors(rng):
    """DOCS x CLIENTS replica docs (JAX package's CRDT), each recording
    its own updates."""
    groups = []
    for _ in range(DOCS):
        group = []
        for _ in range(CLIENTS):
            doc = jax_crdt.Doc()
            doc.client_id = int(rng.integers(1, 2**32))
            box = []
            doc.on("update", lambda update, origin, *rest, box=box: origin != "peer" and box.append(update))
            group.append((doc, box))
        groups.append(group)
    return groups


def _plain_edit(rng, doc) -> None:
    """A text-only edit: the shape that stays on the native text lane."""
    text = doc.get_text("t")
    if len(text) > 2 and rng.random() < 0.3:
        pos = _pair_align(text, int(rng.integers(0, len(text) - 1)))
        end = _pair_align(text, min(pos + int(rng.integers(1, 4)), len(text)))
        if end > pos:
            text.delete(pos, end - pos)
        return
    text.insert(_pair_align(text, int(rng.integers(0, len(text) + 1))), WORDS[rng.integers(0, len(WORDS))])


def _round(rng, group, step: int, plain: bool = False) -> list:
    """Every editor edits its own replica (text only when `plain`), then
    the updates are exchanged; returns them shuffled, the order in which
    the servers receive them."""
    for doc, _box in group:
        for k in range(int(rng.integers(1, 4))):
            if plain:
                _plain_edit(rng, doc)
            else:
                _random_edit(rng, doc, step * 10 + k)
    sent = [(j, update) for j, (_doc, box) in enumerate(group) for update in box]
    for _doc, box in group:
        box.clear()
    for j, (doc, _box) in enumerate(group):
        for src, update in sent:
            if src != j:
                jax_crdt.apply_update(doc, update, "peer")
    order = rng.permutation(len(sent))
    return [sent[k][1] for k in order]


def _assert_counters_equal(jax_plane, plane) -> None:
    for key in COUNTERS + ("cpu_fallbacks", "docs_recycled", "sync_cache_hits"):
        assert jax_plane.counters[key] == plane.counters[key], key


@pytest.mark.parametrize("native_lane", [False, True])
@pytest.mark.parametrize("seed", [5, 23])
@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_served_path_matches_jax_after_every_flush(arena, seed, native_lane):
    if native_lane:
        # the JAX side's lane needs its codec, whatever this worker's
        # first resolution of it found (test_torch_parity_isolation.py)
        resolve_jax_codec()
    rng = np.random.default_rng(seed)
    names = [f"doc-{i}" for i in range(DOCS)]
    jax_side = _Side(JaxExtension, JaxConfiguration, JaxHocuspocus, jax_crdt, arena, native_lane)
    port = _Side(
        TpuMergeExtension, Configuration, Hocuspocus, port_crdt, arena, native_lane, device="cpu"
    )
    await jax_side.open(names)
    await port.open(names)
    groups = _editors(rng)
    stale = {}
    try:
        for step in range(ROUNDS):
            for i, (name, group) in enumerate(zip(names, groups)):
                # with the lane on, half the docs stay plain text (the
                # lane's shape) and half carry mixed content (the demote
                # and in-place rebuild)
                for update in _round(rng, group, step, plain=native_lane and i % 2 == 0):
                    await jax_side.feed(name, update)
                    await port.feed(name, update)
            # broadcasts build from the host logs, before the flush
            await jax_side.broadcast()
            await port.broadcast()
            # one frame per dirty doc, in the order of a set: by doc
            assert sorted(port.recorder.frames) == sorted(jax_side.recorder.frames)
            assert sorted(port.recorder.cross) == sorted(jax_side.recorder.cross)
            await jax_side.flush()
            await port.flush()
            assert_planes_equal(jax_side.ext.plane, port.ext.plane)
            _assert_counters_equal(jax_side.ext.plane, port.ext.plane)
            for name, group in zip(names, groups):
                # read on both servers alike: reading a root types it, and
                # a typed Y.Text cleans up formats in later transactions
                want = _doc_fingerprint(port.core.documents[name])
                assert _doc_fingerprint(jax_side.core.documents[name]) == want
                for sv in (None, stale.get(name)):
                    if step == 0 and sv is not None:
                        continue
                    ours = await port.serve(name, sv)
                    assert ours == await jax_side.serve(name, sv)
                    if sv is None and isinstance(ours, bytes):
                        rebuilt = port_crdt.Doc()
                        port_crdt.apply_update(rebuilt, ours)
                        assert _doc_fingerprint(rebuilt) == want
                if step % 2 == 0:
                    stale[name] = jax_crdt.encode_state_vector(group[0][0])
            _assert_counters_equal(jax_side.ext.plane, port.ext.plane)
        assert port.recorder.frames and port.ext.plane.counters["sync_serves"] > 0
        # every doc is still served from the plane on both sides: a lane
        # demote rebuilds in place, it never hands a doc to the CPU
        for side in (jax_side, port):
            assert side.ext.plane.counters["cpu_fallbacks"] == 0
            assert sorted(side.ext._docs) == sorted(names)
        lane_docs = sorted(n for n, d in port.ext.plane.docs.items() if d.lane_slot is not None)
        assert lane_docs == sorted(
            n for n, d in jax_side.ext.plane.docs.items() if d.lane_slot is not None
        )
        for key in ("docs_retired_lane_demote", "docs_retired_unsupported"):
            assert port.ext.plane.counters[key] == jax_side.ext.plane.counters[key], key
        if native_lane:
            # the plain-text half stays on the lane, the mixed half demotes
            assert lane_docs == sorted(names[::2])
            assert port.ext.plane.counters["docs_retired_lane_demote"] == DOCS // 2
            for name in names[1::2]:
                doc = port.ext.plane.docs[name]
                assert doc.lane_slot is None and not doc.retired, name
        else:
            assert not lane_docs
    finally:
        await jax_side.close()
        await port.close()


async def _cross_wire(server, provider_cls, crdt):
    """Two providers of one package edit a doc concurrently on the other
    package's websocket server, a third joins late; all converge."""
    from tests.utils import retryable_assertion

    await server.listen(port=0)
    url = server.web_socket_url
    editors = [provider_cls(name="wire", url=url) for _ in range(2)]
    late = None
    try:
        for provider in editors:
            await _synced(provider)
        editors[0].document.get_text("t").insert(0, "hello ")
        editors[1].document.get_text("t").insert(0, "world ")

        def converged(providers):
            texts = {p.document.get_text("t").to_string() for p in providers}
            server_text = server.documents["wire"].get_text("t").to_string()
            assert texts == {server_text} and len(server_text) == 12

        await retryable_assertion(lambda: converged(editors), timeout=30)
        editors[1].document.get_text("t").delete(0, 3)
        late = provider_cls(name="wire", url=url)
        await _synced(late)

        def settled():
            texts = {p.document.get_text("t").to_string() for p in editors + [late]}
            assert texts == {server.documents["wire"].get_text("t").to_string()}
            assert len(texts.pop()) == 9

        await retryable_assertion(settled, timeout=30)
        rebuilt = crdt.Doc()
        crdt.apply_update(rebuilt, crdt.encode_state_as_update(late.document))
        assert rebuilt.get_text("t").to_string() == late.document.get_text("t").to_string()
    finally:
        for provider in editors + ([late] if late is not None else []):
            provider.destroy()
        await server.destroy()


async def _synced(provider, timeout: float = 30.0) -> None:
    deadline = asyncio.get_event_loop().time() + timeout
    while not provider.synced:
        assert asyncio.get_event_loop().time() < deadline, "provider never synced"
        await asyncio.sleep(0.02)


async def test_jax_providers_converge_on_the_ports_websocket_server():
    from hocuspocus_tpu.provider import HocuspocusProvider as JaxProvider
    from hocuspocus_tpu_torch.server import Server

    ext = TpuMergeExtension(num_docs=8, capacity=256, serve=True, device="cpu")
    server = Server(Configuration(quiet=True, extensions=[ext]))
    await _cross_wire(server, JaxProvider, jax_crdt)
    assert ext.plane.counters["plane_broadcasts"] > 0
    assert ext.plane.counters["sync_serves"] > 0
    assert ext.plane.counters["cpu_fallbacks"] == 0


async def test_port_providers_converge_on_the_jax_websocket_server():
    from hocuspocus_tpu.server import Server as JaxServer
    from hocuspocus_tpu_torch.provider import HocuspocusProvider

    ext = JaxExtension(num_docs=8, capacity=256, serve=True)
    server = JaxServer(JaxConfiguration(quiet=True, extensions=[ext]))
    await _cross_wire(server, HocuspocusProvider, port_crdt)
    assert ext.plane.counters["plane_broadcasts"] > 0
    assert ext.plane.counters["cpu_fallbacks"] == 0


@pytest.mark.parametrize("seed", [2, 9])
def test_protocol_writers_are_byte_identical(seed):
    """frames, sync, awareness and auth writers of the two packages, on
    the same seeded docs."""
    from hocuspocus_tpu.crdt.encoding import Encoder as JaxEncoder
    from hocuspocus_tpu.protocol import auth as jax_auth
    from hocuspocus_tpu.protocol import awareness as jax_awareness
    from hocuspocus_tpu.protocol import frames as jax_frames
    from hocuspocus_tpu.protocol import message as jax_message
    from hocuspocus_tpu.protocol import sync as jax_sync
    from hocuspocus_tpu_torch.crdt.encoding import Encoder
    from hocuspocus_tpu_torch.protocol import auth, awareness, frames, message, sync

    rng = np.random.default_rng(seed)
    jax_doc, doc = jax_crdt.Doc(), port_crdt.Doc()
    jax_doc.client_id = int(rng.integers(1, 2**32))
    updates = []
    jax_doc.on("update", lambda update, *rest: updates.append(update))
    for step in range(12):
        _random_edit(rng, jax_doc, step)
    for update in updates:
        port_crdt.apply_update(doc, update)
    assert port_crdt.encode_state_as_update(doc) == jax_crdt.encode_state_as_update(jax_doc)
    half_sv = port_crdt.encode_state_vector(port_crdt.Doc())

    def both(write, jax_write, *args):
        ours, theirs = Encoder(), JaxEncoder()
        write(ours, *args)
        jax_write(theirs, *args)
        assert ours.to_bytes() == theirs.to_bytes(), write.__name__

    both(lambda e: sync.write_sync_step1(e, doc), lambda e: jax_sync.write_sync_step1(e, jax_doc))
    for sv in (None, half_sv, port_crdt.encode_state_vector(doc)):
        both(
            lambda e: sync.write_sync_step2(e, doc, sv),
            lambda e: jax_sync.write_sync_step2(e, jax_doc, sv),
        )
    for update in updates[:4]:
        both(sync.write_update, jax_sync.write_update, update)
    assert sync.coalesce_updates(updates) == jax_sync.coalesce_updates(updates)
    for token in ("", "secret-token", "ключ"):
        both(auth.write_authentication, jax_auth.write_authentication, token)
        both(auth.write_permission_denied, jax_auth.write_permission_denied, token)
        both(auth.write_authenticated, jax_auth.write_authenticated, token or "read-write")

    aw_doc, jax_aw_doc = port_crdt.Doc(), jax_crdt.Doc()
    aw_doc.client_id = jax_aw_doc.client_id = int(rng.integers(1, 2**32))
    ours_aw, theirs_aw = awareness.Awareness(aw_doc), jax_awareness.Awareness(jax_aw_doc)
    state = {"user": {"name": "ada", "color": "#%06x" % int(rng.integers(0, 2**24))}}
    for aw in (ours_aw, theirs_aw):
        aw.set_local_state(state)
    clients = [aw_doc.client_id]
    assert awareness.encode_awareness_update(ours_aw, clients) == jax_awareness.encode_awareness_update(
        theirs_aw, clients
    )
    assert (
        message.OutgoingMessage("d").create_awareness_update_message(ours_aw).to_bytes()
        == jax_message.OutgoingMessage("d").create_awareness_update_message(theirs_aw).to_bytes()
    )
    ours_aw.destroy()
    theirs_aw.destroy()

    names = ["doc", "dóc-ü", "x" * 300]
    for name in names:
        for reply in (False, True):
            assert frames.build_update_frame(name, updates[0], reply) == jax_frames.build_update_frame(
                name, updates[0], reply
            )
        for ok in (False, True):
            assert frames.build_sync_status_frame(name, ok) == jax_frames.build_sync_status_frame(name, ok)
    items = [(name, update) for name, update in zip(names * 4, updates)]
    built = frames.build_update_frames_batch(items)
    assert built == jax_frames.build_update_frames_batch(items)
    assert [frames.parse_frame_header(f) for f in built] == [
        jax_frames.parse_frame_header(f) for f in built
    ]
    assert frames.parse_frame_headers_batch(built + [b"\xff"], skip_malformed=True) == (
        jax_frames.parse_frame_headers_batch(built + [b"\xff"], skip_malformed=True)
    )
