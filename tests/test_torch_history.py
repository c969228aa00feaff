"""The port's History extension and HistoryClient against the JAX package's.

Twins of tests/extensions/test_history.py (history on plane-served docs
included, on a CPU plane) and tests/provider/test_history_client.py.
Each scenario runs once per package, through that package's server core,
providers on in-process sockets and History; its events (timestamps and
request ids left out, preview bytes decoded) and the documents it leaves
must be equal. Client ids are drawn at random in both packages, so
bytes that carry them are compared by what they decode to.
"""

import asyncio
import base64
import json
import time
import types

import pytest

import hocuspocus_tpu.aio as jax_aio
import hocuspocus_tpu.crdt as jax_crdt
import hocuspocus_tpu.extensions as jax_extensions
import hocuspocus_tpu.provider as jax_provider
import hocuspocus_tpu.server as jax_server
import hocuspocus_tpu.server.types as jax_types
import hocuspocus_tpu_torch.aio as port_aio
import hocuspocus_tpu_torch.crdt as port_crdt
import hocuspocus_tpu_torch.extensions as port_extensions
import hocuspocus_tpu_torch.provider as port_provider
import hocuspocus_tpu_torch.server as port_server
import hocuspocus_tpu_torch.server.types as port_types
from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

PACKAGES = {
    "jax": types.SimpleNamespace(
        aio=jax_aio, crdt=jax_crdt, extensions=jax_extensions, provider=jax_provider,
        server=jax_server, types=jax_types,
    ),
    "port": types.SimpleNamespace(
        aio=port_aio, crdt=port_crdt, extensions=port_extensions, provider=port_provider,
        server=port_server, types=port_types,
    ),
}

DEADLINE_S = 20.0


async def until(fn, timeout: float = DEADLINE_S) -> None:
    deadline = time.monotonic() + timeout
    while not fn():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met before the deadline")
        await asyncio.sleep(0.01)


class Run:
    """One package's core with `extensions`, providers on in-process
    sockets, and every stateless event each provider receives."""

    def __init__(self, pkg, extensions, **config) -> None:
        self.pkg = pkg
        self.core = pkg.server.Hocuspocus(
            pkg.server.Configuration(quiet=True, extensions=extensions, **config)
        )
        self.providers = []
        self.events: dict = {}

    async def start(self) -> "Run":
        await self.core.ensure_configured()
        return self

    def provider(self, name: str, **options):
        provider = self.pkg.provider.HocuspocusProvider(
            name=name,
            websocket_provider=self.pkg.provider.InProcessProviderSocket(self.core),
            **options,
        )
        provider.attach()
        box = self.events.setdefault(len(self.providers), [])
        provider.on("stateless", lambda data, box=box: box.append(json.loads(data["payload"])))
        self.providers.append(provider)
        return provider

    async def synced(self, *providers) -> None:
        await self.pkg.aio.await_synced(providers, timeout=DEADLINE_S)

    def send(self, provider, **request) -> None:
        provider.send_stateless(json.dumps(request))

    async def event(self, index: int, name: str, count: int = 1) -> list:
        box = self.events[index]
        await until(lambda: sum(1 for e in box if e.get("event") == name) >= count)
        return [e for e in box if e.get("event") == name]

    def normalised(self) -> dict:
        out = {}
        for index, box in self.events.items():
            rows = []
            for event in box:
                event = _strip(event)
                if "update" in event:
                    doc = self.pkg.crdt.Doc()
                    self.pkg.crdt.apply_update(doc, base64.b64decode(event.pop("update")))
                    event["decoded"] = {
                        "t": doc.get_text("t").to_delta(),
                        "meta": doc.get_map("meta").to_json(),
                    }
                rows.append(event)
            out[index] = rows
        return out

    async def stop(self) -> None:
        for provider in self.providers:
            provider.destroy()
            provider.websocket_provider.destroy()
        await self.core.hooks("on_destroy", self.pkg.types.Payload(instance=self.core))


def _strip(value):
    """`value` without its timestamps and request ids, at any depth."""
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in ("ts", "rid")}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


async def _both(scenario, *args):
    results = {}
    for name, pkg in PACKAGES.items():
        results[name] = await scenario(pkg, *args)
    assert results["port"] == results["jax"]
    return results["port"]


# -- twins of tests/extensions/test_history.py --------------------------------


async def _roundtrip(pkg):
    run = await Run(pkg, [pkg.extensions.History()]).start()
    try:
        a, b = run.provider("versioned"), run.provider("versioned")
        await run.synced(a, b)
        ta = a.document.get_text("t")
        ta.insert(0, "first draft")
        ta.format(0, 5, {"bold": True})
        a.document.get_map("meta").set("stage", "draft")
        await until(lambda: b.document.get_text("t").to_string() == "first draft")
        run.send(a, action="history.checkpoint", label="v1")
        vid = (await run.event(1, "history.checkpointed"))[0]["id"]
        ta.delete(0, 6)
        ta.insert(0, "second ")
        a.document.get_map("meta").set("stage", "final")
        await until(lambda: b.document.get_text("t").to_string() == "second draft")
        run.send(a, action="history.list")
        await run.event(0, "history.versions")
        run.send(a, action="history.preview", id=vid)
        await run.event(0, "history.preview")
        run.send(b, action="history.restore", id=vid)
        await until(
            lambda: a.document.get_text("t").to_string() == "first draft"
            and b.document.get_text("t").to_string() == "first draft"
            and a.document.get_map("meta").get("stage") == "draft"
        )
        await run.event(0, "history.restored")
        return run.normalised(), a.document.get_text("t").to_delta(), b.document.get_map("meta").to_json()
    finally:
        await run.stop()


async def test_checkpoint_list_preview_restore_roundtrip():
    events, delta, meta = await _both(_roundtrip)
    assert delta[0] == {"insert": "first", "attributes": {"bold": True}}
    assert meta == {"stage": "draft"}
    preview = next(e for e in events[0] if e["event"] == "history.preview")
    assert preview["decoded"]["meta"] == {"stage": "draft"}


async def _errors(pkg):
    run = await Run(pkg, [pkg.extensions.History()]).start()
    try:
        p = run.provider("errs")
        await run.synced(p)
        run.send(p, action="history.restore", id=999)
        run.send(p, action="history.bogus")
        run.send(p, action="history.diff", id=1, root="t")
        await run.event(0, "history.error", 3)
        return run.normalised()
    finally:
        await run.stop()


async def test_unknown_version_and_action_answer_errors():
    events = await _both(_errors)
    assert [e["error"] for e in events[0]] == [
        "unknown version", "unknown action 'history.bogus'", "unknown version",
    ]


async def _array_cap(pkg):
    history = pkg.extensions.History(max_versions=2)
    run = await Run(pkg, [history]).start()
    try:
        p = run.provider("arr")
        await run.synced(p)
        arr = p.document.get_array("items")
        arr.insert(0, [1, 2, 3])
        await until(lambda: len(history._docs["arr"].archive.get_array("items")) == 3)
        for label in ("one", "two", "three"):
            run.send(p, action="history.checkpoint", label=label)
        ids = [e["id"] for e in await run.event(0, "history.checkpointed", 3)]
        run.send(p, action="history.list")
        await run.event(0, "history.versions")
        arr.delete(0, 3)
        arr.insert(0, ["changed"])
        run.send(p, action="history.restore", id=ids[-1])
        await until(lambda: p.document.get_array("items").to_json() == [1, 2, 3])
        return run.normalised()
    finally:
        await run.stop()


async def test_array_roots_restore_and_version_cap():
    events = await _both(_array_cap)
    versions = next(e for e in events[0] if e["event"] == "history.versions")["versions"]
    assert [v["label"] for v in versions] == ["two", "three"]


async def _xml(pkg):
    run = await Run(pkg, [pkg.extensions.History()]).start()
    try:
        p, q = run.provider("xmldoc"), run.provider("xmldoc")
        await run.synced(p, q)
        frag = p.document.get_xml_fragment("x")
        para = pkg.crdt.YXmlElement("paragraph")
        frag.push([para])
        para.set_attribute("align", "left")
        text = pkg.crdt.YXmlText()
        para.push([text])
        text.insert(0, "styled tree")
        text.format(0, 6, {"bold": True})
        await until(lambda: "styled" in q.document.get_xml_fragment("x").to_string())
        run.send(p, action="history.checkpoint")
        vid = (await run.event(0, "history.checkpointed"))[0]["id"]
        before = p.document.get_xml_fragment("x").to_string()
        text.delete(0, 7)
        para.set_attribute("align", "center")
        frag.push([pkg.crdt.YXmlElement("hr")])
        await until(lambda: "hr" in q.document.get_xml_fragment("x").to_string())
        run.send(p, action="history.restore", id=vid)
        await until(
            lambda: p.document.get_xml_fragment("x").to_string() == before
            and q.document.get_xml_fragment("x").to_string() == before
        )
        return run.normalised(), before, q.document.get_xml_fragment("x").get(0).get_attribute("align")
    finally:
        await run.stop()


async def test_xml_roots_restore_via_deep_clones():
    _events, before, align = await _both(_xml)
    assert align == "left" and "<bold>" in before


async def _read_only(pkg):
    async def on_authenticate(data):
        data.connection_config.read_only = True

    run = await Run(pkg, [pkg.extensions.History()], on_authenticate=on_authenticate).start()
    try:
        p = run.provider("ro", token="t")
        await run.synced(p)
        run.send(p, action="history.checkpoint")
        run.send(p, action="history.restore", id=1)
        await run.event(0, "history.error", 2)
        run.send(p, action="history.list")
        await run.event(0, "history.versions")
        return run.normalised()
    finally:
        await run.stop()


async def test_read_only_connection_cannot_checkpoint_or_restore():
    events = await _both(_read_only)
    assert [e.get("error") for e in events[0]][:2] == ["read-only connection"] * 2


async def _unload_reload(pkg):
    history = pkg.extensions.History()
    run = await Run(pkg, [history], debounce=10).start()
    try:
        p = run.provider("transient")
        await run.synced(p)
        p.document.get_text("t").insert(0, "before unload")
        await until(
            lambda: "transient" in history._docs
            and history._docs["transient"].archive.get_text("t").to_string() == "before unload"
        )
        p.destroy()
        p.websocket_provider.destroy()
        run.providers.remove(p)
        await until(lambda: "transient" not in run.core.documents)
        await until(lambda: "transient" not in history._docs)
        q = run.provider("transient")
        await run.synced(q)
        await until(lambda: "transient" in history._docs)
        return history._docs["transient"].archive.get_text("t").to_string()
    finally:
        await run.stop()


async def test_unload_and_reload_with_history_installed():
    assert await _both(_unload_reload) == ""  # no persistence: a fresh archive


async def _diff(pkg):
    run = await Run(pkg, [pkg.extensions.History()]).start()
    try:
        alice, bob = run.provider("attributed"), run.provider("attributed")
        await run.synced(alice, bob)
        pud_a = pkg.crdt.PermanentUserData(alice.document)
        pud_b = pkg.crdt.PermanentUserData(bob.document)
        pud_a.set_user_mapping(alice.document, alice.document.client_id, "alice")
        pud_b.set_user_mapping(bob.document, bob.document.client_id, "bob")
        alice.document.get_text("t").insert(0, "alice wrote everything")
        await until(lambda: bob.document.get_text("t").to_string() == "alice wrote everything")
        run.send(alice, action="history.checkpoint", label="base")
        vid = (await run.event(0, "history.checkpointed"))[0]["id"]
        tb = bob.document.get_text("t")
        tb.delete(0, 6)
        tb.insert(0, "bob says: ")
        await until(lambda: alice.document.get_text("t").to_string() == "bob says: wrote everything")
        run.send(alice, action="history.diff", id=vid, root="t")
        return (await run.event(0, "history.diff"))[0]["delta"]
    finally:
        await run.stop()


async def test_history_diff_attributes_authors():
    delta = await _both(_diff)
    marks = {
        (op["attributes"]["ychange"]["type"], op["attributes"]["ychange"].get("user")): op["insert"]
        for op in delta
        if "ychange" in op.get("attributes", {})
    }
    assert marks[("added", "bob")] == "bob says: " and marks[("removed", "bob")] == "alice "


async def _plane(pkg, arena):
    reset_device_lane()
    kwargs = dict(num_docs=8, capacity=2048, flush_interval_ms=1, serve=True, arena=arena)
    if pkg is PACKAGES["port"]:
        from hocuspocus_tpu_torch.tpu import TpuMergeExtension

        ext = TpuMergeExtension(device="cpu", **kwargs)
    else:
        from hocuspocus_tpu.tpu import TpuMergeExtension

        ext = TpuMergeExtension(**kwargs)
    run = await Run(pkg, [pkg.extensions.History(), ext]).start()
    try:
        a, b = run.provider("plane-hist"), run.provider("plane-hist")
        await run.synced(a, b)
        ta = a.document.get_text("t")
        ta.insert(0, "plane-served history")
        await until(lambda: b.document.get_text("t").to_string() == "plane-served history")
        served = "plane-hist" in ext._docs
        run.send(a, action="history.checkpoint", label="v1")
        vid = (await run.event(0, "history.checkpointed"))[0]["id"]
        ta.delete(0, 13)
        ta.insert(0, "rewritten ")
        await until(lambda: b.document.get_text("t").to_string() == "rewritten history")
        run.send(a, action="history.restore", id=vid)
        await until(
            lambda: a.document.get_text("t").to_string() == "plane-served history"
            and b.document.get_text("t").to_string() == "plane-served history"
        )
        ta.insert(0, "after; ")
        await until(lambda: b.document.get_text("t").to_string() == "after; plane-served history")
        return served, run.normalised(), ext.plane.counters["docs_retired_unsupported"]
    finally:
        await run.stop()


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_history_on_plane_served_docs(arena):
    served, _events, unsupported = await _both(_plane, arena)
    assert served and unsupported == 0


async def _tombstoned_root(pkg):
    history = pkg.extensions.History()
    run = await Run(pkg, [history]).start()
    try:
        p = run.provider("tombstoned-root")
        await run.synced(p)
        arr = p.document.get_array("zz-emptied")
        arr.insert(0, ["gone", "soon"])
        arr.delete(0, 2)  # all tombstones at checkpoint time
        text = p.document.get_text("aa-text")
        text.insert(0, "keep me")
        await until(
            lambda: "tombstoned-root" in history._docs
            and history._docs["tombstoned-root"].archive.get_text("aa-text").to_string() == "keep me"
        )
        run.send(p, action="history.checkpoint", label="v")
        vid = (await run.event(0, "history.checkpointed"))[0]["id"]
        text.delete(0, len("keep me"))
        text.insert(0, "overwritten")
        arr.insert(0, ["revived"])
        run.send(p, action="history.restore", id=vid)
        await run.event(0, "history.restored")
        return (
            run.normalised(),
            p.document.get_text("aa-text").to_string(),
            p.document.get_array("zz-emptied").to_json(),
        )
    finally:
        await run.stop()


async def test_restore_with_all_tombstoned_array_root_is_not_half_rewritten():
    events, text, array = await _both(_tombstoned_root)
    assert not any(e.get("event") == "history.error" for e in events[0])
    assert text == "keep me" and array == []


async def _store_minted(pkg):
    history = pkg.extensions.History(checkpoint_on_store=True)
    run = await Run(pkg, [history], debounce=50).start()
    try:
        p = run.provider("store-mint")
        await run.synced(p)
        p.document.get_text("t").insert(0, "persist me")
        minted = (await run.event(0, "history.checkpointed"))[0]
        return {k: v for k, v in minted.items() if k != "ts"}, len(history._docs["store-mint"].versions)
    finally:
        await run.stop()


async def test_store_minted_checkpoint_broadcasts_checkpointed():
    minted, versions = await _both(_store_minted)
    assert minted["label"] == "store" and minted.get("origin") == "store" and versions >= 1


# -- twins of tests/provider/test_history_client.py ---------------------------


async def _client_flow(pkg):
    run = await Run(pkg, [pkg.extensions.History()]).start()
    try:
        writer, reviewer = run.provider("hc-doc"), run.provider("hc-doc")
        history = pkg.provider.HistoryClient(reviewer)
        await run.synced(writer, reviewer)
        text = writer.document.get_text("t")
        text.insert(0, "checkpoint me")
        await until(lambda: reviewer.document.get_text("t").to_string() == "checkpoint me")
        version = await history.checkpoint("v1")
        text.insert(0, "NEW: ")
        await until(lambda: reviewer.document.get_text("t").to_string() == "NEW: checkpoint me")
        versions = await history.list()
        old = await history.preview(version["id"])
        delta = await history.diff(version["id"], root="t")
        await history.restore(version["id"])
        await until(lambda: writer.document.get_text("t").to_string() == "checkpoint me")
        with pytest.raises(pkg.provider.HistoryError):
            await history.preview(999)
        history.destroy()
        return (
            _strip(version),
            [v["label"] for v in versions],
            old.get_text("t").to_string(),
            delta,
        )
    finally:
        await run.stop()


async def test_history_client_full_flow():
    version, labels, old, delta = await _both(_client_flow)
    assert version["label"] == "v1" and labels == ["v1"] and old == "checkpoint me"
    added = [op["insert"] for op in delta if op.get("attributes", {}).get("ychange", {}).get("type") == "added"]
    assert added == ["NEW: "]


class FakeProvider:
    def __init__(self) -> None:
        self.sent: list = []
        self.handlers: list = []

    def on(self, event, handler) -> None:
        self.handlers.append(handler)

    def off(self, event, handler) -> None:
        self.handlers.remove(handler)

    def send_stateless(self, payload) -> None:
        self.sent.append(json.loads(payload))

    def deliver(self, event: dict) -> None:
        for handler in list(self.handlers):
            handler({"payload": json.dumps(event)})


async def _rid(pkg):
    provider = FakeProvider()
    client = pkg.provider.HistoryClient(provider, timeout=5.0)
    out = []
    checkpoint = asyncio.ensure_future(client.checkpoint("mine"))
    preview = asyncio.ensure_future(client.preview(123))
    await asyncio.sleep(0)
    rid_checkpoint, rid_preview = provider.sent[0]["rid"], provider.sent[1]["rid"]
    out.append([{k: v for k, v in s.items() if k != "rid"} for s in provider.sent])
    provider.deliver({"event": "history.checkpointed", "id": 99, "label": "theirs", "ts": 1.0, "rid": "x-7"})
    await asyncio.sleep(0)
    out.append(checkpoint.done())
    provider.deliver({"event": "history.error", "error": "unknown version", "rid": rid_preview})
    await asyncio.sleep(0)
    out.append(checkpoint.done())
    try:
        await preview
        out.append("no error")
    except pkg.provider.HistoryError as error:
        out.append(str(error))
    provider.deliver({"event": "history.checkpointed", "id": 2, "label": "mine", "ts": 2.0, "rid": rid_checkpoint})
    out.append((await checkpoint)["id"])
    second = asyncio.ensure_future(client.checkpoint("mine-2"))
    await asyncio.sleep(0)
    rid_second = provider.sent[-1]["rid"]
    provider.deliver({"event": "history.checkpointed", "id": 7, "label": "store", "ts": 3.0, "origin": "store"})
    await asyncio.sleep(0)
    out.append(second.done())
    provider.deliver({"event": "history.checkpointed", "id": 3, "label": "mine-2", "ts": 4.0, "rid": rid_second})
    out.append((await second)["id"])
    listing = asyncio.ensure_future(client.list())
    await asyncio.sleep(0)
    provider.deliver({"event": "history.versions", "versions": [{"id": 1}]})
    out.append(await listing)
    client.destroy()
    return out


async def test_history_client_rid_correlation_is_exact():
    out = await _both(_rid)
    assert out[1:] == [False, False, "unknown version", 2, False, 3, [{"id": 1}]]


async def test_a_restore_is_stored_like_an_edit(tmp_path):
    """The server core stores only updates that come through a
    connection, so a History restore that no client edit follows was lost
    when its doc unloaded: the JAX package's History reloads such a doc as
    it was before the restore. The port's History schedules the store
    chain after a restore: the doc reloads from SQLite restored."""
    pkg = PACKAGES["port"]
    path = str(tmp_path / "restore.sqlite")
    run = await Run(pkg, [pkg.extensions.SQLite(database=path), pkg.extensions.History()], debounce=50).start()
    try:
        p = run.provider("restored")
        await run.synced(p)
        text = p.document.get_text("t")
        text.insert(0, "version one")
        run.send(p, action="history.checkpoint", label="v1")
        vid = (await run.event(0, "history.checkpointed"))[0]["id"]
        text.delete(0, len(text))
        text.insert(0, "version two")
        await asyncio.sleep(0.3)  # the edit's debounced store lands
        run.send(p, action="history.restore", id=vid)
        await run.event(0, "history.restored")
        await until(lambda: p.document.get_text("t").to_string() == "version one")
        p.destroy()
        p.websocket_provider.destroy()
        run.providers.remove(p)
        await until(lambda: "restored" not in run.core.documents)
    finally:
        await run.stop()
    again = await Run(pkg, [pkg.extensions.SQLite(database=path)]).start()
    try:
        q = again.provider("restored")
        await again.synced(q)
        assert q.document.get_text("t").to_string() == "version one"
    finally:
        await again.stop()
