"""The port's extensions against the JAX package's, on the CPU.

Persistence: the same seeded edit stream stored through each package's
Database, SQLite and IncrementalSQLite gives equal rows byte for byte;
a database file (or an incremental log) written by either package is
loaded by the other package's server onto a CPU merge plane, and every
doc is served with the bytes the writer's own server serves, so a
deployment keeps its database across the switch. Logger lines, Throttle
bans, Webhook bodies, signatures and retry backoff (seeded jitter), and
S3's SigV4 headers at a fixed clock are held equal too.
"""

import asyncio
import datetime as real_datetime
import hashlib
import hmac
import json
import random
import sqlite3

import numpy as np
import pytest
from aiohttp import web

from hocuspocus_tpu import crdt as jax_crdt
from hocuspocus_tpu import extensions as jax_extensions
from hocuspocus_tpu.extensions import logger as jax_logger_module
from hocuspocus_tpu.extensions import s3 as jax_s3_module
from hocuspocus_tpu.extensions import throttle as jax_throttle_module
from hocuspocus_tpu.server import Configuration as JaxConfiguration
from hocuspocus_tpu.server import Hocuspocus as JaxHocuspocus
from hocuspocus_tpu.server.types import Payload as JaxPayload
from hocuspocus_tpu.tpu import TpuMergeExtension as JaxExtension
from hocuspocus_tpu_torch import crdt as port_crdt
from hocuspocus_tpu_torch import extensions as port_extensions
from hocuspocus_tpu_torch.extensions import logger as port_logger_module
from hocuspocus_tpu_torch.extensions import s3 as port_s3_module
from hocuspocus_tpu_torch.extensions import throttle as port_throttle_module
from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu import TpuMergeExtension
from tests.test_torch_server_parity import _editors, _round
from chip_smoke import make_pm_doc

PACKAGES = {
    "jax": (jax_crdt, jax_extensions, JaxPayload),
    "port": (port_crdt, port_extensions, Payload),
}


def _edit_stream(seed: int, docs: int = 6, rounds: int = 4):
    """[(round, doc name, update)] from 4 seeded editors a doc, mixed
    content (text, map, array), in the order a server receives them."""
    rng = np.random.default_rng(seed)
    groups = _editors(rng)[:docs]
    stream = []
    for step in range(rounds):
        for i, group in enumerate(groups):
            for update in _round(rng, group, step):
                stream.append((step, f"doc-{i}", update))
    return stream


def _tiptap_update(i: int) -> bytes:
    ydoc = jax_extensions.webhook.TiptapTransformer.to_ydoc(make_pm_doc(i))
    return jax_crdt.encode_state_as_update(ydoc)


async def _store_stream(package: str, ext, stream) -> None:
    """Apply the stream to the package's own docs and store after each
    round, through the extension's hooks."""
    crdt, _extensions, payload_cls = PACKAGES[package]
    if hasattr(ext, "on_configure"):
        await ext.on_configure(payload_cls(instance=None))
    docs: dict = {}
    for step in range(max(s for s, _, _ in stream) + 1):
        for s, name, update in stream:
            if s == step:
                crdt.apply_update(docs.setdefault(name, crdt.Doc()), update)
        for name in sorted(docs):
            await ext.on_store_document(payload_cls(document=docs[name], document_name=name))


def _rows(path: str, table: str) -> list:
    db = sqlite3.connect(path)
    try:
        order = "seq" if table == "document_updates" else "rowid"
        return db.execute(f'SELECT * FROM "{table}" ORDER BY {order}').fetchall()
    finally:
        db.close()


@pytest.mark.parametrize("seed", [1, 8])
async def test_stored_rows_are_equal_byte_for_byte(seed, tmp_path):
    stream = _edit_stream(seed)
    stream += [(3, f"tiptap-{i}", _tiptap_update(i)) for i in range(2)]
    stored: dict = {}
    for package, (_crdt, extensions, _payload) in PACKAGES.items():
        sqlite_path = str(tmp_path / f"{package}.sqlite")
        incremental_path = str(tmp_path / f"{package}-inc.sqlite")
        calls = []

        async def store(data, calls=calls):
            calls.append((data.document_name, bytes(data["state"])))

        sqlite = extensions.SQLite(database=sqlite_path)
        incremental = extensions.IncrementalSQLite(database=incremental_path, compact_after=3)
        database = extensions.Database(store=store)
        for ext in (sqlite, incremental, database):
            await _store_stream(package, ext, stream)
        await sqlite.on_destroy(None)
        await incremental.on_destroy(None)
        stored[package] = (
            _rows(sqlite_path, "documents"),
            _rows(incremental_path, "document_updates"),
            calls,
        )
    assert stored["port"] == stored["jax"]
    rows, log, calls = stored["port"]
    assert len(rows) == 8 and len(calls) == 6 * 4 + 2  # the Tiptap docs join in round 3
    assert len(log) == len(rows) and log[-1][0] > 3 * len(log)  # deltas appended, then compacted


class _Server:
    """One package's core: a persistence extension in front of a serve-
    mode merge plane on the CPU; docs opened over direct connections."""

    def __init__(self, package: str, persistence, arena: str) -> None:
        kwargs = dict(
            num_docs=32,
            capacity=2048,
            serve=True,
            arena=arena,
            native_lane=False,
            governor=False,
            flush_interval_ms=1e6,
        )
        if package == "jax":
            self.ext = JaxExtension(**kwargs)
            self.core = JaxHocuspocus(JaxConfiguration(quiet=True, extensions=[persistence, self.ext]))
        else:
            self.ext = TpuMergeExtension(device="cpu", **kwargs)
            self.core = Hocuspocus(Configuration(quiet=True, extensions=[persistence, self.ext]))
        self.directs = []

    async def serve_all(self, names) -> dict:
        await self.core.ensure_configured()
        served = {}
        for name in names:
            self.directs.append(await self.core.open_direct_connection(name))
            source = self.core.documents[name].sync_source
            assert source is not None, f"{name} left the plane"
            served[name] = await source.encode_state_as_update_async(None)
            assert served[name] is not None, f"{name} served by the CPU document"
        assert self.ext.plane.counters["cpu_fallbacks"] == 0
        return served

    async def close(self) -> None:
        for direct in self.directs:
            await direct.disconnect()
        await self.ext.on_destroy(None)


@pytest.mark.parametrize("kind", ["sqlite", "incremental"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_database_written_by_one_package_serves_equal_docs_from_the_other(
    arena, writer, kind, tmp_path
):
    stream = _edit_stream(4)
    names = sorted({name for _, name, _ in stream})
    path = str(tmp_path / "shared.sqlite")
    _crdt, extensions, _payload = PACKAGES[writer]
    ext = (
        extensions.SQLite(database=path)
        if kind == "sqlite"
        else extensions.IncrementalSQLite(database=path, compact_after=3)
    )
    await _store_stream(writer, ext, stream)
    await ext.on_destroy(None)

    served = {}
    for package in ("jax", "port"):
        _crdt, extensions, _payload = PACKAGES[package]
        persistence = (
            extensions.SQLite(database=path)
            if kind == "sqlite"
            else extensions.IncrementalSQLite(database=path)
        )
        server = _Server(package, persistence, arena)
        try:
            served[package] = await server.serve_all(names)
        finally:
            await server.close()
    assert served["port"] == served["jax"]
    # the served bytes rebuild the writer's docs
    reference: dict = {}
    for _, name, update in stream:
        jax_crdt.apply_update(reference.setdefault(name, jax_crdt.Doc()), update)
    for name in names:
        doc = port_crdt.Doc()
        port_crdt.apply_update(doc, served["port"][name])
        assert doc.get_text("t").to_string() == reference[name].get_text("t").to_string()
        assert port_crdt.encode_state_vector(doc) == jax_crdt.encode_state_vector(reference[name])


# -- Logger, Throttle ---------------------------------------------------------


class _FixedClock:
    class datetime:
        @staticmethod
        def now(tz=None):
            return real_datetime.datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=tz)


class _Instance:
    class configuration:
        name = "instance-7"


class _Request:
    rel_url = "/some/path?x=1"


async def test_logger_lines_are_equal(monkeypatch):
    lines = {}
    for package, module in (("jax", jax_logger_module), ("port", port_logger_module)):
        monkeypatch.setattr(module, "datetime", _FixedClock.datetime)
        _crdt, extensions, payload_cls = PACKAGES[package]
        out = []
        logger = extensions.Logger(log=out.append, on_change=False)
        await logger.on_configure(payload_cls(instance=_Instance()))
        for hook in (
            "on_load_document", "on_change", "on_store_document", "on_connect",
            "on_disconnect", "on_upgrade", "on_request", "on_listen", "on_destroy",
        ):
            await getattr(logger, hook)(payload_cls(document_name="doc-ü", request=_Request()))
        lines[package] = out
    assert lines["port"] == lines["jax"]
    assert lines["port"][0] == '[instance-7 2026-01-02T03:04:05.678901+00:00] Loaded document "doc-ü".'
    assert len(lines["port"]) == 7  # on_change off, on_listen silent


class _FakeTime:
    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


async def test_throttle_bans_are_equal(monkeypatch):
    decisions = {}
    for package, module in (("jax", jax_throttle_module), ("port", port_throttle_module)):
        clock = _FakeTime()
        monkeypatch.setattr(module, "time", clock)
        rng = np.random.default_rng(9)
        _crdt, extensions, payload_cls = PACKAGES[package]
        throttle = extensions.Throttle(throttle=5, considered_seconds=10, ban_time=0.1)
        out = []
        for step in range(600):
            clock.now += float(rng.exponential(0.7))
            ip = f"10.0.0.{int(rng.integers(0, 4))}"
            header = ["x-real-ip", "X-Forwarded-For"][step % 2]
            try:
                await throttle.on_connect(payload_cls(request_headers={header: ip}))
                out.append((step, ip, "ok"))
            except module.ThrottleRejection as rejection:
                out.append((step, ip, rejection.reason))
            if step % 97 == 0:
                throttle.clear_maps()
                out.append(sorted(throttle.banned_ips.items()))
        decisions[package] = out
    assert decisions["port"] == decisions["jax"]
    assert any(entry[-1] == "Too many connection attempts" for entry in decisions["port"] if isinstance(entry, tuple))


# -- Webhook ------------------------------------------------------------------


class Receiver:
    """In-process HTTP endpoint recording every webhook POST; answers
    `fail` times with HTTP 500 before it answers 200."""

    def __init__(self, fail: int = 0, create_body=None) -> None:
        self.fail = fail
        self.create_body = create_body
        self.requests: list = []
        self.runner = None
        self.url = ""

    async def start(self) -> "Receiver":
        app = web.Application()
        app.router.add_post("/", self.handle)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}/"
        return self

    async def handle(self, request):
        body = await request.read()
        self.requests.append((body, request.headers.get("X-Hocuspocus-Signature-256")))
        if self.fail:
            self.fail -= 1
            return web.Response(status=500)
        if self.create_body is not None and json.loads(body)["event"] == "create":
            return web.json_response(self.create_body)
        return web.json_response({})

    async def stop(self) -> None:
        await self.runner.cleanup()


async def test_webhook_bodies_signatures_and_backoff_are_equal(monkeypatch):
    results = {}
    for package, (crdt, extensions, payload_cls) in PACKAGES.items():
        receiver = await Receiver(fail=2).start()
        try:
            webhook = extensions.Webhook(
                url=receiver.url,
                secret="s3cr3t",
                events=[extensions.Events.onChange, extensions.Events.onCreate,
                        extensions.Events.onConnect, extensions.Events.onDisconnect],
                debounce=0,
                retries=2,
                retry_base_ms=1,
                retry_max_ms=4,
            )
            delays = []
            retry_delay = webhook._retry_delay
            monkeypatch.setattr(webhook, "_retry_delay", lambda attempt: delays.append(retry_delay(attempt)) or delays[-1])
            random.seed(1234)  # the jitter of backoff_delay_s
            doc = extensions.webhook.TiptapTransformer.to_ydoc(make_pm_doc(3))
            base = dict(
                document=doc,
                document_name="doc-ä",
                context={"user": 1},
                request_headers={"x-h": "v"},
                request_parameters={"q": "1"},
            )
            await webhook.on_change(payload_cls(**base))  # 2 x 500, then 200
            await webhook.on_connect(payload_cls(**base))
            await webhook.on_disconnect(payload_cls(**base))
            await webhook.on_load_document(payload_cls(**base))
            results[package] = (receiver.requests, delays)
        finally:
            await receiver.stop()
    assert results["port"] == results["jax"]
    requests, delays = results["port"]
    assert len(requests) == 6 and len(delays) == 2
    for body, signature in requests:
        assert signature == "sha256=" + hmac.new(b"s3cr3t", body, hashlib.sha256).hexdigest()
    assert json.loads(requests[0][0])["payload"]["document"] == {"default": make_pm_doc(3)}


async def test_webhook_create_imports_tiptap_json_equally(monkeypatch):
    """onCreate's answer `{"default": <Tiptap JSON>}` fills the empty
    field through the transformer: the same doc bytes in both packages
    (client id fixed)."""
    from hocuspocus_tpu.crdt import doc as jax_doc_module
    from hocuspocus_tpu_torch.crdt import doc as port_doc_module

    for module in (jax_doc_module, port_doc_module):
        monkeypatch.setattr(module, "generate_new_client_id", lambda: 99)
    encoded = {}
    cores = {"jax": (JaxHocuspocus, JaxConfiguration), "port": (Hocuspocus, Configuration)}
    for package, (crdt, extensions, _payload) in PACKAGES.items():
        receiver = await Receiver(create_body={"default": make_pm_doc(5)}).start()
        core_cls, config_cls = cores[package]
        webhook = extensions.Webhook(url=receiver.url, events=[extensions.Events.onCreate])
        core = core_cls(config_cls(quiet=True, extensions=[webhook]))
        try:
            await core.ensure_configured()
            direct = await core.open_direct_connection("d")  # loads through the webhook
            doc = core.documents["d"]
            encoded[package] = crdt.encode_state_as_update(doc)
            assert extensions.webhook.TiptapTransformer.from_ydoc(doc, "default") == make_pm_doc(5)
            assert json.loads(receiver.requests[0][0])["event"] == "create"
            await direct.disconnect()
        finally:
            await receiver.stop()
    assert encoded["port"] == encoded["jax"]


# -- S3 -----------------------------------------------------------------------


class FakeS3:
    """Path-style S3 over HTTP, recording every request's signed headers."""

    def __init__(self) -> None:
        self.objects: dict = {}
        self.seen: list = []
        self.runner = None
        self.endpoint = ""

    async def start(self) -> "FakeS3":
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self.handle)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        self.endpoint = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        return self

    async def handle(self, request):
        self.seen.append(
            (
                request.method,
                request.path,
                request.headers.get("Authorization"),
                request.headers.get("x-amz-date"),
                request.headers.get("x-amz-content-sha256"),
            )
        )
        if request.method == "PUT":
            self.objects[request.path] = await request.read()
            return web.Response()
        if request.method == "GET":
            if request.path not in self.objects:
                return web.Response(status=404)
            return web.Response(body=self.objects[request.path])
        return web.Response()

    async def stop(self) -> None:
        await self.runner.cleanup()


class _FixedS3Clock:
    timezone = real_datetime.timezone

    class datetime:
        @staticmethod
        def now(tz=None):
            return real_datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=tz)


async def test_s3_sigv4_and_round_trip_are_equal(monkeypatch):
    results = {}
    for package, module in (("jax", jax_s3_module), ("port", port_s3_module)):
        monkeypatch.setattr(module, "datetime", _FixedS3Clock)
        crdt, extensions, payload_cls = PACKAGES[package]
        fake = await FakeS3().start()
        try:
            s3 = extensions.S3(
                bucket="docs",
                endpoint=fake.endpoint,
                prefix="collab/",
                access_key_id="AKIDEXAMPLE",
                secret_access_key="wJalrXUtnFEMI/K7MDENG",
            )
            await s3.on_configure(payload_cls(instance=None))  # HEAD probe
            doc = crdt.Doc()
            doc.client_id = 5
            doc.get_text("t").insert(0, "stored in s3 ✓")
            await s3.on_store_document(payload_cls(document=doc, document_name="s3 doc/ä"))
            loaded = crdt.Doc()
            await s3.on_load_document(payload_cls(document=loaded, document_name="s3 doc/ä"))
            missing = crdt.Doc()
            await s3.on_load_document(payload_cls(document=missing, document_name="absent"))
            assert loaded.get_text("t").to_string() == "stored in s3 ✓"
            # the endpoint's port differs between the two runs and is signed
            # as the host header; everything else of the request is equal
            host = fake.endpoint.split("//", 1)[1]
            expected_host = s3.client._headers("PUT", "/p", b"", host)
            results[package] = (
                [(m, p, date, digest) for m, p, _auth, date, digest in fake.seen],
                dict(fake.objects),
                s3.client._headers("GET", "/docs/collab/x.bin", b"", "s3.example:9000"),
                expected_host["x-amz-date"],
            )
        finally:
            await fake.stop()
    assert results["port"] == results["jax"]
    headers = results["port"][2]
    assert headers["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260304/us-east-1/s3/aws4_request, "
        "SignedHeaders=host;x-amz-content-sha256;x-amz-date, Signature="
    )
    assert [m for m, *_ in results["port"][0]] == ["HEAD", "PUT", "GET", "GET"]


async def test_sqlite_load_storm_reads_each_docs_own_row(tmp_path):
    """256 concurrent stores, then 256 concurrent loads, on one SQLite
    extension: each load returns its own doc's row and none fails. The
    worker threads share one sqlite3 connection, so the port serializes
    them with a lock (without it, a storm returned other docs' rows and
    "bad parameter or other API misuse" errors)."""
    sqlite = port_extensions.SQLite(database=str(tmp_path / "storm.sqlite"))
    await sqlite.on_configure(Payload(instance=None))

    def row(i: int) -> bytes:
        return bytes([i % 256]) * (i + 1)

    async def store(i: int) -> None:
        payload = Payload(document_name=f"d{i}")
        payload["state"] = row(i)
        await sqlite._store(payload)

    for _ in range(3):
        await asyncio.gather(*(store(i) for i in range(256)))
        loaded = await asyncio.gather(*(sqlite._fetch(Payload(document_name=f"d{i}")) for i in range(256)))
        assert [bytes(b) for b in loaded] == [row(i) for i in range(256)]
    await sqlite.on_destroy(None)
