"""Version history — snapshot checkpoints with preview and restore.

Beyond the reference's surface (the reference ecosystem ships document
versioning as a paid Tiptap add-on built on the same yjs snapshot
machinery this extension uses): each loaded document gets a
GC-disabled archive replica fed by its update stream, checkpoints are
minted on demand (or on every store), and clients drive everything
over the existing stateless channel — no new wire messages.

Client -> server (JSON over a Stateless message; an optional "rid"
request id is echoed verbatim in every reply/error and in the
broadcasts the request triggers, so clients can correlate exactly):
    {"action": "history.checkpoint", "label": "before cleanup"?, "rid"?}
    {"action": "history.list", "rid"?}
    {"action": "history.preview", "id": 3, "rid"?}
    {"action": "history.restore", "id": 3, "rid"?}

Server -> client:
    {"event": "history.checkpointed", "id", "label", "ts"}   (broadcast)
    {"event": "history.versions", "versions": [{id,label,ts}]}
    {"event": "history.preview", "id", "update": "<base64>"}  (reconstruct
        with Doc() + apply_update on the client)
    {"event": "history.restored", "id"}                       (broadcast)
    {"event": "history.error", "error"}

Restore rewrites the LIVE document's root types to the checkpointed
content as ordinary edits (delete + reinsert in one transaction), so it
propagates to every client and remains undoable. Text roots keep their
formatting via delta re-application; map/array roots restore to their
JSON content; XML trees restore via deep prelim clones (elements keep
attributes and children, text keeps its formatted delta). Y-type
embeds inside text remain preview-only (one type instance cannot
belong to two docs).
"""

from __future__ import annotations

import base64
import copy
import json
import time
from typing import Any, Optional

from ..crdt import Doc, apply_update, create_doc_from_snapshot, encode_state_as_update, snapshot
from ..crdt.content import ContentFormat, ContentString, ContentType
from ..crdt.types.base import AbstractType
from ..crdt.types.ymap import YMap
from ..crdt.types.ytext import YText
from ..crdt.types.yarray import YArray
from ..crdt.update import Snapshot
from ..server.types import Extension, Payload


class _DocHistory:
    __slots__ = ("archive", "versions", "next_id", "listener", "document", "pud")

    def __init__(self) -> None:
        self.archive = Doc(gc=False)
        self.versions: list[dict] = []
        self.next_id = 1
        self.listener = None
        # the LIVE doc the listener is attached to: the unload hook's
        # payload carries only the name (the doc is already torn down)
        self.document = None
        # lazily-created PermanentUserData over the archive (one per
        # doc — each instance registers observers on the users arrays)
        self.pud = None


class History(Extension):
    """In-memory version history. `max_versions` caps retained
    checkpoints per document (oldest dropped); `checkpoint_on_store`
    also mints one whenever the store hooks run (debounced saves)."""

    def __init__(self, max_versions: int = 50, checkpoint_on_store: bool = False) -> None:
        self.max_versions = max_versions
        self.checkpoint_on_store = checkpoint_on_store
        self._docs: dict[str, _DocHistory] = {}
        self._instance = None  # the server core, for a restore's store chain

    # -- lifecycle ---------------------------------------------------------

    async def after_load_document(self, data: Payload) -> None:
        self._instance = data.instance
        name = data.document_name
        if name in self._docs:
            return
        hist = _DocHistory()
        apply_update(hist.archive, encode_state_as_update(data.document), "history")

        def on_update(update: bytes, _origin: Any, *_rest: Any) -> None:
            apply_update(hist.archive, update, "history")

        hist.listener = on_update
        hist.document = data.document
        data.document.on("update", on_update)
        self._docs[name] = hist

    async def after_unload_document(self, data: Payload) -> None:
        # the unload payload carries only the NAME (the doc is already
        # torn down) — detach from the reference captured at load
        hist = self._docs.pop(data.document_name, None)
        if hist is not None and hist.listener is not None and hist.document is not None:
            try:
                hist.document.off("update", hist.listener)
            except Exception:
                pass  # the doc is being destroyed either way

    async def after_store_document(self, data: Payload) -> None:
        if self.checkpoint_on_store:
            version = self._checkpoint(data.document_name, label="store")
            document = data.get("document")
            if version is not None and document is not None:
                # store-minted versions announce themselves exactly like
                # the stateless checkpoint action does — without this,
                # clients only discovered them by polling history.list.
                # origin tags the broadcast as server-initiated so the
                # HistoryClient's rid-less fallback never mistakes it
                # for the reply to a pending checkpoint request
                document.broadcast_stateless(
                    json.dumps(
                        {"event": "history.checkpointed", "origin": "store", **version}
                    )
                )

    # -- the stateless protocol --------------------------------------------

    async def on_stateless(self, data: Payload) -> None:
        try:
            request = json.loads(data.payload)
        except (TypeError, ValueError):
            return
        action = request.get("action", "") if isinstance(request, dict) else ""
        if not action.startswith("history."):
            return
        name = data.document_name
        document = data.document
        send = data.connection.send_stateless
        # request-id echo: clients may attach a "rid"; every reply,
        # error and initiator-triggered broadcast carries it back so
        # the provider's HistoryClient resolves the EXACT pending
        # request instead of correlating by event kind + send order
        rid = request.get("rid")

        def reply(payload: dict) -> None:
            if rid is not None:
                payload = {**payload, "rid": rid}
            send(json.dumps(payload))

        def broadcast(payload: dict) -> None:
            if rid is not None:
                payload = {**payload, "rid": rid}
            document.broadcast_stateless(json.dumps(payload))

        if action in ("history.checkpoint", "history.restore") and getattr(
            data.connection, "read_only", False
        ):
            # the sync path refuses read-only updates; a restore that
            # rewrites every root (or minting checkpoints) must not be
            # a side door around that permission
            reply({"event": "history.error", "error": "read-only connection"})
            return

        if action == "history.checkpoint":
            version = self._checkpoint(name, request.get("label"))
            if version is None:
                reply({"event": "history.error", "error": "no history for document"})
                return
            broadcast({"event": "history.checkpointed", **version})
        elif action == "history.list":
            versions = [
                {"id": v["id"], "label": v["label"], "ts": v["ts"]}
                for v in self._versions(name)
            ]
            reply({"event": "history.versions", "versions": versions})
        elif action == "history.preview":
            restored = self._restore_doc(name, request.get("id"))
            if restored is None:
                reply({"event": "history.error", "error": "unknown version"})
                return
            update = base64.b64encode(encode_state_as_update(restored)).decode()
            reply(
                {"event": "history.preview", "id": request.get("id"), "update": update}
            )
        elif action == "history.diff":
            # attributed diff of a TEXT root between a version and now
            # (or between two versions): ychange added/removed runs,
            # with author names when a PermanentUserData registry is
            # replicated in the doc (root "users")
            hist = self._docs.get(name)
            if hist is None:
                reply({"event": "history.error", "error": "no history for document"})
                return
            base = self._find_version(name, request.get("id"))
            if base is None:
                reply({"event": "history.error", "error": "unknown version"})
                return
            if request.get("until") is not None:
                until = self._find_version(name, request.get("until"))
                if until is None:
                    reply({"event": "history.error", "error": "unknown 'until' version"})
                    return
            else:
                # "until now" needs a CONCRETE snapshot: removed-run
                # marking compares visibility against it (a None
                # snapshot renders plain current text, yjs semantics)
                until = snapshot(hist.archive)
            root = request.get("root", "default")
            target = hist.archive.share.get(root)
            if target is None or _classify_root(target) != "text":
                # never get_text() an unvalidated client-supplied name:
                # it would CREATE a missing root or raise retyping an
                # existing non-text one (e.g. the "users" registry)
                reply(
                    {"event": "history.error", "error": f"root {root!r} is not a text root"}
                )
                return
            compute = self._ychange_resolver(hist)
            delta = hist.archive.get_text(root).to_delta(
                until, base, compute_ychange=compute
            )
            for op in delta:
                if isinstance(op.get("insert"), AbstractType):
                    # embedded Y types are not JSON: ship their snapshot
                    op["insert"] = op["insert"].to_json()
            reply(
                {
                    "event": "history.diff",
                    "id": request.get("id"),
                    "until": request.get("until"),
                    "root": root,
                    "delta": delta,
                }
            )
        elif action == "history.restore":
            restored = self._restore_doc(name, request.get("id"))
            if restored is None:
                reply({"event": "history.error", "error": "unknown version"})
                return
            try:
                _rewrite_live_doc(document, restored)
            except _UnsupportedRestore as error:
                reply({"event": "history.error", "error": str(error)})
                return
            self._store_restore(data, document)
            broadcast({"event": "history.restored", "id": request.get("id")})
        else:
            reply({"event": "history.error", "error": f"unknown action {action!r}"})

    # -- internals ---------------------------------------------------------

    def _store_restore(self, data: Payload, document) -> None:
        """Schedule the store chain for a restore, as a client's edit
        would: the server core stores only updates that came through a
        connection, so a restore no client edit followed was lost at
        unload (the document reloaded as it was before it)."""
        instance = self._instance
        if instance is None or not hasattr(instance, "store_document_hooks"):
            return
        connection = data.get("connection")
        instance.store_document_hooks(
            document,
            Payload(
                clients_count=document.get_connections_count(),
                context=getattr(connection, "context", None) or {},
                document=document,
                document_name=document.name,
                instance=instance,
                request_headers={},
                request_parameters={},
                socket_id=getattr(connection, "socket_id", "history.restore"),
            ),
        )

    def _versions(self, name: str) -> list[dict]:
        hist = self._docs.get(name)
        return hist.versions if hist is not None else []

    def _checkpoint(self, name: str, label: Optional[str] = None) -> Optional[dict]:
        hist = self._docs.get(name)
        if hist is None:
            return None
        snap = snapshot(hist.archive)
        version = {
            "id": hist.next_id,
            "label": label or f"version {hist.next_id}",
            "ts": time.time(),
            "snapshot": base64.b64encode(snap.encode()).decode(),
        }
        hist.next_id += 1
        hist.versions.append(version)
        if len(hist.versions) > self.max_versions:
            hist.versions.pop(0)
        return {k: version[k] for k in ("id", "label", "ts")}

    def _find_version(self, name: str, version_id) -> Optional[Snapshot]:
        hist = self._docs.get(name)
        if hist is None:
            return None
        version = next((v for v in hist.versions if v["id"] == version_id), None)
        if version is None:
            return None
        return Snapshot.decode(base64.b64decode(version["snapshot"]))

    def _restore_doc(self, name: str, version_id) -> Optional[Doc]:
        snap = self._find_version(name, version_id)
        if snap is None:
            return None
        return create_doc_from_snapshot(self._docs[name].archive, snap)

    def _ychange_resolver(self, hist: _DocHistory):
        """compute_ychange backed by the doc's replicated user registry
        (root "users", PermanentUserData layout); plain marks when the
        doc has none."""
        if "users" not in hist.archive.share:
            return None
        if hist.pud is None:
            from ..crdt import PermanentUserData

            hist.pud = PermanentUserData(hist.archive)

        def compute(kind: str, struct_id) -> dict:
            user = (
                hist.pud.get_user_by_deleted_id(struct_id)
                if kind == "removed"
                else hist.pud.get_user_by_client_id(struct_id.client)
            )
            out = {"type": kind}
            if user is not None:
                out["user"] = user
            return out

        return compute


class _UnsupportedRestore(Exception):
    pass


def _concrete_kind(ytype) -> Optional[str]:
    """The root's kind when its Python type already pins it; None for
    generic AbstractType roots (created by remote integrates before any
    typed access)."""
    from ..crdt.types.yxml import YXmlFragment

    # order matters: YXmlFragment before the others (YXmlElement is a
    # fragment; YXmlText/YXmlHook subclass YText/YMap and classify as
    # text/map, matching how the rewrite path addresses them)
    if isinstance(ytype, YXmlFragment):
        return "xml"
    if isinstance(ytype, YText):
        return "text"
    if isinstance(ytype, YMap):
        return "map"
    if isinstance(ytype, YArray):
        return "array"
    return None


def _classify_root(ytype, live=None) -> str:
    """Best-effort root-type classification: roots created by remote
    integrates are GENERIC AbstractType instances until typed access.

    `live`: the live document's root of the same name, if any. An
    all-tombstoned sequence carries no content to sniff (a gc-enabled
    restored doc collapses deleted typed content to GC ranges), so the
    live root's concrete type is the only trustworthy signal there —
    defaulting to 'text' mistyped emptied array/map roots and made
    restore raise mid-transaction (ADVICE.md)."""
    kind = _concrete_kind(ytype)
    if kind is not None:
        return kind
    if ytype._map and ytype._start is None:
        return "map"
    item = ytype._start
    while item is not None:
        if isinstance(item.content, (ContentString, ContentFormat)):
            return "text"
        if isinstance(item.content, ContentType):
            return "xml"
        if not item.deleted:
            return "array"
        item = item.right
    if live is not None:
        live_kind = _concrete_kind(live)
        if live_kind is not None:
            return live_kind
        # server-side roots are usually generic too (typed access only
        # ever happened client-side): sniff the live root's CONTENT —
        # it holds the post-checkpoint state the tombstoned target lost
        return _classify_root(live)
    return "text" if not ytype._map else "map"


def _clone_xml_node(node):
    """Deep-copy a restored-doc XML node into a FRESH prelim node the
    live doc can integrate (one type instance cannot belong to two
    docs). Elements keep attributes and children; text keeps its
    formatted delta."""
    from ..crdt.types.yxml import YXmlElement, YXmlText

    if isinstance(node, YXmlText):
        fresh = YXmlText()
        delta = node.to_delta()
        for op in delta:
            if isinstance(op.get("insert"), AbstractType):
                raise _UnsupportedRestore("XML text embeds a Y type: preview-only")
        if delta:
            fresh.apply_delta(delta)
        return fresh
    if isinstance(node, YXmlElement):
        fresh = YXmlElement(node.node_name)
        for key, value in node.get_attributes().items():
            if isinstance(value, AbstractType):
                raise _UnsupportedRestore(
                    "XML attribute holds a Y type: preview-only"
                )
            fresh.set_attribute(key, value)
        kids = [_clone_xml_node(child) for child in node.to_array()]
        if kids:
            fresh.push(kids)
        return fresh
    if isinstance(node, AbstractType):
        raise _UnsupportedRestore(
            f"unsupported XML child {type(node).__name__}: preview-only"
        )
    # plain values (strings, numbers, json) are legal fragment children
    return copy.deepcopy(node)


def _rewrite_live_doc(document, restored: Doc) -> None:
    """Make the live doc render the restored version, as ordinary edits
    (one transaction -> one broadcastable update; undoable)."""
    names = set(document.share.keys()) | set(restored.share.keys())
    plan: list = []
    # validate EVERYTHING before mutating: a mid-transaction refusal
    # would leave the live doc half-rewritten
    for name in sorted(names):
        target = restored.share.get(name)
        live = document.share.get(name)
        if target is not None:
            kind = _classify_root(target, live)
        else:
            kind = _classify_root(live)
        # the run() below addresses the LIVE root through typed getters
        # (get_text/get_map/...), which raise mid-transaction on a
        # differently-typed root — refuse BEFORE mutating instead
        live_kind = _concrete_kind(live) if live is not None else None
        if live_kind is not None and kind != live_kind:
            raise _UnsupportedRestore(
                f"root {name!r} is {live_kind} in the live document but "
                f"{kind} in the checkpoint"
            )
        payload = None
        if kind == "text" and target is not None:
            payload = restored.get_text(name).to_delta()
            for op in payload:
                if isinstance(op.get("insert"), AbstractType):
                    # a nested Y type from the RESTORED doc must not be
                    # re-integrated into the live doc (one instance
                    # cannot belong to two docs)
                    raise _UnsupportedRestore(
                        f"text root {name!r} embeds a Y type: preview-only"
                    )
        elif kind == "xml" and target is not None:
            payload = [
                _clone_xml_node(child)
                for child in restored.get_xml_fragment(name).to_array()
            ]
        plan.append((name, kind, target, payload))

    def run(_transaction) -> None:
        for name, kind, target, payload in plan:
            if kind == "text":
                live = document.get_text(name)
                live.delete(0, len(live))
                if payload:
                    live.apply_delta(payload)
            elif kind == "xml":
                live = document.get_xml_fragment(name)
                if len(live):
                    live.delete(0, len(live))
                if payload:
                    live.push(payload)
            elif kind == "map":
                live = document.get_map(name)
                old = restored.get_map(name).to_json() if target is not None else {}
                for key in list(live.keys()):
                    if key not in old:
                        live.delete(key)
                for key, value in old.items():
                    live.set(key, value)
            elif kind == "array":
                live = document.get_array(name)
                live.delete(0, len(live))
                old = restored.get_array(name).to_json() if target is not None else []
                if old:
                    live.insert(0, old)

    document.transact(run, origin="history.restore")
