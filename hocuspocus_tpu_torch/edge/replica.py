"""Hot-doc scale-out: follower cells + read-replica fan-out.

The edge tier made connection capacity an edge-replica count, but one owner per
doc means a single viral mega-doc (100k+ viewers, a handful of writers)
still saturates ONE cell's fan-out and catch-up path no matter how many
chips the fleet has. CRDT strong eventual convergence (Shapiro et al.)
makes read replication coordination-free: any cell holding a converged
copy of the doc can serve SyncStep2 catch-up and broadcast fan-out, and
state-based resync heals every delivery fault. This module is the cell
half of that subsystem (the edge half — audience watermark, follower
spread, promotion — lives in `gateway.py` + `router.py`):

- **A follower is an ordinary cell.** `ReplicaManager` keeps the
  follower's local `Document` converged by applying the owner's
  per-tick coalesced update stream (`REPLICA_TICK`, applied under
  `REPLICA_ORIGIN` so it can never echo back into a replication seam).
  Everything else — session ingress, the encode-once broadcast tick,
  the join-storm sync cache (naturally keyed per replica: each cell
  owns its own plane + serving cache), WAL gates, catch-up tiering —
  is the unmodified serving pipeline, which is the point: the read
  storm spreads across cells with zero new read-path code.

- **The owner keeps the write path.** Writers' updates ride the normal
  tick; the fanout's `replica_sink` seam hands each tick's local-origin
  updates to this manager, which streams ONE coalesced, seq-numbered
  `REPLICA_TICK` to every follower (plane-served docs deliver the same
  through the `on_plane_broadcast` window hook). A follower with local
  writers forwards them up as `REPLICA_PUSH`; the owner applies pushes
  under a replicable origin so the next tick re-streams them to every
  follower — including, idempotently, the pusher — and across the
  Redis instance boundary.

- **Gaps heal loudly, never silently.** Ticks are seq-numbered per doc.
  A follower seeing a gap counts a resync and re-FOLLOWs with its local
  state vector; the owner answers with the SV-diff plus its OWN state
  vector, and the follower pushes back anything the owner lacks — the
  symmetric exchange is what makes promotion lossless: whichever side
  has more state, one round trip converges both.

- **Bootstrap rides the migration rail.** A cold follower's first
  FOLLOW gets the owner's full-state snapshot through the residency
  serving path (`replica_snapshot` — the eviction encode WITHOUT the
  evict), and the follower seeds its own arena via `adopt_snapshot` +
  `request_hydration`, exactly like a migration target, so replica
  serving is device-backed from the first frame it serves.

- **Promotion is an edge decision.** On owner death the gateway picks
  the freshest follower (digest-carried tick seqs, HRW tie-break),
  clears the doc's stale router entries (`CellRouter.promote`), and
  sends a FOLLOW hint naming the new owner to every survivor; the
  promoted cell flips role in place and the re-FOLLOW SV exchange
  merges any fresher follower state into it — zero acked-update loss,
  no client-visible disconnect (channels heal through the ordinary
  Auth + SyncStep1 handoff replay).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from ..aio import spawn_tracked
from ..crdt import apply_update, encode_state_as_update, encode_state_vector
from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge
from ..protocol.sync import coalesce_updates
from ..server import logger
from ..server.hocuspocus import RequestInfo
from ..server.types import ConnectionConfiguration, REPLICA_ORIGIN
from . import relay

# Owner-side transaction origin for REPLICA_PUSH applies. Unlike
# REPLICA_ORIGIN these stay REPLICABLE: a follower's pushed writes must
# re-stream to every follower on the next tick and cross the Redis
# instance boundary like any local write. At a follower (stale-hint
# race, chained topologies) the same origin makes the apply forward UP
# through that follower's own push seam instead of dead-ending.
PUSH_ORIGIN = "__hocuspocus__replica_push__origin__"


class ReplicaManager:
    """Per-cell replication roles: which docs this cell OWNS (streams
    ticks for) and which it FOLLOWS (applies ticks for). One instance
    per `CellIngressExtension`; all sends ride the cell's pipelined
    relay lane."""

    def __init__(self, ext) -> None:
        self.ext = ext  # CellIngressExtension
        self.cell_id: str = ext.cell_id
        # doc -> {"seq": int, "followers": {cell_id: {"since": float}}}
        self.owned: "dict[str, dict]" = {}
        # doc -> {"owner": str, "last_seq": Optional[int], "synced":
        #         bool, "resyncing": bool, "last_tick_at": float}
        self.following: "dict[str, dict]" = {}
        # per-doc apply/bootstrap serialization: FIFO lock so envelope
        # handling (which may await document creation) stays in relay
        # order per doc
        self._locks: "dict[str, asyncio.Lock]" = {}
        self._tasks: set = set()
        self.counters = {
            "ticks_out": 0,
            "ticks_in": 0,
            "pushes_out": 0,
            "pushes_in": 0,
            "follows_in": 0,
            "bootstraps": 0,
            "resyncs": 0,
            "promotions": 0,
            "unfollows": 0,
        }
        # residency seams that raised (a device fault of the card's plane)
        self.card_faults = 0
        self._metrics = (
            Gauge(
                "hocuspocus_replica_followers",
                "Follower cells subscribed to docs owned by this cell",
                fn=lambda: float(
                    sum(len(s["followers"]) for s in self.owned.values())
                ),
            ),
            Gauge(
                "hocuspocus_replica_following",
                "Docs this cell follows as a read replica",
                fn=lambda: float(len(self.following)),
            ),
            Gauge(
                "hocuspocus_replica_tick_lag_seconds",
                "Oldest time since a followed doc's last replica tick",
                fn=self._max_tick_lag,
            ),
            Counter(
                "hocuspocus_replica_ticks_total",
                "Replica tick envelopes, by direction",
            ),
            Counter(
                "hocuspocus_replica_resyncs_total",
                "Lost-tick state-vector resyncs initiated by this cell",
            ),
            Counter(
                "hocuspocus_replica_promotions_total",
                "Follower-to-owner promotions performed by this cell",
            ),
        )
        (
            self._m_followers,
            self._m_following,
            self._m_lag,
            self._m_ticks,
            self._m_resyncs,
            self._m_promotions,
        ) = self._metrics

    # -- wiring ---------------------------------------------------------------

    def metrics(self) -> tuple:
        return self._metrics

    def _max_tick_lag(self) -> float:
        now = time.monotonic()
        lags = [
            now - state["last_tick_at"] for state in self.following.values()
        ]
        return round(max(lags), 3) if lags else 0.0

    def _spawn(self, coro) -> None:
        spawn_tracked(self._tasks, coro)

    def _card_fault(self, doc_name: str, seam: str) -> None:
        """Called inside the handler of a residency seam that raised: a
        device fault of the card's plane. Counted, logged and re-raised,
        so the follow fails loudly and no bootstrap goes out."""
        self.card_faults += 1
        get_flight_recorder().record("__replica__", "card_fault", doc=doc_name, seam=seam)
        logger.logger.error(
            f"[replica] {seam} of {doc_name!r} failed on the card", exc_info=True
        )
        raise

    def _lock(self, doc_name: str) -> asyncio.Lock:
        lock = self._locks.get(doc_name)
        if lock is None:
            lock = self._locks[doc_name] = asyncio.Lock()
        return lock

    def _send(self, cell_id: str, kind: int, aux: str, payload: bytes = b"") -> None:
        self.ext.publish_to_cell(
            cell_id, relay.encode_envelope(kind, self.cell_id, aux, payload)
        )

    async def _ensure_document(self, doc_name: str):
        instance = self.ext.instance
        document = instance.documents.get(doc_name)
        if document is not None:
            return document
        return await instance.create_document(
            doc_name,
            RequestInfo(
                headers={"x-hocuspocus-replica": self.cell_id},
                url="/__replica__",
                remote=self.cell_id,
            ),
            f"replica:{self.cell_id}",
            ConnectionConfiguration(is_authenticated=True),
            {"replica": self.cell_id},
        )

    def _residency(self, doc_name: str):
        """The local residency manager covering `doc_name`, or None —
        duck-typed over the instance's merge extensions (multi-device
        `residency_for`, single-plane `plane.residency`)."""
        instance = self.ext.instance
        if instance is None:
            return None
        extensions = getattr(instance, "_extensions", None) or getattr(
            instance.configuration, "extensions", []
        )
        for extension in extensions:
            residency_for = getattr(extension, "residency_for", None)
            if callable(residency_for):
                try:
                    return residency_for(doc_name)
                except Exception:
                    return None
            plane = getattr(extension, "plane", None)
            residency = getattr(plane, "residency", None)
            if residency is not None:
                return residency
        return None

    def _attach_sink(self, doc_name: str, document) -> None:
        """Point the doc's fanout replication seam at this manager.
        Role-agnostic at attach time: the sink dispatches per the
        CURRENT role on every call, so a promotion flips behavior
        without re-wiring the fanout."""

        def sink(updates: list) -> None:
            self._on_tick_updates(doc_name, updates)

        document.fanout.replica_sink = sink

    def on_document_loaded(self, doc_name: str, document) -> None:
        """`after_load_document` seam: a doc this cell owns or follows
        was (re)loaded — a reload dropped the fanout seam with the old
        fanout, so re-attach."""
        if doc_name in self.owned or doc_name in self.following:
            self._attach_sink(doc_name, document)

    # -- tick sources ---------------------------------------------------------

    def _on_tick_updates(self, doc_name: str, updates: list) -> None:
        """One broadcast tick's replicable (local-origin) updates — from
        the fanout's `replica_sink` seam, or a plane window's merged
        cross-update via `on_plane_broadcast`."""
        if doc_name in self.owned:
            update = coalesce_updates(updates)
            # merge failure must not lose updates: per-update ticks
            payloads = [update] if update is not None else list(updates)
            for payload in payloads:
                self._stream_tick(doc_name, payload)
        elif doc_name in self.following:
            state = self.following[doc_name]
            update = coalesce_updates(updates)
            payloads = [update] if update is not None else list(updates)
            for payload in payloads:
                self._send(
                    state["owner"],
                    relay.REPLICA_PUSH,
                    relay.encode_replica_aux(d=doc_name),
                    payload,
                )
                self.counters["pushes_out"] += 1

    def on_plane_broadcast(self, doc_name: str, update: bytes) -> None:
        """Plane-served docs bypass the fanout tick; their merged window
        (already stripped of remote/replica-origin ops by the capture
        seam) arrives here instead."""
        if update:
            self._on_tick_updates(doc_name, [update])

    def _stream_tick(self, doc_name: str, payload: bytes) -> None:
        state = self.owned.get(doc_name)
        if not state or not state["followers"]:
            return
        state["seq"] += 1
        aux = relay.encode_replica_aux(d=doc_name, s=state["seq"])
        for follower_id in state["followers"]:
            self._send(follower_id, relay.REPLICA_TICK, aux, payload)
        self.counters["ticks_out"] += 1
        self._m_ticks.inc(direction="out")

    # -- relay dispatch -------------------------------------------------------

    def dispatch(self, kind: int, sender: str, aux_raw: str, payload: bytes) -> None:
        """Entry from the cell's `_on_message` for the four replica
        envelope kinds. `sender` is the envelope's session field: the
        peer cell id (or the edge id, for FOLLOW hints)."""
        aux = relay.decode_replica_aux(aux_raw)
        doc_name = str(aux.get("d") or "")
        if not doc_name:
            return
        if kind == relay.FOLLOW:
            owner = aux.get("o")
            if owner is not None:
                # edge routing hint: "this doc's owner is `o`"
                self._spawn(self._handle_owner_hint(doc_name, str(owner)))
            else:
                follower = str(aux.get("f") or "")
                if follower:
                    self._spawn(
                        self._handle_follow(doc_name, follower, aux.get("sv"))
                    )
        elif kind == relay.UNFOLLOW:
            follower = str(aux.get("f") or "") or sender
            state = self.owned.get(doc_name)
            if state is not None and state["followers"].pop(follower, None):
                self.counters["unfollows"] += 1
                get_flight_recorder().record(
                    "__replica__", "unfollow", doc=doc_name, follower=follower
                )
        elif kind == relay.REPLICA_TICK:
            self._spawn(self._handle_tick(doc_name, aux, payload))
        elif kind == relay.REPLICA_PUSH:
            self._spawn(self._handle_push(doc_name, payload))

    # -- owner side -----------------------------------------------------------

    async def _handle_follow(
        self, doc_name: str, follower_id: str, follower_sv: Optional[bytes]
    ) -> None:
        """A follower subscribed (or is resyncing after a gap). Reply
        with a REPLICA_TICK bootstrap: the SV-diff (or a full residency
        snapshot for a cold follower) plus our OWN state vector so the
        follower can push back anything we lack — the symmetric exchange
        behind the zero-acked-loss promotion guarantee."""
        async with self._lock(doc_name):
            try:
                document = await self._ensure_document(doc_name)
            except Exception as error:
                logger.log_error(
                    f"[replica] owner load of {doc_name!r} failed: {error!r}"
                )
                return
            state = self.owned.get(doc_name)
            if state is None:
                state = self.owned[doc_name] = {"seq": 0, "followers": {}}
            self._attach_sink(doc_name, document)
            state["followers"][follower_id] = {"since": time.monotonic()}
            self.counters["follows_in"] += 1
            # cold follower (empty/absent state vector): full-state
            # snapshot through the residency serving path, flagged so
            # the follower seeds its arena via adopt_snapshot
            cold = not follower_sv or len(follower_sv) <= 1
            payload = None
            bootstrap = False
            # a failed serve of the plane raises out of these seams only
            # on the card (a CPU plane declines inside them): it must not
            # turn into a CPU diff that hides the device fault
            if cold:
                residency = self._residency(doc_name)
                if residency is not None:
                    try:
                        payload = residency.replica_snapshot(doc_name, document)
                    except Exception:
                        self._card_fault(doc_name, "replica_snapshot")
                    bootstrap = payload is not None
            if payload is None and not cold:
                # warm follower: the plane serves the SV-diff (device
                # tombstone pack, no host serve-log walk) when healthy
                residency = self._residency(doc_name)
                if residency is not None:
                    try:
                        payload = residency.replica_catchup(
                            doc_name, document, follower_sv
                        )
                    except Exception:
                        self._card_fault(doc_name, "replica_catchup")
            if payload is None:
                try:
                    payload = encode_state_as_update(
                        document, follower_sv if not cold else None
                    )
                except Exception:
                    payload = encode_state_as_update(document)
            aux = relay.encode_replica_aux(
                d=doc_name,
                s=state["seq"],
                r=1,
                b=1 if bootstrap else None,
                sv=encode_state_vector(document),
            )
            self._send(follower_id, relay.REPLICA_TICK, aux, payload)
            self.counters["bootstraps"] += 1
            get_flight_recorder().record(
                "__replica__",
                "follow",
                doc=doc_name,
                follower=follower_id,
                seq=state["seq"],
                bootstrap=bootstrap,
            )

    async def _handle_push(self, doc_name: str, payload: bytes) -> None:
        """A follower forwarded its local writers' coalesced updates.
        Applied under the replicable push origin: the next tick streams
        them to every follower (idempotent at the pusher), and at a
        non-owner (stale hint race) the same origin forwards them up
        through OUR push seam instead of dead-ending."""
        if not payload:
            return
        async with self._lock(doc_name):
            try:
                document = await self._ensure_document(doc_name)
                apply_update(document, payload, PUSH_ORIGIN)
            except Exception as error:
                logger.log_error(
                    f"[replica] push apply on {doc_name!r} failed: {error!r}"
                )
                return
            self.counters["pushes_in"] += 1

    # -- follower side --------------------------------------------------------

    async def _ensure_following(self, doc_name: str, owner_id: str) -> None:
        state = self.following.get(doc_name)
        if (
            state is not None
            and state["owner"] == owner_id
            and not state.get("resyncing")
        ):
            return
        was_owner = self.owned.pop(doc_name, None)
        try:
            document = await self._ensure_document(doc_name)
        except Exception as error:
            logger.log_error(
                f"[replica] follower load of {doc_name!r} failed: {error!r}"
            )
            return
        self.following[doc_name] = {
            "owner": owner_id,
            "last_seq": None,
            "synced": False,
            "resyncing": True,  # cleared by the bootstrap reply
            "last_tick_at": time.monotonic(),
        }
        self._attach_sink(doc_name, document)
        self._send(
            owner_id,
            relay.FOLLOW,
            relay.encode_replica_aux(
                d=doc_name, f=self.cell_id, sv=encode_state_vector(document)
            ),
        )
        get_flight_recorder().record(
            "__replica__",
            "follow",
            doc=doc_name,
            owner=owner_id,
            demoted=was_owner is not None,
        )

    async def _handle_owner_hint(self, doc_name: str, owner_id: str) -> None:
        """An edge declared the doc's owner. Us: become (or stay) the
        owner — a follower flips role in place (promotion). Another
        cell: follow it."""
        async with self._lock(doc_name):
            if owner_id != self.cell_id:
                await self._ensure_following(doc_name, owner_id)
                return
            prior = self.following.pop(doc_name, None)
            if prior is not None:
                # promotion: role flips, the doc's state stays — every
                # surviving follower re-FOLLOWs us with its SV and the
                # symmetric exchange merges anything fresher
                self.counters["promotions"] += 1
                self._m_promotions.inc()
                # best-effort: the old owner is usually dead, but a
                # drained one is still listening
                self._send(
                    prior["owner"],
                    relay.UNFOLLOW,
                    relay.encode_replica_aux(d=doc_name, f=self.cell_id),
                )
                get_flight_recorder().record(
                    "__replica__",
                    "promoted",
                    doc=doc_name,
                    old_owner=prior["owner"],
                    last_seq=prior.get("last_seq"),
                )
            if doc_name not in self.owned:
                self.owned[doc_name] = {"seq": 0, "followers": {}}
                try:
                    document = await self._ensure_document(doc_name)
                    self._attach_sink(doc_name, document)
                except Exception:
                    pass

    async def _handle_tick(self, doc_name: str, aux: dict, payload: bytes) -> None:
        async with self._lock(doc_name):
            state = self.following.get(doc_name)
            if state is None:
                return  # stale tick after unfollow/promotion
            try:
                seq = int(aux.get("s", -1))
            except Exception:
                return
            resync = bool(aux.get("r"))
            try:
                document = await self._ensure_document(doc_name)
            except Exception as error:
                logger.log_error(
                    f"[replica] follower load of {doc_name!r} failed: {error!r}"
                )
                return
            if payload:
                try:
                    apply_update(document, payload, REPLICA_ORIGIN)
                except Exception as error:
                    logger.log_error(
                        f"[replica] tick apply on {doc_name!r} failed: "
                        f"{error!r}"
                    )
                    return
                if resync and aux.get("b"):
                    # bootstrap snapshot: seed the local arena through
                    # the migration rail so replica serving is
                    # device-backed from the first frame
                    residency = self._residency(doc_name)
                    if residency is not None:
                        try:
                            residency.adopt_snapshot(doc_name, payload)
                            residency.request_hydration(doc_name, document)
                        except Exception:
                            pass  # CPU-path serving still converges
            self.counters["ticks_in"] += 1
            self._m_ticks.inc(direction="in")
            state["last_tick_at"] = time.monotonic()
            if resync:
                state["last_seq"] = seq
                state["synced"] = True
                state["resyncing"] = False
                owner_sv = aux.get("sv")
                if owner_sv:
                    # symmetric exchange: push back anything we hold
                    # that the owner lacks (promotion's freshest-state
                    # merge and the write-through for follower-local
                    # edits made while partitioned)
                    try:
                        back = encode_state_as_update(document, owner_sv)
                    except Exception:
                        back = None
                    if back and len(back) > 2:
                        self._send(
                            state["owner"],
                            relay.REPLICA_PUSH,
                            relay.encode_replica_aux(d=doc_name),
                            back,
                        )
                        self.counters["pushes_out"] += 1
                return
            previous = state["last_seq"]
            gap = previous is None or seq != previous + 1
            state["last_seq"] = seq
            if gap and not state.get("resyncing"):
                # lost tick: heal via the SV resync exchange — loudly
                # (counted + recorded), never silently
                state["resyncing"] = True
                self.counters["resyncs"] += 1
                self._m_resyncs.inc()
                get_flight_recorder().record(
                    "__replica__",
                    "lag_resync",
                    doc=doc_name,
                    expected=(previous + 1) if previous is not None else 0,
                    got=seq,
                )
                self._send(
                    state["owner"],
                    relay.FOLLOW,
                    relay.encode_replica_aux(
                        d=doc_name,
                        f=self.cell_id,
                        sv=encode_state_vector(document),
                    ),
                )

    # -- peer lifecycle -------------------------------------------------------

    def on_peer_down(self, cell_id: str) -> None:
        """A peer cell left (CELL_DOWN / CELL_DRAINING): drop it from
        every follower set. Docs we FOLLOW from it keep serving their
        last converged state — reads stay available through owner death
        — until the edge's promotion hint re-homes them."""
        for doc_name, state in self.owned.items():
            if state["followers"].pop(cell_id, None):
                get_flight_recorder().record(
                    "__replica__", "unfollow", doc=doc_name, follower=cell_id
                )
        for state in self.following.values():
            if state["owner"] == cell_id:
                state["synced"] = False

    def close(self) -> None:
        """Cell teardown: tell every owner we follow that we're gone
        (best-effort — owners also clean up on our CELL_DOWN)."""
        for doc_name, state in self.following.items():
            self._send(
                state["owner"],
                relay.UNFOLLOW,
                relay.encode_replica_aux(d=doc_name, f=self.cell_id),
            )
        self.following.clear()
        self.owned.clear()
        for task in list(self._tasks):
            task.cancel()
        self._tasks.clear()

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        """Digest + /debug payload: the replication topology as this
        cell sees it (fleet digests carry this under "replica")."""
        now = time.monotonic()
        return {
            "owned": {
                doc: {
                    "seq": state["seq"],
                    "followers": sorted(state["followers"]),
                }
                for doc, state in sorted(self.owned.items())
            },
            "following": {
                doc: {
                    "owner": state["owner"],
                    "seq": state["last_seq"],
                    "synced": state["synced"],
                    "lag_s": round(now - state["last_tick_at"], 3),
                }
                for doc, state in sorted(self.following.items())
            },
            "counters": dict(self.counters),
        }
