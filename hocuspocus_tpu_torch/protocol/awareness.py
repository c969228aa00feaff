"""Awareness CRDT (y-protocols/awareness equivalent).

Ephemeral per-client presence state (cursors, names) with clock-based
last-writer-wins semantics. Wire format: varUint numClients; per client:
varUint clientID, varUint clock, varString JSON state ("null" = removed).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Iterable, Optional

from ..crdt import Doc
from ..crdt.doc import Observable
from ..crdt.encoding import Decoder, Encoder

OUTDATED_TIMEOUT = 30.0  # seconds


class Awareness(Observable):
    def __init__(self, doc: Doc, outdated_timeout: float = OUTDATED_TIMEOUT) -> None:
        super().__init__()
        self.doc = doc
        self.client_id = doc.client_id
        self.states: dict[int, dict] = {}
        # client -> {"clock": int, "last_updated": float}
        self.meta: dict[int, dict] = {}
        self.outdated_timeout = outdated_timeout
        self._check_task: Optional[asyncio.Task] = None
        self.set_local_state({})
        # Periodic keepalive: renew the local state (generating awareness
        # traffic that keeps idle connections alive past the reconnect
        # timeout) and prune outdated remote clients — the y-protocols
        # Awareness check interval. Only when a loop is running.
        try:
            loop = asyncio.get_running_loop()
            self._check_task = loop.create_task(self._check_loop())
        except RuntimeError:
            pass

    async def _check_loop(self) -> None:
        interval = self.outdated_timeout / 10
        while True:
            await asyncio.sleep(interval)
            now = time.monotonic()
            local_meta = self.meta.get(self.client_id)
            if (
                self.get_local_state() is not None
                and local_meta is not None
                and self.outdated_timeout / 2 <= now - local_meta["last_updated"]
            ):
                self.set_local_state(self.get_local_state())
            remove_outdated(self, self.outdated_timeout)

    def destroy(self) -> None:
        if self._check_task is not None:
            self._check_task.cancel()
            self._check_task = None
        self.emit("destroy", self)
        self.set_local_state(None)
        self._observers = {}

    def get_local_state(self) -> Optional[dict]:
        return self.states.get(self.client_id)

    def set_local_state(self, state: Optional[dict]) -> None:
        client_id = self.client_id
        curr_meta = self.meta.get(client_id)
        clock = 0 if curr_meta is None else curr_meta["clock"] + 1
        prev_state = self.states.get(client_id)
        if state is None:
            self.states.pop(client_id, None)
        else:
            self.states[client_id] = state
        self.meta[client_id] = {"clock": clock, "last_updated": time.monotonic()}
        added, updated, filtered_updated, removed = [], [], [], []
        if state is None:
            if prev_state is not None:
                removed.append(client_id)
        elif prev_state is None:
            added.append(client_id)
        else:
            updated.append(client_id)
            if prev_state != state:
                filtered_updated.append(client_id)
        if added or filtered_updated or removed:
            self.emit("change", {"added": added, "updated": filtered_updated, "removed": removed}, "local")
        self.emit("update", {"added": added, "updated": updated, "removed": removed}, "local")

    def set_local_state_field(self, field: str, value: Any) -> None:
        state = self.get_local_state()
        if state is not None:
            new_state = dict(state)
            new_state[field] = value
            self.set_local_state(new_state)

    def get_states(self) -> dict[int, dict]:
        return self.states


def remove_awareness_states(awareness: Awareness, clients: Iterable[int], origin: Any) -> None:
    removed = []
    for client_id in clients:
        if client_id in awareness.states:
            del awareness.states[client_id]
            if client_id == awareness.client_id:
                curr_meta = awareness.meta[client_id]
                awareness.meta[client_id] = {
                    "clock": curr_meta["clock"] + 1,
                    "last_updated": time.monotonic(),
                }
            removed.append(client_id)
    if removed:
        awareness.emit("change", {"added": [], "updated": [], "removed": removed}, origin)
        awareness.emit("update", {"added": [], "updated": [], "removed": removed}, origin)


def encode_awareness_update(
    awareness: Awareness, clients: Iterable[int], states: Optional[dict[int, dict]] = None
) -> bytes:
    states = awareness.states if states is None else states
    clients = list(clients)
    encoder = Encoder()
    encoder.write_var_uint(len(clients))
    for client_id in clients:
        state = states.get(client_id)
        clock = awareness.meta.get(client_id, {"clock": 0})["clock"]
        encoder.write_var_uint(client_id)
        encoder.write_var_uint(clock)
        encoder.write_var_string(json.dumps(state, separators=(",", ":")))
    return encoder.to_bytes()


def apply_awareness_update(awareness: Awareness, update: bytes, origin: Any) -> None:
    decoder = Decoder(update)
    timestamp = time.monotonic()
    added, updated, filtered_updated, removed = [], [], [], []
    length = decoder.read_var_uint()
    for _ in range(length):
        client_id = decoder.read_var_uint()
        clock = decoder.read_var_uint()
        state = json.loads(decoder.read_var_string())
        client_meta = awareness.meta.get(client_id)
        prev_state = awareness.states.get(client_id)
        curr_clock = 0 if client_meta is None else client_meta["clock"]
        if curr_clock < clock or (
            curr_clock == clock and state is None and client_id in awareness.states
        ):
            if state is None:
                if client_id == awareness.client_id and awareness.get_local_state() is not None:
                    # never remove the local state; refresh it with a higher clock
                    clock += 1
                else:
                    awareness.states.pop(client_id, None)
            else:
                awareness.states[client_id] = state
            awareness.meta[client_id] = {"clock": clock, "last_updated": timestamp}
            if client_meta is None and state is not None:
                added.append(client_id)
            elif client_meta is not None and state is None:
                removed.append(client_id)
            elif state is not None:
                if state != prev_state:
                    filtered_updated.append(client_id)
                updated.append(client_id)
    if added or filtered_updated or removed:
        awareness.emit(
            "change", {"added": added, "updated": filtered_updated, "removed": removed}, origin
        )
    if added or updated or removed:
        awareness.emit("update", {"added": added, "updated": updated, "removed": removed}, origin)


def remove_outdated(awareness: Awareness, timeout: float = OUTDATED_TIMEOUT) -> list[int]:
    """Prune remote states not refreshed within `timeout` seconds."""
    now = time.monotonic()
    outdated = [
        client_id
        for client_id, meta in awareness.meta.items()
        if client_id != awareness.client_id
        and now - meta["last_updated"] >= timeout
        and client_id in awareness.states
    ]
    if outdated:
        remove_awareness_states(awareness, outdated, "timeout")
    return outdated


def awareness_states_to_array(states: dict[int, dict]) -> list[dict]:
    return [{"clientId": client_id, **state} for client_id, state in states.items()]
