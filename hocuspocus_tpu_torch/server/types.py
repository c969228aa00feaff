"""Server types: hook names, Extension interface, Configuration.

Mirrors the capability surface of reference `packages/server/src/types.ts`
(22 lifecycle hooks, extension priority ordering, configuration defaults)
with Python naming.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

# Transaction origin marking changes applied from the Redis replication
# bus (defined here, not in hocuspocus.py, so Document's hot path can
# read it without a circular import; re-exported from server/__init__).
REDIS_ORIGIN = "__hocuspocus__redis__origin__"

# Transaction origin for updates replayed out of the write-ahead log at
# recovery time (storage/extension.py): the capture seam must not
# re-append them, and consumers can tell recovery traffic from live
# edits.
WAL_ORIGIN = "__hocuspocus__wal__origin__"

# Transaction origin for updates applied from the hot-doc replication
# stream (edge/replica.py REPLICA_TICK at a follower): like REDIS_ORIGIN
# these must never re-enter the replication seams — the owner's tick
# stream is the single source, so re-streaming a tick apply would echo
# forever between owner and followers.
REPLICA_ORIGIN = "__hocuspocus__replica__origin__"

# All lifecycle hooks, in the reference's vocabulary (snake_cased).
HOOK_NAMES = (
    "on_configure",
    "on_listen",
    "on_upgrade",
    "on_connect",
    "connected",
    "on_authenticate",
    "on_create_document",
    "on_load_document",
    "after_load_document",
    "before_handle_message",
    "before_sync",
    "before_broadcast_stateless",
    "on_stateless",
    "on_change",
    "on_store_document",
    "after_store_document",
    "on_awareness_update",
    "on_request",
    "on_drain",
    "before_unload_document",
    "after_unload_document",
    "on_disconnect",
    "on_destroy",
)


class Extension:
    """Base class for extensions. Override any subset of the 22 hooks.

    Hooks are async callables receiving a single payload object. Raising
    an exception aborts the remaining hook chain (the mechanism behind
    auth denial, request interception and distributed store locks —
    reference `docs/server/hooks.md` "The hook chain").
    """

    priority: int = 100


class Payload:
    """Hook payload with attribute and mapping access."""

    def __init__(self, **kwargs: Any) -> None:
        self.__dict__.update(kwargs)

    def __getitem__(self, key: str) -> Any:
        return self.__dict__[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.__dict__[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def update(self, other: dict) -> None:
        self.__dict__.update(other)

    def keys(self):
        return self.__dict__.keys()

    def __repr__(self) -> str:
        return f"Payload({', '.join(f'{k}={v!r}' for k, v in self.__dict__.items())})"


HookHandler = Callable[[Payload], Awaitable[Any]]


@dataclass
class ConnectionConfiguration:
    is_authenticated: bool = False
    read_only: bool = False


@dataclass
class Configuration:
    """Server configuration (reference `types.ts:114-156` equivalent)."""

    name: Optional[str] = None
    # keepalive ping timeout, milliseconds
    timeout: int = 30000
    # store debounce, milliseconds
    debounce: int = 2000
    max_debounce: int = 10000
    quiet: bool = False
    unload_immediately: bool = True
    # store retry/quarantine (docs/guides/durability.md): a failing
    # on_store_document chain is retried with bounded exponential
    # backoff + jitter; after exhaustion the document is QUARANTINED —
    # kept loaded, WAL retained, re-stored by a periodic sweep and
    # surfaced as degraded in /healthz — instead of silently unloading
    # with its data dropped. store_retries counts retries AFTER the
    # first attempt (0 restores fail-once semantics, but still
    # quarantines). Delays are milliseconds like debounce above.
    store_retries: int = 2
    store_retry_base_ms: float = 100
    store_retry_max_ms: float = 5000
    store_quarantine_sweep_ms: float = 15000
    # graceful drain deadline, seconds: SIGTERM stops intake, flushes
    # the WAL, then stores every dirty doc concurrently under this
    # bound; docs still storing at the deadline are quarantined (their
    # WAL has the data), never silently dropped.
    drain_timeout_secs: float = 20.0
    # Retry-After seconds on 503 refusals when the overload control
    # plane is off (with it on, the controller's retry_after_s wins);
    # the drain, RED and edge rejection paths all share this knob.
    retry_after_s: float = 1.0
    ydoc_options: dict = field(default_factory=lambda: {"gc": True})
    stateless_payload_limit: int = 1024 * 1024 * 100
    extensions: list[Extension] = field(default_factory=list)
    # inline hook callbacks (become the lowest-priority pseudo-extension)
    on_configure: Optional[HookHandler] = None
    on_listen: Optional[HookHandler] = None
    on_upgrade: Optional[HookHandler] = None
    on_connect: Optional[HookHandler] = None
    connected: Optional[HookHandler] = None
    on_authenticate: Optional[HookHandler] = None
    on_create_document: Optional[HookHandler] = None
    on_load_document: Optional[HookHandler] = None
    after_load_document: Optional[HookHandler] = None
    before_handle_message: Optional[HookHandler] = None
    before_sync: Optional[HookHandler] = None
    before_broadcast_stateless: Optional[HookHandler] = None
    on_stateless: Optional[HookHandler] = None
    on_change: Optional[HookHandler] = None
    on_store_document: Optional[HookHandler] = None
    after_store_document: Optional[HookHandler] = None
    on_awareness_update: Optional[HookHandler] = None
    on_request: Optional[HookHandler] = None
    on_drain: Optional[HookHandler] = None
    before_unload_document: Optional[HookHandler] = None
    after_unload_document: Optional[HookHandler] = None
    on_disconnect: Optional[HookHandler] = None
    on_destroy: Optional[HookHandler] = None


class _CallbackExtension(Extension):
    """Wraps the inline configuration callbacks as the last extension."""

    priority = -1  # always runs after every real extension

    def __init__(self, configuration: Configuration) -> None:
        for name in HOOK_NAMES:
            handler = getattr(configuration, name, None)
            if handler is not None:
                setattr(self, name, handler)
