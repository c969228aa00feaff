"""Small asyncio helpers shared across the runtime."""

from __future__ import annotations

import asyncio
import random


def backoff_delay_s(attempt: int, base_ms: float, max_ms: float) -> float:
    """Bounded exponential backoff with full jitter, in SECONDS.

    `attempt` counts completed failures (0 = first retry). The ceiling
    doubles per attempt up to `max_ms`; the delay is drawn uniformly
    from [ceiling/2, ceiling] so a herd of retriers spreads out. Shared
    by the store-retry chain (server/hocuspocus.py) and the webhook
    delivery retries (extensions/webhook.py)."""
    ceiling = min(base_ms * (2 ** attempt), max_ms)
    return random.uniform(ceiling / 2, ceiling) / 1000.0


async def await_synced(providers, timeout: float = 30.0, what: str = "providers") -> None:
    """Event-driven sync barrier over providers.

    Resolves on each provider's "synced" emit (no interval polling), so
    the timeout is a pure liveness bound. Raises TimeoutError naming
    `what` and the stragglers' count."""
    providers = list(providers)
    loop = asyncio.get_running_loop()
    handlers = []
    futs = []
    try:
        for p in providers:
            if p.synced:
                continue
            fut = loop.create_future()

            def handler(payload, fut=fut):
                if payload.get("state") and not fut.done():
                    fut.set_result(None)

            p.on("synced", handler)
            handlers.append((p, handler))
            futs.append(fut)
        if futs:
            await asyncio.wait_for(asyncio.gather(*futs), timeout=timeout)
    except asyncio.TimeoutError:
        raise TimeoutError(
            f"{what}: {sum(1 for p in providers if not p.synced)}/"
            f"{len(providers)} providers never synced"
        )
    finally:
        for p, handler in handlers:
            p.off("synced", handler)


def spawn_tracked(registry: set, coro) -> "asyncio.Task":
    """Fire-and-forget with a strong reference.

    The event loop only weakly references tasks: an unreferenced
    fire-and-forget task can be garbage-collected mid-flight and
    silently never complete (dropping a frame, stalling a pipeline, or
    stranding a lock acquisition). The caller-owned `registry` set
    holds the strong ref until the task settles.
    """
    task = asyncio.ensure_future(coro)
    registry.add(task)
    task.add_done_callback(registry.discard)
    return task
