"""Webhook extension (reference `extension-webhook`).

POSTs document lifecycle events to a URL with an HMAC-SHA256 signature
header `X-Hocuspocus-Signature-256`; imports JSON into empty fields on
load; onConnect response JSON becomes connection context (failure =>
Forbidden).

Requests carry a timeout and retry transient failures (network errors
and 5xx responses) with bounded exponential backoff + jitter — the
reference ships webhook retries; firing once with no timeout turns any
slow endpoint into a hung hook chain. Retries are counted in
`hocuspocus_webhook_retries_total` (exposed when a `Metrics` extension
is configured). 4xx responses are NOT retried: the endpoint understood
the request and rejected it.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import time
from enum import Enum
from typing import Any, Optional

from ..observability.metrics import Counter

# process-global (the wire-telemetry pattern): several Webhook
# instances share ONE counter object, so a second instance's registry
# adoption is a no-op instead of a swallowed name collision that would
# hide its retries from /metrics
_RETRIES_TOTAL = Counter(
    "hocuspocus_webhook_retries_total",
    "Webhook request retries after a transient failure, by event",
)

from ..protocol.close_events import CloseError, FORBIDDEN
from ..server import logger
from ..server.types import Extension, Payload
from ..transformer import TiptapTransformer


class Events(str, Enum):
    onChange = "change"
    onConnect = "connect"
    onCreate = "create"
    onDisconnect = "disconnect"


class Webhook(Extension):
    def __init__(
        self,
        url: str,
        secret: str = "",
        transformer: Any = None,
        events: Optional[list[Events]] = None,
        debounce: Optional[float] = 2000,
        debounce_max_wait: float = 10000,
        request_timeout: float = 10000,
        retries: int = 2,
        retry_base_ms: float = 250,
        retry_max_ms: float = 5000,
    ) -> None:
        if not url:
            raise ValueError("url is required!")
        self.url = url
        self.secret = secret
        self.transformer = transformer or TiptapTransformer
        self.events = events if events is not None else [Events.onChange]
        self.debounce_ms = debounce
        self.debounce_max_wait = debounce_max_wait
        self.debounced: dict[str, dict] = {}
        # delivery robustness: per-request timeout (ms) + bounded
        # exponential-backoff retries with full jitter on transient
        # failures (connection errors, timeouts, 5xx)
        self.request_timeout_ms = request_timeout
        self.retries = max(int(retries), 0)
        self.retry_base_ms = retry_base_ms
        self.retry_max_ms = retry_max_ms
        self.retries_total = _RETRIES_TOTAL

    async def on_configure(self, data: Payload) -> None:
        # surface the retry counter on /metrics when a Metrics extension
        # is configured (its registry adopts pre-built collectors)
        for extension in getattr(data.instance.configuration, "extensions", []):
            registry = getattr(extension, "registry", None)
            if registry is not None and hasattr(registry, "register"):
                try:
                    registry.register(self.retries_total)
                except (ValueError, AttributeError):
                    pass
                break

    def create_signature(self, body: bytes) -> str:
        digest = hmac.new(self.secret.encode(), body, hashlib.sha256).hexdigest()
        return f"sha256={digest}"

    def debounce(self, id: str, fn) -> None:
        old = self.debounced.pop(id, None)
        start = old["start"] if old else time.monotonic()
        if old:
            old["handle"].cancel()

        def run() -> None:
            self.debounced.pop(id, None)
            asyncio.ensure_future(fn())

        if (time.monotonic() - start) * 1000 >= self.debounce_max_wait:
            run()
            return
        handle = asyncio.get_event_loop().call_later(self.debounce_ms / 1000, run)
        self.debounced[id] = {"start": start, "handle": handle}

    def _retry_delay(self, attempt: int) -> float:
        from ..aio import backoff_delay_s

        return backoff_delay_s(attempt, self.retry_base_ms, self.retry_max_ms)

    async def send_request(self, event: Events, payload: Any) -> tuple[int, Any]:
        import aiohttp  # only where a request is made: importing the extension needs none

        body = json.dumps({"event": event.value, "payload": payload}).encode()
        headers = {
            "X-Hocuspocus-Signature-256": self.create_signature(body),
            "Content-Type": "application/json",
        }
        timeout = aiohttp.ClientTimeout(total=self.request_timeout_ms / 1000.0)
        attempts = self.retries + 1
        last_error: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.retries_total.inc(event=event.value)
                await asyncio.sleep(self._retry_delay(attempt - 1))
            try:
                async with aiohttp.ClientSession(timeout=timeout) as session:
                    async with session.post(
                        self.url, data=body, headers=headers
                    ) as response:
                        try:
                            data = await response.json(content_type=None)
                        except Exception:
                            data = await response.text()
                        if response.status >= 500 and attempt + 1 < attempts:
                            # server-side failure: retryable; a 4xx is a
                            # decision, returned to the caller as-is
                            last_error = RuntimeError(
                                f"webhook returned {response.status}"
                            )
                            continue
                        return response.status, data
            except asyncio.CancelledError:
                raise
            except Exception as error:  # connect/timeout/transport
                last_error = error
        raise last_error if last_error is not None else RuntimeError(
            "webhook request failed"
        )

    async def on_change(self, data: Payload) -> None:
        if Events.onChange not in self.events:
            return

        async def save() -> None:
            try:
                await self.send_request(
                    Events.onChange,
                    {
                        "document": self.transformer.from_ydoc(data.document),
                        "documentName": data.document_name,
                        "context": data.context,
                        "requestHeaders": data.request_headers,
                        "requestParameters": dict(data.request_parameters or {}),
                    },
                )
            except Exception as error:
                logger.log_error(f"caught error in extension-webhook: {error}")

        if not self.debounce_ms:
            await save()
            return
        self.debounce(data.document_name, save)

    async def on_load_document(self, data: Payload) -> None:
        if Events.onCreate not in self.events:
            return
        try:
            status, response = await self.send_request(
                Events.onCreate,
                {
                    "documentName": data.document_name,
                    "requestHeaders": data.request_headers,
                    "requestParameters": dict(data.request_parameters or {}),
                },
            )
            if status != 200 or not response:
                return
            document = json.loads(response) if isinstance(response, str) else response
            for field_name, field_doc in document.items():
                if data.document.is_empty(field_name):
                    data.document.merge(self.transformer.to_ydoc(field_doc, field_name))
        except Exception as error:
            logger.log_error(f"caught error in extension-webhook: {error}")

    async def on_connect(self, data: Payload) -> Any:
        if Events.onConnect not in self.events:
            return
        try:
            status, response = await self.send_request(
                Events.onConnect,
                {
                    "documentName": data.document_name,
                    "requestHeaders": data.request_headers,
                    "requestParameters": dict(data.request_parameters or {}),
                },
            )
            if status >= 400:
                raise RuntimeError(f"webhook returned {status}")
            if isinstance(response, str) and response:
                return json.loads(response)
            return response
        except Exception as error:
            logger.log_error(f"caught error in extension-webhook: {error}")
            raise CloseError(FORBIDDEN)

    async def on_disconnect(self, data: Payload) -> None:
        if Events.onDisconnect not in self.events:
            return
        try:
            await self.send_request(
                Events.onDisconnect,
                {
                    "documentName": data.document_name,
                    "requestHeaders": data.request_headers,
                    "requestParameters": dict(data.request_parameters or {}),
                    "context": data.context,
                },
            )
        except Exception as error:
            logger.log_error(f"caught error in extension-webhook: {error}")
