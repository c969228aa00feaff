"""The edge process role: `EdgeServer` + `EdgeGatewayExtension`.

An edge is a normal aiohttp host (same upgrade path, same drain/RED
503s through `service_unavailable_response`, same `/healthz`,
`/metrics` and hook chain) whose websocket sessions are
`EdgeClientSession`s instead of document-owning `ClientConnection`s —
the `Server._create_session` seam is the only server-layer difference
between the roles. Run one per front-door replica:

    gateway_ext = EdgeGatewayExtension(host=redis_host, port=redis_port)
    server = EdgeServer(Configuration(extensions=[
        Metrics(), OverloadExtension(), gateway_ext,
    ]))
    await server.listen(port=80)

`/debug/edge` serves the live route table, session registry and relay
counters (docs/guides/edge-routing.md).
"""

from __future__ import annotations

from typing import Any, Optional

from ..server.server import Server
from ..server.types import Configuration, Extension, Payload
from .gateway import EdgeClientSession, EdgeGateway


class _ServeResponse(Exception):
    """Short-circuits the on_request chain with a ready response (the
    same mechanism the Metrics extension uses)."""

    def __str__(self) -> str:  # suppress hook-chain error logging
        return ""


class EdgeGatewayExtension(Extension):
    """Owns the gateway lifecycle on an edge server: starts the relay
    subscriber at listen time, serves `/debug/edge`, folds relay health
    into `/healthz`, and registers the `hocuspocus_edge_*` metrics with
    a co-installed Metrics extension."""

    priority = 900

    def __init__(self, gateway: Optional[EdgeGateway] = None, **gateway_options: Any) -> None:
        self.gateway = gateway or EdgeGateway(**gateway_options)

    async def on_configure(self, data: Payload) -> None:
        for extension in getattr(data.instance, "_extensions", []):
            registry = getattr(extension, "registry", None)
            if registry is not None and callable(getattr(registry, "register", None)):
                for metric in self.gateway.metrics():
                    try:
                        registry.register(metric)
                    except ValueError:
                        pass  # already adopted (shared registry, repeat bind)
                break

    async def on_listen(self, data: Payload) -> None:
        await self.gateway.start()

    async def on_request(self, data: Payload) -> None:
        request = data.request
        path = getattr(getattr(request, "rel_url", None), "path", None) or getattr(
            request, "path", ""
        )
        if path == "/debug/edge":
            import json

            from aiohttp import web

            from ..observability.fleet import stamp_header

            data.response = web.Response(
                # the consistent attributable header every /debug
                # endpoint carries: {"generated_utc", "role", "node_id"}
                text=json.dumps(stamp_header(self.gateway.status())),
                content_type="application/json",
            )
            error = _ServeResponse()
            error.response = data.response
            raise error

    def health_status(self) -> dict:
        return self.gateway.health_brief()

    async def on_destroy(self, data: Payload) -> None:
        self.gateway.close()


class EdgeServer(Server):
    """A `Server` whose websocket sessions relay to merge cells instead
    of terminating in a local document registry."""

    def __init__(
        self,
        configuration: Optional[Configuration] = None,
        gateway: Optional[EdgeGateway] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(configuration, **kwargs)
        if gateway is None:
            for extension in self.configuration.extensions:
                if isinstance(extension, EdgeGatewayExtension):
                    gateway = extension.gateway
                    break
        if gateway is None:
            raise ValueError(
                "EdgeServer needs an EdgeGateway (pass gateway= or add an "
                "EdgeGatewayExtension to the configuration)"
            )
        self.gateway = gateway

    def _create_session(self, transport, request_info, context):
        return EdgeClientSession(
            transport, request_info, self.hocuspocus, self.gateway, context
        )
