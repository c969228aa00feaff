"""Stateless websocket edge tier + cell router (docs/guides/edge-routing.md).

Splits connection termination from merge capacity: `EdgeServer`
terminates websockets, authenticates and admits at the door, and relays
each document's frames to its owning merge cell over the pipelined RESP
lane; `CellIngressExtension` makes any server a cell whose edge
sessions ride the normal `Connection`/`DocumentFanout` pipeline; the
`CellRouter` (rendezvous hashing + override table + health states)
decides placement, and graceful drain hands a cell's docs off with a
transparent SyncStep1 resync — "millions of users" becomes an
edge-replica count.

Hot docs scale past one cell too: when a doc's audience crosses the
replica watermark the router grows an owner + follower placement, the
`ReplicaManager` on each cell keeps follower copies converged off the
owner's seq-numbered tick stream, and the edge spreads the read storm
across the whole set (docs/guides/hot-doc-replication.md).
"""

from .cell import CellIngressExtension
from .gateway import EdgeClientSession, EdgeGateway
from .replica import ReplicaManager
from .router import CellRouter
from .server import EdgeGatewayExtension, EdgeServer
from . import relay

__all__ = [
    "CellIngressExtension",
    "CellRouter",
    "EdgeClientSession",
    "EdgeGateway",
    "EdgeGatewayExtension",
    "EdgeServer",
    "ReplicaManager",
    "relay",
]
