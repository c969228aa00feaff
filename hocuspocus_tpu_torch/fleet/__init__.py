"""The fleet layer: the autoscaling controller over the per-device merge
cells, and the roster that lets cells on other hosts join the edge
tier's placement.

`controller.py` is a copy of the JAX package's: `FleetController`, the
pure decision core (streaks, cooldown, projection guard, brownout park),
and `FleetControllerExtension`, which samples the co-installed cell
plane (`tpu/cells.py`) and actuates through its `activate_cell` /
`park_cell`. `roster.py` is a copy too: the host-qualified cell ids, the
edges' clock-gated `AdmissionGate` and the cells' `PeerRoster`
membership epochs, which `edge/` imports.
"""

from .controller import FleetController, FleetControllerExtension
from .roster import AdmissionGate, PeerRoster, cell_host, qualify_cell_id

__all__ = [
    "AdmissionGate",
    "FleetController",
    "FleetControllerExtension",
    "PeerRoster",
    "cell_host",
    "qualify_cell_id",
]
