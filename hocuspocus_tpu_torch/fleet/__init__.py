"""The fleet layer: the roster that lets cells on other hosts join the
edge tier's placement, and (not ported yet) the autoscaling controller.

`roster.py` is a copy of the JAX package's: the host-qualified cell ids,
the edges' clock-gated `AdmissionGate` and the cells' `PeerRoster`
membership epochs, which `edge/` imports. `FleetController` and
`FleetControllerExtension` drive the multi-device cell plane, which is
not ported yet: they stay importable and raise when constructed.
"""

from .roster import AdmissionGate, PeerRoster, cell_host, qualify_cell_id


class _NotPortedYet:
    """A name of the JAX package's `fleet` whose code is not ported yet:
    importable, so callers resolve it, and raising when constructed."""

    what = ""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} ({self.what}) is not ported yet: "
            "ROADMAP.md, Queue A items 7 and 8"
        )


class FleetController(_NotPortedYet):
    what = "the autoscaling decision core over per-card cells"


class FleetControllerExtension(_NotPortedYet):
    what = "the autoscaling controller's server extension"


__all__ = [
    "AdmissionGate",
    "FleetController",
    "FleetControllerExtension",
    "PeerRoster",
    "cell_host",
    "qualify_cell_id",
]
