"""The port's `fleet/roster.py` and cross-host admission against the JAX package's.

Twins of the roster and admission tests of tests/fleet/test_controller.py
and of tests/fleet/test_cross_host.py. Each runs the JAX test's own body
as written and with its module's names pointed at the port's (through
tests/test_torch_edge.py's `run_reference_test`, so providers get client
ids fixed by the order they were made), and the cross-host twins compare
the two packages' documents byte for byte. The port's cells run without a
plane and with a served CPU plane. `FleetController` and its extension
are not ported yet (ROADMAP.md, Queue A items 7 and 8): they raise when
constructed.
"""

import pytest

import tests.fleet.test_controller as jax_controller_tests
import tests.fleet.test_cross_host as jax_cross_host_tests
from tests.test_torch_edge import JAX, PLANES, PORT, run_reference_test, twin

ROSTER_TESTS = [
    "test_cell_id_qualification_roundtrip",
    "test_admission_gate_local_cells_admit_immediately",
    "test_admission_gate_holds_foreign_cells_until_clock_resolves",
    "test_admission_gate_pending_lifecycle_and_expiry",
    "test_peer_roster_epoch_counts_transitions_not_heartbeats",
]


@pytest.mark.parametrize("name", ROSTER_TESTS)
def test_roster_twin(name):
    run_reference_test(getattr(jax_controller_tests, name), PORT)


def test_the_roster_module_is_the_jax_packages_word_for_word():
    """Apart from the package name, the port's roster is the reference's
    code: the same admission policy, reasons and counters."""
    import inspect

    import hocuspocus_tpu.fleet.roster as jax_roster
    import hocuspocus_tpu_torch.fleet.roster as port_roster

    assert inspect.getsource(port_roster) == inspect.getsource(jax_roster)


def test_roster_decisions_match_the_jax_package():
    """The same announce stream through both packages' gate and roster
    gives the same decisions, reasons, counters and epochs."""

    class Estimator:
        def __init__(self, samples, rtt_s):
            self.samples, self.rtt_s = samples, rtt_s

    stream = [
        ("cell-0", None), ("host-a/cell-1", None), ("host-b/cell-0", None),
        ("host-b/cell-0", Estimator(1, 0.01)), ("host-b/cell-0", Estimator(3, 2.0)),
        ("host-c/cell-9", Estimator(5, None)), ("host-b/cell-0", Estimator(2, 0.01)),
    ]
    out = {}
    for key, pkg in (("jax", JAX), ("port", PORT)):
        gate = pkg.names["AdmissionGate"](local_host="host-a", min_samples=2, max_rtt_s=0.5)
        roster = pkg.names["PeerRoster"]()
        decisions = []
        for cell, estimator in stream:
            admit, reason = gate.evaluate(cell, estimator)
            decisions.append((admit, reason, gate.admit(cell) if admit else gate.hold(cell, reason)))
            decisions.append(roster.note(cell, "healthy" if admit else "draining"))
        decisions.append(roster.note("cell-0", "down"))
        out[key] = (decisions, dict(gate.counters), gate.status(), roster.table(),
                    [pkg.names["qualify_cell_id"](h, c) for h, c in (("x", "y"), (None, "y"), ("x", "z/y"))],
                    [pkg.names["cell_host"](c) for c in ("a/b", "b")])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("cls", ["FleetController", "FleetControllerExtension"])
def test_the_fleet_controller_raises_naming_its_queue_a_items(cls):
    import hocuspocus_tpu_torch.fleet as port_fleet

    with pytest.raises(NotImplementedError, match="Queue A items 7 and 8"):
        getattr(port_fleet, cls)()


# whole documents compare across the packages: each test's edits are
# sequential, every provider converged before it ends
CROSS_HOST = [
    "test_foreign_cell_pends_then_joins_epoch_safe_and_serves",
    "test_unresolved_clock_skew_keeps_the_cell_pending",
    "test_cross_host_scale_down_drain_loses_nothing_acked",
]


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", CROSS_HOST)
def test_cross_host_twin(name, plane):
    edits = name != "test_unresolved_clock_skew_keeps_the_cell_pending"
    twin(getattr(jax_cross_host_tests, name), plane, "state", edits)
