"""Load generation: the served harness + the scenario traffic simulator.

Two layers (docs/guides/load-testing.md):

- :mod:`.harness` — ``ServedLoadHarness``, the socket-free real-server
  topology for the served many-doc regime;
- the scenario engine — declarative, phase-tagged, seeded traffic
  programs (:mod:`.scenario`), a library of production mixes
  (:mod:`.scenarios`), and the SLO-judged executor (:mod:`.runner`)
  whose verdict is the SLO burn-rate engine's breach status.

Run one from the command line::

    python -m hocuspocus_tpu_torch.loadgen --scenario smoke --seed 7

The planes run on the card; ``--device cpu`` (``device="cpu"`` for
``ScenarioRunner`` and ``ServedLoadHarness``) asks for the CPU.
The edge scenarios boot the split front door (stateless edges and merge
cells over a MiniRedis relay bus); ``multi_device_storm`` serves each
instance from per-device merge cells, and ``diurnal_autoscale`` puts
the fleet controller over them. Sharded scenarios are not ported yet
and raise NotImplementedError naming ROADMAP.md, Queue A item 7b.

Import weight: the schedule/timeline layers (scenario, scenarios,
timeline) are stdlib-only and imported eagerly — tools and the
``/debug/loadgen`` endpoint rely on that staying cheap. The execution
layers (harness, runner) pull the full server + torch stack and resolve
lazily via PEP 562 on first attribute access.
"""

from .scenario import OpEvent, PhaseSpec, Scenario, Schedule
from .scenarios import BENCH_SUITE, SCENARIOS, get_scenario
from .timeline import LoadgenTimeline, get_loadgen_timeline

# heavy symbols (server/tpu/torch imports) -> providing submodule
_LAZY = {
    "ServedLoadHarness": "harness",
    "run_served_load": "harness",
    "ScenarioRunner": "runner",
    "run_scenario": "runner",
}

__all__ = [
    "BENCH_SUITE",
    "LoadgenTimeline",
    "OpEvent",
    "PhaseSpec",
    "SCENARIOS",
    "Scenario",
    "ScenarioRunner",
    "Schedule",
    "ServedLoadHarness",
    "get_loadgen_timeline",
    "get_scenario",
    "run_scenario",
    "run_served_load",
]


def __getattr__(name: str):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    value = getattr(import_module(f".{submodule}", __name__), name)
    globals()[name] = value  # cache: resolve once per process
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
