"""Declarative scenario engine: composable phase-tagged traffic programs.

The north star ("heavy traffic from millions of users", "as many
scenarios as you can imagine") cannot be evidenced by single-shape
bench passes — it needs *named, replayable production mixes* judged by
the SLO engine. This module is the declarative half of that harness:

- a **Scenario** is a population (docs, instances, shards, an optional
  mega-doc) plus an ordered list of **PhaseSpec**s, each a traffic
  program (a pure generator function) with its own SLO thresholds;
- ``Scenario.compile(seed)`` expands the phases into a **Schedule** — a
  flat, sorted op-stream of ``OpEvent``s stamped with a canonical
  SHA-256 **schedule hash**. Compilation is purely a function of
  (scenario, seed): the same seed always yields the same bytes, so a
  recorded schedule replays byte-identically and two runs are
  comparable iff their hashes match;
- the execution half (``runner.ScenarioRunner``) drives a Schedule
  through the real-server ``ServedLoadHarness`` path and judges it with
  multi-window burn rates (docs/guides/load-testing.md).

Op kinds (the whole DSL — small on purpose):

==========  ============================================================
``edit``    writer inserts ``size`` units into doc ``doc``; measured
            end-to-end when the doc is sampled (writer→reader observe)
            — unless ``value`` is nonzero (fire-and-forget background
            traffic even on a sampled doc, e.g. during a partition)
``join``    a new provider joins doc ``doc`` (time-to-synced measured)
``leave``   the oldest scenario-joined provider on doc ``doc`` leaves
``reconnect`` drop + rejoin a provider on doc ``doc`` (resync measured)
``lag``     set cross-instance replication latency to ``value`` ms
            (mini_redis injection; no-op on single-instance runs)
``partition`` ``value`` 1 = one-way-partition instance 0's publisher at
            the mini_redis hop (its publishes blackhole, accounted);
            0 = heal — anti-entropy then reconverges the instances
``overload`` inject ``value`` rungs of synthetic pressure into the
            overload ladder (server/overload.py; 1=brownout1 … 3=red,
            0 clears) — drives shed/admission behavior deterministically
``drain``   gracefully drain merge cell index ``value`` mid-run (edge
            topologies only: the cell announces departure, the router
            remaps its docs, edges re-establish sessions transparently)
==========  ============================================================

Everything here is stdlib-only and import-light: compiling and hashing
schedules must work in tools and tests without touching torch or the
server stack.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

SCHEDULE_VERSION = 1

OP_KINDS = (
    "edit",
    "join",
    "leave",
    "reconnect",
    "lag",
    "partition",
    "overload",
    "drain",
)


@dataclass(frozen=True)
class OpEvent:
    """One scheduled traffic event, at a logical offset from run start."""

    at_ms: int
    phase: str
    kind: str
    doc: int = 0
    size: int = 0
    value: int = 0

    def row(self) -> list:
        return [self.at_ms, self.phase, self.kind, self.doc, self.size, self.value]

    @classmethod
    def from_row(cls, row: Sequence) -> "OpEvent":
        return cls(
            at_ms=int(row[0]),
            phase=str(row[1]),
            kind=str(row[2]),
            doc=int(row[3]),
            size=int(row[4]),
            value=int(row[5]),
        )


@dataclass
class PhaseSpec:
    """One phase: a traffic program plus the SLO it must meet.

    ``gen(rng, scenario, phase)`` returns this phase's OpEvents with
    ``at_ms`` RELATIVE to the phase start; compile offsets and sorts
    them. Each phase gets its own deterministic sub-rng, so editing one
    phase's program never perturbs another's schedule.

    SLO knobs become per-phase ``SloTarget``s on the run's engine:
    - ``slo_e2e_ms`` / ``slo_objective``: `objective` of this phase's
      measured latencies must complete within the threshold,
    - ``error_objective``: fraction of this phase's ops that must
      succeed (timeouts and refused ops are the bad events).
    """

    name: str
    duration_ms: int
    gen: Callable[[random.Random, "Scenario", "PhaseSpec"], "list[OpEvent]"]
    slo_e2e_ms: float = 250.0
    slo_objective: float = 0.95
    error_objective: float = 0.99

    def spec_row(self) -> dict:
        return {
            "name": self.name,
            "duration_ms": self.duration_ms,
            "slo_e2e_ms": self.slo_e2e_ms,
            "slo_objective": self.slo_objective,
            "error_objective": self.error_objective,
        }


@dataclass
class Scenario:
    """A named production mix: population + ordered phases."""

    name: str
    phases: "list[PhaseSpec]"
    num_docs: int = 32
    sampled: int = 8
    instances: int = 1
    # edge topology (docs/guides/edge-routing.md): when edges > 0 the
    # runner boots `edges` stateless edge servers + `cells` merge cells
    # over one relay bus instead of `instances` replicated servers;
    # writers connect to edge 0, readers to edge 1 (cross-edge path)
    edges: int = 0
    cells: int = 0
    shards: int = 1
    # multi-device cell plane (docs/guides/multi-device.md): devices > 1
    # serves each instance from per-chip merge cells with load-aware
    # placement; params["multi_device"] tunes the rebalancer
    devices: int = 0
    capacity: int = 512
    shard_rows: Optional[int] = None
    docs_per_socket: int = 64
    flush_interval_ms: float = 2.0
    # mega-doc workloads: doc 0 takes outsized edits; capacity must hold it
    mega_doc: bool = False
    description: str = ""
    # free-form knobs a generator may read (kept in the hash input)
    params: dict = field(default_factory=dict)

    def population(self) -> dict:
        return {
            "num_docs": self.num_docs,
            "sampled": self.sampled,
            "instances": self.instances,
            "edges": self.edges,
            "cells": self.cells,
            "shards": self.shards,
            "devices": self.devices,
            "capacity": self.capacity,
            "shard_rows": self.shard_rows,
            "docs_per_socket": self.docs_per_socket,
            "flush_interval_ms": self.flush_interval_ms,
            "mega_doc": self.mega_doc,
            "params": self.params,
        }

    def compile(self, seed: int = 0) -> "Schedule":
        """Expand phases into a deterministic, hash-stamped Schedule."""
        ops: "list[OpEvent]" = []
        offset = 0
        phase_index = {phase.name: i for i, phase in enumerate(self.phases)}
        for index, phase in enumerate(self.phases):
            # a string-seeded Random is stable across processes and
            # platforms (seeded via sha512, unlike hash()): phase
            # schedules depend only on (seed, phase position, name)
            rng = random.Random(f"{self.name}/{seed}/{index}/{phase.name}")
            for op in phase.gen(rng, self, phase):
                if op.kind not in OP_KINDS:
                    raise ValueError(f"unknown op kind {op.kind!r} in {phase.name}")
                # clamp STRICTLY inside the phase window: an op landing
                # exactly on the boundary would share a timestamp with
                # the next phase's first op, and the runner's
                # phase-advance walk requires phase-monotonic order
                at = offset + max(min(op.at_ms, phase.duration_ms - 1), 0)
                ops.append(
                    OpEvent(at, phase.name, op.kind, op.doc, op.size, op.value)
                )
            offset += phase.duration_ms
        # stable order: time, then PHASE POSITION (never the phase name
        # — alphabetical ties across a boundary would break the runner's
        # monotonic phase walk), then the row as a final tie-break so
        # the order never depends on generator emission order
        ops.sort(key=lambda op: (op.at_ms, phase_index[op.phase], op.row()))
        return Schedule(
            scenario=self.name,
            seed=seed,
            population=self.population(),
            phases=[phase.spec_row() for phase in self.phases],
            ops=ops,
        )


class Schedule:
    """A compiled, replayable op-stream with a canonical content hash."""

    def __init__(
        self,
        scenario: str,
        seed: int,
        population: dict,
        phases: "list[dict]",
        ops: "list[OpEvent]",
    ) -> None:
        self.scenario = scenario
        self.seed = seed
        self.population = population
        self.phases = phases
        self.ops = ops

    @property
    def total_ms(self) -> int:
        return sum(int(phase["duration_ms"]) for phase in self.phases)

    def canonical_bytes(self) -> bytes:
        """The hash input AND the serialized form: one byte stream, so
        "replays byte-identically" is checkable by construction."""
        payload = {
            "version": SCHEDULE_VERSION,
            "scenario": self.scenario,
            "seed": self.seed,
            "population": self.population,
            "phases": self.phases,
            "ops": [op.row() for op in self.ops],
        }
        return json.dumps(
            payload, sort_keys=True, separators=(",", ":")
        ).encode("utf-8")

    @property
    def schedule_hash(self) -> str:
        return hashlib.sha256(self.canonical_bytes()).hexdigest()

    def to_json(self) -> str:
        return self.canonical_bytes().decode("utf-8")

    @classmethod
    def from_json(cls, text: "str | bytes") -> "Schedule":
        data = json.loads(text)
        if data.get("version") != SCHEDULE_VERSION:
            raise ValueError(
                f"schedule version {data.get('version')!r} != {SCHEDULE_VERSION}"
            )
        return cls(
            scenario=data["scenario"],
            seed=int(data["seed"]),
            population=data["population"],
            phases=data["phases"],
            ops=[OpEvent.from_row(row) for row in data["ops"]],
        )

    def summary(self) -> dict:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "schedule_hash": self.schedule_hash,
            "phases": [phase["name"] for phase in self.phases],
            "total_ms": self.total_ms,
            "ops": len(self.ops),
        }
