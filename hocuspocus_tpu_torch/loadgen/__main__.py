"""CLI: run a scenario and emit its SLO-verdict artifact.

    python -m hocuspocus_tpu_torch.loadgen --scenario smoke --seed 7
    python -m hocuspocus_tpu_torch.loadgen --scenario smoke --device cpu
    python -m hocuspocus_tpu_torch.loadgen --list
    python -m hocuspocus_tpu_torch.loadgen --scenario flash_crowd \\
        --record storm.schedule.json                # compile only
    python -m hocuspocus_tpu_torch.loadgen --replay storm.schedule.json

The planes run on the card (``--device cuda``, the default; without
CUDA the run errors) unless ``--device cpu`` asks for the CPU.

Prints ONE JSON line (the result artifact) on stdout; progress goes to
stderr. Exit code: 0 = SLO verdict pass, 1 = verdict fail, 2 = the run
itself errored. The artifact's ``schedule_hash`` is deterministic for a
given (scenario, seed): two runs are comparable iff hashes match.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from .runner import ScenarioRunner
from .scenario import Schedule
from .scenarios import SCENARIOS, get_scenario


def _progress(msg: str) -> None:
    print(f"[loadgen] {msg}", file=sys.stderr, flush=True)


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hocuspocus_tpu_torch.loadgen",
        description="Scenario traffic simulator with an SLO burn-rate verdict.",
    )
    parser.add_argument("--scenario", help="scenario name (see --list)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--time-scale",
        type=float,
        default=1.0,
        help="compress logical time by this factor (2.0 = run twice as fast)",
    )
    parser.add_argument(
        "--record",
        metavar="PATH",
        help="compile and write the schedule (canonical JSON) without running",
    )
    parser.add_argument(
        "--replay",
        metavar="PATH",
        help="run a previously recorded schedule byte-identically",
    )
    parser.add_argument("--out", metavar="PATH", help="also write the artifact here")
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the merge planes run: the card (default) or the CPU",
    )
    parser.add_argument(
        "--list", action="store_true", help="list known scenarios and exit"
    )
    args = parser.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            scenario = get_scenario(name)
            print(f"{name:18s} {scenario.description}")
        return 0

    if args.replay:
        with open(args.replay) as fh:
            schedule = Schedule.from_json(fh.read())
        _progress(
            f"replaying {args.replay} (hash {schedule.schedule_hash[:12]}...)"
        )
    else:
        if not args.scenario:
            parser.error("--scenario (or --replay/--list) is required")
        schedule = get_scenario(args.scenario).compile(args.seed)

    if args.record:
        with open(args.record, "w") as fh:
            fh.write(schedule.to_json())
        print(json.dumps(schedule.summary()))
        return 0

    try:
        runner = ScenarioRunner(
            schedule, time_scale=args.time_scale, device=args.device, progress=_progress
        )
        result = asyncio.run(runner.run())
    except Exception as error:  # noqa: BLE001 — the artifact IS the report
        print(
            json.dumps(
                {
                    "metric": "scenario_slo_verdict",
                    "scenario": schedule.scenario,
                    "seed": schedule.seed,
                    "schedule_hash": schedule.schedule_hash,
                    "verdict": "error",
                    "error": repr(error)[:500],
                }
            )
        )
        return 2
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0 if result["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
