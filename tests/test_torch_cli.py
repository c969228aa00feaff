"""The port's CLI (`python -m hocuspocus_tpu_torch.cli`) against the JAX package's.

Twins of tests/server/test_cli.py. Each flow boots both packages' CLI on a
free port (the port's with `--tpu-device cpu`), drives it with that
package's provider over a real websocket, and returns what it observed
(texts, endpoint answers) with the CLI's exit codes; the two packages'
observations must be equal and the port's CLI must exit 0. `--tpu-devices 2`
serves from two merge cells in both packages, and `--tpu-devices 4
--fleet-autoscale --fleet-warm-spares 2` boots the fleet controller with
two cells parked in both. The port's sharded and lane-tuning branches exit
with code 2 and one line on stderr naming ROADMAP.md Queue A item 7b, and
without `--tpu-device cpu` the plane needs CUDA. The flows are plain tests over `asyncio.run`: two CLI boots can
outlast the 60 s that tests/conftest.py gives one coroutine test when
the suite runs in parallel.
"""

import asyncio
import contextlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest

import hocuspocus_tpu.cli as jax_cli
import hocuspocus_tpu.provider as jax_provider
import hocuspocus_tpu_torch.cli as port_cli
import hocuspocus_tpu_torch.provider as port_provider

ROOT = Path(__file__).resolve().parent.parent

DRAIN_LINE = re.compile(r"drain: stored \d+/\d+ docs in ([0-9.]+)s")

PACKAGES = {
    "jax": ("hocuspocus_tpu.cli", jax_provider, ()),
    "port": ("hocuspocus_tpu_torch.cli", port_provider, ("--tpu-device", "cpu")),
}


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class Cli:
    def __init__(self, process, port) -> None:
        self.process = process
        self.port = port
        self.url = f"ws://127.0.0.1:{port}"
        self.exit_code = None
        # stderr's lines, when the launch reads them
        self.stderr_lines: list = []
        self.stderr_task = None

    def drain_seconds(self):
        """The drain's own duration, from the `drain: stored N/M docs in
        Xs` line the server logs when it ends; None without a drain."""
        for line in self.stderr_lines:
            match = DRAIN_LINE.match(line)
            if match:
                return float(match.group(1))
        return None

    async def get(self, path: str) -> tuple:
        async with aiohttp.ClientSession() as session:
            async with session.get(f"http://127.0.0.1:{self.port}{path}") as response:
                return response.status, await response.text()


@contextlib.asynccontextmanager
async def _launch(package: str, *extra_args: str, read_stderr: bool = False):
    """Boot a package's CLI on a free port; SIGTERM it on the way out and
    keep its exit code. `read_stderr` keeps its stderr lines
    (`Cli.stderr_lines`)."""
    module, _provider, device_args = PACKAGES[package]
    port = _free_port()
    process = await asyncio.create_subprocess_exec(
        sys.executable, "-m", module, "--port", str(port), "--host", "127.0.0.1",
        *extra_args, *device_args,
        cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
        stdout=asyncio.subprocess.DEVNULL,
        stderr=asyncio.subprocess.PIPE if read_stderr else asyncio.subprocess.DEVNULL,
    )
    cli = Cli(process, port)
    if read_stderr:

        async def pump() -> None:
            async for line in process.stderr:
                cli.stderr_lines.append(line.decode(errors="replace"))

        cli.stderr_task = asyncio.ensure_future(pump())
    try:
        yield cli
    finally:
        if process.returncode is None:
            process.send_signal(signal.SIGTERM)
        try:
            cli.exit_code = await asyncio.wait_for(process.wait(), 30)
        except asyncio.TimeoutError:
            process.kill()
            await process.wait()
        if cli.stderr_task is not None:
            await cli.stderr_task  # ends at the pipe's end of file


async def _wait_for(condition, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not condition():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        await asyncio.sleep(0.05)


async def _both(flow, *args):
    """`flow(package, *args)` returns (observations, exit codes): the
    observations must be equal, and the port's CLI must exit 0 each time.
    The JAX CLI's exit codes are not compared: with `--tpu-serve` it
    aborted (-6) on SIGTERM once while the suite ran in parallel."""
    seen, codes = {}, {}
    for package in PACKAGES:
        seen[package], codes[package] = await flow(package, *args)
    assert seen["port"] == seen["jax"]
    assert all(code == 0 for code in codes["port"]), codes
    return seen["port"]


# -- the parser ---------------------------------------------------------------


def test_parser_has_every_jax_flag_with_its_default():
    jax_actions = {a.dest: a for a in jax_cli.build_parser()._actions}
    port_actions = {a.dest: a for a in port_cli.build_parser()._actions}
    assert set(port_actions) - set(jax_actions) == {"tpu_device"}
    for dest, action in jax_actions.items():
        port_action = port_actions[dest]
        assert port_action.option_strings == action.option_strings, dest
        assert port_action.default == action.default, dest
        assert port_action.choices == action.choices, dest
    assert port_actions["tpu_device"].default == "cuda"
    assert port_actions["tpu_device"].choices == ("cuda", "cpu")


# -- twins of tests/server/test_cli.py ----------------------------------------


async def _serves_connections(package, tmp_path):
    provider_module = PACKAGES[package][1]
    async with _launch(package, "--sqlite", str(tmp_path / f"{package}.db")) as cli:
        provider = provider_module.HocuspocusProvider(name="cli-doc", url=cli.url)
        try:
            await _wait_for(lambda: provider.synced, 30)
            provider.document.get_text("t").insert(0, "via cli")
            await _wait_for(lambda: not provider.has_unsynced_changes, 10)
            text = provider.document.get_text("t").to_string()
        finally:
            provider.destroy()
    return text, (cli.exit_code,)


def test_cli_serves_connections(tmp_path):
    assert asyncio.run(_both(_serves_connections, tmp_path)) == "via cli"


async def _serve_mode(package, arena):
    provider_module = PACKAGES[package][1]
    async with _launch(
        package, "--tpu-serve", "--tpu-arena", arena, "--tpu-docs", "64", "--tpu-capacity", "512",
        "--tpu-flush-interval", "1", "--tpu-broadcast-interval", "1",
    ) as cli:
        a = provider_module.HocuspocusProvider(name="cli-tpu", url=cli.url)
        b = provider_module.HocuspocusProvider(name="cli-tpu", url=cli.url)
        try:
            await _wait_for(lambda: a.synced and b.synced, 60)
            a.document.get_text("t").insert(0, "served by the plane")
            await _wait_for(
                lambda: b.document.get_text("t").to_string() == "served by the plane", 30
            )
            # the plane attaches after boot (its init runs in a worker
            # thread): read the state once init has ended, up to 60 s
            for _ in range(240):
                status, text = await cli.get("/healthz")
                section = json.loads(text)["extensions"]["SupervisedTpuMergeExtension"]
                if section["state"] != "initializing":
                    break
                await asyncio.sleep(0.25)
        finally:
            a.destroy()
            b.destroy()
    # the port's section adds `fault` (a card fault stops serving there)
    keys = sorted(set(section) - {"fault"})
    return (b.document.get_text("t").to_string(), status, keys, section["state"]), (cli.exit_code,)


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_cli_tpu_serve_mode(arena):
    text, status, _keys, state = asyncio.run(_both(_serve_mode, arena))
    assert (text, status, state) == ("served by the plane", 200, "ready")


async def _trace_flags(package):
    provider_module = PACKAGES[package][1]
    async with _launch(
        package, "--tpu-serve", "--tpu-docs", "16", "--tpu-capacity", "512",
        "--tpu-flush-interval", "1", "--tpu-broadcast-interval", "1",
        "--trace", "--trace-max-spans", "1024", "--trace-sample", "1",
    ) as cli:
        provider = provider_module.HocuspocusProvider(name="cli-traced", url=cli.url)
        try:
            await _wait_for(lambda: provider.synced, 60)
            provider.document.get_text("t").insert(0, "trace via cli")
            await _wait_for(lambda: not provider.has_unsynced_changes, 10)

            async def traced() -> bool:
                status, text = await cli.get("/debug/trace")
                return status == 200 and any(
                    e["name"] == "update.broadcast" for e in json.loads(text).get("traceEvents", [])
                )

            # the supervised plane attaches after boot: an edit before that
            # rides the CPU path untraced, so keep editing while polling
            ok = False
            for attempt in range(120):
                if await traced():
                    ok = True
                    break
                if attempt % 5 == 4:
                    provider.document.get_text("t").insert(0, "x")
                await asyncio.sleep(0.25)
            status, body = await cli.get("/metrics")
        finally:
            provider.destroy()
    return (ok, status, "hocuspocus_tpu_update_e2e_seconds_bucket" in body,
            'stage="total"' in body), (cli.exit_code,)


def test_cli_trace_flags_serve_debug_endpoints():
    assert asyncio.run(_both(_trace_flags)) == (True, 200, True, True)


async def _wal_and_drain(package, tmp_path):
    provider_module = PACKAGES[package][1]
    wal_dir = str(tmp_path / f"{package}-wal")
    db = str(tmp_path / f"{package}-wal.db")
    async with _launch(package, "--wal-dir", wal_dir, "--sqlite", db, "--drain-timeout-secs", "5") as cli:
        provider = provider_module.HocuspocusProvider(name="wal-cli-doc", url=cli.url)
        try:
            await _wait_for(lambda: provider.synced, 30)
            provider.document.get_text("t").insert(0, "drained durably")
            await _wait_for(lambda: not provider.has_unsynced_changes, 10)
            await asyncio.sleep(0.2)  # let the WAL group commit land
        finally:
            provider.destroy()
    first_exit = cli.exit_code
    async with _launch(package, "--wal-dir", wal_dir, "--sqlite", db) as cli:
        reader = provider_module.HocuspocusProvider(name="wal-cli-doc", url=cli.url)
        try:
            await _wait_for(lambda: reader.synced, 30)
            await _wait_for(lambda: str(reader.document.get_text("t")) == "drained durably", 10)
            text = str(reader.document.get_text("t"))
        finally:
            reader.destroy()
    return text, (first_exit, cli.exit_code)


def test_cli_wal_and_drain_flags(tmp_path):
    assert asyncio.run(_both(_wal_and_drain, tmp_path)) == "drained durably"


async def _served_wal_replay(package, tmp_path):
    """--tpu-serve --metrics --wal-dir (the smoke's cli_server at one doc):
    SIGTERM drains inside --drain-timeout-secs and the process exits with
    code 0, and a second process on the same WAL serves the doc back byte
    for byte. The 5 s bound times what the flag bounds, the drain itself
    as the server measures and logs it ("drain: stored N/M docs in Xs"):
    not the signal's wait for a loaded event loop, nor the teardown and
    the interpreter's exit after the drain."""
    provider_module = PACKAGES[package][1]
    crdt = sys.modules[provider_module.__name__.rsplit(".", 1)[0] + ".crdt"]
    args = ("--tpu-serve", "--metrics", "--tpu-docs", "16", "--tpu-capacity", "512",
            "--wal-dir", str(tmp_path / f"{package}-served-wal"), "--drain-timeout-secs", "5")
    async with _launch(package, *args, read_stderr=True) as cli:
        a = provider_module.HocuspocusProvider(name="served-wal", url=cli.url)
        try:
            await _wait_for(lambda: a.synced, 60)
            for i, word in enumerate(("alpha ", "béta ", "γ")):
                a.document.get_text("t").insert(i, word)
            await _wait_for(lambda: not a.has_unsynced_changes, 10)
            before = crdt.encode_state_as_update(a.document)
            await asyncio.sleep(0.2)
        finally:
            a.destroy()
        cli.process.send_signal(signal.SIGTERM)
        code = await asyncio.wait_for(cli.process.wait(), 30)
        await cli.stderr_task
        drain_seconds = cli.drain_seconds()
        drained_in_time = drain_seconds is not None and drain_seconds <= 5.0
    async with _launch(package, *args) as cli:
        reader = provider_module.HocuspocusProvider(name="served-wal", url=cli.url)
        try:
            await _wait_for(lambda: reader.synced, 60)
            await _wait_for(lambda: crdt.encode_state_as_update(reader.document) == before, 10)
            text = reader.document.get_text("t").to_string()
        finally:
            reader.destroy()
    return (text, drained_in_time), (code, cli.exit_code)


def test_cli_served_plane_drains_and_replays_its_wal(tmp_path):
    text, drained_in_time = asyncio.run(_both(_served_wal_replay, tmp_path))
    assert drained_in_time and "γ" in text


# -- what the port has not ported yet ---------------------------------------


def _port_cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "hocuspocus_tpu_torch.cli", "--port", str(_free_port()),
         "--host", "127.0.0.1", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
    )


@pytest.mark.parametrize(
    "args,item",
    [
        (("--tpu-serve", "--tpu-shards", "2"), "Queue A item 7b"),
        (("--tpu-serve", "--tpu-scheduler", "off"), "Queue A item 7b"),
        (("--tpu-serve", "--tpu-drain-watermark", "64"), "Queue A item 7b"),
    ],
    ids=["shards", "scheduler-off", "drain-watermark"],
)
def test_unported_branches_exit_naming_their_queue_a_item(args, item):
    proc = _port_cli(*args, "--tpu-device", "cpu")
    assert proc.returncode == 2
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and item in lines[0] and "NotImplementedError" not in lines[0], proc.stderr
    assert "not ported yet" in lines[0]


async def _cells_serve(package):
    """--tpu-serve --tpu-devices 2: two supervised merge cells (on the
    CPU for the port) serve a doc; a late joiner's state equals the
    writer's byte for byte, and /debug/scheduler shows both cells."""
    provider_module = PACKAGES[package][1]
    crdt = sys.modules[provider_module.__name__.rsplit(".", 1)[0] + ".crdt"]
    async with _launch(
        package, "--tpu-serve", "--tpu-devices", "2", "--tpu-docs", "16", "--tpu-capacity", "512",
        "--tpu-flush-interval", "1", "--tpu-broadcast-interval", "1", "--metrics",
    ) as cli:
        a = provider_module.HocuspocusProvider(name="cli-cells", url=cli.url)
        b = provider_module.HocuspocusProvider(name="cli-cells", url=cli.url)
        try:
            await _wait_for(lambda: a.synced and b.synced, 60)

            async def placed() -> list:
                status, text = await cli.get("/debug/scheduler")
                devices = json.loads(text).get("devices", []) if status == 200 else []
                return [cell["docs"] for cell in devices]

            # the supervised cells attach after boot: edit until the doc
            # is served by a cell
            for attempt in range(120):
                docs = await placed()
                if sum(docs) == 1:
                    break
                if attempt % 5 == 4:
                    a.document.get_text("t").insert(0, "x")
                await asyncio.sleep(0.25)
            a.document.get_text("t").insert(0, "served by a cell ")
            await _wait_for(lambda: "served by a cell" in b.document.get_text("t").to_string(), 30)
            await _wait_for(lambda: not a.has_unsynced_changes, 10)
            c = provider_module.HocuspocusProvider(name="cli-cells", url=cli.url)
            try:
                await _wait_for(lambda: c.synced, 60)
                await _wait_for(
                    lambda: crdt.encode_state_as_update(c.document)
                    == crdt.encode_state_as_update(a.document), 30,
                )
            finally:
                c.destroy()
            docs = await placed()
        finally:
            a.destroy()
            b.destroy()
    return (len(docs), sum(docs), "served by a cell" in b.document.get_text("t").to_string()), (
        cli.exit_code,
    )


def test_cli_serves_a_doc_from_per_device_cells_as_the_jax_cli():
    assert asyncio.run(_both(_cells_serve)) == (2, 1, True)


async def _fleet_serve(package):
    """--tpu-serve --tpu-devices 4 --fleet-autoscale --fleet-warm-spares 2:
    the controller boots with the last two cells parked (the /debug/fleet
    autoscale section and /debug/scheduler's placement), and a doc served
    from an active cell reaches a late joiner byte for byte."""
    provider_module = PACKAGES[package][1]
    crdt = sys.modules[provider_module.__name__.rsplit(".", 1)[0] + ".crdt"]
    async with _launch(
        package, "--tpu-serve", "--tpu-devices", "4", "--fleet-autoscale",
        "--fleet-warm-spares", "2", "--tpu-docs", "16", "--tpu-capacity", "512",
        "--tpu-flush-interval", "1", "--tpu-broadcast-interval", "1", "--metrics",
    ) as cli:
        async def section(path, key):
            try:
                status, text = await cli.get(path)
            except aiohttp.ClientConnectionError:
                return None  # not listening yet
            return json.loads(text).get(key) if status == 200 else None

        # the supervised cells attach after boot; the controller adopts
        # them at its first tick (2 s) and parks the spares
        for _ in range(240):
            autoscale = await section("/debug/fleet", "autoscale")
            if autoscale and autoscale.get("roster", {}).get("total") == 4:
                break
            await asyncio.sleep(0.25)
        roster = autoscale["roster"]
        placement = await section("/debug/scheduler", "placement")
        a = provider_module.HocuspocusProvider(name="cli-fleet", url=cli.url)
        b = provider_module.HocuspocusProvider(name="cli-fleet", url=cli.url)
        try:
            await _wait_for(lambda: a.synced and b.synced, 60)
            a.document.get_text("t").insert(0, "served beside warm spares ")
            await _wait_for(lambda: "warm spares" in b.document.get_text("t").to_string(), 30)
            await _wait_for(lambda: not a.has_unsynced_changes, 10)
            c = provider_module.HocuspocusProvider(name="cli-fleet", url=cli.url)
            try:
                await _wait_for(lambda: c.synced, 60)
                await _wait_for(
                    lambda: crdt.encode_state_as_update(c.document)
                    == crdt.encode_state_as_update(a.document), 30,
                )
            finally:
                c.destroy()
            devices = json.loads((await cli.get("/debug/scheduler"))[1]).get("devices", [])
        finally:
            a.destroy()
            b.destroy()
    parked_docs = sum(cell["docs"] for cell in devices if cell["cell"] in (2, 3))
    return (
        roster, sorted(placement["healthy"]), autoscale["bounds"], parked_docs,
        crdt.encode_state_as_update(c.document) == crdt.encode_state_as_update(a.document),
    ), (cli.exit_code,)


def test_cli_fleet_autoscale_boots_warm_spares_parked_as_the_jax_cli():
    roster, healthy, bounds, parked_docs, equal = asyncio.run(_both(_fleet_serve))
    assert roster == {"active": [0, 1], "total": 4} and healthy == [0, 1]
    assert bounds == {"min_cells": 1, "max_cells": 4}
    assert parked_docs == 0 and equal


def test_the_plane_needs_cuda_unless_asked_for_the_cpu():
    proc = _port_cli("--tpu-serve", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "SupervisedTpuMergeExtension needs a CUDA device" in proc.stderr
