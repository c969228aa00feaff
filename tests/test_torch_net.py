"""The port's `net/` (RESP client and mini-redis) against the JAX package's.

The same seeded commands, replies and keys go through both packages'
functions; encoded bytes, parsed replies and every byte a mini-redis
sends back are held equal. The slow-subscriber twin shrinks both ends'
socket buffers so that only the bounded subscriber queue can absorb the
backlog: it can fail only when mini-redis does not drop the subscriber.
"""

import asyncio
import socket

import numpy as np
import pytest

from hocuspocus_tpu.net import mini_redis as jax_mini_redis
from hocuspocus_tpu.net import resp as jax_resp
from hocuspocus_tpu_torch.net import mini_redis as port_mini_redis
from hocuspocus_tpu_torch.net import resp as port_resp

PACKAGES = {
    "jax": (jax_resp, jax_mini_redis),
    "port": (port_resp, port_mini_redis),
}


def _random_arg(rng):
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return int(rng.integers(-(2**40), 2**40))
    if kind == 1:
        return float(rng.normal() * 1e3)
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(rng.integers(0, 24))))
    return bytes(rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8))


def test_encode_command_is_byte_identical():
    rng = np.random.default_rng(11)
    for _ in range(2000):
        args = [_random_arg(rng) for _ in range(int(rng.integers(1, 8)))]
        assert port_resp.encode_command(*args) == jax_resp.encode_command(*args)
    segments = [b"head", memoryview(b"frame-bytes"), b""]
    assert port_resp.encode_publish_segments("chan", segments) == jax_resp.encode_publish_segments(
        "chan", segments
    )


def _random_reply(rng, depth: int = 0) -> bytes:
    kind = int(rng.integers(0, 7 if depth < 3 else 5))
    if kind == 0:
        return b"+" + bytes(rng.integers(97, 123, int(rng.integers(0, 12)), dtype=np.uint8)) + b"\r\n"
    if kind == 1:
        return b"-ERR " + bytes(rng.integers(97, 123, int(rng.integers(1, 12)), dtype=np.uint8)) + b"\r\n"
    if kind == 2:
        return b":%d\r\n" % int(rng.integers(-(2**40), 2**40))
    if kind == 3:
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
        return b"$%d\r\n" % len(body) + body + b"\r\n"
    if kind == 4:
        return b"$-1\r\n"
    if kind == 5:
        return b"*-1\r\n"
    count = int(rng.integers(0, 5))
    # an error inside an array raises out of the whole reply
    items = [_random_reply(rng, depth + 1) for _ in range(count)]
    return b"*%d\r\n" % count + b"".join(items)


async def _parse(module, wire: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(wire)
    reader.feed_eof()
    out = []
    while True:
        try:
            out.append(("value", await module.read_reply(reader)))
        except module.RespError as error:
            out.append(("error", str(error)))
        except ConnectionError:
            return out


async def test_reply_parser_agrees_on_seeded_replies():
    rng = np.random.default_rng(5)
    for _ in range(300):
        wire = b"".join(_random_reply(rng) for _ in range(int(rng.integers(1, 6))))
        assert await _parse(port_resp, wire) == await _parse(jax_resp, wire)


def test_key_hash_slot_over_seeded_keys():
    rng = np.random.default_rng(3)
    for i in range(10_000):
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8))
        if i % 3 == 0:  # hash tags, empty and unterminated ones included
            body = body[:4] + b"{" + body[4:8] + (b"}" if i % 2 else b"") + body[8:]
        key = body if i % 2 else body.decode("latin-1")
        assert port_resp.key_hash_slot(key) == jax_resp.key_hash_slot(key)
        assert port_resp.crc16(body) == jax_resp.crc16(body)
    assert port_resp.RELEASE_LOCK_SCRIPT == jax_resp.RELEASE_LOCK_SCRIPT
    assert port_resp.EXTEND_LOCK_SCRIPT == jax_resp.EXTEND_LOCK_SCRIPT


# -- mini-redis: the same conversation against each package's server ------------


async def _read_available(reader, settle: float = 0.02) -> bytes:
    """Every byte the server sent until it goes quiet for `settle` s."""
    out = bytearray()
    while True:
        try:
            chunk = await asyncio.wait_for(reader.read(65536), settle)
        except asyncio.TimeoutError:
            return bytes(out)
        if not chunk:
            return bytes(out)
        out += chunk


def _conversation(resp, rng):
    """Seeded commands over strings, NX/PX/EX sets, deletes, lock scripts
    (acquire, EXTEND and RELEASE with the right and a wrong token),
    publishes, pings and unknown commands."""
    keys = [f"k{i}" for i in range(6)] + ["{tag}.a", "{tag}.b"]
    commands = []
    for step in range(400):
        key = keys[int(rng.integers(0, len(keys)))]
        token = f"tok{int(rng.integers(0, 3))}"
        pick = int(rng.integers(0, 10))
        if pick == 0:
            commands.append(("SET", key, token))
        elif pick == 1:
            commands.append(("SET", key, token, "PX", 60_000, "NX"))
        elif pick == 2:
            commands.append(("SET", key, token, "EX", 60))
        elif pick == 3:
            commands.append(("GET", key))
        elif pick == 4:
            commands.append(("DEL", key, keys[int(rng.integers(0, len(keys)))]))
        elif pick == 5:
            commands.append(("EVAL", resp.RELEASE_LOCK_SCRIPT, 1, key, token))
        elif pick == 6:
            commands.append(("EVAL", resp.EXTEND_LOCK_SCRIPT, 1, key, token, 30_000))
        elif pick == 7:
            commands.append(("PUBLISH", f"chan{step % 3}", bytes([step % 256]) * (step % 17)))
        elif pick == 8:
            commands.append(("PING",))
        else:
            commands.append(("NOSUCHCOMMAND", key))
    return commands


@pytest.mark.parametrize("seed", [0, 1])
async def test_mini_redis_conversation_is_byte_identical(seed):
    """Commands, lock scripts and pub/sub: every reply and every pushed
    message byte for byte, the servers' counters equal."""
    transcripts = {}
    for name, (resp, mini) in PACKAGES.items():
        rng = np.random.default_rng(seed)
        redis = await mini.MiniRedis().start()
        try:
            sub_reader, sub_writer = await asyncio.open_connection("127.0.0.1", redis.port)
            sub_writer.write(resp.encode_command("SUBSCRIBE", "chan0"))
            sub_writer.write(resp.encode_command("SUBSCRIBE", "chan1"))
            await sub_writer.drain()
            subscribed = await _read_available(sub_reader)
            reader, writer = await asyncio.open_connection("127.0.0.1", redis.port)
            replies = []
            for command in _conversation(resp, rng):
                writer.write(resp.encode_command(*command))
                await writer.drain()
                replies.append(await _read_available(reader, 0.005))
            sub_writer.write(resp.encode_command("UNSUBSCRIBE", "chan1"))
            await sub_writer.drain()
            pushed = await _read_available(sub_reader)
            writer.close()
            sub_writer.close()
            transcripts[name] = (subscribed, replies, pushed, dict(redis.counters))
        finally:
            await redis.stop()
    assert transcripts["port"] == transcripts["jax"]
    _, replies, pushed, counters = transcripts["port"]
    assert any(r.startswith(b"-") for r in replies)  # unknown commands answered
    assert b"message" in pushed and counters["delivered"] > 0


async def _cluster(mini, n: int = 2):
    nodes = [await mini.MiniRedis().start() for _ in range(n)]
    width = 16384 // n
    ranges = [
        (i * width, 16383 if i == n - 1 else (i + 1) * width - 1, node)
        for i, node in enumerate(nodes)
    ]
    for node in nodes:
        node.configure_cluster(ranges)
    return nodes


async def test_mini_redis_cluster_slots_and_moved_are_identical():
    """CLUSTER SLOTS (ports normalised: each run's nodes listen on their
    own ports), MOVED redirects for keys off a node's ranges, and a
    slot-routed cluster client's reads."""
    results = {}
    for name, (resp, mini) in PACKAGES.items():
        nodes = await _cluster(mini)
        try:
            ports = {node.port: f"node{i}".encode() for i, node in enumerate(nodes)}
            reader, writer = await asyncio.open_connection("127.0.0.1", nodes[0].port)
            writer.write(resp.encode_command("CLUSTER", "SLOTS"))
            await writer.drain()
            slots = await resp.read_reply(reader)
            slots = [[s, e, [host, ports[port]]] for s, e, (host, port, *_rest) in slots]
            moved = []
            for i in range(64):
                writer.write(resp.encode_command("GET", f"key-{i}"))
                await writer.drain()
                try:
                    moved.append(await resp.read_reply(reader))
                except resp.RespError as error:
                    head, slot, target = str(error).split(" ")
                    port = int(target.rsplit(":", 1)[1])
                    moved.append((head, slot, ports[port]))
            writer.close()
            client = resp.RedisClusterClient([(n.host, n.port) for n in nodes])
            for i in range(32):
                await client.set(f"c-{i}", f"v{i}")
            values = [await client.get(f"c-{i}") for i in range(32)]
            held = [sorted(node.data) for node in nodes]
            client.close()
            results[name] = (slots, moved, values, held)
        finally:
            for node in nodes:
                await node.stop()
    assert results["port"] == results["jax"]
    assert any(isinstance(m, tuple) for m in results["port"][1])  # some MOVED


async def test_lock_helpers_agree():
    """acquire / extend / release through each package's RedisClient
    against its own mini-redis: the same outcomes in the same order."""
    outcomes = {}
    for name, (resp, mini) in PACKAGES.items():
        redis = await mini.MiniRedis().start()
        try:
            a, b = resp.RedisClient(port=redis.port), resp.RedisClient(port=redis.port)
            out = [
                await a.acquire_lock("lock", "tok-a", 5000),
                await b.acquire_lock("lock", "tok-b", 5000),
                await b.extend_lock("lock", "tok-b", 5000),
                await a.extend_lock("lock", "tok-a", 9000),
                await b.release_lock("lock", "tok-b"),
                await a.release_lock("lock", "tok-a"),
                await b.acquire_lock("lock", "tok-b", 5000),
                await a.acquire_lock("short", "tok-a", 30),
            ]
            await asyncio.sleep(0.08)  # the PX expiry passes
            out.append(await b.acquire_lock("short", "tok-b", 5000))
            a.close()
            b.close()
            outcomes[name] = out
        finally:
            await redis.stop()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"] == [True, False, False, True, False, True, True, True, True]


@pytest.mark.parametrize("package", ["jax", "port"])
async def test_bounded_queue_disconnects_a_slow_subscriber(package):
    """A subscriber that never reads, with 4 KiB socket buffers at both
    ends of its connection (its SO_RCVBUF before connect, mini-redis's
    SO_SNDBUF once accepted), so the kernel cannot absorb the backlog:
    mini-redis's bounded queue (8 frames) must fill and drop it while a
    fast subscriber keeps every frame published before the drop."""
    resp, mini = PACKAGES[package]
    redis = await mini.MiniRedis(subscriber_queue_limit=8).start()
    try:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        sock.setblocking(False)
        await asyncio.get_running_loop().sock_connect(sock, ("127.0.0.1", redis.port))
        reader, writer = await asyncio.open_connection(sock=sock)
        writer.write(resp.encode_command("SUBSCRIBE", "busy"))
        await writer.drain()
        await reader.readexactly(1)  # subscribed: its connection is accepted
        writer.transport.pause_reading()  # never reads again
        for server_side in list(redis._conns):
            server_side.get_extra_info("socket").setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF, 4096
            )
        received = []
        fast = resp.RedisSubscriber(port=redis.port, on_message=lambda ch, data: received.append(data))
        await fast.subscribe("busy")
        pub = resp.RedisClient(port=redis.port)
        dropped_at = None
        for i in range(5000):
            await pub.publish("busy", b"x" * 512)
            if redis.counters["slow_disconnects"] > 0:
                dropped_at = i
                break
        # 2 x 8 KiB of kernel buffers (the kernel doubles 4 KiB), 64 KiB
        # of transport buffer and 8 queued frames hold ~160 frames of 541
        # bytes: the drop comes well before 1,000 publishes
        assert dropped_at is not None and dropped_at < 1000, redis.counters
        assert redis.counters["slow_disconnects"] == 1
        assert redis.counters["dropped_slow"] == 1
        deadline = asyncio.get_running_loop().time() + 10
        while len(received) < dropped_at + 1 and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.01)
        assert len(received) == dropped_at + 1
        fast.close()
        pub.close()
        writer.close()
    finally:
        await redis.stop()
