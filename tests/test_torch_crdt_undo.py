"""The port's relative positions and UndoManager against the JAX package's.

Twins of tests/crdt/test_relative_position.py, tests/crdt/test_undo.py
and tests/crdt/test_search_markers.py (whose undo/redo pops bypass the
marker-aware ops), and of the awareness-cursor case of
tests/provider/test_history_client.py. Each scenario runs once per
package with Python's `random` seeded the same way before it, so both
packages draw the same client ids; the scenario keeps the reference
test's assertions and returns what it observed: encoded updates,
encoded relative positions, resolved indices and texts. Tolerance:
exact, bytes for bytes.
"""

import asyncio
import random
import time
import types

import pytest

import hocuspocus_tpu.aio as jax_aio
import hocuspocus_tpu.crdt as jax_crdt
import hocuspocus_tpu.crdt.ids as jax_ids
import hocuspocus_tpu.crdt.relative_position as jax_relative_position
import hocuspocus_tpu.crdt.undo as jax_undo
import hocuspocus_tpu.provider as jax_provider
import hocuspocus_tpu.server as jax_server
import hocuspocus_tpu.server.types as jax_types
import hocuspocus_tpu_torch.aio as port_aio
import hocuspocus_tpu_torch.crdt as port_crdt
import hocuspocus_tpu_torch.crdt.ids as port_ids
import hocuspocus_tpu_torch.crdt.relative_position as port_relative_position
import hocuspocus_tpu_torch.crdt.undo as port_undo
import hocuspocus_tpu_torch.provider as port_provider
import hocuspocus_tpu_torch.server as port_server
import hocuspocus_tpu_torch.server.types as port_types

PACKAGES = {
    "jax": types.SimpleNamespace(
        crdt=jax_crdt, ids=jax_ids, rp=jax_relative_position, undo=jax_undo,
        aio=jax_aio, provider=jax_provider, server=jax_server, types=jax_types,
    ),
    "port": types.SimpleNamespace(
        crdt=port_crdt, ids=port_ids, rp=port_relative_position, undo=port_undo,
        aio=port_aio, provider=port_provider, server=port_server, types=port_types,
    ),
}

# the search-marker fuzz's seed counts (tests/crdt/test_search_markers.py
# runs 30; each twin runs every seed through both packages)
MARKER_SEEDS = 30


def twin(scenario, seed: int = 0):
    """`scenario(pkg)` in both packages from the same `random` state;
    their observations must be equal. Returns the port's."""
    seen = {}
    for name, pkg in PACKAGES.items():
        random.seed(seed)
        seen[name] = scenario(pkg)
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _resolve(pkg, rpos, doc):
    pos = pkg.crdt.create_absolute_position_from_relative_position(rpos, doc)
    assert pos is not None
    return pos.index


def _state(pkg, *docs):
    return tuple(pkg.crdt.encode_state_as_update(doc) for doc in docs)


# -- twins of tests/crdt/test_relative_position.py ----------------------------


def _anchor_shifts(pkg):
    d = pkg.crdt.Doc()
    t = d.get_text("t")
    t.insert(0, "hello world")
    anchor = pkg.crdt.create_relative_position_from_type_index(t, 6)
    seen = [pkg.crdt.encode_relative_position(anchor)]
    t.insert(0, ">>> ")
    seen.append(_resolve(pkg, anchor, d))
    t.delete(0, 4)
    seen.append(_resolve(pkg, anchor, d))
    t.insert(6, "brave ")
    seen.append(_resolve(pkg, anchor, d))
    assert seen[1:] == [10, 6, 12]
    assert t.to_string()[_resolve(pkg, anchor, d):] == "world"
    return seen, _state(pkg, d)


def _assoc_negative(pkg):
    d = pkg.crdt.Doc()
    t = d.get_text("t")
    t.insert(0, "ab")
    before = pkg.crdt.create_relative_position_from_type_index(t, 1, assoc=-1)
    at = pkg.crdt.create_relative_position_from_type_index(t, 1, assoc=0)
    t.insert(1, "XY")
    assert _resolve(pkg, before, d) == 1
    assert _resolve(pkg, at, d) == 3
    return [pkg.crdt.encode_relative_position(r) for r in (before, at)], _state(pkg, d)


def _boundaries(pkg):
    d = pkg.crdt.Doc()
    t = d.get_text("t")
    start = pkg.crdt.create_relative_position_from_type_index(t, 0)
    end_assoc = pkg.crdt.create_relative_position_from_type_index(t, 0, assoc=-1)
    seen = [_resolve(pkg, start, d), _resolve(pkg, end_assoc, d)]
    t.insert(0, "abc")
    seen.append(_resolve(pkg, start, d))
    tail = pkg.crdt.create_relative_position_from_type_index(t, 3)
    seen.append(_resolve(pkg, tail, d))
    t.insert(3, "d")
    seen.append(_resolve(pkg, tail, d))
    pinned = pkg.crdt.create_relative_position_from_type_index(t, 4, assoc=-1)
    t.insert(4, "e")
    seen.append(_resolve(pkg, pinned, d))
    assert seen == [0, 0, 3, 3, 4, 4]
    encoded = [pkg.crdt.encode_relative_position(r) for r in (start, end_assoc, tail, pinned)]
    return seen, encoded, _state(pkg, d)


def _deleted_anchor(pkg):
    d = pkg.crdt.Doc()
    t = d.get_text("t")
    t.insert(0, "abcdef")
    mid = pkg.crdt.create_relative_position_from_type_index(t, 3)
    t.delete(2, 3)
    assert t.to_string() == "abf"
    assert _resolve(pkg, mid, d) == 2
    return pkg.crdt.encode_relative_position(mid), _state(pkg, d)


def _roundtrip_cross_replica(pkg):
    crdt = pkg.crdt
    a = crdt.Doc()
    ta = a.get_text("t")
    ta.insert(0, "shared content")
    anchor = crdt.create_relative_position_from_type_index(ta, 7)
    raw = crdt.encode_relative_position(anchor)
    b = crdt.Doc()
    crdt.apply_update(b, crdt.encode_state_as_update(a), "remote")
    decoded = crdt.decode_relative_position(raw)
    assert crdt.compare_relative_positions(decoded, crdt.decode_relative_position(raw))
    assert crdt.encode_relative_position(decoded) == raw
    tb = b.get_text("t")
    seen = [_resolve(pkg, decoded, b)]
    tb.insert(0, "B: ")
    seen.append(_resolve(pkg, decoded, b))
    tb.insert(0, "zz")
    newer = crdt.create_relative_position_from_type_index(tb, 1)
    assert crdt.create_absolute_position_from_relative_position(newer, a) is None
    assert seen == [7, 10]
    return raw, seen, crdt.encode_relative_position(newer), _state(pkg, a, b)


def _legacy_decode(pkg):
    crdt = pkg.crdt
    d = crdt.Doc()
    t = d.get_text("t")
    t.insert(0, "xy")
    raw = crdt.encode_relative_position(crdt.create_relative_position_from_type_index(t, 1))
    decoded = crdt.decode_relative_position(raw[:-1])
    assert decoded.assoc == 0
    assert _resolve(pkg, decoded, d) == 1
    return raw, crdt.encode_relative_position(decoded)


def _undo_redo_redone_chain(pkg):
    d = pkg.crdt.Doc()
    t = d.get_text("t")
    t.insert(0, "keep me around")
    um = pkg.undo.UndoManager(t, capture_timeout=0)
    t.insert(5, "X")
    target = t.to_string()[8]
    anchor = pkg.crdt.create_relative_position_from_type_index(t, 8)
    um.undo()
    p1 = _resolve(pkg, anchor, d)
    assert t.to_string()[p1] == target
    um.redo()
    p2 = _resolve(pkg, anchor, d)
    assert t.to_string()[p2] == target and p2 == p1 + 1
    return pkg.crdt.encode_relative_position(anchor), p1, p2, _state(pkg, d)


def _anchor_fuzz(pkg):
    seen = []
    for seed in range(10):
        rng = random.Random(6000 + seed)
        d = pkg.crdt.Doc()
        t = d.get_text("t")
        t.insert(0, "0123456789")
        idx = rng.randrange(10)
        target_char = t.to_string()[idx]
        anchor = pkg.crdt.create_relative_position_from_type_index(t, idx)
        positions = []
        for _ in range(120):
            vis = len(t.to_string())
            p = _resolve(pkg, anchor, d)
            op = rng.random()
            if op < 0.55:
                t.insert(rng.randrange(vis + 1), chr(97 + rng.randrange(26)))
            elif vis > 1:
                at = rng.randrange(vis - 1)
                if at <= p < at + 1:
                    continue
                t.delete(at, 1)
            new_p = _resolve(pkg, anchor, d)
            positions.append(new_p)
            s = t.to_string()
            if new_p < len(s):
                assert s[new_p] == target_char, (seed, s, new_p, target_char)
        seen.append((pkg.crdt.encode_relative_position(anchor), positions, _state(pkg, d)))
    return seen


def _golden_bytes(pkg):
    rp, crdt = pkg.rp, pkg.crdt
    r = rp.RelativePosition(None, None, pkg.ids.ID(5, 7), 0)
    r_assoc = rp.RelativePosition(None, None, None, -1)
    r_assoc.tname = "body"
    big = rp.RelativePosition(None, None, pkg.ids.ID(0x3FFF, 0x80), 0)
    encoded = [crdt.encode_relative_position(x) for x in (r, r_assoc, big)]
    assert encoded == [
        bytes([0, 5, 7, 0]),
        bytes([1, 4]) + b"body" + bytes([0x41]),
        bytes([0, 0xFF, 0x7F, 0x80, 0x01, 0]),
    ]
    for raw in encoded[:2]:
        assert crdt.encode_relative_position(crdt.decode_relative_position(raw)) == raw
    return encoded


@pytest.mark.parametrize(
    "scenario",
    [
        _anchor_shifts, _assoc_negative, _boundaries, _deleted_anchor,
        _roundtrip_cross_replica, _legacy_decode, _undo_redo_redone_chain,
        _anchor_fuzz, _golden_bytes,
    ],
    ids=lambda fn: fn.__name__.lstrip("_"),
)
def test_relative_positions_match_the_jax_package(scenario):
    twin(scenario, seed=11)


# -- twins of tests/crdt/test_undo.py -----------------------------------------


def _sync(pkg, a, b) -> None:
    pkg.crdt.apply_update(b, pkg.crdt.encode_state_as_update(a))
    pkg.crdt.apply_update(a, pkg.crdt.encode_state_as_update(b))


def _undo_insert_and_redo(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    um = pkg.undo.UndoManager(text, capture_timeout=0)
    text.insert(0, "hello")
    text.insert(5, " world")
    seen = [um.can_undo()]
    for step in (um.undo, um.undo, um.redo, um.redo):
        step()
        seen.append((text.to_string(), um.can_undo(), um.can_redo(), _state(pkg, doc)))
    assert [s[0] for s in seen[1:]] == ["hello", "", "hello", "hello world"]
    assert not seen[2][1] and seen[2][2] and not seen[4][2]
    return seen


def _undo_delete_recreates(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    text.insert(0, "keep this text")
    um = pkg.undo.UndoManager(text, capture_timeout=0)
    text.delete(5, 5)
    seen = [text.to_string()]
    um.undo()
    seen.append(text.to_string())
    um.redo()
    seen.append(text.to_string())
    assert seen == ["keep text", "keep this text", "keep text"]
    return seen, _state(pkg, doc)


def _capture_timeout_merges(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    um = pkg.undo.UndoManager(text, capture_timeout=10_000)
    text.insert(0, "a")
    text.insert(1, "b")
    text.insert(2, "c")
    um.undo()
    assert text.to_string() == ""
    return _state(pkg, doc)


def _stop_capturing_splits(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    um = pkg.undo.UndoManager(text, capture_timeout=10_000)
    text.insert(0, "a")
    um.stop_capturing()
    text.insert(1, "b")
    um.undo()
    assert text.to_string() == "a"
    return _state(pkg, doc)


def _untracked_origin(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    um = pkg.undo.UndoManager(text, capture_timeout=0)
    doc.transact(lambda txn: text.insert(0, "remote "), origin="remote-peer")
    assert not um.can_undo()
    text.insert(0, "local ")
    um.undo()
    assert text.to_string() == "remote "
    return _state(pkg, doc)


def _concurrent_remote_edits(pkg):
    a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
    ta, tb = a.get_text("t"), b.get_text("t")
    um = pkg.undo.UndoManager(ta, capture_timeout=0)
    ta.insert(0, "local")
    _sync(pkg, a, b)
    tb.insert(5, " remote")
    _sync(pkg, a, b)
    um.undo()
    _sync(pkg, a, b)
    assert ta.to_string() == tb.to_string() == " remote"
    undone = _state(pkg, a, b)
    um.redo()
    _sync(pkg, a, b)
    assert "local" in ta.to_string() and " remote" in ta.to_string()
    return undone, ta.to_string(), _state(pkg, a, b)


def _delete_after_remote_edit(pkg):
    a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
    ta, tb = a.get_text("t"), b.get_text("t")
    ta.insert(0, "shared base")
    _sync(pkg, a, b)
    um = pkg.undo.UndoManager(ta, capture_timeout=0)
    ta.delete(0, 6)
    _sync(pkg, a, b)
    tb.insert(len(tb), "!!!")
    _sync(pkg, a, b)
    assert ta.to_string() == " base!!!"
    um.undo()
    _sync(pkg, a, b)
    assert ta.to_string() == tb.to_string() == "shared base!!!"
    return _state(pkg, a, b)


def _scope_filtering(pkg):
    doc = pkg.crdt.Doc()
    tracked = doc.get_text("tracked")
    other = doc.get_text("other")
    um = pkg.undo.UndoManager(tracked, capture_timeout=0)
    other.insert(0, "untracked content")
    assert not um.can_undo()
    tracked.insert(0, "tracked content")
    assert um.can_undo()
    um.undo()
    assert tracked.to_string() == "" and other.to_string() == "untracked content"
    return _state(pkg, doc)


def _map_undo(pkg):
    doc = pkg.crdt.Doc()
    m = doc.get_map("m")
    um = pkg.undo.UndoManager(m, capture_timeout=0)
    m.set("k", "v1")
    m.set("k", "v2")
    seen = []
    for step in (um.undo, um.undo, um.redo, um.redo):
        step()
        seen.append((m.get("k"), _state(pkg, doc)))
    assert [v for v, _s in seen] == ["v1", None, "v1", "v2"]
    return seen


def _map_concurrent_set(pkg):
    a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
    ma, mb = a.get_map("m"), b.get_map("m")
    um = pkg.undo.UndoManager(ma, capture_timeout=0)
    ma.set("k", "mine")
    _sync(pkg, a, b)
    um.undo()
    mb.set("k", "theirs")
    _sync(pkg, a, b)
    um.redo()
    _sync(pkg, a, b)
    assert ma.get("k") == mb.get("k") == "theirs"
    return _state(pkg, a, b)


def _array_undo(pkg):
    doc = pkg.crdt.Doc()
    arr = doc.get_array("a")
    um = pkg.undo.UndoManager(arr, capture_timeout=0)
    arr.insert(0, [1, 2, 3])
    arr.insert(3, [4])
    seen = []
    for step in (um.undo, um.undo, um.redo, um.redo):
        step()
        seen.append((arr.to_array(), _state(pkg, doc)))
    assert [v for v, _s in seen] == [[1, 2, 3], [], [1, 2, 3], [1, 2, 3, 4]]
    return seen


def _undo_events(pkg):
    doc = pkg.crdt.Doc()
    text = doc.get_text("t")
    um = pkg.undo.UndoManager(text, capture_timeout=0)
    added, popped = [], []
    um.on("stack-item-added", lambda event, manager: added.append(event["type"]))
    um.on("stack-item-popped", lambda event, manager: popped.append(event["type"]))
    text.insert(0, "x")
    um.undo()
    um.redo()
    assert "undo" in added and "redo" in added
    assert popped == ["undo", "redo"]
    return added, popped, _state(pkg, doc)


def _parent_collected(pkg):
    crdt = pkg.crdt
    a = crdt.Doc()
    frag_a = a.get_xml_fragment("x")
    el = crdt.YXmlElement("paragraph")
    frag_a.push([el])
    text = crdt.YXmlText()
    el.push([text])
    text.insert(0, "tracked content")
    base = crdt.encode_state_as_update(a)

    b = crdt.Doc()
    crdt.apply_update(b, base)
    b_text = b.get_xml_fragment("x").to_array()[0].to_array()[0]
    undo = pkg.undo.UndoManager(b_text, capture_timeout=0)
    b_text.delete(0, 7)
    u_b = crdt.diff_update(crdt.encode_state_as_update(b), crdt.encode_state_vector(a))
    frag_a.delete(0, 1)
    u_a = crdt.diff_update(crdt.encode_state_as_update(a), crdt.encode_state_vector(b))
    crdt.apply_update(a, u_b)
    crdt.apply_update(b, u_a)
    undo.undo()
    undo.redo()
    assert a.get_xml_fragment("x").to_string() == b.get_xml_fragment("x").to_string()
    return u_a, u_b, _state(pkg, a, b)


@pytest.mark.parametrize(
    "scenario",
    [
        _undo_insert_and_redo, _undo_delete_recreates, _capture_timeout_merges,
        _stop_capturing_splits, _untracked_origin, _concurrent_remote_edits,
        _delete_after_remote_edit, _scope_filtering, _map_undo, _map_concurrent_set,
        _array_undo, _undo_events, _parent_collected,
    ],
    ids=lambda fn: fn.__name__.lstrip("_"),
)
def test_undo_matches_the_jax_package(scenario):
    twin(scenario, seed=23)


# -- twins of tests/crdt/test_search_markers.py -------------------------------


def _marker_pair(pkg):
    a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
    ta, tb = a.get_text("t"), b.get_text("t")
    tb._search_markers = None  # the oracle walks from _start
    return a, b, ta, tb


def _text_positional(pkg):
    seen = []
    for seed in range(MARKER_SEEDS):
        rng = random.Random(1000 + seed)
        a, b, ta, tb = _marker_pair(pkg)
        model = ""
        for step in range(300):
            if model and rng.random() < 0.35:
                pos = rng.randrange(len(model) + 1)
                length = min(rng.randrange(1, 20), len(model) - pos)
                if length > 0:
                    ta.delete(pos, length)
                    tb.delete(pos, length)
                    model = model[:pos] + model[pos + length:]
                    continue
            pos = rng.randrange(len(model) + 1)
            chunk = f"<{seed}.{step}>" + "x" * rng.randrange(0, 30)
            ta.insert(pos, chunk)
            tb.insert(pos, chunk)
            model = model[:pos] + chunk + model[pos:]
        assert ta.to_string() == tb.to_string() == model
        seen.append(_state(pkg, a))
    return seen


def _text_remote_interleaving(pkg):
    seen = []
    for seed in range(max(MARKER_SEEDS // 3, 5)):
        rng = random.Random(7000 + seed)
        a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
        ta, tb = a.get_text("t"), b.get_text("t")
        oracle = pkg.crdt.Doc()
        oracle.client_id = a.client_id
        to = oracle.get_text("t")
        to._search_markers = None
        for _round in range(20):
            for _ in range(rng.randrange(1, 6)):
                pos = rng.randrange(len(ta.to_string()) + 1)
                chunk = "a%03d" % rng.randrange(1000)
                ta.insert(pos, chunk)
                to.insert(pos, chunk)
            tb.insert(rng.randrange(len(tb.to_string()) + 1), "B%02d" % rng.randrange(100))
            upd = pkg.crdt.encode_state_as_update(b)
            pkg.crdt.apply_update(a, upd, "remote")
            pkg.crdt.apply_update(oracle, upd, "remote")
            pos = rng.randrange(len(ta.to_string()) + 1)
            ta.insert(pos, "!")
            to.insert(pos, "!")
            assert ta.to_string() == to.to_string(), seed
        assert _state(pkg, a) == _state(pkg, oracle)
        seen.append(_state(pkg, a, b))
    return seen


def _text_formatting(pkg):
    seen = []
    for seed in range(max(MARKER_SEEDS // 3, 5)):
        rng = random.Random(3000 + seed)
        a, b, ta, tb = _marker_pair(pkg)
        for _ in range(60):
            pos = rng.randrange(len(ta.to_string()) + 1)
            chunk = "p%02d" % rng.randrange(100)
            ta.insert(pos, chunk)
            tb.insert(pos, chunk)
        start = rng.randrange(len(ta.to_string()) - 10)
        ta.format(start, 10, {"bold": True})
        tb.format(start, 10, {"bold": True})
        for _ in range(40):
            vis = len(ta.to_string())
            pos = rng.randrange(vis + 1)
            if vis and rng.random() < 0.3:
                length = min(3, vis - pos)
                if length:
                    ta.delete(pos, length)
                    tb.delete(pos, length)
                    continue
            ta.insert(pos, "z")
            tb.insert(pos, "z")
        assert ta.to_string() == tb.to_string() and ta.to_delta() == tb.to_delta()
        seen.append((ta.to_delta(), _state(pkg, a)))
    return seen


def _text_undo_interleaving(pkg):
    seen = []
    for seed in range(max(MARKER_SEEDS // 3, 5)):
        rng = random.Random(5000 + seed)
        a, b, ta, tb = _marker_pair(pkg)
        ua = pkg.undo.UndoManager(ta, capture_timeout=0)
        ub = pkg.undo.UndoManager(tb, capture_timeout=0)
        for _round in range(15):
            for _ in range(rng.randrange(1, 4)):
                pos = rng.randrange(len(ta.to_string()) + 1)
                chunk = "u%02d" % rng.randrange(100)
                ta.insert(pos, chunk)
                tb.insert(pos, chunk)
            if rng.random() < 0.5:
                ua.undo()
                ub.undo()
            if rng.random() < 0.3:
                ua.redo()
                ub.redo()
            pos = rng.randrange(len(ta.to_string()) + 1)
            ta.insert(pos, ".")
            tb.insert(pos, ".")
            assert ta.to_string() == tb.to_string(), (seed, _round)
        seen.append(_state(pkg, a, b))
    return seen


def _array_positional(pkg):
    seen = []
    for seed in range(MARKER_SEEDS):
        rng = random.Random(9000 + seed)
        a, b = pkg.crdt.Doc(), pkg.crdt.Doc()
        aa, ab = a.get_array("a"), b.get_array("a")
        ab._search_markers = None
        model: list = []
        for _step in range(200):
            if model and rng.random() < 0.35:
                pos = rng.randrange(len(model))
                length = min(rng.randrange(1, 4), len(model) - pos)
                aa.delete(pos, length)
                ab.delete(pos, length)
                del model[pos:pos + length]
                continue
            pos = rng.randrange(len(model) + 1)
            values = [rng.randrange(10_000) for _ in range(rng.randrange(1, 4))]
            aa.insert(pos, values)
            ab.insert(pos, values)
            model[pos:pos] = values
        assert aa.to_json() == ab.to_json() == model
        reads = [rng.randrange(len(model)) for _ in range(20)]
        assert [aa.get(i) for i in reads] == [model[i] for i in reads]
        seen.append(_state(pkg, a))
    return seen


def _array_push(pkg):
    a = pkg.crdt.Doc()
    arr = a.get_array("a")
    for i in range(500):
        arr.push([i])
    assert arr.to_json() == list(range(500))
    return _state(pkg, a)


@pytest.mark.parametrize(
    "scenario",
    [
        _text_positional, _text_remote_interleaving, _text_formatting,
        _text_undo_interleaving, _array_positional, _array_push,
    ],
    ids=lambda fn: fn.__name__.lstrip("_"),
)
def test_search_markers_match_the_jax_package(scenario):
    twin(scenario, seed=31)


# -- the awareness cursor (tests/provider/test_history_client.py:84-108) ------


async def _until(condition, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not condition():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        await asyncio.sleep(0.01)


async def _cursor(pkg):
    core = pkg.server.Hocuspocus(pkg.server.Configuration(quiet=True))
    await core.ensure_configured()
    providers = [
        pkg.provider.HocuspocusProvider(
            name="cursor-doc", websocket_provider=pkg.provider.InProcessProviderSocket(core)
        )
        for _ in range(2)
    ]
    a, b = providers
    for provider in providers:
        provider.attach()
    try:
        await pkg.aio.await_synced(providers, timeout=20)
        ta = a.document.get_text("t")
        ta.insert(0, "the quick brown fox")
        await _until(lambda: b.document.get_text("t").to_string() == "the quick brown fox")
        a.set_awareness_cursor(ta, 4, 9)

        def cursor():
            state = b.awareness.get_states().get(a.document.client_id)
            return None if state is None else state.get("cursor")

        await _until(lambda: cursor() is not None)
        field = cursor()
        first = b.resolve_awareness_cursor(field, b.document)
        assert first == {"anchor": 4, "head": 9}
        b.document.get_text("t").insert(0, ">>> ")
        await _until(lambda: ta.to_string().startswith(">>> "))
        shifted = b.resolve_awareness_cursor(cursor(), b.document)
        assert shifted == {"anchor": 8, "head": 13}
        text = b.document.get_text("t").to_string()
        assert text[shifted["anchor"]:shifted["head"]] == "quick"
        assert b.resolve_awareness_cursor("junk", b.document) is None
        assert b.resolve_awareness_cursor({"anchor": "zz"}, b.document) is None
        # each end is a relative position on a's first insert, encoded as
        # the package encodes it: the same bytes but for a's client id
        decoded = {
            key: pkg.crdt.decode_relative_position(bytes.fromhex(raw)) for key, raw in field.items()
        }
        assert all(rpos.item.client == a.document.client_id for rpos in decoded.values())
        ends = {key: (rpos.item.clock, rpos.assoc) for key, rpos in decoded.items()}
        return first, shifted, text, ends
    finally:
        for provider in providers:
            provider.destroy()
            provider.websocket_provider.destroy()
        await core.hooks("on_destroy", pkg.types.Payload(instance=core))


def test_awareness_cursor_through_the_port_provider_matches_the_jax_package():
    seen = {name: asyncio.run(_cursor(pkg)) for name, pkg in PACKAGES.items()}
    assert seen["port"] == seen["jax"]
    assert seen["port"][3] == {"anchor": (4, 0), "head": (9, 0)}
