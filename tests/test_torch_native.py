"""The port's native codec against the JAX package's and the port's own
Python paths.

`hocuspocus_tpu_torch/native` is the port's copy of the JAX package's
C++ codec, built under its own module name. Every entry point is driven
here with inputs made from a numpy seed and held to tolerance 0: the
port's module must return what the JAX package's `_codec` returns, and
what the port's pure-Python encoder/decoder computes (frames, varints,
merges, window struct sections, decodes).
"""

import numpy as np
import pytest

from hocuspocus_tpu.native import get_codec as jax_get_codec
from hocuspocus_tpu_torch.crdt import (
    Doc,
    apply_update,
    encode_state_as_update,
    encode_state_vector,
)
from hocuspocus_tpu_torch.crdt.encoding import Decoder, Encoder
from hocuspocus_tpu_torch.crdt.update import _is_redundant_update, _write_structs, merge_updates
from hocuspocus_tpu_torch.native import get_codec
from hocuspocus_tpu_torch.protocol import frames
from hocuspocus_tpu_torch.protocol.message import MessageType
from hocuspocus_tpu_torch.protocol.sync import MESSAGE_YJS_UPDATE, coalesce_updates
from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing
from hocuspocus_tpu_torch.tpu import lowering

NAMES = ["doc", "", "näme/ünïcode-😀", "x" * 300, "doc"]
ALPHABET = ["a", "bc", "é", "€", "😀", "xyz", " "]


@pytest.fixture(scope="module")
def codec():
    return get_codec()


@pytest.fixture(scope="module")
def jax_codec():
    module = jax_get_codec()
    assert module is not None, "the JAX package's codec did not build"
    return module


def _random_text_updates(rng, steps, client_id=None, gc=True):
    doc = Doc(gc=gc)
    if client_id is not None:
        doc.client_id = client_id
    updates = []
    doc.on("update", lambda update, *rest: updates.append(update))
    text = doc.get_text("t")
    for _ in range(steps):
        n = len(text)
        if rng.random() < 0.7 or n < 3:
            word = "".join(rng.choice(ALPHABET, size=int(rng.integers(1, 6))))
            text.insert(int(rng.integers(0, n + 1)), word)
        else:
            pos = int(rng.integers(0, n - 1))
            text.delete(pos, int(rng.integers(1, min(4, n - pos) + 1)))
    return doc, updates


def _python_frame(name, update, reply):
    encoder = Encoder()
    encoder.write_var_string(name)
    encoder.write_var_uint(MessageType.SyncReply if reply else MessageType.Sync)
    encoder.write_var_uint(MESSAGE_YJS_UPDATE)
    encoder.write_var_uint8_array(update)
    return encoder.to_bytes()


def _python_header(data):
    decoder = Decoder(data)
    name = decoder.read_var_string()
    return name, decoder.read_var_uint(), decoder.pos


def _random_bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


# -- module identity ----------------------------------------------------------


def test_module_is_the_ports_own_with_the_jax_modules_api(codec, jax_codec):
    assert codec.__name__ == "_hocuspocus_torch_codec"
    assert jax_codec.__name__ == "_codec"
    assert codec is not jax_codec
    public = lambda module: {n for n in dir(module) if not n.startswith("_")}
    assert public(codec) == public(jax_codec) - {"NATIVE_API_VERSION"}


def test_lane_handles_are_refused_across_packages(codec, jax_codec):
    """The lane capsule carries a name of its own: a handle made by one
    package's module is refused by the other's functions."""
    ours, theirs = codec.lane_new(), jax_codec.lane_new()
    codec.lane_open(ours, 0)
    jax_codec.lane_open(theirs, 0)
    with pytest.raises(ValueError):
        codec.lane_open(theirs, 1)
    with pytest.raises(ValueError):
        jax_codec.lane_queue_total(ours)
    assert codec.lane_queue_total(ours) == 0


# -- utf16_len / decode_update ------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_utf16_len_matches_jax_and_python(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        s = "".join(rng.choice(ALPHABET + ["\U0001f680", "ß"], size=int(rng.integers(0, 20))))
        assert codec.utf16_len(s) == jax_codec.utf16_len(s) == lowering._utf16_len(s)
        assert codec.utf16_len(s) == len(s.encode("utf-16-le")) // 2


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_decode_update_matches_jax(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    doc, updates = _random_text_updates(rng, 40, gc=bool(seed % 2))
    doc.get_map("m").set("k", 1)  # rich content: kind 4, the Python path
    for update in updates + [encode_state_as_update(doc)]:
        assert codec.decode_update(update) == jax_codec.decode_update(update)


@pytest.mark.parametrize("seed", [6, 7])
def test_decode_screen_lowers_like_the_python_decoder(seed):
    """The lowering's native screen yields the same lowered ops as the
    pure-Python decoder for the plain-text stream."""
    rng = np.random.default_rng(seed)
    _, updates = _random_text_updates(rng, 60)
    native, python = lowering.DocLowerer(), lowering.DocLowerer()
    for update in updates:
        structs, deletes = lowering._decode_update(update)
        p_structs, p_deletes = lowering._python_decode(update)
        assert [(s.client, s.clock, s.kind, s.length, s.payload) for s in structs] == [
            (s.client, s.clock, s.kind, s.length, s.payload) for s in p_structs
        ]
        assert sorted(deletes) == sorted(p_deletes)
        assert repr(native.lower_update(update)) == repr(python.lower_update(update))


@pytest.mark.parametrize("seed", [8, 9])
def test_corrupt_updates_decode_alike_in_both_packages(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    doc, _ = _random_text_updates(rng, 30)
    update = bytearray(encode_state_as_update(doc))
    cases = [bytes(update[:n]) for n in range(0, len(update), 5)]
    for _ in range(100):
        mutated = bytearray(update)
        for _ in range(int(rng.integers(1, 4))):
            mutated[int(rng.integers(0, len(mutated)))] = int(rng.integers(0, 256))
        cases.append(bytes(mutated))
    for data in cases:
        outcomes = []
        for module in (codec, jax_codec):
            try:
                outcomes.append(("ok", module.decode_update(data)))
            except Exception as error:  # noqa: BLE001 - compared, not swallowed
                outcomes.append(("raised", type(error).__name__))
        assert outcomes[0] == outcomes[1]


# -- frames -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [10, 11])
def test_frame_singles_match_jax_and_python(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        update = _random_bytes(rng, int(rng.integers(0, 80)))
        reply = bool(rng.random() < 0.4)
        frame = frames.build_update_frame(name, update, reply)
        assert frame == jax_codec.build_update_frame(name, update, reply)
        assert frame == _python_frame(name, update, reply)
        assert frames.parse_frame_header(frame) == _python_header(frame)
        assert codec.parse_frame_header(frame) == jax_codec.parse_frame_header(frame)
        ok = bool(rng.random() < 0.5)
        status = Encoder()
        status.write_var_string(name)
        status.write_var_uint(MessageType.SyncStatus)
        status.write_var_uint(1 if ok else 0)
        assert frames.build_sync_status_frame(name, ok) == status.to_bytes()
        assert frames.build_sync_status_frame(name, ok) == jax_codec.build_sync_status_frame(
            name, ok
        )


@pytest.mark.parametrize("seed", [12, 13])
def test_frame_batches_match_jax_and_python(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(60):
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        update = _random_bytes(rng, int(rng.integers(0, 200)))
        items.append((name, update, bool(rng.random() < 0.5)))
    built = frames.build_update_frames_batch(items)
    assert built == jax_codec.build_update_frames_batch(items)
    assert built == [_python_frame(*it) for it in items]
    assert frames.build_update_frames_batch([it[:2] for it in items]) == [
        _python_frame(name, update, False) for name, update, _ in items
    ]
    parsed = frames.parse_frame_headers_batch(built)
    assert parsed == jax_codec.parse_frame_headers_batch(built, False)
    assert parsed == [_python_header(f) for f in built]


MALFORMED = [b"", b"\x80", b"\x05ab", b"\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01", b"\x03doc"]


@pytest.mark.parametrize("seed", [14, 15])
def test_frame_batch_skip_malformed_matches_jax_and_python(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    good = [
        frames.build_update_frame(NAMES[int(rng.integers(0, len(NAMES)))], _random_bytes(rng, 9))
        for _ in range(20)
    ]
    batch = []
    for frame in good:
        roll = rng.random()
        if roll < 0.3 and len(frame) > 1:
            batch.append(frame[: int(rng.integers(1, len(frame)))])
        elif roll < 0.5:
            batch.append(MALFORMED[int(rng.integers(0, len(MALFORMED)))])
        else:
            batch.append(frame)
    skipped = frames.parse_frame_headers_batch(batch, skip_malformed=True)
    assert skipped == jax_codec.parse_frame_headers_batch(batch, True)
    for data, parsed in zip(batch, skipped):
        try:
            expect = _python_header(data)
        except (ValueError, EOFError, IndexError):
            expect = None
        assert parsed == expect
    assert None in skipped
    with pytest.raises(ValueError):
        frames.parse_frame_headers_batch(batch)


# -- coalesce_updates ---------------------------------------------------------


@pytest.mark.parametrize("seed", [16, 17])
def test_coalesce_matches_python_merge(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    merged_natively = 0
    for _ in range(20):
        updates = []
        for _ in range(int(rng.integers(2, 5))):
            doc, _ = _random_text_updates(rng, int(rng.integers(1, 5)))
            updates.append(encode_state_as_update(doc))
        native = codec.coalesce_updates(updates)
        assert native == jax_codec.coalesce_updates(updates)
        assert coalesce_updates(updates) == merge_updates(updates)
        if native is not None:
            merged_natively += 1
            assert native == merge_updates(updates)
    assert merged_natively > 0


def test_coalesce_defers_rich_content_to_the_python_merge(codec, jax_codec):
    a, b = Doc(), Doc()
    a.get_text("t").insert(0, "plain")
    b.get_map("m").set("k", {"json": [1, 2]})
    updates = [encode_state_as_update(a), encode_state_as_update(b)]
    assert codec.coalesce_updates(updates) is None
    assert jax_codec.coalesce_updates(updates) is None
    merged = coalesce_updates(updates)
    assert merged is not None and merged == merge_updates(updates)
    rebuilt = Doc()
    apply_update(rebuilt, merged)
    assert rebuilt.get_text("t").to_string() == "plain"


# -- scan_update_frontier / the redelivery fast drop --------------------------


@pytest.mark.parametrize("seed", [18, 19])
def test_scan_update_frontier_matches_jax_and_the_decoded_update(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    doc, updates = _random_text_updates(rng, 30, client_id=int(rng.integers(1, 2**32 - 2)))
    for update in updates + [encode_state_as_update(doc)]:
        frontier, ds_empty = codec.scan_update_frontier(update)
        assert (frontier, ds_empty) == jax_codec.scan_update_frontier(update)
        structs, deletes = lowering._python_decode(update)
        ends: dict = {}
        for s in structs:
            ends[s.client] = max(ends.get(s.client, 0), s.clock + s.length)
        assert dict(frontier) == ends
        assert ds_empty == (not deletes)


def test_redelivered_update_is_dropped_before_decoding():
    editor = Doc()
    updates = []
    editor.on("update", lambda update, *rest: updates.append(update))
    editor.get_text("t").insert(0, "hello")
    editor.get_text("t").insert(5, " world")
    replica = Doc()
    for update in updates:
        apply_update(replica, update)
    events = []
    replica.on("update", lambda update, *rest: events.append(update))
    assert _is_redundant_update(replica.store, updates[0])
    apply_update(replica, updates[0])  # a redelivery: no transaction at all
    assert events == []
    editor.get_text("t").delete(0, 1)  # a delete set is never redundant
    assert not _is_redundant_update(replica.store, updates[-1])
    apply_update(replica, updates[-1])
    assert replica.get_text("t").to_string() == "ello world"
    assert encode_state_vector(replica) == encode_state_vector(editor)


# -- bulk varints -------------------------------------------------------------


@pytest.mark.parametrize("seed", [20, 21])
def test_bulk_varints_match_scalar_and_jax(codec, jax_codec, seed):
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(0, 2**50, size=200)] + [0, 1, 127, 128, 2**31, 2**32 - 1]
    enc = Encoder()
    enc.write_var_uints(values)
    scalar = Encoder()
    for v in values:
        scalar.write_var_uint(v)
    assert enc.to_bytes() == scalar.to_bytes() == jax_codec.encode_var_uints(values)
    data = b"\x07" + enc.to_bytes()
    decoder = Decoder(data)
    decoder.read_var_uint()
    assert list(decoder.read_var_uints(len(values))) == values
    assert not decoder.has_content()
    assert codec.read_var_uints(data, 1, len(values)) == jax_codec.read_var_uints(
        data, 1, len(values)
    )


def test_bulk_varint_truncation_and_hostile_counts_raise_value_error():
    enc = Encoder()
    enc.write_var_uints([1, 2, 300000])
    with pytest.raises(ValueError):
        Decoder(enc.to_bytes()[:-1]).read_var_uints(3)
    with pytest.raises(ValueError):
        Decoder(b"\x01\x02\x03").read_var_uints(2**50)


# -- envelopes (copied whole with the module) ---------------------------------


def test_envelope_decoders_match_jax(codec, jax_codec):
    raws = []
    for kind, session, aux, payload in (
        (1, "sess-1", "", b"payload-a"),
        (1, "sess-1", "aux", b"payload-b"),
        (3, "sess-2", "1000:bye", b""),
    ):
        enc = Encoder()
        enc.write_var_uint(kind)
        enc.write_var_string(session)
        enc.write_var_string(aux)
        enc.write_var_uint8_array(payload)
        raws.append(enc.to_bytes())
    for raw in raws:
        assert codec.parse_envelope(raw) == jax_codec.parse_envelope(raw)
    batch = raws + [b"\x80\x80", b""]
    assert codec.parse_envelopes_batch(batch, True) == jax_codec.parse_envelopes_batch(batch, True)
    with pytest.raises(ValueError):
        codec.parse_envelopes_batch(batch, False)


# -- window struct sections ---------------------------------------------------


def _python_struct_section(serving, doc, sm):
    items_by_client = serving._group_items(doc, doc.serve_log, sm)
    encoder = Encoder()
    encoder.write_var_uint(len(items_by_client))
    for client in sorted(items_by_client, reverse=True):
        _write_structs(encoder, items_by_client[client], client, sm[client])
    return encoder.to_bytes()


@pytest.mark.parametrize("arena", ["unit", "rle"])
@pytest.mark.parametrize("seed", [22, 23])
def test_encode_text_window_matches_items_path_and_jax(
    codec, jax_codec, monkeypatch, arena, seed
):
    """encode_text_window through PlaneServing._encode_window_native is
    byte-identical to the Python Item encoder across per-client cutoffs,
    surrogate pairs and deleted runs included; the JAX module emits the
    same bytes for the same groups."""
    import hocuspocus_tpu_torch.tpu.serving as serving_mod

    rng = np.random.default_rng(seed)
    plane = MergePlane(num_docs=4, capacity=2048, device="cpu", arena=arena)
    serving = PlaneServing(plane)
    _, a_updates = _random_text_updates(rng, 25, client_id=7)
    b = Doc()
    b.client_id = 0x9000001
    for update in a_updates:
        apply_update(b, update)
    b_updates = []
    b.on("update", lambda update, *rest: b_updates.append(update))
    b.get_text("t").insert(1, "B\U0001f680B")
    b.get_text("t").delete(0, 2)
    for update in a_updates + b_updates:
        plane.enqueue_update("d", update)
    plane.flush()
    doc = plane.docs["d"]

    class Recorder:
        groups = None

        def encode_text_window(self, groups):
            Recorder.groups = groups
            return codec.encode_text_window(groups)

    monkeypatch.setattr(serving_mod, "get_codec", Recorder)
    known = dict(doc.lowerer.known)
    for cut_a in range(0, known[7] + 1, 3):
        for cut_b in range(0, known[0x9000001] + 1, 2):
            sm = {7: cut_a, 0x9000001: cut_b}
            body = serving._encode_window_native(doc, doc.serve_log, dict(sm))
            assert body is not None
            assert body == _python_struct_section(serving, doc, dict(sm)), sm
            assert body == jax_codec.encode_text_window(Recorder.groups)
