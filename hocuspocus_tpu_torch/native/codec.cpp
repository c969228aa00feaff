// Native update codec for hocuspocus_tpu_torch.
//
// C++ implementation of the Yjs v1 update *decode* hot path (lib0
// varints, struct sections, delete sets) feeding the merge plane's
// host-side lowering. Replaces the reference's lib0/yjs JavaScript
// decode layer; the pure-Python decoder in hocuspocus_tpu_torch.crdt
// remains the correctness reference.
//
// Exposes:
//   decode_update(bytes) -> (structs, deletes)
//     structs: list of (client, clock, kind, origin_client, origin_clock,
//              right_client, right_clock, payload)
//              kind 0 = string run (payload: str)
//                   1 = deleted run (payload: length int)
//                   2 = GC run (payload: length int)
//                   3 = Skip run (payload: length int)
//                   4 = other content (payload: length int) — caller
//                       falls back to the Python path for this doc
//     deletes: list of (client, clock, length)
//   utf16_len(str) -> int      (JS string .length semantics)
//
// Wire-frame hot path (reference IncomingMessage/OutgoingMessage,
// `packages/server/src/OutgoingMessage.ts:24-28` frame layout
// [varString documentName][varUint msgType][payload]):
//   parse_frame_header(bytes) -> (document_name, msg_type, offset)
//     one call replacing the per-message Python varint reads used for
//     routing (ClientConnection.messageHandler) and dispatch
//   build_update_frame(name, update, reply) -> bytes
//     the broadcast frame [name][Sync|SyncReply][yjsUpdate][update] —
//     built once per document update (Document.handleUpdate fan-out)
//   build_sync_status_frame(name, ok) -> bytes
//     the per-update durability ack [name][SyncStatus][0|1]
//
// Batched wire path (one Python->C++ call per drain batch, GIL released
// during the pure-byte passes — protocol/frames.py entry points):
//   parse_frame_headers_batch(frames, skip_malformed=False)
//     -> list[(name, type, offset)] (or None slots in skip mode);
//     repeated document names within a batch share ONE str object
//   build_update_frames_batch(items) -> list[bytes]
//     items: (name, update[, reply]) triples, frames built in one pass
//   coalesce_updates(updates) -> bytes | None
//     docless merge of N Y-updates at the BYTE level: struct spans are
//     copied verbatim when that is provably identical to the Python
//     merge_updates re-encode (canonical varints, strict UTF-8, content
//     refs in {GC, Deleted, Binary, String, Skip}, no overlapping runs
//     needing an offset split); returns None when it cannot guarantee
//     byte identity and the caller falls back to the Python merge
//   scan_update_frontier(update) -> (list[(client, end_clock)], ds_empty)
//     per-client clock frontier of an update without building structs —
//     powers the idempotent-redelivery fast-drop in crdt/update.py
//   parse_envelope(bytes) / parse_envelopes_batch(raws, skip_malformed)
//     edge relay envelope [kind][session][aux][payload] decode
//   read_var_uints(data, pos, count) -> (tuple, new_pos)
//   encode_var_uints(seq) -> bytes
//     bulk varint helpers for crdt/encoding.py hot loops
//
// Build: g++ -O2 -shared -fPIC, together with text_lane.cpp, into the
// module _hocuspocus_torch_codec (native/__init__.py); no external deps.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Reader {
    const uint8_t* buf;
    Py_ssize_t len;
    Py_ssize_t pos = 0;
    // Set when any varint read so far was non-minimal (e.g. 0x80 0x00).
    // A re-encode of such input would shrink it, so byte-verbatim span
    // copies (coalesce_updates) are only safe while this stays false.
    bool noncanonical = false;

    bool eof() const { return pos >= len; }

    uint8_t u8() {
        if (pos >= len) throw std::runtime_error("unexpected end of buffer");
        return buf[pos++];
    }

    uint64_t var_uint() {
        uint64_t num = 0;
        int shift = 0;
        uint8_t last = 0;
        while (true) {
            uint8_t b = u8();
            last = b;
            num |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (b < 0x80) break;
            shift += 7;
            if (shift > 63) throw std::runtime_error("varint too long");
        }
        // minimal encoding never ends with a zero continuation group
        if (shift > 0 && last == 0) noncanonical = true;
        return num;
    }

    // Validate an untrusted varuint length against the remaining bytes
    // BEFORE any signed cast: a length near 2^64 cast to Py_ssize_t
    // goes negative and would slip past a `pos + n > len` check,
    // turning a 10-byte pre-auth frame into an out-of-bounds read.
    Py_ssize_t checked_len(uint64_t n) {
        if (n > static_cast<uint64_t>(len - pos))
            throw std::runtime_error("length prefix exceeds buffer");
        return static_cast<Py_ssize_t>(n);
    }

    void skip(Py_ssize_t n) {
        if (n < 0 || pos + n > len)
            throw std::runtime_error("unexpected end of buffer");
        pos += n;
    }

    const char* bytes(Py_ssize_t n) {
        if (n < 0 || pos + n > len)
            throw std::runtime_error("unexpected end of buffer");
        const char* p = reinterpret_cast<const char*>(buf + pos);
        pos += n;
        return p;
    }

    // lib0 readVarString: utf-8 bytes with varuint length prefix
    std::pair<const char*, Py_ssize_t> var_string() {
        Py_ssize_t n = checked_len(var_uint());
        return {bytes(n), n};
    }

    void skip_var_string() { skip(checked_len(var_uint())); }

    void skip_var_bytes() { skip(checked_len(var_uint())); }

    // lib0 readAny (tags 116-127) — value discarded, cursor advanced
    void skip_any() {
        uint8_t tag = u8();
        switch (tag) {
            case 127:  // undefined
            case 126:  // null
            case 121:  // false
            case 120:  // true
                return;
            case 125: {  // varint
                uint8_t b = u8();
                while (b & 0x80) b = u8();
                return;
            }
            case 124: skip(4); return;  // float32
            case 123: skip(8); return;  // float64
            case 122: skip(8); return;  // bigint64
            case 119: skip_var_string(); return;
            case 118: {  // object
                uint64_t n = var_uint();
                for (uint64_t i = 0; i < n; i++) {
                    skip_var_string();
                    skip_any();
                }
                return;
            }
            case 117: {  // array
                uint64_t n = var_uint();
                for (uint64_t i = 0; i < n; i++) skip_any();
                return;
            }
            case 116: skip_var_bytes(); return;
            default:
                throw std::runtime_error("unknown Any tag");
        }
    }
};

constexpr uint8_t BIT_ORIGIN = 0x80;
constexpr uint8_t BIT_RIGHT_ORIGIN = 0x40;
constexpr uint8_t BIT_PARENT_SUB = 0x20;
constexpr int64_t NONE_CLIENT = 0xFFFFFFFFll;

// UTF-16 code-unit count of a UTF-8 byte range (JS string length).
Py_ssize_t utf8_to_utf16_len(const char* s, Py_ssize_t n) {
    Py_ssize_t units = 0;
    for (Py_ssize_t i = 0; i < n;) {
        uint8_t c = static_cast<uint8_t>(s[i]);
        if (c < 0x80) { i += 1; units += 1; }
        else if (c < 0xE0) { i += 2; units += 1; }
        else if (c < 0xF0) { i += 3; units += 1; }
        else { i += 4; units += 2; }  // astral -> surrogate pair
    }
    return units;
}

PyObject* decode_update(PyObject* /*self*/, PyObject* arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
    Reader r{static_cast<const uint8_t*>(view.buf), view.len};

    PyObject* structs = PyList_New(0);
    PyObject* deletes = PyList_New(0);
    if (!structs || !deletes) {
        PyBuffer_Release(&view);
        Py_XDECREF(structs);
        Py_XDECREF(deletes);
        return nullptr;
    }

    try {
        uint64_t num_clients = r.var_uint();
        for (uint64_t ci = 0; ci < num_clients; ci++) {
            uint64_t num_structs = r.var_uint();
            int64_t client = static_cast<int64_t>(r.var_uint());
            int64_t clock = static_cast<int64_t>(r.var_uint());
            for (uint64_t si = 0; si < num_structs; si++) {
                uint8_t info = r.u8();
                uint8_t ref = info & 0x1F;
                int64_t kind;
                int64_t origin_client = NONE_CLIENT, origin_clock = 0;
                int64_t right_client = NONE_CLIENT, right_clock = 0;
                PyObject* payload = nullptr;
                int64_t length = 0;

                if (ref == 0) {  // GC
                    length = static_cast<int64_t>(r.var_uint());
                    kind = 2;
                    payload = PyLong_FromLongLong(length);
                } else if (ref == 10) {  // Skip
                    length = static_cast<int64_t>(r.var_uint());
                    kind = 3;
                    payload = PyLong_FromLongLong(length);
                } else {
                    if (info & BIT_ORIGIN) {
                        origin_client = static_cast<int64_t>(r.var_uint());
                        origin_clock = static_cast<int64_t>(r.var_uint());
                    }
                    if (info & BIT_RIGHT_ORIGIN) {
                        right_client = static_cast<int64_t>(r.var_uint());
                        right_clock = static_cast<int64_t>(r.var_uint());
                    }
                    if (!(info & (BIT_ORIGIN | BIT_RIGHT_ORIGIN))) {
                        // parent info
                        if (r.var_uint() == 1) {
                            r.skip_var_string();  // root key
                        } else {
                            r.var_uint();  // parent id client
                            r.var_uint();  // parent id clock
                        }
                        if (info & BIT_PARENT_SUB) r.skip_var_string();
                    }
                    switch (ref) {
                        case 1: {  // ContentDeleted
                            length = static_cast<int64_t>(r.var_uint());
                            kind = 1;
                            payload = PyLong_FromLongLong(length);
                            break;
                        }
                        case 4: {  // ContentString
                            auto [p, n] = r.var_string();
                            length = utf8_to_utf16_len(p, n);
                            kind = 0;
                            payload = PyUnicode_DecodeUTF8(p, n, "replace");
                            break;
                        }
                        case 2: {  // ContentJSON
                            uint64_t n = r.var_uint();
                            for (uint64_t i = 0; i < n; i++) r.skip_var_string();
                            length = static_cast<int64_t>(n);
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        }
                        case 3:  // ContentBinary
                            r.skip_var_bytes();
                            length = 1;
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        case 5:  // ContentEmbed
                            r.skip_var_string();
                            length = 1;
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        case 6:  // ContentFormat
                            r.skip_var_string();
                            r.skip_var_string();
                            length = 1;
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        case 7: {  // ContentType
                            uint64_t type_ref = r.var_uint();
                            if (type_ref == 3 || type_ref == 5) r.skip_var_string();
                            length = 1;
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        }
                        case 8: {  // ContentAny
                            uint64_t n = r.var_uint();
                            for (uint64_t i = 0; i < n; i++) r.skip_any();
                            length = static_cast<int64_t>(n);
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        }
                        case 9:  // ContentDoc
                            r.skip_var_string();
                            r.skip_any();
                            length = 1;
                            kind = 4;
                            payload = PyLong_FromLongLong(length);
                            break;
                        default:
                            throw std::runtime_error("unknown content ref");
                    }
                }
                if (!payload) throw std::runtime_error("payload alloc failed");
                PyObject* tup = Py_BuildValue(
                    "(LLLLLLLN)", client, clock, kind, origin_client, origin_clock,
                    right_client, right_clock, payload);
                if (!tup) throw std::runtime_error("tuple alloc failed");
                PyList_Append(structs, tup);
                Py_DECREF(tup);
                clock += length;
            }
        }
        // delete set
        uint64_t ds_clients = r.var_uint();
        for (uint64_t i = 0; i < ds_clients; i++) {
            int64_t client = static_cast<int64_t>(r.var_uint());
            uint64_t ranges = r.var_uint();
            for (uint64_t j = 0; j < ranges; j++) {
                int64_t clock = static_cast<int64_t>(r.var_uint());
                int64_t dlen = static_cast<int64_t>(r.var_uint());
                PyObject* tup = Py_BuildValue("(LLL)", client, clock, dlen);
                if (!tup) throw std::runtime_error("tuple alloc failed");
                PyList_Append(deletes, tup);
                Py_DECREF(tup);
            }
        }
    } catch (const std::exception& e) {
        PyBuffer_Release(&view);
        Py_DECREF(structs);
        Py_DECREF(deletes);
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }

    PyBuffer_Release(&view);
    return Py_BuildValue("(NN)", structs, deletes);
}

PyObject* utf16_len(PyObject* /*self*/, PyObject* arg) {
    Py_ssize_t n;
    const char* s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return nullptr;
    return PyLong_FromSsize_t(utf8_to_utf16_len(s, n));
}

// lib0 writeVarUint: 7-bit groups, little-endian, continuation bit 0x80
void put_var_uint(std::string& out, uint64_t num) {
    while (num > 0x7F) {
        out.push_back(static_cast<char>(0x80 | (num & 0x7F)));
        num >>= 7;
    }
    out.push_back(static_cast<char>(num));
}

void put_var_string(std::string& out, const char* s, Py_ssize_t n) {
    put_var_uint(out, static_cast<uint64_t>(n));
    out.append(s, static_cast<size_t>(n));
}

constexpr uint64_t MSG_SYNC = 0;
constexpr uint64_t MSG_SYNC_REPLY = 4;
constexpr uint64_t MSG_SYNC_STATUS = 8;
constexpr uint64_t MSG_YJS_UPDATE = 2;

PyObject* parse_frame_header(PyObject* /*self*/, PyObject* arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
    Reader r{static_cast<const uint8_t*>(view.buf), view.len};
    PyObject* result = nullptr;
    try {
        auto [p, n] = r.var_string();
        uint64_t msg_type = r.var_uint();
        // strict decode like the Python Decoder.read_var_string: both
        // paths must reject an invalid-UTF-8 name the same way
        PyObject* name = PyUnicode_DecodeUTF8(p, n, nullptr);
        if (!name) {
            PyErr_Clear();
            throw std::runtime_error("invalid utf-8 in document name");
        }
        result = Py_BuildValue("(NKn)", name, msg_type, r.pos);
    } catch (const std::exception& e) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }
    PyBuffer_Release(&view);
    return result;
}

PyObject* build_update_frame(PyObject* /*self*/, PyObject* args) {
    const char* name;
    Py_ssize_t name_len;
    Py_buffer update;
    int reply = 0;
    if (!PyArg_ParseTuple(args, "s#y*|p", &name, &name_len, &update, &reply))
        return nullptr;
    std::string out;
    out.reserve(static_cast<size_t>(name_len + update.len) + 12);
    put_var_string(out, name, name_len);
    put_var_uint(out, reply ? MSG_SYNC_REPLY : MSG_SYNC);
    put_var_uint(out, MSG_YJS_UPDATE);
    put_var_uint(out, static_cast<uint64_t>(update.len));
    out.append(static_cast<const char*>(update.buf),
               static_cast<size_t>(update.len));
    PyBuffer_Release(&update);
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

PyObject* build_sync_status_frame(PyObject* /*self*/, PyObject* args) {
    const char* name;
    Py_ssize_t name_len;
    int ok = 0;
    if (!PyArg_ParseTuple(args, "s#p", &name, &name_len, &ok)) return nullptr;
    std::string out;
    out.reserve(static_cast<size_t>(name_len) + 8);
    put_var_string(out, name, name_len);
    put_var_uint(out, MSG_SYNC_STATUS);
    put_var_uint(out, ok ? 1 : 0);
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

// Serve-path struct-section encoder (the write mirror of decode_update,
// restricted to the shapes the TPU plane serves hot: string runs and GC
// ranges). Python keeps the semantic work — cutoff trimming, first-item
// offset/origin rewrite, group ordering — and hands fully-resolved
// groups here for pure byte emission. Replaces ~15 Python-level calls
// per item in `crdt/update.py:_write_structs` / `crdt/structs.py
// Item.write` on broadcast/sync serves (reference hot path:
// `packages/server/src/MessageReceiver.ts:137-213` encode side).
//
//   encode_text_window(groups) -> bytes
//     groups: list of (client, write_clock, items), caller-ordered
//     item: (kind, origin_client, origin_clock, right_client,
//            right_clock, parent_name|None, payload)
//       kind 0: string run — payload str; negative origin client means
//               absent; when both origins absent parent_name (a root
//               type name) is written
//       kind 1: GC range — payload int length
//       kind 2: deleted run (ContentDeleted) — payload int length;
//               origins/parent rules as kind 0
constexpr uint8_t CONTENT_STRING_REF = 4;
constexpr uint8_t CONTENT_DELETED_REF = 1;
constexpr uint8_t STRUCT_GC_REF = 0;

PyObject* encode_text_window(PyObject* /*self*/, PyObject* arg) {
    PyObject* groups = PySequence_Fast(arg, "groups must be a sequence");
    if (!groups) return nullptr;
    std::string out;
    out.reserve(256);
    Py_ssize_t num_groups = PySequence_Fast_GET_SIZE(groups);
    put_var_uint(out, static_cast<uint64_t>(num_groups));
    for (Py_ssize_t g = 0; g < num_groups; ++g) {
        PyObject* group = PySequence_Fast_GET_ITEM(groups, g);
        unsigned long long client, write_clock;
        PyObject* items_obj;
        if (!PyArg_ParseTuple(group, "KKO", &client, &write_clock, &items_obj)) {
            Py_DECREF(groups);
            return nullptr;
        }
        PyObject* items = PySequence_Fast(items_obj, "items must be a sequence");
        if (!items) {
            Py_DECREF(groups);
            return nullptr;
        }
        Py_ssize_t num_items = PySequence_Fast_GET_SIZE(items);
        put_var_uint(out, static_cast<uint64_t>(num_items));
        put_var_uint(out, client);
        put_var_uint(out, write_clock);
        for (Py_ssize_t i = 0; i < num_items; ++i) {
            PyObject* item = PySequence_Fast_GET_ITEM(items, i);
            int kind;
            long long oc, ok, rc, rk;
            PyObject* parent_name;
            PyObject* payload;
            if (!PyArg_ParseTuple(item, "iLLLLOO", &kind, &oc, &ok,
                                  &rc, &rk, &parent_name, &payload)) {
                Py_DECREF(items);
                Py_DECREF(groups);
                return nullptr;
            }
            if (kind == 1) {  // GC range
                out.push_back(static_cast<char>(STRUCT_GC_REF));
                unsigned long long len = PyLong_AsUnsignedLongLong(payload);
                if (PyErr_Occurred()) {
                    Py_DECREF(items);
                    Py_DECREF(groups);
                    return nullptr;
                }
                put_var_uint(out, len);
                continue;
            }
            uint8_t info =
                (kind == 2) ? CONTENT_DELETED_REF : CONTENT_STRING_REF;
            if (oc >= 0) info |= BIT_ORIGIN;
            if (rc >= 0) info |= BIT_RIGHT_ORIGIN;
            out.push_back(static_cast<char>(info));
            if (oc >= 0) {
                put_var_uint(out, static_cast<uint64_t>(oc));
                put_var_uint(out, static_cast<uint64_t>(ok));
            }
            if (rc >= 0) {
                put_var_uint(out, static_cast<uint64_t>(rc));
                put_var_uint(out, static_cast<uint64_t>(rk));
            }
            if (oc < 0 && rc < 0) {
                // origin-less: wire parent is a root type name
                Py_ssize_t n;
                const char* s = PyUnicode_AsUTF8AndSize(parent_name, &n);
                if (!s) {
                    Py_DECREF(items);
                    Py_DECREF(groups);
                    return nullptr;
                }
                put_var_uint(out, 1);
                put_var_string(out, s, n);
            }
            if (kind == 2) {  // deleted run: just its length
                unsigned long long len = PyLong_AsUnsignedLongLong(payload);
                if (PyErr_Occurred()) {
                    Py_DECREF(items);
                    Py_DECREF(groups);
                    return nullptr;
                }
                put_var_uint(out, len);
            } else {
                Py_ssize_t n;
                const char* s = PyUnicode_AsUTF8AndSize(payload, &n);
                if (!s) {
                    Py_DECREF(items);
                    Py_DECREF(groups);
                    return nullptr;
                }
                put_var_string(out, s, n);
            }
        }
        Py_DECREF(items);
    }
    Py_DECREF(groups);
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

// ---------------------------------------------------------------------------
// Batched wire path. Everything below runs its pure-byte passes
// with the GIL released; Python objects are only touched in the collect /
// materialize phases at the edges of each call.
// ---------------------------------------------------------------------------

// CPython-strict UTF-8 validity (rejects overlongs, surrogates, >U+10FFFF).
// Used to prove a byte span can be copied verbatim: Python's merge path
// round-trips strings through strict decode/encode, which either raises
// (invalid) or reproduces the exact bytes (valid + canonical varints).
bool utf8_valid_strict(const uint8_t* s, Py_ssize_t n) {
    Py_ssize_t i = 0;
    while (i < n) {
        uint8_t c = s[i];
        if (c < 0x80) { i += 1; continue; }
        if (c < 0xC2) return false;  // continuation or overlong lead
        if (c < 0xE0) {
            if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return false;
            i += 2; continue;
        }
        if (c < 0xF0) {
            if (i + 2 >= n) return false;
            uint8_t c1 = s[i + 1], c2 = s[i + 2];
            if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80) return false;
            if (c == 0xE0 && c1 < 0xA0) return false;   // overlong
            if (c == 0xED && c1 >= 0xA0) return false;  // surrogate
            i += 3; continue;
        }
        if (c < 0xF5) {
            if (i + 3 >= n) return false;
            uint8_t c1 = s[i + 1], c2 = s[i + 2], c3 = s[i + 3];
            if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80 ||
                (c3 & 0xC0) != 0x80) return false;
            if (c == 0xF0 && c1 < 0x90) return false;   // overlong
            if (c == 0xF4 && c1 >= 0x90) return false;  // > U+10FFFF
            i += 4; continue;
        }
        return false;
    }
    return true;
}

// One struct's byte span inside a source update, plus the clock geometry
// the merge planner needs. `src` indexes the input update buffer.
struct SpanRec {
    Py_ssize_t start = 0;
    Py_ssize_t end = 0;
    uint64_t clock = 0;
    uint64_t length = 0;
    bool is_skip = false;
    int src = 0;
};

struct ClientSpans {
    uint64_t client = 0;
    std::vector<SpanRec> spans;
};

struct DeleteRange {
    uint64_t client = 0, clock = 0, length = 0;
};

// Walk one update's struct sections recording byte spans. Mirrors the
// cursor discipline of decode_update exactly. When `verbatim` is set it
// additionally proves every span re-encodes to itself under the Python
// merge (strict UTF-8 strings, canonical varints, content refs whose
// write mirror is byte-stable, no parent-sub-with-origins shapes) and
// throws std::runtime_error("not verbatim-safe") as soon as the proof
// fails — callers catch and fall back to the Python path.
void scan_update_spans(Reader& r, int src, bool verbatim,
                       std::vector<ClientSpans>& out,
                       std::vector<DeleteRange>& deletes) {
    auto bail = []() -> void {
        throw std::runtime_error("not verbatim-safe");
    };
    uint64_t num_clients = r.var_uint();
    for (uint64_t ci = 0; ci < num_clients; ci++) {
        uint64_t num_structs = r.var_uint();
        uint64_t client = r.var_uint();
        uint64_t clock = r.var_uint();
        ClientSpans* cs = nullptr;
        for (auto& existing : out) {
            if (existing.client == client) { cs = &existing; break; }
        }
        if (!cs) {
            out.push_back(ClientSpans{client, {}});
            cs = &out.back();
        }
        for (uint64_t si = 0; si < num_structs; si++) {
            SpanRec rec;
            rec.src = src;
            rec.start = r.pos;
            rec.clock = clock;
            uint8_t info = r.u8();
            uint8_t ref = info & 0x1F;
            if (ref == 0 || ref == 10) {  // GC / Skip
                rec.length = r.var_uint();
                rec.is_skip = (ref == 10);
                // read_struct ignores high info bits on GC/Skip but the
                // write mirror emits a bare ref byte — a decorated info
                // byte would not round-trip verbatim
                if (verbatim && info != ref) bail();
            } else {
                if (verbatim && (info & BIT_PARENT_SUB) &&
                    (info & (BIT_ORIGIN | BIT_RIGHT_ORIGIN))) {
                    // Item.write re-derives parent_sub presence from the
                    // parent field, which is only populated when both
                    // origins are absent — this shape does not round-trip
                    bail();
                }
                if (info & BIT_ORIGIN) { r.var_uint(); r.var_uint(); }
                if (info & BIT_RIGHT_ORIGIN) { r.var_uint(); r.var_uint(); }
                if (!(info & (BIT_ORIGIN | BIT_RIGHT_ORIGIN))) {
                    if (r.var_uint() == 1) {
                        auto [p, n] = r.var_string();
                        if (verbatim &&
                            !utf8_valid_strict(
                                reinterpret_cast<const uint8_t*>(p), n))
                            bail();
                    } else {
                        r.var_uint();
                        r.var_uint();
                    }
                    if (info & BIT_PARENT_SUB) {
                        auto [p, n] = r.var_string();
                        if (verbatim &&
                            !utf8_valid_strict(
                                reinterpret_cast<const uint8_t*>(p), n))
                            bail();
                    }
                }
                switch (ref) {
                    case 1:  // ContentDeleted
                        rec.length = r.var_uint();
                        break;
                    case 4: {  // ContentString
                        auto [p, n] = r.var_string();
                        if (verbatim &&
                            !utf8_valid_strict(
                                reinterpret_cast<const uint8_t*>(p), n))
                            bail();
                        rec.length = static_cast<uint64_t>(
                            utf8_to_utf16_len(p, n));
                        break;
                    }
                    case 2: {  // ContentJSON — json round-trip not stable
                        if (verbatim) bail();
                        uint64_t n = r.var_uint();
                        for (uint64_t i = 0; i < n; i++) r.skip_var_string();
                        rec.length = n;
                        break;
                    }
                    case 3:  // ContentBinary — bytes round-trip verbatim
                        r.skip_var_bytes();
                        rec.length = 1;
                        break;
                    case 5:  // ContentEmbed
                        if (verbatim) bail();
                        r.skip_var_string();
                        rec.length = 1;
                        break;
                    case 6:  // ContentFormat
                        if (verbatim) bail();
                        r.skip_var_string();
                        r.skip_var_string();
                        rec.length = 1;
                        break;
                    case 7: {  // ContentType
                        if (verbatim) bail();
                        uint64_t type_ref = r.var_uint();
                        if (type_ref == 3 || type_ref == 5)
                            r.skip_var_string();
                        rec.length = 1;
                        break;
                    }
                    case 8: {  // ContentAny
                        if (verbatim) bail();
                        uint64_t n = r.var_uint();
                        for (uint64_t i = 0; i < n; i++) r.skip_any();
                        rec.length = n;
                        break;
                    }
                    case 9:  // ContentDoc
                        if (verbatim) bail();
                        r.skip_var_string();
                        r.skip_any();
                        rec.length = 1;
                        break;
                    default:
                        throw std::runtime_error("unknown content ref");
                }
                if (verbatim && rec.length == 0) bail();  // degenerate run
            }
            rec.end = r.pos;
            clock += rec.length;
            cs->spans.push_back(rec);
        }
    }
    uint64_t ds_clients = r.var_uint();
    for (uint64_t i = 0; i < ds_clients; i++) {
        uint64_t client = r.var_uint();
        uint64_t ranges = r.var_uint();
        for (uint64_t j = 0; j < ranges; j++) {
            uint64_t dclock = r.var_uint();
            uint64_t dlen = r.var_uint();
            deletes.push_back(DeleteRange{client, dclock, dlen});
        }
    }
    if (r.pos != r.len) throw std::runtime_error("trailing bytes in update");
    if (verbatim && r.noncanonical) bail();
}

// coalesce_updates(updates) -> merged bytes, or None to signal "fall back
// to the Python merge". Byte-identical to crdt/update.py merge_updates for
// every input it accepts; bails (None) whenever identity is not provable.
PyObject* coalesce_updates_native(PyObject* /*self*/, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "updates must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n == 0) {
        Py_DECREF(seq);
        return PyBytes_FromStringAndSize("\x00\x00", 2);
    }
    if (n == 1) {
        PyObject* only = PySequence_Fast_GET_ITEM(seq, 0);
        Py_INCREF(only);
        Py_DECREF(seq);
        return only;
    }
    std::vector<Py_buffer> views(static_cast<size_t>(n));
    for (Py_ssize_t i = 0; i < n; i++) {
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, i), &views[i],
                               PyBUF_SIMPLE) != 0) {
            PyErr_Clear();
            for (Py_ssize_t j = 0; j < i; j++) PyBuffer_Release(&views[j]);
            Py_DECREF(seq);
            Py_RETURN_NONE;  // non-buffer input: let Python decide
        }
    }

    bool failed = false;
    std::string out;
    Py_BEGIN_ALLOW_THREADS
    try {
        std::vector<ClientSpans> clients;
        std::vector<DeleteRange> deletes;
        for (Py_ssize_t i = 0; i < n; i++) {
            Reader r{static_cast<const uint8_t*>(views[i].buf), views[i].len};
            scan_update_spans(r, static_cast<int>(i), /*verbatim=*/true,
                              clients, deletes);
        }
        // Per client: stable sort by clock (mirrors Python's
        // sort(key=clock) on the concatenated per-update span lists),
        // then plan the emission — verbatim span copies with synthetic
        // Skips bridging gaps, duplicates dropped, overlaps (which the
        // Python path resolves with an offset re-encode) rejected.
        struct EmitEntry {
            bool synth_skip;
            uint64_t clock;
            uint64_t skip_len;
            const SpanRec* span;
        };
        struct ClientPlan {
            uint64_t client;
            std::vector<EmitEntry> entries;
        };
        std::vector<ClientPlan> plans;
        for (auto& cs : clients) {
            std::stable_sort(cs.spans.begin(), cs.spans.end(),
                             [](const SpanRec& a, const SpanRec& b) {
                                 return a.clock < b.clock;
                             });
            ClientPlan plan{cs.client, {}};
            uint64_t cur = cs.spans.front().clock;
            for (const auto& s : cs.spans) {
                if (s.is_skip) continue;
                uint64_t end = s.clock + s.length;
                if (end <= cur) continue;  // fully covered duplicate
                if (s.clock > cur) {
                    plan.entries.push_back(
                        EmitEntry{true, cur, s.clock - cur, nullptr});
                    cur = s.clock;
                }
                if (s.clock < cur)  // partial overlap: needs offset split
                    throw std::runtime_error("overlapping struct runs");
                plan.entries.push_back(EmitEntry{false, s.clock, 0, &s});
                cur = end;
            }
            // Python pops trailing Skips (all synthetic at this point)
            while (!plan.entries.empty() && plan.entries.back().synth_skip)
                plan.entries.pop_back();
            if (!plan.entries.empty()) plans.push_back(std::move(plan));
        }
        std::sort(plans.begin(), plans.end(),
                  [](const ClientPlan& a, const ClientPlan& b) {
                      return a.client > b.client;  // DESC like Python
                  });
        out.reserve(256);
        put_var_uint(out, static_cast<uint64_t>(plans.size()));
        for (const auto& plan : plans) {
            put_var_uint(out, static_cast<uint64_t>(plan.entries.size()));
            put_var_uint(out, plan.client);
            put_var_uint(out, plan.entries.front().clock);
            for (const auto& e : plan.entries) {
                if (e.synth_skip) {
                    out.push_back(static_cast<char>(10));  // Skip info byte
                    put_var_uint(out, e.skip_len);
                } else {
                    const Py_buffer& v = views[e.span->src];
                    out.append(
                        static_cast<const char*>(v.buf) + e.span->start,
                        static_cast<size_t>(e.span->end - e.span->start));
                }
            }
        }
        // Merged delete set: union ranges per client, sort, coalesce —
        // mirrors delete_set.py merge_delete_sets + sort_and_merge.
        std::unordered_map<uint64_t,
                           std::vector<std::pair<uint64_t, uint64_t>>> ds;
        for (const auto& d : deletes)
            ds[d.client].emplace_back(d.clock, d.length);
        std::vector<uint64_t> ds_clients;
        ds_clients.reserve(ds.size());
        for (auto& kv : ds) ds_clients.push_back(kv.first);
        std::sort(ds_clients.begin(), ds_clients.end(),
                  std::greater<uint64_t>());
        put_var_uint(out, static_cast<uint64_t>(ds_clients.size()));
        for (uint64_t client : ds_clients) {
            auto& ranges = ds[client];
            std::sort(ranges.begin(), ranges.end());
            std::vector<std::pair<uint64_t, uint64_t>> merged;
            for (const auto& [clock, length] : ranges) {
                if (!merged.empty() &&
                    merged.back().first + merged.back().second >= clock) {
                    auto& prev = merged.back();
                    prev.second =
                        std::max(prev.second, clock + length - prev.first);
                } else {
                    merged.emplace_back(clock, length);
                }
            }
            put_var_uint(out, client);
            put_var_uint(out, static_cast<uint64_t>(merged.size()));
            for (const auto& [clock, length] : merged) {
                put_var_uint(out, clock);
                put_var_uint(out, length);
            }
        }
    } catch (...) {
        failed = true;
    }
    Py_END_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) PyBuffer_Release(&views[i]);
    Py_DECREF(seq);
    if (failed) Py_RETURN_NONE;
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

// scan_update_frontier(update) -> ([(client, end_clock), ...], ds_empty)
// end_clock is the highest clock+length over the update's non-Skip structs
// per client; ds_empty is True when the delete set carries no ranges.
// Powers the idempotent-redelivery fast-drop: if every (client, end) is
// <= the local StructStore state and the delete set is empty, applying
// the update is a no-op and the Python decoder can be skipped entirely.
PyObject* scan_update_frontier(PyObject* /*self*/, PyObject* arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
    bool failed = false;
    bool has_deletes = false;
    std::vector<std::pair<uint64_t, uint64_t>> frontier;
    Py_BEGIN_ALLOW_THREADS
    try {
        std::vector<ClientSpans> clients;
        std::vector<DeleteRange> deletes;
        Reader r{static_cast<const uint8_t*>(view.buf), view.len};
        scan_update_spans(r, 0, /*verbatim=*/false, clients, deletes);
        has_deletes = !deletes.empty();
        for (const auto& cs : clients) {
            uint64_t end = 0;
            bool any = false;
            for (const auto& s : cs.spans) {
                if (s.is_skip) continue;
                any = true;
                end = std::max(end, s.clock + s.length);
            }
            if (any) frontier.emplace_back(cs.client, end);
        }
    } catch (...) {
        failed = true;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (failed) {
        PyErr_SetString(PyExc_ValueError, "malformed update");
        return nullptr;
    }
    PyObject* list = PyList_New(static_cast<Py_ssize_t>(frontier.size()));
    if (!list) return nullptr;
    for (size_t i = 0; i < frontier.size(); i++) {
        PyObject* tup = Py_BuildValue("(KK)", frontier[i].first,
                                      frontier[i].second);
        if (!tup) {
            Py_DECREF(list);
            return nullptr;
        }
        PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), tup);
    }
    return Py_BuildValue("(NO)", list, has_deletes ? Py_False : Py_True);
}

// parse_frame_headers_batch(frames, skip_malformed=False)
//   -> list[(name, type, offset) | None]
// One call per drain batch. The byte scan runs without the GIL; document
// names are materialized afterwards with run-length dedup (consecutive
// frames for the same doc share ONE str object — the common case for an
// inbox drain). skip_malformed=True yields None slots instead of raising
// (replication inboxes drop bad frames; client paths keep strict parity).
PyObject* parse_frame_headers_batch(PyObject* /*self*/, PyObject* args) {
    PyObject* frames_obj;
    int skip_malformed = 0;
    if (!PyArg_ParseTuple(args, "O|p", &frames_obj, &skip_malformed))
        return nullptr;
    PyObject* seq = PySequence_Fast(frames_obj, "frames must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::vector<Py_buffer> views(static_cast<size_t>(n));
    std::vector<char> have(static_cast<size_t>(n), 0);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, i), &views[i],
                               PyBUF_SIMPLE) == 0) {
            have[i] = 1;
        } else if (skip_malformed) {
            PyErr_Clear();
        } else {
            for (Py_ssize_t j = 0; j < i; j++)
                if (have[j]) PyBuffer_Release(&views[j]);
            Py_DECREF(seq);
            return nullptr;
        }
    }
    struct Hdr {
        Py_ssize_t name_off = 0, name_len = 0;
        uint64_t type = 0;
        Py_ssize_t payload_off = 0;
        bool ok = false;
    };
    std::vector<Hdr> hdrs(static_cast<size_t>(n));
    Py_ssize_t first_bad = -1;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!have[i]) {
            if (first_bad < 0) first_bad = i;
            continue;
        }
        Reader r{static_cast<const uint8_t*>(views[i].buf), views[i].len};
        try {
            Py_ssize_t nl = r.checked_len(r.var_uint());
            hdrs[i].name_off = r.pos;
            hdrs[i].name_len = nl;
            r.skip(nl);
            hdrs[i].type = r.var_uint();
            hdrs[i].payload_off = r.pos;
            hdrs[i].ok = true;
        } catch (...) {
            if (first_bad < 0) first_bad = i;
        }
    }
    Py_END_ALLOW_THREADS

    PyObject* result = nullptr;
    PyObject* prev_name = nullptr;
    const char* prev_ptr = nullptr;
    Py_ssize_t prev_len = -1;
    if (!skip_malformed && first_bad >= 0) {
        PyErr_Format(PyExc_ValueError, "malformed frame header at index %zd",
                     first_bad);
        goto cleanup;
    }
    result = PyList_New(n);
    if (!result) goto cleanup;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!hdrs[i].ok) {
            Py_INCREF(Py_None);
            PyList_SET_ITEM(result, i, Py_None);
            continue;
        }
        const char* p =
            static_cast<const char*>(views[i].buf) + hdrs[i].name_off;
        Py_ssize_t nl = hdrs[i].name_len;
        PyObject* name;
        if (prev_name && nl == prev_len && std::memcmp(p, prev_ptr, nl) == 0) {
            name = prev_name;
            Py_INCREF(name);
        } else {
            name = PyUnicode_DecodeUTF8(p, nl, nullptr);
            if (!name) {
                PyErr_Clear();
                if (skip_malformed) {
                    Py_INCREF(Py_None);
                    PyList_SET_ITEM(result, i, Py_None);
                    continue;
                }
                Py_DECREF(result);
                result = nullptr;
                PyErr_SetString(PyExc_ValueError,
                                "invalid utf-8 in document name");
                goto cleanup;
            }
            Py_XDECREF(prev_name);
            prev_name = name;
            Py_INCREF(prev_name);
            prev_ptr = p;
            prev_len = nl;
        }
        PyObject* tup = Py_BuildValue("(NKn)", name, hdrs[i].type,
                                      hdrs[i].payload_off);
        if (!tup) {
            Py_DECREF(result);
            result = nullptr;
            goto cleanup;
        }
        PyList_SET_ITEM(result, i, tup);
    }
cleanup:
    Py_XDECREF(prev_name);
    for (Py_ssize_t i = 0; i < n; i++)
        if (have[i]) PyBuffer_Release(&views[i]);
    Py_DECREF(seq);
    return result;
}

// build_update_frames_batch(items) -> list[bytes]
//   items: (name, update) or (name, update, reply) tuples.
// All frames are laid out in one arena with the GIL released, then cut
// into per-frame bytes objects (each recipient list owns its frame).
PyObject* build_update_frames_batch(PyObject* /*self*/, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "items must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    struct Item {
        const char* name;
        Py_ssize_t name_len;
        Py_buffer update;
        int reply;
    };
    std::vector<Item> items(static_cast<size_t>(n));
    Py_ssize_t acquired = 0;
    for (; acquired < n; acquired++) {
        PyObject* it = PySequence_Fast_GET_ITEM(seq, acquired);
        Item& slot = items[acquired];
        slot.reply = 0;
        PyObject* reply_obj = nullptr;
        PyObject* name_obj;
        PyObject* update_obj;
        if (!PyArg_ParseTuple(it, "UO|O", &name_obj, &update_obj,
                              &reply_obj))
            break;
        slot.name = PyUnicode_AsUTF8AndSize(name_obj, &slot.name_len);
        if (!slot.name) break;
        if (reply_obj) {
            slot.reply = PyObject_IsTrue(reply_obj);
            if (slot.reply < 0) break;
        }
        if (PyObject_GetBuffer(update_obj, &slot.update, PyBUF_SIMPLE) != 0)
            break;
    }
    if (acquired < n) {
        for (Py_ssize_t j = 0; j < acquired; j++)
            PyBuffer_Release(&items[j].update);
        Py_DECREF(seq);
        return nullptr;
    }
    std::string arena;
    std::vector<std::pair<size_t, size_t>> cuts(static_cast<size_t>(n));
    Py_BEGIN_ALLOW_THREADS
    {
        size_t total = 0;
        for (const auto& it : items)
            total += static_cast<size_t>(it.name_len + it.update.len) + 12;
        arena.reserve(total);
        for (Py_ssize_t i = 0; i < n; i++) {
            const Item& it = items[i];
            size_t start = arena.size();
            put_var_string(arena, it.name, it.name_len);
            put_var_uint(arena, it.reply ? MSG_SYNC_REPLY : MSG_SYNC);
            put_var_uint(arena, MSG_YJS_UPDATE);
            put_var_uint(arena, static_cast<uint64_t>(it.update.len));
            arena.append(static_cast<const char*>(it.update.buf),
                         static_cast<size_t>(it.update.len));
            cuts[i] = {start, arena.size() - start};
        }
    }
    Py_END_ALLOW_THREADS
    for (Py_ssize_t j = 0; j < n; j++) PyBuffer_Release(&items[j].update);
    Py_DECREF(seq);
    PyObject* result = PyList_New(n);
    if (!result) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* frame = PyBytes_FromStringAndSize(
            arena.data() + cuts[i].first,
            static_cast<Py_ssize_t>(cuts[i].second));
        if (!frame) {
            Py_DECREF(result);
            return nullptr;
        }
        PyList_SET_ITEM(result, i, frame);
    }
    return result;
}

// Relay envelope [varUint kind][varString session][varString aux]
// [varUint8Array payload] — mirrors edge/relay.py decode_envelope.
// `prev_session`/`prev_bytes` form a one-slot dedup window: consecutive
// envelopes for the same session reuse ONE str object (prev_bytes owns a
// copy of the session bytes so the window survives buffer release).
PyObject* parse_one_envelope(Py_buffer* view, PyObject** prev_session,
                             std::string* prev_bytes) {
    Reader r{static_cast<const uint8_t*>(view->buf), view->len};
    uint64_t kind;
    const char *sp, *ap, *pp;
    Py_ssize_t sn, an, pn;
    try {
        kind = r.var_uint();
        std::tie(sp, sn) = r.var_string();
        std::tie(ap, an) = r.var_string();
        Py_ssize_t plen = r.checked_len(r.var_uint());
        pp = r.bytes(plen);
        pn = plen;
    } catch (const std::exception& e) {
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }
    PyObject* session;
    if (*prev_session &&
        sn == static_cast<Py_ssize_t>(prev_bytes->size()) &&
        std::memcmp(sp, prev_bytes->data(), static_cast<size_t>(sn)) == 0) {
        session = *prev_session;
        Py_INCREF(session);
    } else {
        session = PyUnicode_DecodeUTF8(sp, sn, nullptr);
        if (!session) {
            PyErr_Clear();
            PyErr_SetString(PyExc_ValueError,
                            "invalid utf-8 in envelope session");
            return nullptr;
        }
        Py_XDECREF(*prev_session);
        *prev_session = session;
        Py_INCREF(session);
        prev_bytes->assign(sp, static_cast<size_t>(sn));
    }
    PyObject* aux = PyUnicode_DecodeUTF8(ap, an, nullptr);
    if (!aux) {
        PyErr_Clear();
        Py_DECREF(session);
        PyErr_SetString(PyExc_ValueError, "invalid utf-8 in envelope aux");
        return nullptr;
    }
    return Py_BuildValue("(KNNy#)", kind, session, aux, pp, pn);
}

PyObject* parse_envelope(PyObject* /*self*/, PyObject* arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
    PyObject* prev = nullptr;
    std::string prev_bytes;
    PyObject* result = parse_one_envelope(&view, &prev, &prev_bytes);
    Py_XDECREF(prev);
    PyBuffer_Release(&view);
    return result;
}

// parse_envelopes_batch(raws, skip_malformed=False)
//   -> list[(kind, session, aux, payload) | None]
// Consecutive envelopes for the same session share ONE str object.
PyObject* parse_envelopes_batch(PyObject* /*self*/, PyObject* args) {
    PyObject* raws_obj;
    int skip_malformed = 0;
    if (!PyArg_ParseTuple(args, "O|p", &raws_obj, &skip_malformed))
        return nullptr;
    PyObject* seq = PySequence_Fast(raws_obj, "raws must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* result = PyList_New(n);
    if (!result) {
        Py_DECREF(seq);
        return nullptr;
    }
    PyObject* prev = nullptr;
    std::string prev_bytes;
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_buffer view;
        PyObject* tup = nullptr;
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, i), &view,
                               PyBUF_SIMPLE) == 0) {
            tup = parse_one_envelope(&view, &prev, &prev_bytes);
            PyBuffer_Release(&view);
        }
        if (!tup) {
            if (!skip_malformed) {
                Py_XDECREF(prev);
                Py_DECREF(result);
                Py_DECREF(seq);
                return nullptr;
            }
            PyErr_Clear();
            tup = Py_None;
            Py_INCREF(tup);
        }
        PyList_SET_ITEM(result, i, tup);
    }
    Py_XDECREF(prev);
    Py_DECREF(seq);
    return result;
}

// read_var_uints(data, pos, count) -> (tuple_of_ints, new_pos)
// Bulk varint reads for crdt/encoding.py hot loops (struct runs, state
// vectors, delete-set ranges) — one call instead of `count` Python reads.
PyObject* read_var_uints(PyObject* /*self*/, PyObject* args) {
    Py_buffer view;
    Py_ssize_t pos, count;
    if (!PyArg_ParseTuple(args, "y*nn", &view, &pos, &count)) return nullptr;
    if (pos < 0 || pos > view.len || count < 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "invalid position or count");
        return nullptr;
    }
    // every varint is >= 1 byte: an untrusted count prefix larger than
    // the remaining buffer must fail BEFORE the result allocation
    if (count > view.len - pos) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "unexpected end of buffer");
        return nullptr;
    }
    std::vector<uint64_t> vals(static_cast<size_t>(count));
    Reader r{static_cast<const uint8_t*>(view.buf), view.len, pos};
    bool failed = false;
    Py_BEGIN_ALLOW_THREADS
    try {
        for (Py_ssize_t i = 0; i < count; i++) vals[i] = r.var_uint();
    } catch (...) {
        failed = true;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (failed) {
        PyErr_SetString(PyExc_ValueError, "unexpected end of buffer");
        return nullptr;
    }
    PyObject* tup = PyTuple_New(count);
    if (!tup) return nullptr;
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject* v = PyLong_FromUnsignedLongLong(vals[i]);
        if (!v) {
            Py_DECREF(tup);
            return nullptr;
        }
        PyTuple_SET_ITEM(tup, i, v);
    }
    return Py_BuildValue("(Nn)", tup, r.pos);
}

// encode_var_uints(seq) -> bytes — bulk lib0 varint writes.
PyObject* encode_var_uints(PyObject* /*self*/, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "values must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::string out;
    out.reserve(static_cast<size_t>(n) * 2);
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned long long v = PyLong_AsUnsignedLongLong(
            PySequence_Fast_GET_ITEM(seq, i));
        if (v == static_cast<unsigned long long>(-1) && PyErr_Occurred()) {
            Py_DECREF(seq);
            return nullptr;
        }
        put_var_uint(out, v);
    }
    Py_DECREF(seq);
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef methods[] = {
    {"decode_update", decode_update, METH_O,
     "Decode a Yjs v1 update into (structs, deletes) tuples."},
    {"encode_text_window", encode_text_window, METH_O,
     "Encode resolved (string|GC) struct groups into update bytes."},
    {"utf16_len", utf16_len, METH_O, "UTF-16 code unit count of a string."},
    {"parse_frame_header", parse_frame_header, METH_O,
     "Parse [varString name][varUint type] -> (name, type, offset)."},
    {"build_update_frame", build_update_frame, METH_VARARGS,
     "Build [name][Sync|SyncReply][yjsUpdate][update] broadcast frame."},
    {"build_sync_status_frame", build_sync_status_frame, METH_VARARGS,
     "Build [name][SyncStatus][0|1] durability ack frame."},
    {"parse_frame_headers_batch", parse_frame_headers_batch, METH_VARARGS,
     "Parse N frame headers in one call -> list[(name, type, offset)]."},
    {"build_update_frames_batch", build_update_frames_batch, METH_O,
     "Build N broadcast frames from (name, update[, reply]) tuples."},
    {"coalesce_updates", coalesce_updates_native, METH_O,
     "Byte-level merge of N Yjs updates; None = fall back to Python."},
    {"scan_update_frontier", scan_update_frontier, METH_O,
     "Per-client clock frontier of an update -> (pairs, ds_empty)."},
    {"parse_envelope", parse_envelope, METH_O,
     "Decode one relay envelope -> (kind, session, aux, payload)."},
    {"parse_envelopes_batch", parse_envelopes_batch, METH_VARARGS,
     "Decode N relay envelopes in one call."},
    {"read_var_uints", read_var_uints, METH_VARARGS,
     "Bulk varint reads -> (tuple_of_ints, new_pos)."},
    {"encode_var_uints", encode_var_uints, METH_O,
     "Bulk varint writes -> bytes."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hocuspocus_torch_codec",
    "Native Yjs v1 update codec (C++)", -1, methods,
};

}  // namespace

// text_lane.cpp — the native host path for plain-text documents
void register_text_lane(PyObject* module);

PyMODINIT_FUNC PyInit__hocuspocus_torch_codec(void) {
    PyObject* m = PyModule_Create(&module);
    if (m) register_text_lane(m);
    return m;
}
