// Native "text lane": the full host-side hot path for plain-text docs.
//
// The host plane's cost (~17 us of Python per doc-window) is spread
// across lowering, serve-log bookkeeping and window encoding — no
// single hotspot to shave. This module owns the WHOLE per-update path
// for the hot shape (documents whose device content is one root text
// sequence, the plain-text editing workload):
//
//   lane_apply(handle, slot, update, presync, remote)
//       decode (Yjs v1) + causal lowering (known clocks, pending
//       buffering, gc routing, overlap trimming — the exact semantics
//       of tpu/lowering.DocLowerer restricted to this shape) + append
//       to the native serve log / unit log / dispatch queue.
//       Returns None when the update needs the Python path (rich
//       content, tree parents, map entries): the caller demotes the
//       doc and re-lowers from the CPU snapshot.
//   lane_drain(handle, k)
//       pops up to k ops per lane slot across EVERY lane slot into
//       columnar buffers the flush scatters straight into the device
//       batch (replaces the per-op Python loop in _build_batch).
//   lane_window(handle, slot, from_idx, ...)
//       one call per dirty doc building the broadcast window update
//       bytes (struct groups + window delete set) and the
//       cross-instance variant (remote-origin records excluded) —
//       byte-identical to serving._encode_window + DeleteSet.write.
//   lane_export(handle, slot) / lane_known(handle, slot)
//       materialize the log for the Python serving paths that stay
//       cold (stale/cold sync serves, text(), the RLE payload index).
//
// Reference hot loop being replaced: per-message decode+apply+fan-out
// in `packages/server/src/MessageReceiver.ts:195-213` and
// `packages/server/src/Document.ts:228-240`.
//
// lib0 varint / utf helpers are duplicated from codec.cpp (anonymous
// namespace, internal linkage — both objects link into one module).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// -- lib0 primitives ---------------------------------------------------------

struct LaneReader {
    const uint8_t* buf;
    Py_ssize_t len;
    Py_ssize_t pos = 0;

    uint8_t u8() {
        if (pos >= len) throw std::runtime_error("unexpected end of buffer");
        return buf[pos++];
    }
    uint64_t var_uint() {
        uint64_t num = 0;
        int shift = 0;
        while (true) {
            uint8_t b = u8();
            num |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (b < 0x80) return num;
            shift += 7;
            if (shift > 63) throw std::runtime_error("varint too long");
        }
    }
    Py_ssize_t checked_len(uint64_t n) {
        if (n > static_cast<uint64_t>(len - pos))
            throw std::runtime_error("length prefix exceeds buffer");
        return static_cast<Py_ssize_t>(n);
    }
    const char* bytes(Py_ssize_t n) {
        if (n < 0 || pos + n > len)
            throw std::runtime_error("unexpected end of buffer");
        const char* p = reinterpret_cast<const char*>(buf + pos);
        pos += n;
        return p;
    }
    std::pair<const char*, Py_ssize_t> var_string() {
        Py_ssize_t n = checked_len(var_uint());
        return {bytes(n), n};
    }
};

void put_var_uint(std::string& out, uint64_t num) {
    while (num > 0x7F) {
        out.push_back(static_cast<char>(0x80 | (num & 0x7F)));
        num >>= 7;
    }
    out.push_back(static_cast<char>(num));
}

void put_var_string(std::string& out, const char* s, size_t n) {
    put_var_uint(out, n);
    out.append(s, n);
}

constexpr uint8_t BIT_ORIGIN = 0x80;
constexpr uint8_t BIT_RIGHT_ORIGIN = 0x40;
constexpr uint8_t BIT_PARENT_SUB = 0x20;
constexpr uint32_t NONE_CLIENT = 0xFFFFFFFFu;

// utf-8 -> utf-16 code units with U+FFFD replacement (JS semantics)
void utf8_to_utf16(const char* s, Py_ssize_t n, std::vector<uint16_t>& out) {
    Py_ssize_t i = 0;
    while (i < n) {
        uint8_t c = static_cast<uint8_t>(s[i]);
        uint32_t cp;
        int need;
        if (c < 0x80) { cp = c; need = 0; }
        else if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; need = 1; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; need = 2; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; need = 3; }
        else { out.push_back(0xFFFD); i++; continue; }
        bool ok = true;
        for (int k = 1; k <= need; ++k) {
            if (i + k >= n || (static_cast<uint8_t>(s[i + k]) & 0xC0) != 0x80) {
                ok = false;
                break;
            }
            cp = (cp << 6) | (static_cast<uint8_t>(s[i + k]) & 0x3F);
        }
        if (!ok) { out.push_back(0xFFFD); i++; continue; }
        i += need + 1;
        if (cp >= 0x10000) {
            cp -= 0x10000;
            out.push_back(static_cast<uint16_t>(0xD800 + (cp >> 10)));
            out.push_back(static_cast<uint16_t>(0xDC00 + (cp & 0x3FF)));
        } else {
            out.push_back(static_cast<uint16_t>(cp));
        }
    }
}

// utf-16 code units -> utf-8, lone surrogates -> U+FFFD (TextEncoder)
void utf16_to_utf8(const uint16_t* s, size_t n, std::string& out) {
    size_t i = 0;
    while (i < n) {
        uint32_t cp = s[i];
        if (cp >= 0xD800 && cp < 0xDC00) {
            if (i + 1 < n && s[i + 1] >= 0xDC00 && s[i + 1] < 0xE000) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (s[i + 1] - 0xDC00);
                i += 2;
            } else {
                cp = 0xFFFD;
                i += 1;
            }
        } else if (cp >= 0xDC00 && cp < 0xE000) {
            cp = 0xFFFD;
            i += 1;
        } else {
            i += 1;
        }
        if (cp < 0x80) {
            out.push_back(static_cast<char>(cp));
        } else if (cp < 0x800) {
            out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
            out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
            out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else {
            out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
            out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
            out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        }
    }
}

// -- lane state ---------------------------------------------------------------

constexpr int32_t KIND_INSERT = 1;
constexpr int32_t KIND_DELETE = 2;

constexpr uint8_t F_DELETED_CONTENT = 1;
constexpr uint8_t F_GC = 2;
constexpr uint8_t F_PRESYNC = 4;
constexpr uint8_t F_REMOTE = 8;

struct LaneOp {
    int32_t kind;
    uint32_t client;
    int64_t clock;
    int32_t run_len;
    uint32_t left_client;
    int64_t left_clock;
    uint32_t right_client;
    int64_t right_clock;
    int64_t unit_off;  // inserts: payload offset into units
    uint8_t flags;
};

// decoded struct waiting on (or ready for) emission
struct PendStruct {
    uint32_t client;
    int64_t clock;
    int32_t kind;  // 0 string, 1 deleted, 2 gc
    int64_t length;
    bool has_origin = false, has_right = false, has_root_parent = false;
    uint32_t oc = 0, rc = 0;
    int64_t ok = 0, rk = 0;
    std::string root;          // utf8, when has_root_parent
    std::vector<uint16_t> text;  // string payload
};

struct Interval {
    int64_t start, end;
    uint8_t tag;  // 0 seq, 1 gc
};

struct DelRange {
    uint32_t client;
    int64_t clock;
    int64_t len;
};

struct SlotLane {
    std::string root;  // single root seq name; empty until discovered
    bool root_known = false;
    std::vector<LaneOp> ops;       // serve log (inserts, deletes, gc)
    std::vector<uint16_t> units;   // insert payloads, arrival order
    std::vector<uint32_t> queue;   // undispatched op indices
    size_t q_pos = 0;
    std::unordered_map<uint32_t, int64_t> known;
    std::unordered_map<uint32_t, std::vector<Interval>> routes;
    std::vector<PendStruct> pending;
    std::vector<DelRange> pending_deletes;
    bool dead = false;

    int64_t known_of(uint32_t c) const {
        auto it = known.find(c);
        return it == known.end() ? 0 : it->second;
    }
    bool id_known(uint32_t c, int64_t k) const { return k < known_of(c); }

    const Interval* run_of_id(uint32_t c, int64_t k) const {
        auto it = routes.find(c);
        if (it == routes.end() || it->second.empty()) return nullptr;
        const auto& v = it->second;
        // emits per client are clock-ordered: binary search by start
        size_t lo = 0, hi = v.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (v[mid].start <= k) lo = mid + 1; else hi = mid;
        }
        if (lo == 0) return nullptr;
        const Interval& iv = v[lo - 1];
        return (iv.start <= k && k < iv.end) ? &iv : nullptr;
    }
    void record_route(uint32_t c, int64_t start, int64_t len, uint8_t tag) {
        routes[c].push_back(Interval{start, start + len, tag});
    }
};

struct LaneRegistry {
    std::unordered_map<int64_t, SlotLane> slots;
};

void registry_destructor(PyObject* cap) {
    delete static_cast<LaneRegistry*>(
        PyCapsule_GetPointer(cap, "hocuspocus_torch_lane"));
}

LaneRegistry* registry_of(PyObject* cap) {
    return static_cast<LaneRegistry*>(
        PyCapsule_GetPointer(cap, "hocuspocus_torch_lane"));
}

// -- lowering (DocLowerer semantics, text-lane subset) ------------------------

bool struct_ready(const SlotLane& lane, const PendStruct& p) {
    if (p.clock > lane.known_of(p.client)) return false;  // same-client gap
    if (p.has_origin && !lane.id_known(p.oc, p.ok)) return false;
    if (p.has_right && !lane.id_known(p.rc, p.rk)) return false;
    return true;
}

bool collected_by_gc(const SlotLane& lane, const PendStruct& p) {
    if (p.has_origin) {
        const Interval* iv = lane.run_of_id(p.oc, p.ok);
        if (iv && iv->tag == 1) return true;
    }
    if (p.has_right) {
        const Interval* iv = lane.run_of_id(p.rc, p.rk);
        if (iv && iv->tag == 1) return true;
    }
    return false;
}

// emit one causally-ready struct; returns false -> lane dead (demote)
bool emit_struct(SlotLane& lane, const PendStruct& p, uint8_t base_flags,
                 int64_t& queued_insert_units) {
    int64_t known = lane.known_of(p.client);
    if (p.clock + p.length <= known) return true;  // full duplicate
    if (p.kind == 2 || collected_by_gc(lane, p)) {
        // GC struct (or item resolving into a collected range): serve-
        // log-only record, never queued to the device
        int64_t offset = std::max<int64_t>(known - p.clock, 0);
        LaneOp op{};
        op.kind = KIND_INSERT;
        op.client = p.client;
        op.clock = p.clock + offset;
        op.run_len = static_cast<int32_t>(p.length - offset);
        op.left_client = NONE_CLIENT;
        op.right_client = NONE_CLIENT;
        op.unit_off = static_cast<int64_t>(lane.units.size());
        op.flags = static_cast<uint8_t>(base_flags | F_GC);
        lane.ops.push_back(op);
        lane.record_route(p.client, p.clock + offset, p.length - offset, 1);
        lane.known[p.client] = p.clock + p.length;
        return true;
    }
    // route resolution (text subset): explicit root parent, or via
    // an origin's recorded run
    if (p.has_root_parent) {
        if (!lane.root_known) {
            lane.root = p.root;
            lane.root_known = true;
        } else if (lane.root != p.root) {
            return false;  // a second root sequence: tree/map doc
        }
    } else {
        uint32_t ref_c;
        int64_t ref_k;
        if (p.has_origin) { ref_c = p.oc; ref_k = p.ok; }
        else if (p.has_right) { ref_c = p.rc; ref_k = p.rk; }
        else return false;  // no origins and no parent: undecidable
        const Interval* iv = lane.run_of_id(ref_c, ref_k);
        if (!iv || iv->tag != 0) return false;  // unknown/odd route
    }
    int64_t offset = std::max<int64_t>(known - p.clock, 0);
    uint32_t lc = p.has_origin ? p.oc : NONE_CLIENT;
    int64_t lk = p.has_origin ? p.ok : 0;
    if (offset > 0) {
        lc = p.client;
        lk = p.clock + offset - 1;
    }
    LaneOp op{};
    op.kind = KIND_INSERT;
    op.client = p.client;
    op.clock = p.clock + offset;
    op.run_len = static_cast<int32_t>(p.length - offset);
    op.left_client = lc;
    op.left_clock = lk;
    op.right_client = p.has_right ? p.rc : NONE_CLIENT;
    op.right_clock = p.has_right ? p.rk : 0;
    op.unit_off = static_cast<int64_t>(lane.units.size());
    op.flags = base_flags;
    if (p.kind == 1) {  // ContentDeleted run: zero markers in the log
        op.flags |= F_DELETED_CONTENT;
        lane.units.insert(lane.units.end(),
                          static_cast<size_t>(p.length - offset), 0);
    } else {
        lane.units.insert(lane.units.end(), p.text.begin() + offset,
                          p.text.end());
    }
    lane.ops.push_back(op);
    lane.queue.push_back(static_cast<uint32_t>(lane.ops.size() - 1));
    queued_insert_units += op.run_len;
    if (p.kind == 1) {
        // idempotent id-range tombstone over the full struct range
        LaneOp del{};
        del.kind = KIND_DELETE;
        del.client = p.client;
        del.clock = p.clock;
        del.run_len = static_cast<int32_t>(p.length);
        del.left_client = NONE_CLIENT;
        del.right_client = NONE_CLIENT;
        del.unit_off = static_cast<int64_t>(lane.units.size());
        del.flags = base_flags;
        lane.ops.push_back(del);
        lane.queue.push_back(static_cast<uint32_t>(lane.ops.size() - 1));
    }
    lane.record_route(p.client, p.clock + offset, p.length - offset, 0);
    lane.known[p.client] = p.clock + p.length;
    return true;
}

// split an id range across the runs it covers; false -> lane dead
bool route_delete(SlotLane& lane, uint32_t client, int64_t clock, int64_t len,
                  uint8_t base_flags) {
    int64_t end = clock + len;
    while (clock < end) {
        const Interval* iv = lane.run_of_id(client, clock);
        if (!iv) return false;  // covers ids never integrated
        int64_t upto = std::min(end, iv->end);
        if (iv->tag == 0) {
            LaneOp del{};
            del.kind = KIND_DELETE;
            del.client = client;
            del.clock = clock;
            del.run_len = static_cast<int32_t>(upto - clock);
            del.left_client = NONE_CLIENT;
            del.right_client = NONE_CLIENT;
            del.unit_off = static_cast<int64_t>(lane.units.size());
            del.flags = base_flags;
            lane.ops.push_back(del);
            lane.queue.push_back(static_cast<uint32_t>(lane.ops.size() - 1));
        }  // tag gc: already collected, tombstones meaningless
        clock = upto;
    }
    return true;
}

// the _drain loop: emit everything causally ready, then apply the
// known prefix of pending deletes
bool drain(SlotLane& lane, uint8_t base_flags, int64_t& queued_insert_units) {
    bool progress = true;
    while (progress) {
        progress = false;
        std::vector<PendStruct> remaining;
        remaining.reserve(lane.pending.size());
        for (auto& p : lane.pending) {
            if (struct_ready(lane, p)) {
                if (!emit_struct(lane, p, base_flags, queued_insert_units))
                    return false;
                progress = true;
            } else {
                remaining.push_back(std::move(p));
            }
        }
        lane.pending = std::move(remaining);
    }
    std::vector<DelRange> remaining_deletes;
    for (const auto& d : lane.pending_deletes) {
        int64_t known = lane.known_of(d.client);
        int64_t upto = std::min(known, d.clock + d.len);
        if (upto > d.clock) {
            if (!route_delete(lane, d.client, d.clock, upto - d.clock,
                              base_flags))
                return false;
        }
        if (upto < d.clock + d.len) {
            int64_t from = std::max(d.clock, upto);
            remaining_deletes.push_back(
                DelRange{d.client, from, d.clock + d.len - from});
        }
    }
    lane.pending_deletes = std::move(remaining_deletes);
    return true;
}

// decode one v1 update into pending structs/deletes; false -> unsupported
bool decode_into(SlotLane& lane, const uint8_t* buf, Py_ssize_t len) {
    LaneReader r{buf, len};
    uint64_t num_clients = r.var_uint();
    for (uint64_t ci = 0; ci < num_clients; ci++) {
        uint64_t num_structs = r.var_uint();
        uint32_t client = static_cast<uint32_t>(r.var_uint());
        int64_t clock = static_cast<int64_t>(r.var_uint());
        for (uint64_t si = 0; si < num_structs; si++) {
            uint8_t info = r.u8();
            uint8_t ref = info & 0x1F;
            PendStruct p{};
            p.client = client;
            p.clock = clock;
            if (ref == 0) {  // GC
                p.kind = 2;
                p.length = static_cast<int64_t>(r.var_uint());
            } else if (ref == 10) {  // Skip: host-only -> python path
                return false;
            } else if (ref == 1 || ref == 4) {  // Deleted / String
                if (info & BIT_ORIGIN) {
                    p.has_origin = true;
                    p.oc = static_cast<uint32_t>(r.var_uint());
                    p.ok = static_cast<int64_t>(r.var_uint());
                }
                if (info & BIT_RIGHT_ORIGIN) {
                    p.has_right = true;
                    p.rc = static_cast<uint32_t>(r.var_uint());
                    p.rk = static_cast<int64_t>(r.var_uint());
                }
                if (!(info & (BIT_ORIGIN | BIT_RIGHT_ORIGIN))) {
                    if (r.var_uint() == 1) {
                        auto [s, n] = r.var_string();
                        p.has_root_parent = true;
                        p.root.assign(s, static_cast<size_t>(n));
                    } else {
                        return false;  // item parent: tree doc
                    }
                    if (info & BIT_PARENT_SUB) return false;  // map entry
                }
                if (ref == 1) {
                    p.kind = 1;
                    p.length = static_cast<int64_t>(r.var_uint());
                } else {
                    p.kind = 0;
                    auto [s, n] = r.var_string();
                    utf8_to_utf16(s, n, p.text);
                    p.length = static_cast<int64_t>(p.text.size());
                }
            } else {
                return false;  // any rich content: python path
            }
            clock += p.length;
            lane.pending.push_back(std::move(p));
        }
    }
    uint64_t ds_clients = r.var_uint();
    for (uint64_t i = 0; i < ds_clients; i++) {
        uint32_t client = static_cast<uint32_t>(r.var_uint());
        uint64_t ranges = r.var_uint();
        for (uint64_t j = 0; j < ranges; j++) {
            int64_t clock = static_cast<int64_t>(r.var_uint());
            int64_t dlen = static_cast<int64_t>(r.var_uint());
            lane.pending_deletes.push_back(DelRange{client, clock, dlen});
        }
    }
    return true;
}

// -- window encoding ----------------------------------------------------------

constexpr uint8_t CONTENT_STRING_REF = 4;
constexpr uint8_t CONTENT_DELETED_REF = 1;
constexpr uint8_t STRUCT_GC_REF = 0;

// emit one struct entry (GC ref / info byte / origins / root parent /
// payload), sliced by `offset` units for the first item of a cutoff
// group (offset 0 = the broadcast-window case). Shared by
// encode_window and lane_window_sm so the two paths can't diverge
// byte-wise. Returns false only for a rootless origin-less item.
bool emit_struct_entry(const SlotLane& lane, const LaneOp& op, int64_t offset,
                       std::string& out) {
    if (op.flags & F_GC) {
        out.push_back(static_cast<char>(STRUCT_GC_REF));
        put_var_uint(out, static_cast<uint64_t>(op.run_len - offset));
        return true;
    }
    uint8_t info = (op.flags & F_DELETED_CONTENT) ? CONTENT_DELETED_REF
                                                  : CONTENT_STRING_REF;
    uint32_t oc = op.left_client;
    int64_t ok = op.left_clock;
    if (offset > 0) {
        // emitting a tail: its origin is the unit just before the cut
        // (Item.write offset semantics)
        oc = op.client;
        ok = op.clock + offset - 1;
    }
    bool has_o = oc != NONE_CLIENT;
    bool has_r = op.right_client != NONE_CLIENT;
    if (has_o) info |= BIT_ORIGIN;
    if (has_r) info |= BIT_RIGHT_ORIGIN;
    out.push_back(static_cast<char>(info));
    if (has_o) {
        put_var_uint(out, oc);
        put_var_uint(out, static_cast<uint64_t>(ok));
    }
    if (has_r) {
        put_var_uint(out, op.right_client);
        put_var_uint(out, static_cast<uint64_t>(op.right_clock));
    }
    if (!has_o && !has_r) {
        if (!lane.root_known) return false;
        put_var_uint(out, 1);
        put_var_string(out, lane.root.data(), lane.root.size());
    }
    if (op.flags & F_DELETED_CONTENT) {
        put_var_uint(out, static_cast<uint64_t>(op.run_len - offset));
    } else {
        std::string payload;
        utf16_to_utf8(lane.units.data() + op.unit_off + offset,
                      static_cast<size_t>(op.run_len - offset), payload);
        put_var_string(out, payload.data(), payload.size());
    }
    return true;
}

// encode one window (indices into lane.ops) as update bytes;
// byte-identical to serving._encode_window + DeleteSet.write
bool encode_window(const SlotLane& lane, const std::vector<uint32_t>& recs,
                   std::string& out) {
    // group insert records by client
    std::map<uint32_t, std::vector<uint32_t>, std::greater<uint32_t>> by;
    std::map<uint32_t, std::vector<std::pair<int64_t, int64_t>>,
             std::greater<uint32_t>> ds;
    bool has_inserts = false;
    for (uint32_t idx : recs) {
        const LaneOp& op = lane.ops[idx];
        if (op.kind == KIND_DELETE) {
            ds[op.client].emplace_back(op.clock, op.run_len);
        } else if (op.kind == KIND_INSERT) {
            has_inserts = true;
            by[op.client].push_back(idx);
        }
    }
    if (!has_inserts && ds.empty()) return false;  // nothing to ship
    put_var_uint(out, by.size());
    for (auto& [client, idxs] : by) {
        std::stable_sort(idxs.begin(), idxs.end(),
                         [&](uint32_t a, uint32_t b) {
                             return lane.ops[a].clock < lane.ops[b].clock;
                         });
        put_var_uint(out, idxs.size());
        put_var_uint(out, client);
        put_var_uint(out, static_cast<uint64_t>(lane.ops[idxs[0]].clock));
        for (uint32_t idx : idxs) {
            if (!emit_struct_entry(lane, lane.ops[idx], 0, out)) return false;
        }
    }
    // window delete set: sorted + merged ranges, clients descending
    put_var_uint(out, ds.size());
    for (auto& [client, ranges] : ds) {
        std::sort(ranges.begin(), ranges.end());
        std::vector<std::pair<int64_t, int64_t>> merged;
        for (auto& [clock, rlen] : ranges) {
            if (!merged.empty() &&
                merged.back().first + merged.back().second >= clock) {
                merged.back().second =
                    std::max(merged.back().second,
                             clock + rlen - merged.back().first);
            } else {
                merged.emplace_back(clock, rlen);
            }
        }
        put_var_uint(out, client);
        put_var_uint(out, merged.size());
        for (auto& [clock, rlen] : merged) {
            put_var_uint(out, static_cast<uint64_t>(clock));
            put_var_uint(out, static_cast<uint64_t>(rlen));
        }
    }
    return true;
}

// -- python api ---------------------------------------------------------------

PyObject* lane_new(PyObject* /*self*/, PyObject* /*args*/) {
    return PyCapsule_New(new LaneRegistry(), "hocuspocus_torch_lane",
                         registry_destructor);
}

PyObject* lane_open(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    reg->slots[slot];  // default-construct
    Py_RETURN_NONE;
}

PyObject* lane_close(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    reg->slots.erase(slot);
    Py_RETURN_NONE;
}

// lane_apply(cap, slot, update, presync, remote)
//   -> (ops_added, queued_insert_units, queued_ops, root_name|None)
//      | None=demote
//   ops_added counts serve-log records (incl. host-only GC records);
//   queued_ops counts only device-bound queue entries
PyObject* lane_apply(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    Py_buffer update;
    int presync = 0, remote = 0;
    if (!PyArg_ParseTuple(args, "OLy*pp", &cap, &slot, &update, &presync,
                          &remote))
        return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) {
        PyBuffer_Release(&update);
        return nullptr;
    }
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) {
        PyBuffer_Release(&update);
        PyErr_SetString(PyExc_KeyError, "lane slot not open");
        return nullptr;
    }
    SlotLane& lane = it->second;
    if (lane.dead) {
        PyBuffer_Release(&update);
        Py_RETURN_NONE;
    }
    uint8_t base_flags = static_cast<uint8_t>(
        (presync ? F_PRESYNC : 0) | (remote ? F_REMOTE : 0));
    size_t ops_before = lane.ops.size();
    size_t queued_before = lane.queue.size();
    int64_t queued_units = 0;
    bool ok;
    try {
        ok = decode_into(lane, static_cast<const uint8_t*>(update.buf),
                         update.len) &&
             drain(lane, base_flags, queued_units);
    } catch (const std::exception&) {
        ok = false;
    }
    PyBuffer_Release(&update);
    if (!ok) {
        lane.dead = true;
        Py_RETURN_NONE;  // caller demotes + re-lowers from CPU snapshot
    }
    PyObject* root = lane.root_known
                         ? PyUnicode_DecodeUTF8(lane.root.data(),
                                                static_cast<Py_ssize_t>(
                                                    lane.root.size()),
                                                "replace")
                         : Py_NewRef(Py_None);
    if (!root) return nullptr;
    return Py_BuildValue("(nLnN)",
                         static_cast<Py_ssize_t>(lane.ops.size() - ops_before),
                         static_cast<long long>(queued_units),
                         static_cast<Py_ssize_t>(lane.queue.size() - queued_before),
                         root);
}

PyObject* lane_queue_len(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) return PyLong_FromLong(0);
    return PyLong_FromSize_t(it->second.queue.size() - it->second.q_pos);
}

PyObject* lane_queue_total(PyObject* /*self*/, PyObject* arg) {
    LaneRegistry* reg = registry_of(arg);
    if (!reg) return nullptr;
    size_t total = 0;
    for (auto& [slot, lane] : reg->slots)
        total += lane.queue.size() - lane.q_pos;
    return PyLong_FromSize_t(total);
}

PyObject* lane_queue_max(PyObject* /*self*/, PyObject* arg) {
    LaneRegistry* reg = registry_of(arg);
    if (!reg) return nullptr;
    size_t mx = 0;
    for (auto& [slot, lane] : reg->slots)
        mx = std::max(mx, lane.queue.size() - lane.q_pos);
    return PyLong_FromSize_t(mx);
}

PyObject* lane_clear_queue(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it != reg->slots.end()) {
        it->second.queue.clear();
        it->second.q_pos = 0;
    }
    Py_RETURN_NONE;
}

// lane_drain(cap, k) -> (built, rows_i64, slots_i64, kind_i32,
//   client_u32, clock_i32, run_i32, lc_u32, lk_i32, rc_u32, rk_i32,
//   dispatch_slots_i64, dispatch_units_i64)
// Pops up to k ops per lane slot; buffers are bytes for np.frombuffer.
PyObject* lane_drain(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long k;
    if (!PyArg_ParseTuple(args, "OL", &cap, &k)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    std::vector<int64_t> rows, slots, d_slots, d_units;
    std::vector<int32_t> kind, clock, run, lk, rk;
    std::vector<uint32_t> client, lc, rc;
    for (auto& [slot, lane] : reg->slots) {
        size_t avail = lane.queue.size() - lane.q_pos;
        size_t take = std::min<size_t>(avail, static_cast<size_t>(k));
        if (!take) continue;
        int64_t units = 0;
        for (size_t i = 0; i < take; i++) {
            const LaneOp& op = lane.ops[lane.queue[lane.q_pos + i]];
            rows.push_back(static_cast<int64_t>(i));
            slots.push_back(slot);
            kind.push_back(op.kind);
            client.push_back(op.client);
            clock.push_back(static_cast<int32_t>(op.clock));
            run.push_back(op.run_len);
            lc.push_back(op.left_client);
            lk.push_back(static_cast<int32_t>(op.left_clock));
            rc.push_back(op.right_client);
            rk.push_back(static_cast<int32_t>(op.right_clock));
            if (op.kind == KIND_INSERT) units += op.run_len;
        }
        lane.q_pos += take;
        if (lane.q_pos == lane.queue.size()) {
            lane.queue.clear();
            lane.q_pos = 0;
        }
        d_slots.push_back(slot);
        d_units.push_back(units);
    }
    auto as_bytes = [](const void* p, size_t n) {
        return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                         static_cast<Py_ssize_t>(n));
    };
    return Py_BuildValue(
        "(nNNNNNNNNNNNN)", static_cast<Py_ssize_t>(rows.size()),
        as_bytes(rows.data(), rows.size() * 8),
        as_bytes(slots.data(), slots.size() * 8),
        as_bytes(kind.data(), kind.size() * 4),
        as_bytes(client.data(), client.size() * 4),
        as_bytes(clock.data(), clock.size() * 4),
        as_bytes(run.data(), run.size() * 4),
        as_bytes(lc.data(), lc.size() * 4),
        as_bytes(lk.data(), lk.size() * 4),
        as_bytes(rc.data(), rc.size() * 4),
        as_bytes(rk.data(), rk.size() * 4),
        as_bytes(d_slots.data(), d_slots.size() * 8),
        as_bytes(d_units.data(), d_units.size() * 8));
}

// lane_window(cap, slot, from_idx)
//   -> (full_update|None, cross_update|None, new_idx, log_len)
// cross excludes remote-origin records; None full = empty window.
// Identical semantics to serving.build_broadcast_pair's encode step.
PyObject* lane_window(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot, from_idx;
    if (!PyArg_ParseTuple(args, "OLL", &cap, &slot, &from_idx)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) {
        PyErr_SetString(PyExc_KeyError, "lane slot not open");
        return nullptr;
    }
    const SlotLane& lane = it->second;
    int64_t log_len = static_cast<int64_t>(lane.ops.size());
    int64_t start = std::min<int64_t>(from_idx, log_len);
    std::vector<uint32_t> window, local;
    for (int64_t i = start; i < log_len; i++) {
        const LaneOp& op = lane.ops[static_cast<size_t>(i)];
        if (op.flags & F_PRESYNC) continue;
        window.push_back(static_cast<uint32_t>(i));
        if (!(op.flags & F_REMOTE)) local.push_back(static_cast<uint32_t>(i));
    }
    if (window.empty())
        return Py_BuildValue("(OOLL)", Py_None, Py_None, log_len, log_len);
    std::string full;
    if (!encode_window(lane, window, full))
        return Py_BuildValue("(OOLL)", Py_None, Py_None, log_len, log_len);
    PyObject* full_obj =
        PyBytes_FromStringAndSize(full.data(),
                                  static_cast<Py_ssize_t>(full.size()));
    if (!full_obj) return nullptr;
    PyObject* cross_obj;
    if (local.size() == window.size()) {
        cross_obj = Py_NewRef(full_obj);
    } else if (local.empty()) {
        cross_obj = Py_NewRef(Py_None);
    } else {
        std::string cross;
        if (encode_window(lane, local, cross)) {
            cross_obj = PyBytes_FromStringAndSize(
                cross.data(), static_cast<Py_ssize_t>(cross.size()));
        } else {
            cross_obj = Py_NewRef(Py_None);
        }
        if (!cross_obj) {
            Py_DECREF(full_obj);
            return nullptr;
        }
    }
    return Py_BuildValue("(NNLL)", full_obj, cross_obj, log_len, log_len);
}

// lane_window_sm(cap, slot, [(client, cutoff), ...]) -> bytes
// The struct section of a stale/cold SyncStep2 for a lane doc: per-
// client cutoff trimming, the first emitted item's offset slice with
// its origin rewrite, and the mid-surrogate-pair cutoff widening — the
// native mirror of serving._encode_from_sm's struct work (the caller
// appends the device-tombstone delete set). Clients absent from the
// map are skipped, matching the Python path.
PyObject* lane_window_sm(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    PyObject* sm_obj;
    if (!PyArg_ParseTuple(args, "OLO", &cap, &slot, &sm_obj)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) {
        PyErr_SetString(PyExc_KeyError, "lane slot not open");
        return nullptr;
    }
    const SlotLane& lane = it->second;
    PyObject* sm_items = PySequence_Fast(sm_obj, "expected a sequence");
    if (!sm_items) return nullptr;
    std::unordered_map<uint32_t, int64_t> sm;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(sm_items); i++) {
        unsigned long long client;
        long long cutoff;
        if (!PyArg_ParseTuple(PySequence_Fast_GET_ITEM(sm_items, i), "KL",
                              &client, &cutoff)) {
            Py_DECREF(sm_items);
            return nullptr;
        }
        sm[static_cast<uint32_t>(client)] = cutoff;
    }
    Py_DECREF(sm_items);

    // mid-surrogate-pair cutoff widening, ONE pass over the log
    // (serving semantics: the unit AT the cutoff and the one BEFORE it
    // resolved independently — the pair may span two records)
    std::unordered_map<uint32_t, uint16_t> at_unit, prev_unit;
    for (const LaneOp& op : lane.ops) {
        if (op.kind != KIND_INSERT || (op.flags & F_GC) ||
            (op.flags & F_DELETED_CONTENT))
            continue;
        auto sit = sm.find(op.client);
        if (sit == sm.end() || sit->second <= 0) continue;
        int64_t cutoff = sit->second;
        if (op.clock <= cutoff && cutoff < op.clock + op.run_len)
            at_unit[op.client] = lane.units[static_cast<size_t>(
                op.unit_off + (cutoff - op.clock))];
        if (op.clock <= cutoff - 1 && cutoff - 1 < op.clock + op.run_len)
            prev_unit[op.client] = lane.units[static_cast<size_t>(
                op.unit_off + (cutoff - 1 - op.clock))];
    }
    for (auto& [client, at] : at_unit) {
        auto pit = prev_unit.find(client);
        if (pit != prev_unit.end() && at >= 0xDC00 && at < 0xE000 &&
            pit->second >= 0xD800 && pit->second < 0xDC00)
            sm[client] -= 1;
    }

    // group overlapping insert records by client (descending)
    std::map<uint32_t, std::vector<uint32_t>, std::greater<uint32_t>> by;
    for (uint32_t i = 0; i < lane.ops.size(); i++) {
        const LaneOp& op = lane.ops[i];
        if (op.kind != KIND_INSERT) continue;
        auto sit = sm.find(op.client);
        if (sit == sm.end()) continue;
        if (op.clock + op.run_len <= sit->second) continue;
        by[op.client].push_back(i);
    }
    std::string out;
    put_var_uint(out, by.size());
    for (auto& [client, idxs] : by) {
        std::stable_sort(idxs.begin(), idxs.end(),
                         [&](uint32_t a, uint32_t b) {
                             return lane.ops[a].clock < lane.ops[b].clock;
                         });
        int64_t cutoff = sm[client];
        int64_t write_clock = std::max(cutoff, lane.ops[idxs[0]].clock);
        put_var_uint(out, idxs.size());
        put_var_uint(out, client);
        put_var_uint(out, static_cast<uint64_t>(write_clock));
        bool first = true;
        for (uint32_t idx : idxs) {
            const LaneOp& op = lane.ops[idx];
            int64_t offset =
                first ? std::max<int64_t>(write_clock - op.clock, 0) : 0;
            first = false;
            if (!emit_struct_entry(lane, op, offset, out)) {
                PyErr_SetString(PyExc_ValueError, "rootless lane item");
                return nullptr;
            }
        }
    }
    return PyBytes_FromStringAndSize(out.data(),
                                     static_cast<Py_ssize_t>(out.size()));
}

// lane_covers(cap, slot, [(client, clock), ...]) -> bool
PyObject* lane_covers(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    PyObject* sv_obj;
    if (!PyArg_ParseTuple(args, "OLO", &cap, &slot, &sv_obj)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) Py_RETURN_FALSE;
    PyObject* items = PySequence_Fast(sv_obj, "expected a sequence");
    if (!items) return nullptr;
    bool ok = true;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(items); i++) {
        unsigned long long client;
        long long clock;
        if (!PyArg_ParseTuple(PySequence_Fast_GET_ITEM(items, i), "KL",
                              &client, &clock)) {
            Py_DECREF(items);
            return nullptr;
        }
        if (clock > it->second.known_of(static_cast<uint32_t>(client))) {
            ok = false;
            break;
        }
    }
    Py_DECREF(items);
    if (ok) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

// lane_known(cap, slot) -> dict client -> next clock
PyObject* lane_known(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    PyObject* known = PyDict_New();
    if (!known) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) return known;
    for (auto& [c, k] : it->second.known) {
        PyObject* key = PyLong_FromUnsignedLong(c);
        PyObject* val = PyLong_FromLongLong(k);
        if (!key || !val || PyDict_SetItem(known, key, val) < 0) {
            Py_XDECREF(key);
            Py_XDECREF(val);
            Py_DECREF(known);
            return nullptr;
        }
        Py_DECREF(key);
        Py_DECREF(val);
    }
    return known;
}

// lane_windows_batch(cap, [(slot, from_idx), ...])
//   -> [(full|None, cross|None, new_idx), ...]
// One call drains the whole dirty set's broadcast windows — the
// per-doc Python call overhead dominates the drain at 10k-doc width.
PyObject* lane_windows_batch(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    PyObject* items_obj;
    if (!PyArg_ParseTuple(args, "OO", &cap, &items_obj)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    PyObject* items = PySequence_Fast(items_obj, "expected a sequence");
    if (!items) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(items);
    PyObject* out = PyList_New(n);
    if (!out) {
        Py_DECREF(items);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        long long slot, from_idx;
        if (!PyArg_ParseTuple(PySequence_Fast_GET_ITEM(items, i), "LL", &slot,
                              &from_idx)) {
            Py_DECREF(items);
            Py_DECREF(out);
            return nullptr;
        }
        auto it = reg->slots.find(slot);
        PyObject* entry;
        if (it == reg->slots.end()) {
            entry = Py_BuildValue("(OOL)", Py_None, Py_None, from_idx);
        } else {
            const SlotLane& lane = it->second;
            int64_t log_len = static_cast<int64_t>(lane.ops.size());
            int64_t start = std::min<int64_t>(from_idx, log_len);
            std::vector<uint32_t> window, local;
            for (int64_t j = start; j < log_len; j++) {
                const LaneOp& op = lane.ops[static_cast<size_t>(j)];
                if (op.flags & F_PRESYNC) continue;
                window.push_back(static_cast<uint32_t>(j));
                if (!(op.flags & F_REMOTE))
                    local.push_back(static_cast<uint32_t>(j));
            }
            std::string full;
            if (window.empty() || !encode_window(lane, window, full)) {
                entry = Py_BuildValue("(OOL)", Py_None, Py_None, log_len);
            } else {
                PyObject* full_obj = PyBytes_FromStringAndSize(
                    full.data(), static_cast<Py_ssize_t>(full.size()));
                PyObject* cross_obj = nullptr;
                if (local.size() == window.size()) {
                    cross_obj = Py_NewRef(full_obj);
                } else if (local.empty()) {
                    cross_obj = Py_NewRef(Py_None);
                } else {
                    std::string cross;
                    if (encode_window(lane, local, cross)) {
                        cross_obj = PyBytes_FromStringAndSize(
                            cross.data(),
                            static_cast<Py_ssize_t>(cross.size()));
                    } else {
                        cross_obj = Py_NewRef(Py_None);
                    }
                }
                if (!full_obj || !cross_obj) {
                    Py_XDECREF(full_obj);
                    Py_XDECREF(cross_obj);
                    Py_DECREF(items);
                    Py_DECREF(out);
                    return nullptr;
                }
                entry = Py_BuildValue("(NNL)", full_obj, cross_obj, log_len);
            }
        }
        if (!entry) {
            Py_DECREF(items);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, entry);
    }
    Py_DECREF(items);
    return out;
}

// lane_export(cap, slot) -> (ops list, units bytes u16le, known dict, root)
//   op: (kind, client, clock, run_len, lc, lk, rc, rk, unit_off, flags)
PyObject* lane_export(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) {
        PyErr_SetString(PyExc_KeyError, "lane slot not open");
        return nullptr;
    }
    const SlotLane& lane = it->second;
    PyObject* ops = PyList_New(static_cast<Py_ssize_t>(lane.ops.size()));
    if (!ops) return nullptr;
    for (size_t i = 0; i < lane.ops.size(); i++) {
        const LaneOp& op = lane.ops[i];
        PyObject* t = Py_BuildValue(
            "(iILiILILLi)", op.kind, op.client,
            static_cast<long long>(op.clock), op.run_len, op.left_client,
            static_cast<long long>(op.left_clock), op.right_client,
            static_cast<long long>(op.right_clock),
            static_cast<long long>(op.unit_off), static_cast<int>(op.flags));
        if (!t) {
            Py_DECREF(ops);
            return nullptr;
        }
        PyList_SET_ITEM(ops, static_cast<Py_ssize_t>(i), t);
    }
    PyObject* units = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(lane.units.data()),
        static_cast<Py_ssize_t>(lane.units.size() * 2));
    PyObject* known = PyDict_New();
    if (!units || !known) {
        Py_DECREF(ops);
        Py_XDECREF(units);
        Py_XDECREF(known);
        return nullptr;
    }
    for (auto& [c, k] : lane.known) {
        PyObject* key = PyLong_FromUnsignedLong(c);
        PyObject* val = PyLong_FromLongLong(k);
        if (!key || !val || PyDict_SetItem(known, key, val) < 0) {
            Py_XDECREF(key);
            Py_XDECREF(val);
            Py_DECREF(ops);
            Py_DECREF(units);
            Py_DECREF(known);
            return nullptr;
        }
        Py_DECREF(key);
        Py_DECREF(val);
    }
    PyObject* root =
        lane.root_known
            ? PyUnicode_DecodeUTF8(lane.root.data(),
                                   static_cast<Py_ssize_t>(lane.root.size()),
                                   "replace")
            : Py_NewRef(Py_None);
    if (!root) {
        Py_DECREF(ops);
        Py_DECREF(units);
        Py_DECREF(known);
        return nullptr;
    }
    return Py_BuildValue("(NNNN)", ops, units, known, root);
}

PyObject* lane_log_len(PyObject* /*self*/, PyObject* args) {
    PyObject* cap;
    long long slot;
    if (!PyArg_ParseTuple(args, "OL", &cap, &slot)) return nullptr;
    LaneRegistry* reg = registry_of(cap);
    if (!reg) return nullptr;
    auto it = reg->slots.find(slot);
    if (it == reg->slots.end()) return PyLong_FromLong(0);
    return Py_BuildValue(
        "(nn)", static_cast<Py_ssize_t>(it->second.ops.size()),
        static_cast<Py_ssize_t>(it->second.units.size()));
}

PyMethodDef lane_methods[] = {
    {"lane_new", lane_new, METH_NOARGS, "Create a text-lane registry."},
    {"lane_open", lane_open, METH_VARARGS, "Open a lane for a slot."},
    {"lane_close", lane_close, METH_VARARGS, "Release a slot's lane."},
    {"lane_apply", lane_apply, METH_VARARGS,
     "Decode+lower+append one update; None = needs the Python path."},
    {"lane_queue_len", lane_queue_len, METH_VARARGS,
     "Undispatched ops queued for one slot."},
    {"lane_queue_total", lane_queue_total, METH_O,
     "Undispatched ops across every lane slot."},
    {"lane_queue_max", lane_queue_max, METH_O,
     "Deepest per-slot undispatched queue (flush K sizing)."},
    {"lane_clear_queue", lane_clear_queue, METH_VARARGS,
     "Drop a slot's undispatched ops (retire path)."},
    {"lane_drain", lane_drain, METH_VARARGS,
     "Pop up to k ops per lane slot into columnar buffers."},
    {"lane_window", lane_window, METH_VARARGS,
     "Build (full, cross) broadcast window updates since an index."},
    {"lane_windows_batch", lane_windows_batch, METH_VARARGS,
     "Drain broadcast windows for many slots in one call."},
    {"lane_window_sm", lane_window_sm, METH_VARARGS,
     "Struct section of a stale/cold SyncStep2 under per-client cutoffs."},
    {"lane_covers", lane_covers, METH_VARARGS,
     "Whether the lane's known clocks cover a state vector."},
    {"lane_known", lane_known, METH_VARARGS,
     "The lane's per-client next-clock map."},
    {"lane_export", lane_export, METH_VARARGS,
     "Materialize a lane's log for the Python serving paths."},
    {"lane_log_len", lane_log_len, METH_VARARGS,
     "(ops, units) lengths of a slot's lane log."},
    {nullptr, nullptr, 0, nullptr},
};

}  // namespace

// called from codec.cpp's module init
void register_text_lane(PyObject* module) {
    PyModule_AddFunctions(module, lane_methods);
}
