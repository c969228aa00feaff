// YATA integrate of K op slots into routed run-length arena rows, for
// Hopper (sm_90a).
//
// Replaces hocuspocus_tpu/tpu/pallas_kernels_rle.py::_rle_block_kernel
// (launched there by _integrate_pallas_rle and, through a gather/scatter,
// by _integrate_sparse_pallas_rle). The plain PyTorch version it is held
// against bit for bit is hocuspocus_tpu_torch/tpu/kernels_rle.py::
// integrate_op_slots_rle (dense) and ::integrate_op_slots_rle_sparse
// (routed).
//
// A row holds up to R entries, one per run of units; entry i is (client,
// clock, len, rank, orank, deleted) and entries [0, num_runs) are
// occupied. Per op the body makes a few passes over the occupied
// entries, each but the last followed by one reduction:
//   insert: origin ranks by range membership (max of two values), the
//           first blocking rank among run heads and the in-run successor
//           (min), then one pass that takes the run straddling the
//           insertion rank (five masked sums), shortens it and bumps
//           ranks; the run's tail and the new run are appended at
//           num_runs;
//   delete: for each of the two id bounds, one pass that takes the run
//           straddling it (four masked sums) and shortens it, and an
//           appended tail; then a pass that tombstones the covered runs.
// The split fields are extracted with masked sums over every matching
// entry, exactly as the TPU kernel does, so the result is the plain
// version's even when ids repeat.
//
// What bounds it on this card: at the plane's shapes (D = 1024 routed
// rows of about 100 entries in a row of R = 4096, K = 16) neither bytes
// nor operations but the latency of the K dependent op steps, each a
// chain of three reductions and up to eight op-field loads; at the bench
// shape (8192 rows of about 260 entries, K = 8) the same chain, with
// more rows than one wave. The design:
//
// - Warp path. One warp per routed column, kWarpRows warps a CTA; a
//   padding column (slot outside [0, num_docs)) idles only its warp.
//   Each warp holds a window of S entries of dynamic shared memory
//   (S = `window`, chosen by the dispatcher, integrate.py::_warp_window:
//   at most 512, so 8 warps take 86 KB and the plane's 1,024 rows sit in
//   one wave of 128 CTAs on 132 SMs). Entry i belongs to lane i % 32 for
//   the whole launch (load, every pass, appends, store), so the lanes
//   exchange only warp reductions (one redux.sync each): no barrier and
//   no __syncwarp.
//   The K ops are prefetched once (lane l holds slots l and l + 32 of
//   each 64-slot chunk in registers) and each step takes its op by
//   __shfl_sync, so no global load sits on the chain.
// - Fit test. A row runs on the warp path when every entry it can touch
//   lies in its window: min(R, occupied(num_runs) + 2K) <= S, since
//   each op appends at most two entries.
// - CTA path. A row that does not fit runs the same body CTA-wide,
//   entry i owned by thread i % 256, one barrier per block reduction,
//   the ops from a shared-memory chunk. Where a whole row fits the CTA's
//   pool of windows (R <= 8 S, the plane's R = 4096 included), the CTA
//   takes its warps' misfit rows after them in the same launch, each in
//   the pool. A wider row runs in a second launch over the same slots
//   (one CTA per column, the row in shared memory, or in global memory
//   past the opt-in limit): the first launch writes a (B,) `done` flag
//   per column and the second skips done columns, so it never re-decides
//   from the row, which the first launch has already changed. When
//   S >= R every row fits and the CTA path never runs.
// - The per-launch host setup (the opt-in limit, the shared-memory
//   attribute) is cached per device: a launch makes one or two kernel
//   launches and cudaGetLastError.
//
// Client ids are int32 bit patterns; the one ordered compare (the YATA
// client-id tiebreak) is made on uint32. int32 sums and offsets wrap as
// in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;  // CTA path, second launch
constexpr int kWarpRows = 8;  // warp path: routed columns (warps) a CTA
constexpr int kOpChunk = 64;  // op slots prefetched at a time
constexpr int kOpFields = 8;
constexpr int kMaxReduce = 5;  // values in the widest reduction
constexpr int kInf = 0x7FFFFFFF;
constexpr int kNone = -1;  // NONE_CLIENT as an int32 bit pattern
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr unsigned kFull = 0xffffffffu;
// op fields, in OpBatch order
constexpr int kKind = 0, kClient = 1, kClock = 2, kRun = 3;
constexpr int kLeftClient = 4, kLeftClock = 5, kRightClient = 6, kRightClock = 7;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Each reduction's identity and its one-instruction warp form (redux.sync).
struct Max {
  static constexpr int kIdentity = -0x7FFFFFFF - 1;
  __device__ static int warp(int v) { return __reduce_max_sync(kFull, v); }
};
struct Min {
  static constexpr int kIdentity = kInf;
  __device__ static int warp(int v) { return __reduce_min_sync(kFull, v); }
};
struct Sum {  // wraps, as int32 sums do in the plain version
  static constexpr int kIdentity = 0;
  __device__ static int warp(int v) {
    return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
  }
};

struct Ops {
  const int* field[kOpFields];  // each (K, B)
};

struct Row {
  int* client;
  int* clock;
  int* len;
  int* rank;
  int* orank;
  uint8_t* deleted;

  __device__ void put(size_t i, int c, int k, int l, int r, int o, int d) const {
    client[i] = c;
    clock[i] = k;
    len[i] = l;
    rank[i] = r;
    orank[i] = o;
    deleted[i] = static_cast<uint8_t>(d);
  }

  __device__ void copy_from(const Row& src, size_t src_base, int i) const {
    put(i, src.client[src_base + i], src.clock[src_base + i], src.len[src_base + i],
        src.rank[src_base + i], src.orank[src_base + i], src.deleted[src_base + i]);
  }

  __device__ void copy_to(const Row& dst, size_t dst_base, int i) const {
    dst.put(dst_base + i, client[i], clock[i], len[i], rank[i], orank[i], deleted[i]);
  }

  // A row's fields laid out one after another in `ints` / `bytes`, with
  // `stride` entries between the int fields.
  __device__ static Row carve(int* ints, int stride, uint8_t* bytes) {
    return Row{ints, ints + stride, ints + 2 * stride, ints + 3 * stride, ints + 4 * stride,
               bytes};
  }
};

__device__ __forceinline__ int occupied(int num_runs, int entries) {
  return min(max(num_runs, 0), entries);
}

// One warp runs a row: lane = threadIdx.x % 32, reductions are one
// redux.sync each, and the ops of the current chunk live in registers.
struct WarpGroup {
  static constexpr int kSize = 32;
  int tid;
  int k0 = 0;
  int op[kOpFields][2];

  __device__ explicit WarpGroup(int lane) : tid(lane) {}

  __device__ void load_ops(const Ops& ops, int k, int num_slots, int batch, int col) {
    k0 = k;
#pragma unroll
    for (int f = 0; f < kOpFields; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = k0 + h * 32 + tid;
        op[f][h] = s < num_slots ? ops.field[f][static_cast<size_t>(s) * batch + col] : 0;
      }
  }

  template <int F>
  __device__ int take(int k) const {
    const int r = k - k0;
    return __shfl_sync(kFull, r < 32 ? op[F][0] : op[F][1], r & 31);
  }

  template <int N, typename Op>
  __device__ void reduce(int (&v)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = Op::warp(v[j]);
  }
};

// One CTA of kSize threads runs a row: reductions go through shared
// memory with one barrier each, and the ops of the current chunk live
// in shared memory.
template <int kSize_>
struct BlockGroup {
  static constexpr int kSize = kSize_;
  static constexpr int kGroupWarps = kSize / 32;
  static constexpr int kScratch = 2 * kMaxReduce * kGroupWarps;
  int tid;
  int k0 = 0;
  int parity = 0;
  int* scratch;  // kScratch ints
  int* op_buf;   // kOpFields * kOpChunk ints

  __device__ BlockGroup(int t, int* s, int* o) : tid(t), scratch(s), op_buf(o) {}

  __device__ void load_ops(const Ops& ops, int k, int num_slots, int batch, int col) {
    k0 = k;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < kOpFields * kOpChunk; i += kSize) {
      const int s = k0 + i % kOpChunk;
      op_buf[i] = s < num_slots ? ops.field[i / kOpChunk][static_cast<size_t>(s) * batch + col] : 0;
    }
    __syncthreads();
  }

  template <int F>
  __device__ int take(int k) const {
    return op_buf[F * kOpChunk + (k - k0)];
  }

  // Block-wide reduction of N values; every thread returns the results.
  // Partials go to scratch buffer `parity` (which then flips): a buffer
  // is rewritten only two reductions later, after a barrier every reader
  // has passed, so one barrier per reduction suffices.
  template <int N, typename Op>
  __device__ void reduce(int (&v)[N]) {
    const int lane = tid & 31, warp = tid >> 5;
    int* buf = scratch + parity * kMaxReduce * kGroupWarps;
    parity ^= 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int w = Op::warp(v[j]);
      if (lane == 0) buf[j * kGroupWarps + warp] = w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = Op::warp(lane < kGroupWarps ? buf[j * kGroupWarps + lane] : Op::kIdentity);
  }
};

// The K op steps on one row (`row` holds its occupied prefix; entry i
// belongs to member i % G::kSize). The caller has loaded the first op
// chunk. The per-row scalars and every reduction result are uniform
// across the group. A pass that only reads an entry before changing it
// carries both steps (the split sums with the shortening and bump, a
// delete bound's sums with its shortening): each entry's share is taken
// from its own values before its update, as in separate passes.
template <typename G>
__device__ void integrate_row(G& g, const Row& row, int R, int& num_runs, int& total, int& ovf,
                              const Ops& ops, int num_slots, int batch, int col) {
  // the lane an append writes, when it lies inside the row (the plain
  // version's `idx == num_runs` selects nothing otherwise)
  auto owns = [&](int lane) { return lane >= 0 && lane < R && lane % G::kSize == g.tid; };
  const int tid = g.tid;
  for (int k = 0; k < num_slots; ++k) {
    if (k > 0 && k % kOpChunk == 0) g.load_ops(ops, k, num_slots, batch, col);
    const int kind = g.template take<kKind>(k);
    const int op_client = g.template take<kClient>(k);
    const int op_clock = g.template take<kClock>(k);
    const int run = g.template take<kRun>(k);
    // the capacity verdict of this op, before any of its splits
    const bool fits = wadd(num_runs, 2) <= R;

    if (kind == kInsert) {
      const int occ = occupied(num_runs, R);
      const int lc = g.template take<kLeftClient>(k), lk = g.template take<kLeftClock>(k);
      const int rc = g.template take<kRightClient>(k), rk = g.template take<kRightClock>(k);

      // 1. origin ids -> unit ranks: range membership, masked max
      int origin[2] = {-1, -1};
#pragma unroll 4
      for (int i = tid; i < occ; i += G::kSize) {
        const int c = row.client[i], t = row.clock[i], r = row.rank[i];
        const int end = wadd(t, row.len[i]);
        if (c == lc && lk >= t && lk < end) origin[0] = max(origin[0], wadd(r, wsub(lk, t)));
        if (c == rc && rk >= t && rk < end) origin[1] = max(origin[1], wadd(r, wsub(rk, t)));
      }
      g.template reduce<2, Max>(origin);
      const bool has_left = lc != kNone, has_right = rc != kNone;
      const int left_rank = has_left ? origin[0] : -1;
      const int right_rank = has_right ? origin[1] : total;
      if (!fits) ovf = 1;  // sticky
      const bool deps_ok = (!has_left || origin[0] >= 0) && (!has_right || origin[1] >= 0);
      if (!(fits && deps_ok)) continue;  // dropped: nothing else changes

      // 2. YATA conflict scan: a run head in the window whose origin lies
      //    left of it, or the unit right after `left` inside a run; both
      //    lose the tie to an op client that is not above theirs
      const unsigned op_client_u = static_cast<unsigned>(op_client);
      const int succ = wadd(left_rank, 1);
      int first[1] = {kInf};
#pragma unroll 4
      for (int i = tid; i < occ; i += G::kSize) {
        const int r = row.rank[i], o = row.orank[i];
        const bool client_ge = !(static_cast<unsigned>(row.client[i]) < op_client_u);
        if (r > left_rank && r < right_rank && (o < left_rank || (o == left_rank && client_ge)))
          first[0] = min(first[0], r);
        if (r < succ && succ < wadd(r, row.len[i]) && succ < right_rank && client_ge)
          first[0] = min(first[0], succ);
      }
      g.template reduce<1, Min>(first);
      const int ins_rank = min(first[0], right_rank);

      // 3. the run straddling the insertion rank (count, client, tail
      //    clock, tail length, tombstone count), shortened in the same
      //    pass that bumps ranks at/after the insertion
      int split[5] = {0, 0, 0, 0, 0};
#pragma unroll 4
      for (int i = tid; i < occ; i += G::kSize) {
        const int r = row.rank[i], o = row.orank[i], l = row.len[i];
        if (r < ins_rank && ins_rank < wadd(r, l)) {
          const int off = wsub(ins_rank, r);
          split[0] += 1;
          split[1] = wadd(split[1], row.client[i]);
          split[2] = wadd(split[2], wadd(row.clock[i], off));
          split[3] = wadd(split[3], wsub(l, off));
          split[4] += row.deleted[i] ? 1 : 0;
          row.len[i] = off;
        }
        if (r >= ins_rank) row.rank[i] = wadd(r, run);
        if (o >= ins_rank) row.orank[i] = wadd(o, run);
      }
      g.template reduce<5, Sum>(split);
      // the tail at num_runs (its rank is the insertion rank, so it is
      // bumped), then the new run, which is not
      if (split[0] != 0) {
        const int o = wsub(ins_rank, 1);
        if (owns(num_runs))
          row.put(num_runs, split[1], split[2], split[3], wadd(ins_rank, run),
                  o >= ins_rank ? wadd(o, run) : o, split[4] != 0);
        num_runs = wadd(num_runs, 1);
      }
      if (owns(num_runs)) row.put(num_runs, op_client, op_clock, run, ins_rank, left_rank, 0);
      num_runs = wadd(num_runs, 1);
      total = wadd(total, run);
    } else if (kind == kDelete) {
      if (!fits) {
        ovf = 1;  // sticky
        continue;
      }
      const int del_end = wadd(op_clock, run);
      for (int b = 0; b < 2; ++b) {
        const int bound = b == 0 ? op_clock : del_end;
        const int occ = occupied(num_runs, R);
        // the run of op_client straddling `bound` (count, tail rank, tail
        // length, tombstone count), shortened in the same pass
        int split[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int i = tid; i < occ; i += G::kSize) {
          const int t = row.clock[i], l = row.len[i];
          if (row.client[i] == op_client && t < bound && bound < wadd(t, l)) {
            const int off = wsub(bound, t);
            split[0] += 1;
            split[1] = wadd(split[1], wadd(row.rank[i], off));
            split[2] = wadd(split[2], wsub(l, off));
            split[3] += row.deleted[i] ? 1 : 0;
            row.len[i] = off;
          }
        }
        g.template reduce<4, Sum>(split);
        if (split[0] == 0) continue;
        if (owns(num_runs))
          row.put(num_runs, op_client, bound, split[2], split[1], wsub(split[1], 1),
                  split[3] != 0);
        num_runs = wadd(num_runs, 1);
      }
      // tombstone every run of op_client inside [op_clock, del_end)
      const int occ = occupied(num_runs, R);
#pragma unroll 4
      for (int i = tid; i < occ; i += G::kSize) {
        const int t = row.clock[i];
        if (row.client[i] == op_client && t >= op_clock && wadd(t, row.len[i]) <= del_end)
          row.deleted[i] = 1;
      }
    }
    // any other kind is a noop
  }
}

struct Scalars {
  int* num_runs;
  int* total;
  uint8_t* overflow;
};

// One row on the CTA path: its occupied prefix in `smem_row` (or, when
// that is null, the row itself in global memory), the K ops, the row
// written back. Every thread of the CTA calls it for the same column.
template <int kSize>
__device__ void cta_row(const Row& g, const Scalars& s, int slot, int R, const Ops& ops,
                        int num_slots, int batch, int col, int* smem_row, int* scratch,
                        int* op_buf) {
  const size_t base = static_cast<size_t>(slot) * R;
  const int tid = threadIdx.x;
  int num_runs = s.num_runs[slot];
  int total = s.total[slot];
  int ovf = s.overflow[slot];
  BlockGroup<kSize> group(tid, scratch, op_buf);
  group.load_ops(ops, 0, num_slots, batch, col);
  Row row;
  if (smem_row != nullptr) {
    row = Row::carve(smem_row, R, reinterpret_cast<uint8_t*>(smem_row + 5 * R));
    const int occ0 = occupied(num_runs, R);
#pragma unroll 4
    for (int i = tid; i < occ0; i += kSize) row.copy_from(g, base, i);
  } else {
    row = Row{g.client + base, g.clock + base, g.len + base,
              g.rank + base,   g.orank + base, g.deleted + base};
  }
  integrate_row(group, row, R, num_runs, total, ovf, ops, num_slots, batch, col);
  if (smem_row != nullptr) {
    const int occ = occupied(num_runs, R);
#pragma unroll 4
    for (int i = tid; i < occ; i += kSize) row.copy_to(g, base, i);
  }
  if (tid == 0) {
    s.num_runs[slot] = num_runs;
    s.total[slot] = total;
    s.overflow[slot] = static_cast<uint8_t>(ovf);
  }
}

__global__ void __launch_bounds__(kWarpRows * 32, 2)
integrate_rle_warp_kernel(Row g, Scalars s, int num_docs, int entries, Ops ops, int num_slots,
                          int batch, const int* __restrict__ slots, int window,
                          uint8_t* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[BlockGroup<kWarpRows * 32>::kScratch];
  __shared__ int op_buf[kOpFields * kOpChunk];
  __shared__ uint8_t misfit[kWarpRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarpRows + warp;
  const int R = entries;
  int* ints = reinterpret_cast<int*>(smem);

  bool cta_takes = false;
  if (col < batch) {
    // the ops first: their loads overlap the slot -> row chain below
    WarpGroup group(lane);
    group.load_ops(ops, 0, num_slots, batch, col);
    const int slot = slots[col];
    if (slot >= 0 && slot < num_docs) {  // else a padding column
      const size_t base = static_cast<size_t>(slot) * R;
      int num_runs = s.num_runs[slot];
      int total = s.total[slot];
      int ovf = s.overflow[slot];
      const int occ0 = occupied(num_runs, R);
      // every op appends at most two entries
      const bool fits = min(static_cast<long long>(R), occ0 + 2LL * num_slots) <= window;
      if (done != nullptr && lane == 0) done[col] = fits;
      cta_takes = !fits;
      if (fits) {
        const Row row = Row::carve(
            ints + warp * 5 * window, window,
            reinterpret_cast<uint8_t*>(ints + kWarpRows * 5 * window) + warp * window);
#pragma unroll 4
        for (int i = lane; i < occ0; i += 32) row.copy_from(g, base, i);
        integrate_row(group, row, R, num_runs, total, ovf, ops, num_slots, batch, col);
        const int occ = occupied(num_runs, R);
#pragma unroll 4
        for (int i = lane; i < occ; i += 32) row.copy_to(g, base, i);
        if (lane == 0) {
          s.num_runs[slot] = num_runs;
          s.total[slot] = total;
          s.overflow[slot] = static_cast<uint8_t>(ovf);
        }
      }
    }
  }
  if (done != nullptr) return;  // a second launch takes the rows that did not fit
  // the CTA takes its warps' rows that did not fit, one at a time, each
  // in the pool the warps have finished with (a whole row fits the pool)
  if (lane == 0) misfit[warp] = cta_takes;
  __syncthreads();
  for (int w = 0; w < kWarpRows; ++w) {
    if (!misfit[w]) continue;
    const int c = blockIdx.x * kWarpRows + w;
    cta_row<kWarpRows * 32>(g, s, slots[c], R, ops, num_slots, batch, c, ints, scratch, op_buf);
    __syncthreads();  // the pool and the scratch are free for the next row
  }
}

__global__ void __launch_bounds__(kThreads)
integrate_rle_block_kernel(Row g, Scalars s, int num_docs, int entries, Ops ops, int num_slots,
                           int batch, const int* __restrict__ slots,
                           const uint8_t* __restrict__ done, int row_in_smem) {
  __shared__ int scratch[BlockGroup<kThreads>::kScratch];
  __shared__ int op_buf[kOpFields * kOpChunk];
  extern __shared__ __align__(16) unsigned char smem[];
  const int col = blockIdx.x;
  const int slot = slots[col];
  if (slot < 0 || slot >= num_docs) return;  // padding column
  if (done[col]) return;  // the warp path took this row
  cta_row<kThreads>(g, s, slot, entries, ops, num_slots, batch, col,
                    row_in_smem ? reinterpret_cast<int*>(smem) : nullptr, scratch, op_buf);
}

// Per device: the opt-in shared-memory limit, queried once, and per
// kernel the largest dynamic size opted in so far.
constexpr int kMaxDevices = 64;
constexpr int kDefaultDynamic = 48 * 1024;
struct DeviceSetup {
  int optin = 0;
  int opted[2] = {kDefaultDynamic, kDefaultDynamic};  // warp kernel, block kernel
};
std::mutex g_setup_mutex;
DeviceSetup g_setup[kMaxDevices];

// Opt `kernel` in to `bytes` of dynamic shared memory unless a launch
// on this device already did (the caller holds g_setup_mutex).
cudaError_t opt_in(const void* kernel, int& opted, size_t bytes) {
  if (bytes <= static_cast<size_t>(opted)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = static_cast<int>(bytes);
  return err;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory `entries` entries take.
size_t hp_integrate_rle_row_bytes(int entries) {
  return static_cast<size_t>(entries) * (5 * sizeof(int) + 1);
}

// Launch the RLE integrate over `batch` routed columns on `stream`, with
// a warp-path window of `window` entries a row. A row that does not fit
// its window runs on the CTA path: in the same launch when a whole row
// fits the CTA's pool of windows (entries <= 8 * window), else in a
// second launch over the columns the first marks not done in `done`, a
// (batch,) byte scratch that may be null when no second launch is
// needed. Returns the launches' cudaError_t (0 = launched).
int hp_integrate_rle_rows(int* run_client, int* run_clock, int* run_len, int* run_rank,
                          int* run_orank, uint8_t* run_deleted, int* num_runs,
                          int* total_units, uint8_t* overflow, int num_docs, int entries,
                          const int* kind, const int* client, const int* clock,
                          const int* run, const int* left_client, const int* left_clock,
                          const int* right_client, const int* right_clock, int num_slots,
                          int batch, const int* slots, int window, uint8_t* done,
                          void* stream) {
  if (batch <= 0) return 0;
  if (window <= 0) return cudaErrorInvalidValue;
  // a row wider than the CTA's pool of windows takes the CTA path in a
  // second launch
  const bool second_launch = entries > 1LL * kWarpRows * window;
  if (second_launch && done == nullptr) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t pool_bytes = kWarpRows * hp_integrate_rle_row_bytes(window);
  size_t row_bytes = hp_integrate_rle_row_bytes(entries);
  int in_smem = 0;
  {
    std::lock_guard<std::mutex> lock(g_setup_mutex);
    DeviceSetup& setup = g_setup[device];
    if (setup.optin == 0) {
      err = cudaDeviceGetAttribute(&setup.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
    }
    const size_t op_bytes = kOpFields * kOpChunk * sizeof(int);
    const size_t warp_static =
        BlockGroup<kWarpRows * 32>::kScratch * sizeof(int) + op_bytes + kWarpRows;
    if (pool_bytes + warp_static > static_cast<size_t>(setup.optin)) return cudaErrorInvalidValue;
    err = opt_in(reinterpret_cast<const void*>(integrate_rle_warp_kernel), setup.opted[0],
                 pool_bytes);
    if (err != cudaSuccess) return err;
    if (second_launch) {
      const size_t static_bytes = BlockGroup<kThreads>::kScratch * sizeof(int) + op_bytes;
      in_smem = row_bytes + static_bytes <= static_cast<size_t>(setup.optin) ? 1 : 0;
      if (!in_smem) row_bytes = 0;
      err = opt_in(reinterpret_cast<const void*>(integrate_rle_block_kernel), setup.opted[1],
                   row_bytes);
      if (err != cudaSuccess) return err;
    }
  }
  const Row row{run_client, run_clock, run_len, run_rank, run_orank, run_deleted};
  const Scalars scalars{num_runs, total_units, overflow};
  const Ops ops{{kind, client, clock, run, left_client, left_clock, right_client, right_clock}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  integrate_rle_warp_kernel<<<(batch + kWarpRows - 1) / kWarpRows, kWarpRows * 32, pool_bytes,
                              s>>>(row, scalars, num_docs, entries, ops, num_slots, batch, slots,
                                   window, second_launch ? done : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !second_launch) return err;
  integrate_rle_block_kernel<<<batch, kThreads, row_bytes, s>>>(
      row, scalars, num_docs, entries, ops, num_slots, batch, slots, done, in_smem);
  return cudaGetLastError();
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
