// YATA integrate of K op slots into routed arena rows, for Hopper (sm_90a).
//
// Replaces hocuspocus_tpu/tpu/pallas_kernels.py::_integrate_block_kernel
// (launched there by _integrate_pallas and, through a gather/scatter, by
// _integrate_sparse_pallas). The plain PyTorch version it is held against
// bit for bit is hocuspocus_tpu_torch/tpu/kernels.py::integrate_op_slots
// (dense) and ::integrate_op_slots_sparse (routed).
//
// Per op the body makes passes over the row's occupied units: an applied
// insert four (origin maxes, first-block min, skipped count, then the
// bump of ranks at/after the insertion rank and the fill of the new
// units), a delete one (id-range tombstones), an insert dropped for a
// missing origin or overflow only the first. Each of the insert's first
// three passes ends in a reduction. The skipped-count pass stays a count:
// `min(first_block, right_rank) - left_rank - 1` equals it only while
// ranks are a permutation, and the plain version counts.
//
// What bounds it on this card: at the plane's shapes (D = 1024 routed
// rows of about 200 units in a row of N = 4096, K = 16) neither bytes
// nor operations but the latency of the K dependent op steps, each a
// chain of three reductions and up to eight op-field loads; at the bench
// shape (N = 5632, rows of about 1,400 units, K = 64) integer operations
// over the occupied units. The design:
//
// - Warp path. One warp per routed column, kWarpRows warps a CTA; a
//   padding column (slot outside [0, num_docs)) idles only its warp.
//   Each warp holds a window of S units of dynamic shared memory
//   (S = `window`, chosen by the dispatcher, integrate.py::_warp_window:
//   at most 512, so 8 warps take 68 KB and the plane's 1,024 rows sit in
//   one wave of 128 CTAs on 132 SMs). Unit i belongs to lane i % 32 for
//   the whole launch (load, every pass, the fill, store), so the lanes
//   exchange only warp reductions (one redux.sync each): no barrier and
//   no __syncwarp.
//   The K ops are prefetched once (lane l holds slots l and l + 32 of
//   each 64-slot chunk in registers) and each step takes its op by
//   __shfl_sync, so no global load sits on the chain.
// - Fit test. A row runs on the warp path when every unit it can touch
//   lies in its window: min(N, occupied(length) + the sum of the
//   column's positive insert run_lens) <= S.
// - CTA path. A row that does not fit runs the same body CTA-wide, unit
//   i owned by thread i % (CTA size), one barrier per block reduction,
//   the ops from a shared-memory chunk. Where a whole row fits the CTA's
//   pool of windows (N <= 8 S, the plane's N = 4096 included), the CTA
//   of 256 threads takes its warps' misfit rows after them in the same
//   launch, each in the pool. A wider row (the bench's N = 5632) runs in
//   a second launch over the same slots, one CTA of 512 threads per
//   column, the row in shared memory, or in global memory past the
//   opt-in limit: the first launch writes a (B,) `done` flag per column
//   and the second skips done columns, so it never re-decides from the
//   row, which the first launch has already changed. When S >= N every
//   row fits and the CTA path never runs.
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

constexpr int kThreads = 512;  // CTA path, second launch
constexpr int kWarpRows = 8;  // warp path: routed columns (warps) a CTA
constexpr int kOpChunk = 64;  // op slots prefetched at a time
constexpr int kOpFields = 8;
constexpr int kMaxReduce = 2;  // values in the widest reduction
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
  int* idc;
  int* idk;
  int* rank;
  int* orank;
  uint8_t* del;

  __device__ void copy_from(const Row& src, size_t src_base, int i) const {
    idc[i] = src.idc[src_base + i];
    idk[i] = src.idk[src_base + i];
    rank[i] = src.rank[src_base + i];
    orank[i] = src.orank[src_base + i];
    del[i] = src.del[src_base + i];
  }

  __device__ void copy_to(const Row& dst, size_t dst_base, int i) const {
    dst.idc[dst_base + i] = idc[i];
    dst.idk[dst_base + i] = idk[i];
    dst.rank[dst_base + i] = rank[i];
    dst.orank[dst_base + i] = orank[i];
    dst.del[dst_base + i] = del[i];
  }

  // A row's fields laid out one after another in `ints` / `bytes`, with
  // `stride` units between the int fields.
  __device__ static Row carve(int* ints, int stride, uint8_t* bytes) {
    return Row{ints, ints + stride, ints + 2 * stride, ints + 3 * stride, bytes};
  }
};

__device__ __forceinline__ int occupied(int length, int capacity) {
  return min(max(length, 0), capacity);
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

// The K op steps on one row of capacity n (`row` holds its occupied
// prefix; unit i belongs to member i % G::kSize). The caller has loaded
// the first op chunk. The per-row scalars and every reduction result
// are uniform across the group.
template <typename G>
__device__ void integrate_row(G& g, const Row& row, int n, int& length, int& ovf, const Ops& ops,
                              int num_slots, int batch, int col) {
  const int tid = g.tid;
  for (int k = 0; k < num_slots; ++k) {
    if (k > 0 && k % kOpChunk == 0) g.load_ops(ops, k, num_slots, batch, col);
    // units [0, occ) are occupied (a length outside [0, n] reads as the
    // JAX program's `idx < length` mask does)
    const int occ = occupied(length, n);
    const int kind = g.template take<kKind>(k);
    const int op_client = g.template take<kClient>(k);
    const int op_clock = g.template take<kClock>(k);
    const int run = g.template take<kRun>(k);

    if (kind == kDelete) {
      // id-range tombstones over occupied slots
      const int end = wadd(op_clock, run);
#pragma unroll 4
      for (int i = tid; i < occ; i += G::kSize) {
        const int c = row.idk[i];
        if (row.idc[i] == op_client && c >= op_clock && c < end) row.del[i] = 1;
      }
      continue;
    }
    if (kind != kInsert) continue;  // noop (or unknown kind): no effect

    const int lc = g.template take<kLeftClient>(k), lk = g.template take<kLeftClock>(k);
    const int rc = g.template take<kRightClient>(k), rk = g.template take<kRightClock>(k);

    // 1. resolve origin ids to ranks: masked row maxes, one pass
    int origin[2] = {-1, -1};
#pragma unroll 4
    for (int i = tid; i < occ; i += G::kSize) {
      const int c = row.idc[i], t = row.idk[i], r = row.rank[i];
      if (c == lc && t == lk) origin[0] = max(origin[0], r);
      if (c == rc && t == rk) origin[1] = max(origin[1], r);
    }
    g.template reduce<2, Max>(origin);
    const bool has_left = lc != kNone, has_right = rc != kNone;
    const int left_rank = has_left ? origin[0] : -1;
    const int right_rank = has_right ? origin[1] : length;
    // int32 arithmetic with wraparound, as in the plain version
    const int new_length = wadd(length, run);
    const bool fits = new_length <= n;
    if (!fits) ovf = 1;  // sticky
    const bool deps_ok = (!has_left || origin[0] >= 0) && (!has_right || origin[1] >= 0);
    if (!(fits && deps_ok)) continue;  // dropped: nothing else changes

    // 2. YATA conflict scan: first blocked rank in the window
    const unsigned op_client_u = static_cast<unsigned>(op_client);
    int first_block[1] = {kInf};
#pragma unroll 4
    for (int i = tid; i < occ; i += G::kSize) {
      const int r = row.rank[i];
      if (r > left_rank && r < right_rank) {
        const int o = row.orank[i];
        const bool skip =
            o > left_rank || (o == left_rank && static_cast<unsigned>(row.idc[i]) < op_client_u);
        if (!skip) first_block[0] = min(first_block[0], r);
      }
    }
    g.template reduce<1, Min>(first_block);

    // 3. units skipped before the first blocked one
    int skipped[1] = {0};
#pragma unroll 4
    for (int i = tid; i < occ; i += G::kSize) {
      const int r = row.rank[i];
      skipped[0] += (r > left_rank && r < right_rank && r < first_block[0]) ? 1 : 0;
    }
    g.template reduce<1, Sum>(skipped);
    const int ins_rank = wadd(wadd(left_rank, 1), skipped[0]);

    // 4. bump ranks at/after the insertion rank, then fill the new units
    //    [length, length + run) that lie inside the row, each by the
    //    member that owns it
#pragma unroll 4
    for (int i = tid; i < occ; i += G::kSize) {
      const int r = row.rank[i], o = row.orank[i];
      if (r >= ins_rank) row.rank[i] = wadd(r, run);
      if (o >= ins_rank) row.orank[i] = wadd(o, run);
    }
    const int start = max(length, 0);
    const int fill_end =
        static_cast<int>(min(static_cast<long long>(length) + run, static_cast<long long>(n)));
    for (int i = start - start % G::kSize + tid; i < fill_end; i += G::kSize) {
      if (i < start) continue;
      const int off = static_cast<int>(static_cast<long long>(i) - length);
      row.idc[i] = op_client;
      row.idk[i] = wadd(op_clock, off);
      row.rank[i] = wadd(ins_rank, off);
      row.orank[i] = off == 0 ? left_rank : wadd(wadd(ins_rank, off), -1);
      row.del[i] = 0;
    }
    length = new_length;
  }
}

struct Scalars {
  int* length;
  uint8_t* overflow;
};

// One row on the CTA path: its occupied prefix in `smem_row` (or, when
// that is null, the row itself in global memory), the K ops, the row
// written back. Every thread of the CTA calls it for the same column.
template <int kSize>
__device__ void cta_row(const Row& g, const Scalars& s, int slot, int n, const Ops& ops,
                        int num_slots, int batch, int col, int* smem_row, int* scratch,
                        int* op_buf) {
  const size_t base = static_cast<size_t>(slot) * n;
  const int tid = threadIdx.x;
  int length = s.length[slot];
  int ovf = s.overflow[slot];
  BlockGroup<kSize> group(tid, scratch, op_buf);
  group.load_ops(ops, 0, num_slots, batch, col);
  Row row;
  if (smem_row != nullptr) {
    row = Row::carve(smem_row, n, reinterpret_cast<uint8_t*>(smem_row + 4 * n));
    const int occ0 = occupied(length, n);
#pragma unroll 4
    for (int i = tid; i < occ0; i += kSize) row.copy_from(g, base, i);
  } else {
    row = Row{g.idc + base, g.idk + base, g.rank + base, g.orank + base, g.del + base};
  }
  integrate_row(group, row, n, length, ovf, ops, num_slots, batch, col);
  if (smem_row != nullptr) {
    const int occ = occupied(length, n);
#pragma unroll 4
    for (int i = tid; i < occ; i += kSize) row.copy_to(g, base, i);
  }
  if (tid == 0) {
    s.length[slot] = length;
    s.overflow[slot] = static_cast<uint8_t>(ovf);
  }
}

__global__ void __launch_bounds__(kWarpRows * 32, 2)
integrate_warp_kernel(Row g, Scalars s, int num_docs, int capacity, Ops ops, int num_slots,
                      int batch, const int* __restrict__ slots, int window,
                      uint8_t* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[BlockGroup<kWarpRows * 32>::kScratch];
  __shared__ int op_buf[kOpFields * kOpChunk];
  __shared__ uint8_t misfit[kWarpRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarpRows + warp;
  const int n = capacity;
  int* ints = reinterpret_cast<int*>(smem);

  bool cta_takes = false;
  if (col < batch) {
    // the ops first: their loads overlap the slot -> row chain below
    WarpGroup group(lane);
    group.load_ops(ops, 0, num_slots, batch, col);
    const int slot = slots[col];
    if (slot >= 0 && slot < num_docs) {  // else a padding column
      const size_t base = static_cast<size_t>(slot) * n;
      int length = s.length[slot];
      int ovf = s.overflow[slot];
      const int occ0 = occupied(length, n);
      // the units the inserts can add: their positive run lengths, each
      // lane's partial saturated past the window
      int grow[1] = {0};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (group.op[kKind][h] == kInsert)
          grow[0] = min(grow[0] + max(group.op[kRun][h], 0), window + 1);
      for (int k = kOpChunk + lane; k < num_slots; k += 32) {
        const size_t at = static_cast<size_t>(k) * batch + col;
        if (ops.field[kKind][at] == kInsert)
          grow[0] = min(grow[0] + max(ops.field[kRun][at], 0), window + 1);
      }
      group.reduce<1, Sum>(grow);
      const bool fits = min(n, occ0 + grow[0]) <= window;
      if (done != nullptr && lane == 0) done[col] = fits;
      cta_takes = !fits;
      if (fits) {
        const Row row = Row::carve(
            ints + warp * 4 * window, window,
            reinterpret_cast<uint8_t*>(ints + kWarpRows * 4 * window) + warp * window);
#pragma unroll 4
        for (int i = lane; i < occ0; i += 32) row.copy_from(g, base, i);
        integrate_row(group, row, n, length, ovf, ops, num_slots, batch, col);
        const int occ = occupied(length, n);
#pragma unroll 4
        for (int i = lane; i < occ; i += 32) row.copy_to(g, base, i);
        if (lane == 0) {
          s.length[slot] = length;
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
    cta_row<kWarpRows * 32>(g, s, slots[c], n, ops, num_slots, batch, c, ints, scratch, op_buf);
    __syncthreads();  // the pool and the scratch are free for the next row
  }
}

__global__ void __launch_bounds__(kThreads)
integrate_block_kernel(Row g, Scalars s, int num_docs, int capacity, Ops ops, int num_slots,
                       int batch, const int* __restrict__ slots,
                       const uint8_t* __restrict__ done, int row_in_smem) {
  __shared__ int scratch[BlockGroup<kThreads>::kScratch];
  __shared__ int op_buf[kOpFields * kOpChunk];
  extern __shared__ __align__(16) unsigned char smem[];
  const int col = blockIdx.x;
  const int slot = slots[col];
  if (slot < 0 || slot >= num_docs) return;  // padding column
  if (done[col]) return;  // the warp path took this row
  cta_row<kThreads>(g, s, slot, capacity, ops, num_slots, batch, col,
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

// Bytes of dynamic shared memory `capacity` units take.
size_t hp_integrate_row_bytes(int capacity) {
  return static_cast<size_t>(capacity) * (4 * sizeof(int) + 1);
}

// Launch the integrate over `batch` routed columns on `stream`, with a
// warp-path window of `window` units a row. A row that does not fit its
// window runs on the CTA path: in the same launch when a whole row fits
// the CTA's pool of windows (capacity <= 8 * window), else in a second
// launch over the columns the first marks not done in `done`, a (batch,)
// byte scratch that may be null when no second launch is needed. Returns
// the launches' cudaError_t (0 = launched).
int hp_integrate_rows(int* id_client, int* id_clock, int* rank, int* origin_rank,
                      uint8_t* deleted, int* length, uint8_t* overflow, int num_docs,
                      int capacity, const int* kind, const int* client, const int* clock,
                      const int* run_len, const int* left_client, const int* left_clock,
                      const int* right_client, const int* right_clock, int num_slots,
                      int batch, const int* slots, int window, uint8_t* done, void* stream) {
  if (batch <= 0) return 0;
  if (window <= 0) return cudaErrorInvalidValue;
  // a row wider than the CTA's pool of windows takes the CTA path in a
  // second launch
  const bool second_launch = capacity > 1LL * kWarpRows * window;
  if (second_launch && done == nullptr) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t pool_bytes = kWarpRows * hp_integrate_row_bytes(window);
  size_t row_bytes = hp_integrate_row_bytes(capacity);
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
    err = opt_in(reinterpret_cast<const void*>(integrate_warp_kernel), setup.opted[0], pool_bytes);
    if (err != cudaSuccess) return err;
    if (second_launch) {
      const size_t static_bytes = BlockGroup<kThreads>::kScratch * sizeof(int) + op_bytes;
      in_smem = row_bytes + static_bytes <= static_cast<size_t>(setup.optin) ? 1 : 0;
      if (!in_smem) row_bytes = 0;
      err = opt_in(reinterpret_cast<const void*>(integrate_block_kernel), setup.opted[1],
                   row_bytes);
      if (err != cudaSuccess) return err;
    }
  }
  const Row row{id_client, id_clock, rank, origin_rank, deleted};
  const Scalars scalars{length, overflow};
  const Ops ops{{kind, client, clock, run_len, left_client, left_clock, right_client, right_clock}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  integrate_warp_kernel<<<(batch + kWarpRows - 1) / kWarpRows, kWarpRows * 32, pool_bytes, s>>>(
      row, scalars, num_docs, capacity, ops, num_slots, batch, slots, window,
      second_launch ? done : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !second_launch) return err;
  integrate_block_kernel<<<batch, kThreads, row_bytes, s>>>(
      row, scalars, num_docs, capacity, ops, num_slots, batch, slots, done, in_smem);
  return cudaGetLastError();
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
