// YATA integrate of K op slots into routed arena rows, for Hopper (sm_90a).
//
// Replaces hocuspocus_tpu/tpu/pallas_kernels.py::_integrate_block_kernel
// (launched there by _integrate_pallas and, through a gather/scatter, by
// _integrate_sparse_pallas). The plain PyTorch version it is held against
// bit for bit is hocuspocus_tpu_torch/tpu/kernels.py::integrate_op_slots
// (dense) and ::integrate_op_slots_sparse (routed).
//
// What bounds it on this card: integer operations. An applied insert
// makes four passes over the row's occupied units (origin maxes,
// first-block min, skipped count, bump), at least 17 int32 operations a
// unit; a delete makes one pass of 5, and an insert dropped for a
// missing origin or overflow only the first pass (6). The row itself is
// read once and written once (17 bytes a unit). At K = 64 op slots the
// operations outweigh the bytes, so the design keeps every pass on-chip
// and cheap (chip_smoke.py counts both for its inputs):
//
// - One CTA per routed row. The kernel takes the whole state plus a
//   (B,) slot vector and updates rows IN PLACE; a column whose slot is
//   outside [0, num_docs) is padding and does nothing. The dense step
//   passes slots = arange(D), the sparse step the busy rows, so neither
//   pays a gather or scatter copy.
// - The row lives in dynamic shared memory: its occupied prefix of the
//   five fields is loaded once, all K ops apply there, and the final
//   occupied prefix is written back once (slots past the final length
//   are untouched, and new slots are written whole by the fill, so
//   nothing else needs to move). A capacity whose row exceeds the
//   opt-in shared-memory limit runs the same body on global memory.
// - Each op's reductions (left/right origin max in one pass, first-block
//   min, skipped count) are warp shuffles plus one shared-memory step
//   across warps; the op's scalars are uniform across the CTA.
//
// Client ids are int32 bit patterns; the one ordered compare (the YATA
// client-id tiebreak) is made on uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 0x7FFFFFFF;
constexpr int kNone = -1;  // NONE_CLIENT as an int32 bit pattern
constexpr int kInsert = 1;
constexpr int kDelete = 2;

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions: every thread returns the block's result. The
// closing barrier lets the scratch be reused by the next reduction.
__device__ __forceinline__ void block_max2(int& a, int& b, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  a = warp_max(lane < kWarps ? scratch[lane] : -1);
  b = warp_max(lane < kWarps ? scratch[kWarps + lane] : -1);
  __syncthreads();
}

__device__ __forceinline__ int block_min(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = warp_min(lane < kWarps ? scratch[lane] : kInf);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = warp_sum(lane < kWarps ? scratch[lane] : 0);
  __syncthreads();
  return v;
}

struct Ops {
  const int* kind;
  const int* client;
  const int* clock;
  const int* run_len;
  const int* left_client;
  const int* left_clock;
  const int* right_client;
  const int* right_clock;
};

__global__ void __launch_bounds__(kThreads)
integrate_rows_kernel(int* __restrict__ g_idc, int* __restrict__ g_idk,
                      int* __restrict__ g_rank, int* __restrict__ g_orank,
                      uint8_t* __restrict__ g_del, int* __restrict__ g_len,
                      uint8_t* __restrict__ g_ovf, int num_docs, int capacity,
                      Ops ops, int num_slots, int batch,
                      const int* __restrict__ slots, int row_in_smem) {
  __shared__ int scratch[2 * kWarps];
  extern __shared__ __align__(16) unsigned char smem[];

  const int col = blockIdx.x;
  const int slot = slots[col];
  if (slot < 0 || slot >= num_docs) return;  // padding column
  const int n = capacity;
  const size_t base = static_cast<size_t>(slot) * n;
  const int tid = threadIdx.x;

  int *idc, *idk, *rank, *orank;
  uint8_t* del;
  int length = g_len[slot];
  int ovf = g_ovf[slot];
  const int len0 = length;
  if (row_in_smem) {
    idc = reinterpret_cast<int*>(smem);
    idk = idc + n;
    rank = idk + n;
    orank = rank + n;
    del = reinterpret_cast<uint8_t*>(orank + n);
    const int occ0 = min(max(len0, 0), n);
    for (int i = tid; i < occ0; i += kThreads) {
      idc[i] = g_idc[base + i];
      idk[i] = g_idk[base + i];
      rank[i] = g_rank[base + i];
      orank[i] = g_orank[base + i];
      del[i] = g_del[base + i];
    }
    __syncthreads();
  } else {
    idc = g_idc + base;
    idk = g_idk + base;
    rank = g_rank + base;
    orank = g_orank + base;
    del = g_del + base;
  }

  for (int k = 0; k < num_slots; ++k) {
    // units [0, occ) are occupied (a length outside [0, n] reads as the
    // JAX program's `idx < length` mask does)
    const int occ = min(max(length, 0), n);
    const int at = k * batch + col;
    const int kind = ops.kind[at];
    const int op_client = ops.client[at];
    const int op_clock = ops.clock[at];
    const int run = ops.run_len[at];

    if (kind == kDelete) {
      // id-range tombstones over occupied slots
      const int end = static_cast<int>(static_cast<unsigned>(op_clock) +
                                        static_cast<unsigned>(run));
      for (int i = tid; i < occ; i += kThreads) {
        const int c = idk[i];
        if (idc[i] == op_client && c >= op_clock && c < end) del[i] = 1;
      }
      __syncthreads();
      continue;
    }
    if (kind != kInsert) continue;  // noop (or unknown kind): no effect

    const int lc = ops.left_client[at], lk = ops.left_clock[at];
    const int rc = ops.right_client[at], rk = ops.right_clock[at];

    // 1. resolve origin ids to ranks: masked row maxes, one pass
    int left_raw = -1, right_raw = -1;
    for (int i = tid; i < occ; i += kThreads) {
      const int c = idc[i], t = idk[i], r = rank[i];
      if (c == lc && t == lk) left_raw = max(left_raw, r);
      if (c == rc && t == rk) right_raw = max(right_raw, r);
    }
    block_max2(left_raw, right_raw, scratch);
    const bool has_left = lc != kNone, has_right = rc != kNone;
    const int left_rank = has_left ? left_raw : -1;
    const int right_rank = has_right ? right_raw : length;
    // int32 arithmetic with wraparound, as in the plain version
    const int new_length = static_cast<int>(static_cast<unsigned>(length) +
                                            static_cast<unsigned>(run));
    const bool fits = new_length <= n;
    if (!fits) ovf = 1;  // sticky
    const bool deps_ok = (!has_left || left_raw >= 0) && (!has_right || right_raw >= 0);
    if (!(fits && deps_ok)) continue;  // dropped: nothing else changes

    // 2. YATA conflict scan: first blocked rank in the window
    const unsigned op_client_u = static_cast<unsigned>(op_client);
    int first_block = kInf;
    for (int i = tid; i < occ; i += kThreads) {
      const int r = rank[i];
      if (r > left_rank && r < right_rank) {
        const int o = orank[i];
        const bool skip =
            o > left_rank ||
            (o == left_rank && static_cast<unsigned>(idc[i]) < op_client_u);
        if (!skip) first_block = min(first_block, r);
      }
    }
    first_block = block_min(first_block, scratch);

    // 3. units skipped before the first blocked one
    int skipped = 0;
    for (int i = tid; i < occ; i += kThreads) {
      const int r = rank[i];
      skipped += (r > left_rank && r < right_rank && r < first_block) ? 1 : 0;
    }
    skipped = block_sum(skipped, scratch);
    const int ins_rank = left_rank + 1 + skipped;

    // 4. bump ranks at/after the insertion rank, fill the new slots
    for (int i = tid; i < occ; i += kThreads) {
      const int r = rank[i], o = orank[i];
      if (r >= ins_rank) rank[i] = r + run;
      if (o >= ins_rank) orank[i] = o + run;
    }
    // new slots [length, length + run) that lie inside the row
    const long long fill_end = min(static_cast<long long>(length) + run,
                                   static_cast<long long>(n));
    for (long long i = max(length, 0) + tid; i < fill_end; i += kThreads) {
      const int off = static_cast<int>(i - length);
      idc[i] = op_client;
      idk[i] = op_clock + off;
      rank[i] = ins_rank + off;
      orank[i] = off == 0 ? left_rank : ins_rank + off - 1;
      del[i] = 0;
    }
    length = new_length;
    __syncthreads();
  }

  if (row_in_smem) {
    const int occ = min(max(length, 0), n);
    for (int i = tid; i < occ; i += kThreads) {
      g_idc[base + i] = idc[i];
      g_idk[base + i] = idk[i];
      g_rank[base + i] = rank[i];
      g_orank[base + i] = orank[i];
      g_del[base + i] = del[i];
    }
  }
  if (tid == 0) {
    g_len[slot] = length;
    g_ovf[slot] = static_cast<uint8_t>(ovf);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a row of `capacity` units takes.
size_t hp_integrate_row_bytes(int capacity) {
  return static_cast<size_t>(capacity) * (4 * sizeof(int) + 1);
}

// Launch the integrate over `batch` routed columns on `stream`. Returns
// the launch's cudaError_t (0 = launched).
int hp_integrate_rows(int* id_client, int* id_clock, int* rank, int* origin_rank,
                      uint8_t* deleted, int* length, uint8_t* overflow,
                      int num_docs, int capacity, const int* kind,
                      const int* client, const int* clock, const int* run_len,
                      const int* left_client, const int* left_clock,
                      const int* right_client, const int* right_clock,
                      int num_slots, int batch, const int* slots, void* stream) {
  if (batch <= 0) return 0;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t static_bytes = 2 * kWarps * sizeof(int);
  size_t row_bytes = hp_integrate_row_bytes(capacity);
  int in_smem = row_bytes + static_bytes <= static_cast<size_t>(optin) ? 1 : 0;
  if (!in_smem) row_bytes = 0;
  if (row_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(integrate_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(row_bytes));
    if (err != cudaSuccess) return err;
  }
  Ops ops{kind, client, clock, run_len, left_client, left_clock, right_client,
          right_clock};
  integrate_rows_kernel<<<batch, kThreads, row_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      id_client, id_clock, rank, origin_rank, deleted, length, overflow,
      num_docs, capacity, ops, num_slots, batch, slots, in_smem);
  return cudaGetLastError();
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
