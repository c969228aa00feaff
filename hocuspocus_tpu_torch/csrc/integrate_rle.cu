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
// occupied. Per op the kernel makes a few passes over the occupied
// entries, each followed by one block reduction:
//   insert: origin ranks by range membership (max of two values), the
//           first blocking rank among run heads and the in-run successor
//           (min), the run straddling the insertion rank (five masked
//           sums), then one pass that shortens that run and bumps ranks;
//           the run's tail and the new run are appended at num_runs;
//   delete: for each of the two id bounds, the run straddling it (four
//           masked sums), a pass that shortens it and an appended tail;
//           then a pass that tombstones the covered runs.
// The split fields are extracted with masked sums over every matching
// entry, exactly as the TPU kernel does, so the result is the plain
// version's even when ids repeat.
//
// What bounds it on this card: at the plane's shapes, the latency of the
// K dependent op steps, each a chain of block reductions; at the bench
// shape, integer operations over the occupied entries. The row is read
// once and written once (21 bytes an entry). The design keeps every pass
// on-chip and every step cheap (chip_smoke.py counts bytes and
// operations for its inputs):
//
// - One CTA per routed row. The kernel takes the whole state plus a (B,)
//   slot vector and updates rows IN PLACE; a column whose slot is outside
//   [0, num_docs) is padding and does nothing. The dense step passes
//   slots = arange(D), the sparse step the busy rows: no gather/scatter.
// - The row lives in dynamic shared memory, sized for all R entries
//   (21 B each: 21.5 KB at R = 1024, 86 KB at R = 4096, opted in above
//   48 KB), since each op may append two. Its occupied prefix is loaded
//   once, all K ops apply there, and the final occupied prefix is written
//   back once. A row too wide for the opt-in limit runs the same body on
//   global memory.
// - Entry i belongs to thread i % kThreads for the whole launch: it alone
//   loads, reads, writes and stores it, and an appended entry is written
//   by the thread that owns its lane. Threads only exchange the block
//   reductions, whose partials alternate between two scratch buffers, so
//   each reduction costs one barrier and no other barrier is needed.
// - The per-row scalars (num_runs, total_units, overflow) and every
//   reduction result are uniform across the CTA.
//
// Client ids are int32 bit patterns; the one ordered compare (the YATA
// client-id tiebreak) is made on uint32. int32 sums and offsets wrap as
// in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxReduce = 5;  // values in the widest block reduction
constexpr int kInf = 0x7FFFFFFF;
constexpr int kNone = -1;  // NONE_CLIENT as an int32 bit pattern
constexpr int kInsert = 1;
constexpr int kDelete = 2;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

struct Max {
  static constexpr int kIdentity = -0x7FFFFFFF - 1;
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Min {
  static constexpr int kIdentity = kInf;
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Sum {
  static constexpr int kIdentity = 0;
  __device__ int operator()(int a, int b) const { return wadd(a, b); }
};

// Block-wide reduction of N values; every thread returns the results.
// Partials go to scratch buffer `parity` (which then flips): a buffer is
// rewritten only two reductions later, after a barrier every reader has
// passed, so one barrier per reduction suffices.
template <int N, typename Op>
__device__ __forceinline__ void block_reduce(int (&v)[N], int* scratch, int& parity) {
  const Op op{};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j)
    for (int o = 16; o > 0; o >>= 1) v[j] = op(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
  int* buf = scratch + parity * kMaxReduce * kWarps;
  parity ^= 1;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) buf[j * kWarps + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int x = Op::kIdentity;
    if (lane < kWarps) x = buf[j * kWarps + lane];
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
    v[j] = x;
  }
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

struct Row {
  int* client;
  int* clock;
  int* len;
  int* rank;
  int* orank;
  uint8_t* deleted;

  __device__ void put(int i, int c, int k, int l, int r, int o, int d) const {
    client[i] = c;
    clock[i] = k;
    len[i] = l;
    rank[i] = r;
    orank[i] = o;
    deleted[i] = static_cast<uint8_t>(d);
  }
};

__device__ __forceinline__ int occupied(int num_runs, int entries) {
  return min(max(num_runs, 0), entries);
}

// The lane an append writes, when it lies inside the row (the plain
// version's `idx == num_runs` selects nothing otherwise).
__device__ __forceinline__ bool owns_lane(int lane, int entries) {
  return lane >= 0 && lane < entries && lane % kThreads == static_cast<int>(threadIdx.x);
}

__global__ void __launch_bounds__(kThreads)
integrate_rle_rows_kernel(Row g, int* __restrict__ g_num_runs, int* __restrict__ g_total,
                          uint8_t* __restrict__ g_ovf, int num_docs, int entries, Ops ops,
                          int num_slots, int batch, const int* __restrict__ slots,
                          int row_in_smem) {
  __shared__ int scratch[2 * kMaxReduce * kWarps];
  extern __shared__ __align__(16) unsigned char smem[];

  const int col = blockIdx.x;
  const int slot = slots[col];
  if (slot < 0 || slot >= num_docs) return;  // padding column
  const int R = entries;
  const size_t base = static_cast<size_t>(slot) * R;
  const int tid = threadIdx.x;

  int num_runs = g_num_runs[slot];
  int total = g_total[slot];
  int ovf = g_ovf[slot];
  const int occ0 = occupied(num_runs, R);

  Row row;
  if (row_in_smem) {
    row.client = reinterpret_cast<int*>(smem);
    row.clock = row.client + R;
    row.len = row.clock + R;
    row.rank = row.len + R;
    row.orank = row.rank + R;
    row.deleted = reinterpret_cast<uint8_t*>(row.orank + R);
    for (int i = tid; i < occ0; i += kThreads)
      row.put(i, g.client[base + i], g.clock[base + i], g.len[base + i], g.rank[base + i],
              g.orank[base + i], g.deleted[base + i]);
  } else {
    row = Row{g.client + base, g.clock + base, g.len + base,
              g.rank + base,   g.orank + base, g.deleted + base};
  }
  int parity = 0;

  for (int k = 0; k < num_slots; ++k) {
    const int at = k * batch + col;
    const int kind = ops.kind[at];
    const int op_client = ops.client[at];
    const int op_clock = ops.clock[at];
    const int run = ops.run_len[at];
    // the capacity verdict of this op, before any of its splits
    const bool fits = wadd(num_runs, 2) <= R;

    if (kind == kInsert) {
      const int occ = occupied(num_runs, R);
      const int lc = ops.left_client[at], lk = ops.left_clock[at];
      const int rc = ops.right_client[at], rk = ops.right_clock[at];

      // 1. origin ids -> unit ranks: range membership, masked max
      int origin[2] = {-1, -1};
      for (int i = tid; i < occ; i += kThreads) {
        const int c = row.client[i], t = row.clock[i], r = row.rank[i];
        const int end = wadd(t, row.len[i]);
        if (c == lc && lk >= t && lk < end) origin[0] = max(origin[0], wadd(r, wsub(lk, t)));
        if (c == rc && rk >= t && rk < end) origin[1] = max(origin[1], wadd(r, wsub(rk, t)));
      }
      block_reduce<2, Max>(origin, scratch, parity);
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
      for (int i = tid; i < occ; i += kThreads) {
        const int r = row.rank[i], o = row.orank[i];
        const bool client_ge = !(static_cast<unsigned>(row.client[i]) < op_client_u);
        if (r > left_rank && r < right_rank && (o < left_rank || (o == left_rank && client_ge)))
          first[0] = min(first[0], r);
        if (r < succ && succ < wadd(r, row.len[i]) && succ < right_rank && client_ge)
          first[0] = min(first[0], succ);
      }
      block_reduce<1, Min>(first, scratch, parity);
      const int ins_rank = min(first[0], right_rank);

      // 3. the run straddling the insertion rank: count, client, tail
      //    clock, tail length, tombstone count
      int split[5] = {0, 0, 0, 0, 0};
      for (int i = tid; i < occ; i += kThreads) {
        const int r = row.rank[i], l = row.len[i];
        if (r < ins_rank && ins_rank < wadd(r, l)) {
          const int off = wsub(ins_rank, r);
          split[0] += 1;
          split[1] = wadd(split[1], row.client[i]);
          split[2] = wadd(split[2], wadd(row.clock[i], off));
          split[3] = wadd(split[3], wsub(l, off));
          split[4] += row.deleted[i] ? 1 : 0;
        }
      }
      block_reduce<5, Sum>(split, scratch, parity);

      // 4. shorten the straddled run, bump ranks at/after the insertion
      for (int i = tid; i < occ; i += kThreads) {
        const int r = row.rank[i], o = row.orank[i];
        if (r < ins_rank && ins_rank < wadd(r, row.len[i])) row.len[i] = wsub(ins_rank, r);
        if (r >= ins_rank) row.rank[i] = wadd(r, run);
        if (o >= ins_rank) row.orank[i] = wadd(o, run);
      }
      // the tail at num_runs (its rank is the insertion rank, so it is
      // bumped), then the new run, which is not
      if (split[0] != 0) {
        const int o = wsub(ins_rank, 1);
        if (owns_lane(num_runs, R))
          row.put(num_runs, split[1], split[2], split[3], wadd(ins_rank, run),
                  o >= ins_rank ? wadd(o, run) : o, split[4] != 0);
        num_runs = wadd(num_runs, 1);
      }
      if (owns_lane(num_runs, R))
        row.put(num_runs, op_client, op_clock, run, ins_rank, left_rank, 0);
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
        // the run of op_client straddling `bound`: count, tail rank,
        // tail length, tombstone count
        int split[4] = {0, 0, 0, 0};
        for (int i = tid; i < occ; i += kThreads) {
          const int t = row.clock[i], l = row.len[i];
          if (row.client[i] == op_client && t < bound && bound < wadd(t, l)) {
            const int off = wsub(bound, t);
            split[0] += 1;
            split[1] = wadd(split[1], wadd(row.rank[i], off));
            split[2] = wadd(split[2], wsub(l, off));
            split[3] += row.deleted[i] ? 1 : 0;
          }
        }
        block_reduce<4, Sum>(split, scratch, parity);
        if (split[0] == 0) continue;
        for (int i = tid; i < occ; i += kThreads) {
          const int t = row.clock[i];
          if (row.client[i] == op_client && t < bound && bound < wadd(t, row.len[i]))
            row.len[i] = wsub(bound, t);
        }
        if (owns_lane(num_runs, R))
          row.put(num_runs, op_client, bound, split[2], split[1], wsub(split[1], 1),
                  split[3] != 0);
        num_runs = wadd(num_runs, 1);
      }
      // tombstone every run of op_client inside [op_clock, del_end)
      const int occ = occupied(num_runs, R);
      for (int i = tid; i < occ; i += kThreads) {
        const int t = row.clock[i];
        if (row.client[i] == op_client && t >= op_clock && wadd(t, row.len[i]) <= del_end)
          row.deleted[i] = 1;
      }
    }
    // any other kind is a noop
  }

  if (row_in_smem) {
    const int occ = occupied(num_runs, R);
    for (int i = tid; i < occ; i += kThreads) {
      g.client[base + i] = row.client[i];
      g.clock[base + i] = row.clock[i];
      g.len[base + i] = row.len[i];
      g.rank[base + i] = row.rank[i];
      g.orank[base + i] = row.orank[i];
      g.deleted[base + i] = row.deleted[i];
    }
  }
  if (tid == 0) {
    g_num_runs[slot] = num_runs;
    g_total[slot] = total;
    g_ovf[slot] = static_cast<uint8_t>(ovf);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a row of `entries` entries takes.
size_t hp_integrate_rle_row_bytes(int entries) {
  return static_cast<size_t>(entries) * (5 * sizeof(int) + 1);
}

// Launch the RLE integrate over `batch` routed columns on `stream`.
// Returns the launch's cudaError_t (0 = launched).
int hp_integrate_rle_rows(int* run_client, int* run_clock, int* run_len, int* run_rank,
                          int* run_orank, uint8_t* run_deleted, int* num_runs,
                          int* total_units, uint8_t* overflow, int num_docs, int entries,
                          const int* kind, const int* client, const int* clock,
                          const int* run, const int* left_client, const int* left_clock,
                          const int* right_client, const int* right_clock, int num_slots,
                          int batch, const int* slots, void* stream) {
  if (batch <= 0) return 0;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t static_bytes = 2 * kMaxReduce * kWarps * sizeof(int);
  size_t row_bytes = hp_integrate_rle_row_bytes(entries);
  const int in_smem = row_bytes + static_bytes <= static_cast<size_t>(optin) ? 1 : 0;
  if (!in_smem) row_bytes = 0;
  if (row_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(integrate_rle_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(row_bytes));
    if (err != cudaSuccess) return err;
  }
  Row row{run_client, run_clock, run_len, run_rank, run_orank, run_deleted};
  Ops ops{kind, client, clock, run, left_client, left_clock, right_client, right_clock};
  integrate_rle_rows_kernel<<<batch, kThreads, row_bytes, static_cast<cudaStream_t>(stream)>>>(
      row, num_runs, total_units, overflow, num_docs, entries, ops, num_slots, batch, slots,
      in_smem);
  return cudaGetLastError();
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
