// The per-lane reductions of the swarm simulator's scan, as sm_90a kernels:
// TK4 lane_sums (the offload series) and TK5 timeline_row (one metrics
// timeline row, and the rebuffer ratio).
//
// The reference is hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py: _scan_swarm's
// step sums p2p_bytes and cdn_bytes with jnp.sum and takes their ratio
// (:1643-1647, offload_ratio :2607-2611), and _timeline_row (:1559-1627)
// reduces the state into one row every record_every steps, with per-cohort
// columns (:1594-1611) when the config has cohorts.  XLA fuses those
// reductions into the scanned program; there was no Pallas kernel.
//
// Layout: lanes as in swarm_step.cu.  Per-peer arrays are [B, P], float32
// (int32 for `level`); lane b's rows start at b * P (64-bit).  The grid is
// (n_blocks, B): n_blocks blocks per lane, each summing a fixed contiguous
// range of the lane's peers (lane_sums: one super-partial of LS_SUPER
// peers, as in lane_sums.cuh; timeline_row: ops/swarm_kernels.py
// reduce_blocks).
//
// Determinism: no float atomics.  lane_sums sums in lane_sums.cuh's order.
// In timeline_row each thread sums its strided share of the block's range
// in order, the block sums its threads' values by a fixed tree in shared
// memory, and writes one partial per quantity; the last block of a lane to
// finish (an integer arrival counter per lane, which that block sets back
// to 0) sums the lane's partials in block order by the same scheme.
// n_blocks depends on P alone, so a lane's sums are the same bits whatever
// the batch it runs in, and from run to run.  Counts are summed as
// integers in shared memory and as float32 across blocks, which is exact
// below 2^24.
//
// What bounds these kernels on an H100: bytes.  Each reads its [B, P]
// arrays once (8 B a peer for lane_sums, 20-24 B for timeline_row, 12 B
// more with cohorts) and does a few operations per element; the partials
// are 8 B a super-partial of 8,192 peers for lane_sums and a few KB for
// timeline_row.
//
// Numerics: built with --fmad=false like swarm_step.cu.  The ratios are
// IEEE divisions; the interval rates multiply by one float32 constant
// (`rate`), as XLA folds the reference's `* 8.0 / interval_s`.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_sums.cuh"

#define RBLOCK 256      // threads per block; a power of two
#define MAX_LEVELS 16   // the row's level columns
#define MAX_EDGES 32    // the stall digest's edges
#define MAX_COHORTS 8   // the row's cohorts, 3 columns and 4 quantities each
#define MAX_QUANT (3 + MAX_LEVELS + MAX_EDGES + 1 + 4 * MAX_COHORTS)

// [begin, end) of block blk's peers among P peers cut into n_blocks ranges
__device__ __forceinline__ void block_range(long long P, int n_blocks,
                                            int blk, long long* begin,
                                            long long* end) {
  const long long chunk = (P + n_blocks - 1) / n_blocks;
  *begin = (long long)blk * chunk;
  *end = min(P, *begin + chunk);
}

// The block's sum of v in a fixed order: a tree over the threads in
// shared memory.  Every thread returns the sum.
__device__ __forceinline__ float block_sum(float* red, float v) {
  const int tid = threadIdx.x;
  __syncthreads();  // red may still be read from a previous call
  red[tid] = v;
  __syncthreads();
  for (int s = RBLOCK / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// Whether this block is the last of its lane to finish; if so, the
// partials of every block of the lane are visible to it.
__device__ __forceinline__ bool last_block(int* counters, int lane,
                                           int n_blocks) {
  __shared__ bool last;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int arrived =
        atomicAdd(reinterpret_cast<unsigned int*>(&counters[lane]), 1u);
    last = arrived == (unsigned int)n_blocks - 1u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Quantity q summed over the lane's n_blocks partials (stride nq), in
// block order; every thread returns it.
__device__ __forceinline__ float lane_total(float* red, const float* part,
                                            int n_blocks, int nq, int q) {
  float v = 0.0f;
  for (int k = threadIdx.x; k < n_blocks; k += RBLOCK)
    v += __ldcg(&part[(long long)k * nq + q]);
  return block_sum(red, v);
}

// ---------------------------------------------------------------------------
// TK4 lane_sums
//
// Replaces: the two jnp.sums and the ratio of _scan_swarm's step
// (swarm_sim.py:1643-1647) and offload_ratio (:2607-2611).  Per lane:
// sums[b] = (cdn, p2p) over the lane's peers and, when `series` is given,
// series[b * series_stride + column] = p2p / max(p2p + cdn, 1).  Inside the
// step TK3 peer_update computes the same in its epilogue (swarm_step.cu);
// this kernel serves the reductions outside the step (a timeline's first
// interval, offload_ratio).  Both sum in lane_sums.cuh's order, so the two
// give the same bits.
//
// Design for the H100: one thread block of LS_WARPS warps per
// super-partial (LS_SUPER = 8,192 peers, 64 KB of the two arrays), grid
// (n_blocks = ceil(P / LS_SUPER), B), where one thread block per 256 peers
// would make 196,608 tiny blocks and as many arrivals at B = 48.  Warp
// w sums the block's partials w, w + 8, w + 16 and w + 24: for each, lane
// t loads peers t, t + 32, ..., t + 224 of both arrays (coalesced, through
// the read-only path) and ls_partial8 adds them in lane_sums.cuh's order.
// The warps' partials meet in shared memory, warp 0 takes the
// super-partial's tree, writes it and arrives at the lane's counter (one
// atomic a thread block); the lane's last block sums the lane's
// super-partials (4 a warp lane at 1,048,576 peers).
struct LaneSumsArgs {
  const float* p2p_bytes;
  const float* cdn_bytes;
  float* partials;  // [B, n_blocks, 2]: the lanes' super-partials
  int* counters;    // [>= B], zero between launches
  float* sums;      // [B, 2]: cdn, p2p
  float* series;    // null: sums only
  long long n_peers;
  long long series_stride;
  int n_lanes;
  int n_blocks;     // super-partials a lane
  int column;
};

#define LS_WARPS (LS_THREADS / 32)     // warps of a TK4 block
#define LS_LOADS (LS_FAN / LS_WARPS)   // partials a warp

__global__ void __launch_bounds__(LS_THREADS) lane_sums_kernel(
    const LaneSumsArgs a) {
  __shared__ float2 part_s[LS_FAN];
  const int lane = blockIdx.y, j = blockIdx.x;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long P = a.n_peers;
  const float* cdn = a.cdn_bytes + (long long)lane * P;
  const float* p2p = a.p2p_bytes + (long long)lane * P;
#pragma unroll
  for (int i = 0; i < LS_LOADS; ++i) {
    const int m = w + LS_WARPS * i;  // the partial within the super
    const long long base =
        (long long)j * LS_SUPER + (long long)m * LS_THREADS + t;
    float c[8], p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long q = base + 32 * k;
      c[k] = q < P ? __ldg(cdn + q) : 0.0f;
      p[k] = q < P ? __ldg(p2p + q) : 0.0f;
    }
    const float2 b = make_float2(ls_partial8(c), ls_partial8(p));
    if (t == 0) part_s[m] = b;
  }
  __syncthreads();
  if (w != 0) return;
  const float2 s = ls_warp_sum2(part_s[t]);
  float* sup = a.partials + (long long)lane * a.n_blocks * 2;
  if (t == 0) reinterpret_cast<float2*>(sup)[j] = s;
  if (!ls_arrive(&a.counters[lane], gridDim.x)) return;
  const LsOut out = {a.sums, a.series, a.series_stride, a.column, nullptr,
                     0.0f};
  ls_finish(sup, a.n_blocks, lane, out);
}

// ---------------------------------------------------------------------------
// TK5 timeline_row
//
// Replaces: _timeline_row (swarm_sim.py:1559-1627), and the sums of
// rebuffer_ratio (:2613-2631).  Per lane, at the clock t_s[b]: the rebuffer
// sum and the watched sum  sum(clip(min(leave, t) - join, 0)), and in row
// mode (prev_rebuffer given) also the stalled count (rebuffer_s >
// prev_rebuffer, every peer), the present-peer count per level, with
// n_cohorts > 0 per cohort k (:1594-1611) the present peers and the
// stalled peers whose cohort_id is k and the sums of their p2p_bytes and
// cdn_bytes, and, with n_edges > 0, the stall digest: each present peer's
// interval stall in ms binned by searchsorted(edges, ms, side="left"),
// i.e. the number of edges below it.  The row is
//   t, offload, rebuffer, cdn_rate, p2p_rate, stalled, level_0..L-1,
//   (cohort_k_peers, cohort_k_stalled, cohort_k_offload) for each k,
//   bin_0..n_edges
// with the offload and the rates from this step's `sums` (peer_update's
// epilogue, or lane_sums) and the previous sample's `prev_sums`, and
// cohort_k_offload = p2p_k / max(p2p_k + cdn_k, 1), an IEEE division;
// then prev_sums and prev_rebuffer take this sample's values (one writer
// per element).  Without prev_rebuffer (ratio mode) it writes the
// rebuffer ratio alone, to row[b * row_stride], summed exactly as the
// row's rebuffer column is.
//
// Cohorts are a template parameter (COH): the instantiation without them
// reads no cohort_id, p2p_bytes or cdn_bytes and compiles the kernel's
// code before cohorts (the cohort fields sit at the end of the argument
// struct, so the others keep their offsets).  With them, each thread keeps
// MAX_COHORTS pairs of byte sums in registers (the cohort loop unrolled, a
// peer adding its bytes to its own cohort's pair and 0 to the others',
// which leaves them as they were), the block sums each by the fixed tree,
// and the lane's last block sums the blocks' partials in block order, as
// the rebuffer sum: a lane's cohort columns are the same bits batched or
// alone.  The two counts a cohort are integer atomics in shared memory, as
// the level counts.
//
// Quantities, in the partials' order: 0 rebuffer, 1 watched, 2 stalled,
// the levels, the digest bins, then per cohort (p2p_k, cdn_k, peers_k,
// stalled_k).
struct TimelineArgs {
  const float* t_s;
  const float* join_s;
  const float* leave_s;
  const float* rebuffer_s;
  float* prev_rebuffer;  // null: ratio mode
  const int* level;
  const float* sums;     // [B, 2]: cdn, p2p of this step
  float* prev_sums;      // [B, 2], updated
  const float* edges;    // [n_edges], ascending
  float* partials;       // [B, n_blocks, n_quant]
  int* counters;         // [>= B], zero between launches
  float* row;            // lane b's row at row + b * row_stride
  long long n_peers;
  long long row_stride;
  int n_lanes;
  int n_blocks;
  int n_levels;
  int n_edges;           // 0: no stall digest
  float rate;            // 8 / interval_s, one float32 constant
  const int* cohort_id;  // [B, P]; read only with n_cohorts > 0
  const float* p2p_bytes;
  const float* cdn_bytes;
  int n_cohorts;         // 0: no cohort columns (the COH = false kernel)
};

template <bool COH>
__global__ void __launch_bounds__(RBLOCK) timeline_row_kernel(
    const TimelineArgs a) {
  __shared__ float red[RBLOCK];
  __shared__ int counts[MAX_QUANT];  // [2] stalled, [3 + l] levels, bins
  __shared__ float edges_s[MAX_EDGES];
  __shared__ float tot[MAX_QUANT];
  const int lane = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const long long lb = (long long)lane * a.n_peers;
  const bool row_mode = a.prev_rebuffer != nullptr;
  const int n_bins = a.n_edges > 0 ? a.n_edges + 1 : 0;
  // the cohorts' quantities start at q_co, 4 a cohort
  const int nc = COH && row_mode ? a.n_cohorts : 0;
  const int q_co = 3 + a.n_levels + n_bins;
  // quantities: 0 rebuffer sum, 1 watched sum, 2 stalled, then levels, bins
  const int nq = row_mode ? 3 + a.n_levels + n_bins + 4 * nc : 2;
  for (int q = tid; q < MAX_QUANT; q += RBLOCK) counts[q] = 0;
  for (int e = tid; e < a.n_edges; e += RBLOCK) edges_s[e] = a.edges[e];
  __syncthreads();

  const float t = a.t_s[lane];
  long long begin, end;
  block_range(a.n_peers, a.n_blocks, blk, &begin, &end);
  float reb = 0.0f, watched = 0.0f;
  float p2p_c[COH ? MAX_COHORTS : 1], cdn_c[COH ? MAX_COHORTS : 1];
#pragma unroll
  for (int k = 0; k < (COH ? MAX_COHORTS : 1); ++k) {
    p2p_c[k] = 0.0f;
    cdn_c[k] = 0.0f;
  }
  for (long long x = begin + tid; x < end; x += RBLOCK) {
    const long long r = lb + x;
    const float rb = a.rebuffer_s[r];
    const float join = a.join_s[r], leave = a.leave_s[r];
    reb += rb;
    watched += fmaxf(fminf(leave, t) - join, 0.0f);
    if (!row_mode) continue;
    const float prev = a.prev_rebuffer[r];
    const int lv = a.level[r];
    const bool present = (t >= join) && (t < leave);
    if (rb > prev) atomicAdd(&counts[2], 1);
    if (present && lv >= 0 && lv < a.n_levels) atomicAdd(&counts[3 + lv], 1);
    if (n_bins > 0 && present) {
      const float ms = (rb - prev) * 1000.0f;
      int idx = 0;
      for (int e = 0; e < a.n_edges; ++e) idx += edges_s[e] < ms ? 1 : 0;
      atomicAdd(&counts[3 + a.n_levels + idx], 1);
    }
    if (COH && nc > 0) {
      const int c = a.cohort_id[r];
      if (c >= 0 && c < nc) {
        if (present) atomicAdd(&counts[q_co + 4 * c + 2], 1);
        if (rb > prev) atomicAdd(&counts[q_co + 4 * c + 3], 1);
        const float p = a.p2p_bytes[r], d = a.cdn_bytes[r];
#pragma unroll
        for (int k = 0; k < (COH ? MAX_COHORTS : 1); ++k) {
          p2p_c[k] += c == k ? p : 0.0f;
          cdn_c[k] += c == k ? d : 0.0f;
        }
      }
    }
    a.prev_rebuffer[r] = rb;
  }
  float* part = a.partials + ((long long)lane * a.n_blocks + blk) * nq;
  const float br = block_sum(red, reb);
  const float bw = block_sum(red, watched);
  if (tid == 0) {
    part[0] = br;
    part[1] = bw;
  }
  for (int q = 2 + tid; q < nq; q += RBLOCK) {
    // the cohorts' byte sums are written below, by the block's tree
    if (COH && q >= q_co && ((q - q_co) & 3) < 2) continue;
    part[q] = (float)counts[q];
  }
  if (COH) {
#pragma unroll
    for (int k = 0; k < (COH ? MAX_COHORTS : 1); ++k) {
      if (k >= nc) break;  // nc is the same for every thread of the block
      const float bp = block_sum(red, p2p_c[k]);
      const float bc = block_sum(red, cdn_c[k]);
      if (tid == 0) {
        part[q_co + 4 * k] = bp;
        part[q_co + 4 * k + 1] = bc;
      }
    }
  }
  if (!last_block(a.counters, lane, a.n_blocks)) return;

  const float* lp = a.partials + (long long)lane * a.n_blocks * nq;
  for (int q = 0; q < nq; ++q) {
    const float v = lane_total(red, lp, a.n_blocks, nq, q);
    if (tid == 0) tot[q] = v;
  }
  if (tid != 0) return;
  float* row = a.row + lane * a.row_stride;
  const float rebuffer = tot[0] / fmaxf(tot[1], 1e-9f);
  a.counters[lane] = 0;
  if (!row_mode) {
    row[0] = rebuffer;
    return;
  }
  const float cdn = a.sums[2 * lane], p2p = a.sums[2 * lane + 1];
  row[0] = t;
  row[1] = p2p / fmaxf(p2p + cdn, 1.0f);
  row[2] = rebuffer;
  row[3] = (cdn - a.prev_sums[2 * lane]) * a.rate;
  row[4] = (p2p - a.prev_sums[2 * lane + 1]) * a.rate;
  // stalled, the levels and (past the cohorts' 3 columns each) the bins;
  // then per cohort its two counts and its offload
  for (int q = 2; q < nq - 4 * nc; ++q)
    row[q + 3 + (COH && q >= 3 + a.n_levels ? 3 * nc : 0)] = tot[q];
  if (COH) {
    for (int k = 0; k < nc; ++k) {
      const float* v = tot + q_co + 4 * k;
      float* col = row + 6 + a.n_levels + 3 * k;
      col[0] = v[2];
      col[1] = v[3];
      col[2] = v[0] / fmaxf(v[0] + v[1], 1.0f);
    }
  }
  a.prev_sums[2 * lane] = cdn;
  a.prev_sums[2 * lane + 1] = p2p;
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes.  Each launches on the caller's stream
// and returns cudaGetLastError(), so a refused launch reaches the caller.

extern "C" int reduce_lane_sums(const LaneSumsArgs* a, void* stream) {
  if (a->n_peers <= 0 ||
      a->n_blocks != (a->n_peers + LS_SUPER - 1) / LS_SUPER)
    return (int)cudaErrorInvalidValue;
  if (a->n_lanes > 0)
    lane_sums_kernel<<<dim3((unsigned int)a->n_blocks,
                            (unsigned int)a->n_lanes),
                       LS_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int reduce_timeline_row(const TimelineArgs* a, void* stream) {
  if (a->n_peers <= 0 || a->n_blocks <= 0 || a->n_levels < 0 ||
      a->n_levels > MAX_LEVELS || a->n_edges < 0 ||
      a->n_edges > MAX_EDGES || a->n_cohorts < 0 ||
      a->n_cohorts > MAX_COHORTS ||
      (a->n_cohorts > 0 && (a->prev_rebuffer == nullptr ||
                            a->cohort_id == nullptr ||
                            a->p2p_bytes == nullptr ||
                            a->cdn_bytes == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)a->n_blocks, (unsigned int)a->n_lanes);
  if (a->n_lanes > 0 && a->n_cohorts > 0)
    timeline_row_kernel<true><<<grid, RBLOCK, 0, (cudaStream_t)stream>>>(*a);
  else if (a->n_lanes > 0)
    timeline_row_kernel<false><<<grid, RBLOCK, 0, (cudaStream_t)stream>>>(
        *a);
  return (int)cudaGetLastError();
}

// Load every kernel of this library onto the card now (see swarm_step.cu
// swarm_preload).
extern "C" int reduce_preload(void) {
  cudaFuncAttributes attr;
  const void* kernels[] = {(const void*)lane_sums_kernel,
                           (const void*)timeline_row_kernel<false>,
                           (const void*)timeline_row_kernel<true>};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Struct sizes, so the Python side can check its ctypes mirrors.
extern "C" int reduce_args_sizes(long long* out) {
  out[0] = (long long)sizeof(LaneSumsArgs);
  out[1] = (long long)sizeof(TimelineArgs);
  return 0;
}
