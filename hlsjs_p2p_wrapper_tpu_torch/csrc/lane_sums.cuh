// The offload series' per-lane sums, shared by the two kernels that take
// them: TK3 peer_update's epilogue (swarm_step.cu), which sums the bytes
// counters it has just written, and the standalone TK4 lane_sums
// (swarm_reduce.cu), which sums them from memory outside the step.  Both
// sum by the code below in one order that depends on P alone, so the two
// give the same bits on the same counters: a run's last series entry, its
// final offload ratio and its last timeline row agree exactly, and a lane
// alone gives the bits it gives in a batch.
//
// Order, fixed (no float atomics):
//   1. a partial: LS_THREADS = 256 consecutive peers (zeros past P), as 8
//      runs of 32: each run by the warp's tree (ls_warp_sum: lane t adds
//      lane t + s at strides s = 16..1), then the 8 runs' sums by the
//      tree of strides 4, 2, 1;
//   2. a super-partial: LS_FAN = 32 consecutive partials (zeros past the
//      lane's last), lane t holding partial t, by the warp's tree;
//   3. the lane: lane t adds super-partials t, t + 32, ... in order, then
//      the warp's tree.
// Level 1 is peer_update's thread block of 256 threads, one peer each:
// every warp takes its run's tree before the block's barrier, so that
// warp 0 is left with 8 values (ls_block_sum).  TK4 takes a partial in
// one warp: lane t loads peers t, t + 32, ..., t + 224 (coalesced) and a
// butterfly of xor shuffles takes the 8 runs' trees and the tree over
// them at once (ls_partial8: the same operand pairs at every node, so the
// same bits).  A thread block of TK4 sums a whole super-partial.
//
// Arrival: integer counters, each zero between launches and set back to 0
// by its last arrival; an arrival is one atomic with release and acquire
// semantics by one thread, after it has written what it contributes, and
// the last arrival reads what the others wrote through L2.  TK4 sums a
// whole super-partial in one thread block and arrives once at the lane's
// counter; its last block sums the lane's super-partials.  In
// peer_update, whose grid runs in one wave at B = 1 so that the last
// block's tail is the kernel's end, each thread block's warp 0 writes its
// partial and arrives at its super-partial's counter; the last of those
// 32 blocks sums their partials (one load a warp lane), writes the
// super-partial and arrives at the lane's counter; the last of those sums
// the lane's super-partials (one load a warp lane up to 262,144 peers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LS_THREADS 256  // peers per partial: peer_update's thread block
#define LS_FAN 32       // partials per super-partial: a warp's lanes
#define LS_SUPER (LS_THREADS * LS_FAN)  // peers per super-partial

// The sum of v over the warp by the tree of strides 16, 8, 4, 2, 1; lane
// 0 holds it.
__device__ __forceinline__ float ls_warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float2 ls_warp_sum2(float2 v) {
  return make_float2(ls_warp_sum(v.x), ls_warp_sum(v.y));
}

// Level 1 in one warp (TK4): lane t holds v[k], peer 32k + t of the
// partial.  Returns the partial on every lane.  Stages xor 16, 8, 4 halve
// the values a lane keeps while they add across lanes, xor 2 and 1 finish
// the runs' trees (run k = b2 + 2 b3 + 4 b4 of lane t's bits), and xor
// 16, 8, 4 again take the tree over the runs: each add joins the same two
// sets of peers as ls_warp_sum's and ls_block_sum's trees do.
__device__ __forceinline__ float ls_partial8(const float (&v)[8]) {
  const unsigned int full = 0xffffffffu;
  const int t = threadIdx.x & 31;
  const bool b4 = (t & 16) != 0, b3 = (t & 8) != 0, b2 = (t & 4) != 0;
  float u[4], w[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (b4 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(full, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w[i] = (b3 ? u[i + 2] : u[i]) +
           __shfl_xor_sync(full, b3 ? u[i] : u[i + 2], 8);
  float z = (b2 ? w[1] : w[0]) + __shfl_xor_sync(full, b2 ? w[0] : w[1], 4);
  z += __shfl_xor_sync(full, z, 2);
  z += __shfl_xor_sync(full, z, 1);
  z += __shfl_xor_sync(full, z, 16);
  z += __shfl_xor_sync(full, z, 8);
  z += __shfl_xor_sync(full, z, 4);
  return z;
}

// Level 1 in a thread block of LS_THREADS threads, thread i holding peer
// i's v (peer_update): the runs' trees in every warp, then warp 0 over the
// 8 runs.  Lane 0 of warp 0 holds the partial; every thread must call it.
__device__ __forceinline__ float2 ls_block_sum(float2 v, float2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ls_warp_sum2(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < LS_THREADS / 32 ? red[lane] : make_float2(0.0f, 0.0f);
    for (int s = LS_THREADS / 64; s > 0; s >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, s);
      v.y += __shfl_down_sync(0xffffffffu, v.y, s);
    }
  }
  return v;
}

// Whether this thread block's arrival (thread 0 has written what it
// contributes) is the last of n on *counter; if so, thread 0 sets the
// counter back to 0.  The atomic is a release (what thread 0 wrote before
// it is visible first) and an acquire (the last arrival sees what every
// other wrote, which it reads through L2: __ldcg).  Every lane of warp 0,
// and no other warp, calls it.
__device__ __forceinline__ bool ls_arrive(int* counter, unsigned int n) {
  int last = 0;
  if (threadIdx.x == 0) {
    unsigned int arrived;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(arrived)
                 : "l"(counter)
                 : "memory");
    last = arrived == n - 1u;
    if (last) *counter = 0;
  }
  return __shfl_sync(0xffffffffu, last, 0) != 0;
}

// Where a lane's sums go: sums[lane] = (cdn, p2p); with a series, the
// offload ratio p2p / max(p2p + cdn, 1) at series[lane * series_stride +
// column]; with a clock, t_s[lane] = t_next (the step's clock advance,
// computed by the caller from the clock it read earlier, so that the tail
// does not wait on a load).
struct LsOut {
  float* sums;
  float* series;
  long long series_stride;
  int column;
  float* t_s;
  float t_next;
};

// Level 3 by one warp: lane `lane`'s n_sup super-partials at sup
// ([n_sup, 2]), written out by lane 0 as `out` says.
__device__ __forceinline__ void ls_finish(const float* sup, int n_sup,
                                          int lane, const LsOut& out) {
  const int t = threadIdx.x & 31;
  const float2* s = reinterpret_cast<const float2*>(sup);
  float2 v = make_float2(0.0f, 0.0f);
  for (int k = t; k < n_sup; k += 32) {
    const float2 sk = __ldcg(&s[k]);
    v.x += sk.x;
    v.y += sk.y;
  }
  v = ls_warp_sum2(v);
  if (t != 0) return;
  const float c = v.x, p = v.y;
  out.sums[2 * lane] = c;
  out.sums[2 * lane + 1] = p;
  if (out.series != nullptr)
    out.series[lane * out.series_stride + out.column] = p / fmaxf(p + c, 1.0f);
  if (out.t_s != nullptr) out.t_s[lane] = out.t_next;
}

// Level 2 by one warp: the super-partial j of the lane's n_part partials
// at part ([n_part, 2]); lane 0 holds it.
__device__ __forceinline__ float2 ls_super(const float* part, int n_part,
                                           int j) {
  const int k = j * LS_FAN + (threadIdx.x & 31);
  float2 v = make_float2(0.0f, 0.0f);
  if (k < n_part) v = __ldcg(reinterpret_cast<const float2*>(part) + k);
  return ls_warp_sum2(v);
}

// peer_update's epilogue, by warp 0 of thread block (blk, lane), lane 0
// holding the block's partial b: the partial to scratch, then the two
// arrivals.  scratch is [n_lanes, n_part + n_sup, 2]: a lane's partials,
// then its super-partials; counters holds the lanes' arrivals
// ([n_lanes]), then the super-partials' ([n_lanes, n_sup]).
__device__ __forceinline__ void ls_block_epilogue(
    float2 b, float* scratch, int* counters, int n_lanes, int n_part,
    int blk, int lane, const LsOut& out) {
  const int n_sup = (n_part + LS_FAN - 1) / LS_FAN;
  float* part = scratch + (long long)lane * (n_part + n_sup) * 2;
  float* sup = part + (long long)n_part * 2;
  if (threadIdx.x == 0) reinterpret_cast<float2*>(part)[blk] = b;
  const int j = blk / LS_FAN;
  const int in_super = min(LS_FAN, n_part - j * LS_FAN);
  if (!ls_arrive(&counters[n_lanes + (long long)lane * n_sup + j],
                 (unsigned int)in_super))
    return;
  const float2 s = ls_super(part, n_part, j);
  if (threadIdx.x == 0) reinterpret_cast<float2*>(sup)[j] = s;
  if (!ls_arrive(&counters[lane], (unsigned int)n_sup)) return;
  ls_finish(sup, n_sup, lane, out);
}
