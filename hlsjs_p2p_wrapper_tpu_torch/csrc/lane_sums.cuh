// The offload series' per-lane sums, shared by the two kernels that take
// them: TK3 peer_update's epilogue (swarm_step.cu), which sums the bytes
// counters it has just written, and the standalone TK4 lane_sums
// (swarm_reduce.cu), which sums them from memory outside the step.  Both
// cut a lane's P peers into the same blocks of LS_THREADS peers and sum by
// the same code below, so the two give the same bits on the same counters:
// a run's last series entry, its final offload ratio and its last timeline
// row agree exactly.
//
// Order, fixed: each block of LS_THREADS peers (one a thread) sums its
// peers' (cdn, p2p) by warp shuffles, then its warps' sums by shuffles in
// warp 0, giving one partial pair.  These blocks are the thread blocks of
// both kernels.  The last thread block of a lane to finish (an integer
// arrival counter per lane, which that block sets back to 0; no float
// atomics) sums the lane's
// partials in block order, strided over warp 0's lanes, then by the warp's
// tree.  The partials depend on P alone, so a lane alone and the same lane
// in a batch give the same bits, run after run.
//
// Cost: the arrival is one fence and one atomic by one thread a thread
// block, and the other warps leave as soon as the block's sums are in
// shared memory; the lane's last block then reads 8 B a partial.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LS_THREADS 256  // peers per block; a multiple of 32
#define LS_WARPS (LS_THREADS / 32)

// The sum of v over the warp, in a fixed tree; lane 0 holds it.
__device__ __forceinline__ float ls_warp_sum(float v, int width) {
  for (int s = width / 2; s > 0; s >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// The block's (x, y) sums in a fixed order; thread 0 holds them.  Every
// thread of the block must call it.
__device__ __forceinline__ float2 ls_block_sum(float2 v, float2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v.x = ls_warp_sum(v.x, 32);
  v.y = ls_warp_sum(v.y, 32);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < LS_WARPS ? red[lane] : make_float2(0.0f, 0.0f);
    v.x = ls_warp_sum(v.x, LS_WARPS);
    v.y = ls_warp_sum(v.y, LS_WARPS);
  }
  return v;
}

// Warp 0 of block blockIdx.x of lane blockIdx.y, after lane 0 has written
// the block's partials to partials[lane, :] ([B, n_partials, 2]), counts
// the block's arrival (counters[lane], zero between launches; gridDim.x
// blocks a lane); the lane's last block sums the lane's n_partials
// partials: lane t of warp 0 the partials t, t + 32, ... in order, then
// the warp's tree.  It writes sums[lane] = (cdn, p2p) and, with a series,
// the offload ratio p2p / max(p2p + cdn, 1) to series[lane * series_stride
// + column], and sets the counter back to 0.  Only warp 0 calls it: the
// other warps are done once the block's sums are in shared memory.
__device__ __forceinline__ void lane_sums_finish(
    const float* partials, int n_partials, int* counters, float* sums,
    float* series, long long series_stride, int column) {
  const int lane = blockIdx.y, t = threadIdx.x;
  int last = 0;
  if (t == 0) {
    __threadfence();  // this block's partials before its arrival
    const unsigned int arrived =
        atomicAdd(reinterpret_cast<unsigned int*>(&counters[lane]), 1u);
    last = arrived == gridDim.x - 1u;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  const float2* part =
      reinterpret_cast<const float2*>(partials) + (long long)lane * n_partials;
  float2 v = make_float2(0.0f, 0.0f);
  for (int k = t; k < n_partials; k += 32) {
    const float2 pk = __ldcg(&part[k]);
    v.x += pk.x;
    v.y += pk.y;
  }
  v.x = ls_warp_sum(v.x, 32);
  v.y = ls_warp_sum(v.y, 32);
  if (t == 0) {
    const float c = v.x, p = v.y;
    sums[2 * lane] = c;
    sums[2 * lane + 1] = p;
    if (series != nullptr)
      series[lane * series_stride + column] = p / fmaxf(p + c, 1.0f);
    counters[lane] = 0;
  }
}
