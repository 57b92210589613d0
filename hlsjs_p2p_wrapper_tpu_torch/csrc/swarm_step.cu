// One step of the circulant VOD swarm simulator as sm_90a kernels: on the
// main path select_admit then TK3 (two launches); for an offset tuple whose
// halo is too wide for select_admit's tile, TK1, TK2 and TK3.
//
// The reference is hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py, whose step is
// jnp code that XLA fuses (its one Pallas kernel, the eligibility stencil
// of ops/pallas_elig.py, was retired).  Each kernel below names the
// reference lines it replaces.  The slice they cover: circulant offsets,
// one transfer slot (max_concurrency == 1), "spread" holder selection, an
// admission cap (max_total_serves > 0) and VOD (live == False).
//
// Layout: TK1-TK3 run one thread per peer over a 1-D grid; select_admit
// runs a tile of peers per block (see there).  Per-peer fields are [P]
// arrays; the packed cache map `avail` is [P, W] u32 (stored by PyTorch as
// int32 with the same bit pattern), `dl_flags` is [P] u32 (bit 0 = slot 0
// active, bit 1 = slot 0 is_p2p).  Scalars that the scenario carries as
// 0-dim device tensors (the clock t_s, the policy knobs) are read through
// pointers, so a step never waits on the host.
//
// What bounds these kernels on an H100: bytes.  They do a few dozen scalar
// operations per peer and no matrix product, so each is a stream over its
// per-peer arrays (3.35 TB/s).  The reference's analytic model
// (step_hbm_breakdown, swarm_sim.py:2668) puts one step at ~625 MB for
// 1,048,576 peers, i.e. ~0.19 ms; that model re-reads and rewrites the
// whole carry.  Here the state is updated in place and the packed map is
// touched only where it is needed: TK1 and select_admit read, per
// requester, one word of each of its K neighbours' rows, TK3 rewrites one
// word of a row only where a transfer completed.  Per-kernel counts are
// computed by chip_smoke.py (kernel_bytes) and printed in its report.
//
// Numerics: built with --fmad=false and without --use_fast_math, so every
// multiply and add rounds on its own, like the separate PyTorch ops of the
// plain versions in ops/swarm_kernels.py.  A division by a constant is a
// multiplication by its float32 reciprocal, as XLA compiles the reference's
// (x / 1000.0 becomes x * 0.001f); every other division is IEEE division.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_OFFS 32
#define BLOCK 256

// ---------------------------------------------------------------------------
// TK1 elig_select (reference K1 + K2)
//
// Replaces: circulant_eligibility (swarm_sim.py:681-772), spread_holder_only
// (:959-991) through select_holder (:1015-1018), the estimate / ABR level /
// next segment (:825-840), slot targets (:882-894), urgency and budget
// (:1060-1074), slot 0's start decision (:1093-1175, VOD branches) and
// pinning (:1207-1228).
//
// Per peer i: reads its own row and, for each offset o_k, the wanted word
// of neighbour (i + o_k) mod P plus that neighbour's presence and p2p_ok.
// Writes the slot record into its own row of the state (in place: no other
// thread reads those fields) and two scratch words: slot_flags (bit 0 may,
// bit 1 active, bit 2 is_p2p, bit 3 have_n) and req, the offset index k of
// the selected holder for a transfer that places demand, else -1.
struct SelectArgs {
  const float* t_s;
  const float* join_s;
  const float* leave_s;
  const float* p2p_ok;
  const int* abr_cap_level;
  const float* urgent_margin_off_s;
  const float* bitrates;
  const float* urgent_margin_s;
  const float* p2p_budget_fraction;
  const float* p2p_budget_cap_ms;
  const float* p2p_budget_floor_ms;
  const float* playhead_s;
  const float* buffer_s;
  const float* fast_estimate;
  const float* fast_weight;
  const float* slow_estimate;
  const float* slow_weight;
  const uint32_t* avail;
  const uint32_t* dl_flags;
  const int* dl_attempts;
  int* level;
  int* dl_seg;
  int* dl_level;
  float* dl_done_bytes;
  float* dl_total_bytes;
  float* dl_elapsed_ms;
  float* dl_budget_ms;
  int* dl_holder_off;
  int* slot_flags;
  int* req;
  long long n_peers;
  int n_words;
  int n_segments;
  int n_levels;
  int n_offs;
  float seg_duration_s;
  float inv_seg_duration_s;
  float max_buffer_s;
  float end_s;
  float fast_alpha;
  float slow_alpha;
  float default_estimate_bps;
  float bandwidth_safety;
  int offs[MAX_OFFS];  // normalized offsets, each reduced mod P to [0, P)
};

__device__ __forceinline__ float corrected(float alpha, float est,
                                           float total_w) {
  // ops/ewma.py get_estimate: bias correction of one EWMA
  float zero_factor = 1.0f - powf(alpha, total_w);
  return total_w > 0.0f ? est / fmaxf(zero_factor, 1e-12f) : 0.0f;
}

__device__ __forceinline__ bool is_present(float t, const float* join_s,
                                           const float* leave_s,
                                           long long i) {
  return (t >= join_s[i]) && (t < leave_s[i]);
}

// A requester's own inputs to the selection, which TK1 and select_admit
// each load from global memory.
struct PeerIn {
  bool present;
  float p2p_req;
  uint32_t fl;
  float playhead;
  float buffer;
  float fast_est;
  float fast_w;
  float slow_est;
  float slow_w;
  int cap_level;
  float margin_off;
  int attempts;
};

// What a requester wants: slot 0's target and the map bit it asks its
// neighbours for (word wi, bit bit).
struct Target {
  bool a0;
  bool p0;
  bool fg_wants;
  int want_level;
  int next_seg;
  int gi_seg;
  int wi;
  int bit;
};

// The requester half of the selection before eligibility (shared by TK1
// and select_admit, so that the two round alike).
__device__ __forceinline__ Target select_target(const SelectArgs& a,
                                                long long i,
                                                const PeerIn& in) {
  const int S = a.n_segments;
  Target tg;
  tg.a0 = (in.fl & 1u) != 0u;
  tg.p0 = ((in.fl >> 1) & 1u) != 0u;

  // estimate and ABR level (:825-830, ewma.get_estimate, _abr_pick)
  const float fast = corrected(a.fast_alpha, in.fast_est, in.fast_w);
  const float slow = corrected(a.slow_alpha, in.slow_est, in.slow_w);
  const float estimate = in.fast_w > 0.0f ? fminf(fast, slow)
                                          : a.default_estimate_bps;
  const float thr = estimate * a.bandwidth_safety;
  int pick = 0;
  for (int l = 0; l < a.n_levels; ++l)
    if (a.bitrates[l] <= thr && l > pick) pick = l;
  tg.want_level = min(pick, in.cap_level);

  // next segment: truncate toward zero, then cap (:831-836)
  const float pb = in.playhead + in.buffer;
  tg.next_seg = min((int)(pb * a.inv_seg_duration_s), S - 1);
  const bool timeline_left = pb < a.end_s;
  tg.fg_wants = in.present && !tg.a0 && timeline_left &&
                (in.buffer < a.max_buffer_s);

  // slot 0's target (:882-890).  In-place invariant: dl_seg, dl_level and
  // dl_holder_off are read only when a0 holds, and written (by the owner,
  // in select_finish) only when it does not (`may` implies !a0).
  // select_admit recomputes the requesters of its halo, whose rows another
  // block owns and writes in the same launch; a0 comes from dl_flags,
  // which neither kernel writes, so no thread reads a field that this
  // launch writes.  Keep these loads under `if (a0)`: never speculative.
  tg.gi_seg = tg.next_seg;
  int gi_level = tg.want_level;
  if (tg.a0) {
    tg.gi_seg = a.dl_seg[i];
    gi_level = a.dl_level[i];
  }
  const int gi_flat = gi_level * S + tg.gi_seg;
  tg.wi = gi_flat >> 5;
  tg.bit = gi_flat & 31;
  return tg;
}

// The requester half after eligibility: elig_bits has bit k set where
// neighbour k holds the target bit and serves (:681-772, serve_ok :805).
// Writes the requester's outputs only where `owner` holds; returns req.
__device__ __forceinline__ int select_finish(const SelectArgs& a, long long i,
                                             const PeerIn& in,
                                             const Target& tg,
                                             uint32_t elig_bits,
                                             bool owner) {
  const float n_count = (float)__popc(elig_bits);
  // requester-side connectivity gate (:905-906): elig_k * p2p_req
  const float n_holders = n_count * in.p2p_req;
  if (!(in.p2p_req > 0.0f)) elig_bits = 0u;
  const bool have_n = n_holders > 0.0f;

  // urgency, budget and segment bytes (:1060-1074)
  const float margin = (float)tg.next_seg * a.seg_duration_s - in.playhead;
  const bool urgent = margin < (*a.urgent_margin_s + in.margin_off);
  const float budget = fminf(fmaxf(margin * 1000.0f * *a.p2p_budget_fraction,
                                   *a.p2p_budget_floor_ms),
                             *a.p2p_budget_cap_ms);
  // the reference's one-hot sum over the ladder: 0 off the ladder
  const float want_rate = (tg.want_level >= 0 && tg.want_level < a.n_levels)
                              ? a.bitrates[tg.want_level] : 0.0f;
  const float want_bytes = want_rate * (a.seg_duration_s / 8.0f);

  // slot 0's start decision, VOD (:1133-1175)
  const bool start_p2p = tg.fg_wants && have_n && !urgent;
  const bool start_cdn = tg.fg_wants && !start_p2p;
  const bool may = start_p2p || start_cdn;
  const bool is_p2p = (may ? start_p2p : tg.p0) && have_n;
  const bool active = tg.a0 || may;

  // spread holder selection (:959-991), salt (0 * 2246822519 + 97) mod 2^32:
  // the rank-th set bit of elig_bits
  const uint32_t h = (uint32_t)i * 2654435761u +
                     (uint32_t)tg.gi_seg * 40503u + 97u;
  const uint32_t nu = (uint32_t)fmaxf(n_holders, 1.0f);
  const int rank = (int)((h % nu + (uint32_t)in.attempts) % nu);
  int sel = -1;
  if (rank < __popc(elig_bits)) {
    uint32_t rest = elig_bits;
    for (int r = 0; r < rank; ++r) rest &= rest - 1u;
    sel = __ffs(rest) - 1;
  }
  const int new_off = sel >= 0 ? sel : 0;
  // pinning (:1207-1228): an active transfer keeps its stored holder,
  // and rides it only while that holder is still eligible
  int off = new_off;
  if (tg.a0) {
    off = a.dl_holder_off[i];
    sel = (off >= 0 && off < a.n_offs && ((elig_bits >> off) & 1u)) ? off
                                                                    : -1;
  }
  const bool demand = active && is_p2p && in.present;
  const int req = (demand && sel >= 0) ? sel : -1;
  if (!owner) return req;
  a.req[i] = req;
  a.slot_flags[i] = (may ? 1 : 0) | (active ? 2 : 0) | (is_p2p ? 4 : 0) |
                    (have_n ? 8 : 0);
  if (!tg.a0) a.dl_holder_off[i] = off;
  if (may) {
    a.level[i] = tg.want_level;
    a.dl_seg[i] = tg.next_seg;
    a.dl_level[i] = tg.want_level;
    a.dl_total_bytes[i] = want_bytes;
    a.dl_done_bytes[i] = 0.0f;
    a.dl_elapsed_ms[i] = 0.0f;
    a.dl_budget_ms[i] = budget;
  }
  return req;
}

__global__ void elig_select_kernel(const SelectArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (i >= P) return;
  const float t = *a.t_s;
  PeerIn in;
  in.present = is_present(t, a.join_s, a.leave_s, i);
  in.p2p_req = a.p2p_ok[i];
  in.fl = a.dl_flags[i];
  in.playhead = a.playhead_s[i];
  in.buffer = a.buffer_s[i];
  in.fast_est = a.fast_estimate[i];
  in.fast_w = a.fast_weight[i];
  in.slow_est = a.slow_estimate[i];
  in.slow_w = a.slow_weight[i];
  in.cap_level = a.abr_cap_level[i];
  in.margin_off = a.urgent_margin_off_s[i];
  in.attempts = a.dl_attempts[i];
  const Target tg = select_target(a, i, in);
  // circulant eligibility (:681-772): neighbour k is (i + o_k) mod P; the
  // holder side is gated on presence and p2p_ok (serve_ok, :805)
  const uint32_t bm = 1u << tg.bit;
  uint32_t elig_bits = 0u;
  for (int k = 0; k < a.n_offs; ++k) {
    long long j = i + a.offs[k];
    if (j >= P) j -= P;
    const bool serve = is_present(t, a.join_s, a.leave_s, j) &&
                       (a.p2p_ok[j] > 0.0f);
    const bool have = (a.avail[j * a.n_words + tg.wi] & bm) != 0u;
    if (have && serve) elig_bits |= 1u << k;
  }
  select_finish(a, i, in, tg, elig_bits, true);
}

// ---------------------------------------------------------------------------
// TK2 admit_service (reference K3)
//
// Replaces: the circulant admission and service of swarm_sim.py:1259-1303
// (the cap > 0 branch).  Holder side: holder j walks k in offset order over
// requesters r = (j - o_k) mod P, admits each one whose selected offset is
// k until max_total_serves, and writes its service
// uplink * efficiency / max(load, 1) and a bit mask of the admitted k.
// Requesters read both back in TK3 (one reader per selected edge), so no
// flag is scattered.
struct AdmitArgs {
  const int* req;
  const float* uplink_bps;
  const float* uplink_efficiency;
  float* service;
  int* adm_mask;
  long long n_peers;
  int n_offs;
  float cap;
  int offs[MAX_OFFS];
};

__global__ void admit_service_kernel(const AdmitArgs a) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (j >= P) return;
  float cum = 0.0f;
  uint32_t adm = 0u;
  for (int k = 0; k < a.n_offs; ++k) {
    long long r = j - a.offs[k];
    if (r < 0) r += P;
    if (a.req[r] == k && cum < a.cap) {
      cum += 1.0f;
      adm |= 1u << k;
    }
  }
  a.service[j] = a.uplink_bps[j] * *a.uplink_efficiency / fmaxf(cum, 1.0f);
  a.adm_mask[j] = (int)adm;
}

// ---------------------------------------------------------------------------
// select_admit (reference K1 + K2 + K3, one launch)
//
// Replaces: the same reference lines as TK1 followed by TK2
// (swarm_sim.py:681-772, :959-991, :1053-1175, :1207-1228, :1259-1303).
// Its outputs equal TK1 then TK2 to the bit; TK1 and TK2 remain the route
// for offset tuples whose halo is too wide for a tile (the wrapper in
// ops/swarm_kernels.py picks the route from the offsets before launch).
//
// Tile plus halo.  A block owns SA_TILE consecutive peers [b, b + SA_TILE)
// as holders and as requesters.  With o_max = max(offsets, 0), o_min =
// min(offsets, 0) and span = o_max - o_min, the requesters of its holders
// are the R = SA_TILE + span peers [b - o_max, b + SA_TILE - o_min), one
// per thread, and their neighbours the H = SA_TILE + 2 span peers from
// b - o_max + o_min.  Every index is taken mod P, so the ring may wrap
// more than once when P < SA_TILE + span.
//   1. Serve bits (present, present && p2p_ok > 0) of the neighbour range
//      go to shared memory once, so each neighbour test reads a byte of
//      shared memory instead of three global arrays.
//   2. Each requester computes its target (select_target), tests its K
//      neighbours' map words (K template: the K loads go out together),
//      finishes its selection (select_finish) and keeps its req in shared
//      memory; only the block that owns the peer writes its outputs.  The
//      halo costs span / SA_TILE of recompute.
//   3. Each holder of the tile walks its K requesters in offset order from
//      shared memory (admission up to the cap, then its service), as TK2.
// Each thread loads its requester's inputs from global memory itself, and
// the map words directly; map rows are never staged whole.  What bounds it
// on an H100: bytes, as TK1.  PERF.md has the designs that were timed
// against this one and what holds it back.
//
// The build sets SA_TILE (peers per block) and SA_MAX_SPAN (the widest
// halo a block takes) from ops/swarm_kernels.py, whose route sends a wider
// halo to TK1 + TK2.
#if !defined(SA_TILE) || !defined(SA_MAX_SPAN)
#error "build with -DSA_TILE=... -DSA_MAX_SPAN=... (ops/swarm_kernels.py)"
#endif
// the block's threads at the widest halo: one per requester, whole warps
#define SA_THREADS ((SA_TILE + SA_MAX_SPAN + 31) / 32 * 32)
// registers for 8 blocks per SM: 48 at 160 threads, no spills (asking for
// 12 blocks spilled and ran 40% slower, PERF.md)
#define SA_MIN_BLOCKS 8

struct SelectAdmitArgs {
  SelectArgs sel;  // its offs hold the offsets reduced mod P
  const float* uplink_bps;
  const float* uplink_efficiency;
  float* service;
  int* adm_mask;
  float cap;
  int o_max;
  int o_min;
  int soffs[MAX_OFFS];  // the normalized offsets, signed
};

// x mod P in [0, P), for any x
__device__ __forceinline__ long long wrap(long long x, long long P) {
  if (x >= 0 && x < P) return x;
  x %= P;
  return x < 0 ? x + P : x;
}

template <int KT>
__global__ void __launch_bounds__(SA_THREADS, SA_MIN_BLOCKS)
    select_admit_kernel(const SelectAdmitArgs a) {
  // the serve bits of the neighbour range (bit 0 present, bit 1 serves)
  // and the req of the requester range
  __shared__ unsigned char serve_s[SA_TILE + 2 * SA_MAX_SPAN];
  __shared__ signed char req_s[SA_TILE + SA_MAX_SPAN];
  const SelectArgs& s = a.sel;
  const long long P = s.n_peers;
  const int K = KT > 0 ? KT : s.n_offs;
  const int span = a.o_max - a.o_min;
  const int R = SA_TILE + span;
  const int H = SA_TILE + 2 * span;
  const int tid = threadIdx.x;
  const float t = *s.t_s;
  const long long b = (long long)blockIdx.x * SA_TILE;
  const long long q0 = b - a.o_max;   // requester q is peer (q0 + q) mod P
  const long long h0 = q0 + a.o_min;  // neighbour h is peer (h0 + h) mod P

  // 1. serve bits of the neighbour range.  The three loads are taken
  // before the test, so they go out together: behind `&&` the compiler
  // waited for join_s before it loaded leave_s and p2p_ok.
  for (int h = tid; h < H; h += blockDim.x) {
    const long long x = wrap(h0 + h, P);
    const float join = s.join_s[x], leave = s.leave_s[x], p2p = s.p2p_ok[x];
    const bool present = (t >= join) && (t < leave);
    serve_s[h] = (unsigned char)((present ? 1 : 0) |
                                 ((present && p2p > 0.0f) ? 2 : 0));
  }
  __syncthreads();

  // 2. requester q = tid: its target, its neighbours' words, its selection
  const int q = tid;
  if (q < R) {
    const long long i = wrap(q0 + q, P);
    const int hq = q - a.o_min;  // requester q in the neighbour range
    PeerIn in;
    in.present = (serve_s[hq] & 1) != 0;
    in.p2p_req = s.p2p_ok[i];
    in.fl = s.dl_flags[i];
    in.playhead = s.playhead_s[i];
    in.buffer = s.buffer_s[i];
    in.fast_est = s.fast_estimate[i];
    in.fast_w = s.fast_weight[i];
    in.slow_est = s.slow_estimate[i];
    in.slow_w = s.slow_weight[i];
    in.cap_level = s.abr_cap_level[i];
    in.margin_off = s.urgent_margin_off_s[i];
    in.attempts = s.dl_attempts[i];
    const Target tg = select_target(s, i, in);
    // circulant eligibility (:681-772); the map is not written in this
    // launch, so its words go through the read-only path.  Each neighbour's
    // serve bit is read whatever its map word holds, and the two are
    // combined without a branch, so the K shared loads go out together.
    uint32_t elig_bits = 0u;
    if (KT > 0) {
      uint32_t w[KT > 0 ? KT : 1];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        long long j = i + s.offs[k];
        if (j >= P) j -= P;
        w[k] = __ldg(&s.avail[j * s.n_words + tg.wi]);
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const uint32_t serves = (serve_s[hq + a.soffs[k]] >> 1) & 1u;
        elig_bits |= (((w[k] >> tg.bit) & serves) & 1u) << k;
      }
    } else {
      for (int k = 0; k < K; ++k) {
        long long j = i + s.offs[k];
        if (j >= P) j -= P;
        const uint32_t serves = (serve_s[hq + a.soffs[k]] >> 1) & 1u;
        elig_bits |= (((__ldg(&s.avail[j * s.n_words + tg.wi]) >> tg.bit) &
                       serves) & 1u) << k;
      }
    }
    const long long u = (long long)q - a.o_max;  // position in the tile
    const bool owner = u >= 0 && u < SA_TILE && b + u < P;
    req_s[q] = (signed char)select_finish(s, i, in, tg, elig_bits, owner);
  }
  __syncthreads();

  // 3. admission and service of the tile's holders (TK2's walk):
  // requester (j - o_k) mod P sits at q = jl - o_k + o_max
  const float eff = *a.uplink_efficiency;
  for (int jl = tid; jl < SA_TILE; jl += blockDim.x) {
    const long long j = b + jl;
    if (j >= P) break;
    float cum = 0.0f;
    uint32_t adm = 0u;
#pragma unroll
    for (int k = 0; k < (KT > 0 ? KT : K); ++k) {
      if (req_s[jl - a.soffs[k] + a.o_max] == k && cum < a.cap) {
        cum += 1.0f;
        adm |= 1u << k;
      }
    }
    a.service[j] = a.uplink_bps[j] * eff / fmaxf(cum, 1.0f);
    a.adm_mask[j] = (int)adm;
  }
}

// ---------------------------------------------------------------------------
// TK3 peer_update (reference K4 + K3's readback)
//
// Replaces: swarm_sim.py:1297-1303 (service readback), the slot-0 update
// :1351-1434 and :1467-1493 with ops/ewma.py update, and playback and the
// state repack :1495-1525.  Per peer: reads back the service of its
// selected holder, then progress after the setup time, completion, BUSY
// fast-fail, budget failover, byte counters, the cache bit-OR into its own
// row, the EWMA, playback and the dl_flags word.  Updates the state in
// place; each thread writes only its own peer's row.
struct UpdateArgs {
  const float* t_s;
  const float* join_s;
  const float* leave_s;
  const float* cdn_bps;
  const float* p2p_setup_ms;
  const int* slot_flags;
  const int* req;
  const float* service;
  const int* adm_mask;
  const int* dl_seg;
  const int* dl_level;
  const float* dl_total_bytes;
  const float* dl_budget_ms;
  float* playhead_s;
  float* buffer_s;
  float* rebuffer_s;
  float* fast_estimate;
  float* fast_weight;
  float* slow_estimate;
  float* slow_weight;
  uint32_t* avail;
  float* cdn_bytes;
  float* p2p_bytes;
  uint32_t* dl_flags;
  float* dl_done_bytes;
  float* dl_elapsed_ms;
  float* dl_cooldown_ms;
  long long n_peers;
  int n_words;
  int n_segments;
  int n_offs;
  float seg_duration_s;
  float end_s;
  float dt_ms;
  float dt_s;
  float p2p_bps;
  float fast_alpha;
  float slow_alpha;
  float min_sample_ms;
  int offs[MAX_OFFS];
};

__device__ __forceinline__ void ewma_update(float alpha, float weight,
                                            float bandwidth, float* est,
                                            float* total_w) {
  // ops/ewma.py update, for a valid sample
  const float adj = powf(alpha, weight);
  const float e = *est;
  *est = adj * e + (1.0f - adj) * bandwidth;
  *total_w = *total_w + weight;
}

__global__ void peer_update_kernel(const UpdateArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (i >= P) return;
  const float t = *a.t_s;
  const bool present = is_present(t, a.join_s, a.leave_s, i);
  const int fl = a.slot_flags[i];
  const bool may = (fl & 1) != 0;
  const bool active0 = (fl & 2) != 0;
  const bool is_p2p0 = (fl & 4) != 0;
  const bool have_n = (fl & 8) != 0;

  // service readback through the selected edge (:1297-1303)
  const int k = a.req[i];
  bool admitted = false;
  float svc = 0.0f;
  if (k >= 0) {
    long long j = i + a.offs[k];
    if (j >= P) j -= P;
    admitted = ((a.adm_mask[j] >> k) & 1) != 0;
    if (admitted) svc = a.service[j];
  }

  // progress (:1362-1394)
  const float demand = (active0 && is_p2p0 && present) ? 1.0f : 0.0f;
  const float p2p_rate = fminf(demand * svc, a.p2p_bps);
  const bool progressing = active0 && present;
  float elapsed = a.dl_elapsed_ms[i] + (progressing ? a.dt_ms : 0.0f);
  const float live_ms = fminf(fmaxf(elapsed - *a.p2p_setup_ms, 0.0f), a.dt_ms);
  const float p2p_step = p2p_rate * live_ms * (1.0f / 8000.0f);
  const float step_bytes = is_p2p0 ? p2p_step
                                    : a.cdn_bps[i] * a.dt_s * (1.0f / 8.0f);
  const float total = a.dl_total_bytes[i];
  const float done0 = a.dl_done_bytes[i];
  const float cdn_accrue = (progressing && !is_p2p0)
                               ? fminf(step_bytes, fmaxf(total - done0, 0.0f))
                               : 0.0f;
  float done = done0 + (progressing ? step_bytes : 0.0f);
  const bool completed = progressing && (done >= total);
  const bool active = active0 && !completed;
  bool is_p2p = is_p2p0;

  // BUSY fast-fail and budget failover (:1397-1427)
  const bool denied = may && is_p2p && have_n && !admitted;
  is_p2p = is_p2p && !denied;
  if (denied) {
    done = 0.0f;
    elapsed = 0.0f;
  }
  const bool expired = active && is_p2p && (elapsed >= a.dl_budget_ms[i]);
  is_p2p = is_p2p && !expired;
  if (expired) {
    done = 0.0f;
    elapsed = 0.0f;
  }
  a.cdn_bytes[i] = a.cdn_bytes[i] + cdn_accrue;
  a.p2p_bytes[i] = a.p2p_bytes[i] + ((completed && is_p2p) ? total : 0.0f);
  const float buffer_add = 0.0f + (completed ? a.seg_duration_s : 0.0f);
  a.dl_cooldown_ms[i] = fmaxf(a.dl_cooldown_ms[i] - a.dt_ms, 0.0f);
  a.dl_done_bytes[i] = done;
  a.dl_elapsed_ms[i] = elapsed;
  a.dl_flags[i] = (active ? 1u : 0u) | (is_p2p ? 2u : 0u);

  if (completed) {
    // cache insert (:1472): one bit of the own row
    const int gi_flat = a.dl_level[i] * a.n_segments + a.dl_seg[i];
    a.avail[i * a.n_words + (gi_flat >> 5)] |= 1u << (gi_flat & 31);
    // the estimator sample (:1478-1482, ops/ewma.py update)
    const float d = fmaxf(elapsed, a.min_sample_ms);
    if (total > 0.0f) {
      const float bandwidth = 8000.0f * total / d;
      const float weight = d * (1.0f / 1000.0f);
      ewma_update(a.fast_alpha, weight, bandwidth, &a.fast_estimate[i],
                  &a.fast_weight[i]);
      ewma_update(a.slow_alpha, weight, bandwidth, &a.slow_estimate[i],
                  &a.slow_weight[i]);
    }
  }

  // playback (:1495-1511)
  const float playhead = a.playhead_s[i];
  float buf = a.buffer_s[i] + buffer_add;
  const bool can_play = present && (playhead < a.end_s);
  const float advance = fminf(buf, a.dt_s) * (can_play ? 1.0f : 0.0f);
  a.playhead_s[i] = playhead + advance;
  a.rebuffer_s[i] = a.rebuffer_s[i] + (can_play ? a.dt_s - advance : 0.0f);
  a.buffer_s[i] = buf - advance;
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes.  Each launches on the caller's stream
// and returns cudaGetLastError(), so a refused launch reaches the caller.

static inline unsigned int grid_for(long long n) {
  return (unsigned int)((n + BLOCK - 1) / BLOCK);
}

extern "C" int swarm_elig_select(const SelectArgs* args, void* stream) {
  if (args->n_peers > 0)
    elig_select_kernel<<<grid_for(args->n_peers), BLOCK, 0,
                         (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int swarm_admit_service(const AdmitArgs* args, void* stream) {
  if (args->n_peers > 0)
    admit_service_kernel<<<grid_for(args->n_peers), BLOCK, 0,
                           (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int swarm_peer_update(const UpdateArgs* args, void* stream) {
  if (args->n_peers > 0)
    peer_update_kernel<<<grid_for(args->n_peers), BLOCK, 0,
                         (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// select_admit's launch: SA_TILE peers per block, one thread per requester
// of the tile and its halo (rounded up to a warp).  A halo wider than
// SA_MAX_SPAN is refused; the wrapper never sends one.
template <int KT>
static int launch_select_admit(const SelectAdmitArgs* a,
                               cudaStream_t stream) {
  const long long P = a->sel.n_peers;
  const int span = a->o_max - a->o_min;
  if (span < 0 || span > SA_MAX_SPAN) return (int)cudaErrorInvalidValue;
  if (P > 0)
    select_admit_kernel<KT><<<(unsigned int)((P + SA_TILE - 1) / SA_TILE),
                              (SA_TILE + span + 31) / 32 * 32, 0, stream>>>(
        *a);
  return (int)cudaGetLastError();
}

extern "C" int swarm_select_admit(const SelectAdmitArgs* args, void* stream) {
  if (args->sel.n_offs == 8)
    return launch_select_admit<8>(args, (cudaStream_t)stream);
  return launch_select_admit<0>(args, (cudaStream_t)stream);
}

// Struct sizes, so the Python side can check its ctypes mirrors.
extern "C" int swarm_args_sizes(long long* out) {
  out[0] = (long long)sizeof(SelectArgs);
  out[1] = (long long)sizeof(AdmitArgs);
  out[2] = (long long)sizeof(UpdateArgs);
  out[3] = (long long)sizeof(SelectAdmitArgs);
  return 0;
}
