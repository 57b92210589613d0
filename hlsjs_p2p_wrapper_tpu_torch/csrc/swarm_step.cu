// One step of the circulant VOD swarm simulator as three sm_90a kernels.
//
// The reference is hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py, whose step is
// jnp code that XLA fuses (its one Pallas kernel, the eligibility stencil
// of ops/pallas_elig.py, was retired).  Each kernel below names the
// reference lines it replaces.  The slice they cover: circulant offsets,
// one transfer slot (max_concurrency == 1), "spread" holder selection, an
// admission cap (max_total_serves > 0) and VOD (live == False).
//
// Layout: one thread per peer over a 1-D grid.  Per-peer fields are [P]
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
// touched only where it is needed: TK1 reads one word of its own row and
// one of each of its K neighbours' rows, TK3 rewrites one word of a row
// only where a transfer completed.  Per-kernel counts are computed by
// chip_smoke.py (kernel_bytes) and printed in its report.
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

__global__ void elig_select_kernel(const SelectArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (i >= P) return;
  const int S = a.n_segments;
  const float t = *a.t_s;
  const bool present = is_present(t, a.join_s, a.leave_s, i);
  const float p2p_req = a.p2p_ok[i];
  const uint32_t fl = a.dl_flags[i];
  const bool a0 = (fl & 1u) != 0u;
  const bool p0 = ((fl >> 1) & 1u) != 0u;
  const float playhead = a.playhead_s[i];
  const float buffer = a.buffer_s[i];

  // estimate and ABR level (:825-830, ewma.get_estimate, _abr_pick)
  const float fast = corrected(a.fast_alpha, a.fast_estimate[i],
                               a.fast_weight[i]);
  const float slow = corrected(a.slow_alpha, a.slow_estimate[i],
                               a.slow_weight[i]);
  const float estimate = a.fast_weight[i] > 0.0f ? fminf(fast, slow)
                                                 : a.default_estimate_bps;
  const float thr = estimate * a.bandwidth_safety;
  int pick = 0;
  for (int l = 0; l < a.n_levels; ++l)
    if (a.bitrates[l] <= thr && l > pick) pick = l;
  const int want_level = min(pick, a.abr_cap_level[i]);

  // next segment: truncate toward zero, then cap (:831-836)
  const float pb = playhead + buffer;
  const int next_seg = min((int)(pb * a.inv_seg_duration_s), S - 1);
  const bool timeline_left = pb < a.end_s;
  const bool fg_wants = present && !a0 && timeline_left &&
                        (buffer < a.max_buffer_s);

  // slot 0's target (:882-890)
  const int gi_seg = a0 ? a.dl_seg[i] : next_seg;
  const int gi_level = a0 ? a.dl_level[i] : want_level;
  const int gi_flat = gi_level * S + gi_seg;
  const int wi = gi_flat >> 5;
  const uint32_t bm = 1u << (gi_flat & 31);

  // circulant eligibility (:681-772): neighbour k is (i + o_k) mod P;
  // the holder side is gated on presence and p2p_ok (serve_ok, :805)
  uint32_t elig_bits = 0u;
  float n_count = 0.0f;
  for (int k = 0; k < a.n_offs; ++k) {
    long long j = i + a.offs[k];
    if (j >= P) j -= P;
    const bool serve = is_present(t, a.join_s, a.leave_s, j) &&
                       (a.p2p_ok[j] > 0.0f);
    const bool have = (a.avail[j * a.n_words + wi] & bm) != 0u;
    if (have && serve) {
      elig_bits |= 1u << k;
      n_count += 1.0f;
    }
  }
  // requester-side connectivity gate (:905-906): elig_k * p2p_req
  const float n_holders = n_count * p2p_req;
  if (!(p2p_req > 0.0f)) elig_bits = 0u;
  const bool have_n = n_holders > 0.0f;

  // urgency, budget and segment bytes (:1060-1074)
  const float margin = (float)next_seg * a.seg_duration_s - playhead;
  const bool urgent = margin < (*a.urgent_margin_s + a.urgent_margin_off_s[i]);
  const float budget = fminf(fmaxf(margin * 1000.0f * *a.p2p_budget_fraction,
                                   *a.p2p_budget_floor_ms),
                             *a.p2p_budget_cap_ms);
  // the reference's one-hot sum over the ladder: 0 off the ladder
  const float want_rate = (want_level >= 0 && want_level < a.n_levels)
                              ? a.bitrates[want_level] : 0.0f;
  const float want_bytes = want_rate * (a.seg_duration_s / 8.0f);

  // slot 0's start decision, VOD (:1133-1175)
  const bool start_p2p = fg_wants && have_n && !urgent;
  const bool start_cdn = fg_wants && !start_p2p;
  const bool may = start_p2p || start_cdn;
  const bool is_p2p = (may ? start_p2p : p0) && have_n;
  const bool active = a0 || may;

  // spread holder selection (:959-991), salt (0 * 2246822519 + 97) mod 2^32
  const uint32_t h = (uint32_t)i * 2654435761u +
                     (uint32_t)gi_seg * 40503u + 97u;
  const uint32_t nu = (uint32_t)fmaxf(n_holders, 1.0f);
  const int rank = (int)((h % nu + (uint32_t)a.dl_attempts[i]) % nu);
  int sel = -1;
  int cum = 0;
  for (int k = 0; k < a.n_offs; ++k) {
    const int is_e = (elig_bits >> k) & 1u;
    if (is_e && cum == rank) sel = k;
    cum += is_e;
  }
  const int new_off = sel >= 0 ? sel : 0;
  // pinning (:1207-1228): an active transfer keeps its stored holder,
  // and rides it only while that holder is still eligible
  const int off = a0 ? a.dl_holder_off[i] : new_off;
  if (a0) {
    sel = (off >= 0 && off < a.n_offs && ((elig_bits >> off) & 1u)) ? off
                                                                    : -1;
  }
  const bool demand = active && is_p2p && present;

  a.req[i] = (demand && sel >= 0) ? sel : -1;
  a.slot_flags[i] = (may ? 1 : 0) | (active ? 2 : 0) | (is_p2p ? 4 : 0) |
                    (have_n ? 8 : 0);
  if (!a0) a.dl_holder_off[i] = off;
  if (may) {
    a.level[i] = want_level;
    a.dl_seg[i] = next_seg;
    a.dl_level[i] = want_level;
    a.dl_total_bytes[i] = want_bytes;
    a.dl_done_bytes[i] = 0.0f;
    a.dl_elapsed_ms[i] = 0.0f;
    a.dl_budget_ms[i] = budget;
  }
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

// Struct sizes, so the Python side can check its ctypes mirrors.
extern "C" int swarm_args_sizes(long long* out) {
  out[0] = (long long)sizeof(SelectArgs);
  out[1] = (long long)sizeof(AdmitArgs);
  out[2] = (long long)sizeof(UpdateArgs);
  return 0;
}
