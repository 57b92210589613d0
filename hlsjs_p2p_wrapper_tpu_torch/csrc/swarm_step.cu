// One step of the swarm simulator as sm_90a kernels: on the circulant main
// path select_admit then TK3 (two launches, TK3 with the offset series'
// sums and the clock's advance in its epilogue); for an offset tuple whose
// halo is too wide for select_admit's tile, TK1, TK2 and TK3; on the
// general [P, K] neighbour-list path the gather forms of TK1, TK2 and TK3
// (elig_select_gather_kernel, admit_gather_kernel and
// peer_update_gather_kernel).
//
// The reference is hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py, whose step is
// jnp code that XLA fuses (its one Pallas kernel, the eligibility stencil
// of ops/pallas_elig.py, was retired).  Each kernel below names the
// reference lines it replaces.  The slice they cover: circulant offsets and
// general neighbour lists, up to 16 transfer slots (max_concurrency), the
// three holder policies, VOD and live mode, an admission cap
// (max_total_serves > 0) and the uncapped fair share, which the wrapper
// passes as cap = +inf: every demand is admitted, so TK3 never sees a BUSY
// deny or an admission abort (reference :1291-1297, :1336-1346), and the
// kernels are the capped ones.
//
// Transfer slots (C = max_concurrency) are a template parameter CT of
// every step kernel: CT = 1 (the foreground alone), CT = 3 (the policy A/B
// ring's three slots), and CT = 0, which reads C from the launch's n_slots
// for any other C <= 16.  Slot 0 is the foreground download, slots 1..
// P2P-only prefetches (reference :1076-1246, :1436-1466).  Each kernel
// walks the slots in the reference's order, so that every float add and
// every EWMA update rounds as the reference's do: the selection slot by
// slot (its dedup guard reads the processed slots' new records from
// registers and the later slots' old ones from memory), admission over
// (slot, offset), the update slot by slot.
//
// Live mode (config.live) is a template parameter LIVE of TK1, TK3 and
// select_admit, so that a VOD step runs kernels compiled without it.  Its
// branches: the playhead floor at join (live_playhead, which the selection
// and the update both apply, from the same inputs), the published-only gate
// on the foreground's wish, P2P visibility after the announce lag, the edge
// stagger, and the playback cushion.  The stagger's wait clock fg_wait_ms
// is read by the selection and written only by TK3: the selection reports
// a foreground blocked on the stagger in slot flag bit 4, and TK3 runs the
// clock from it (reference :1143-1168).  select_admit's halo requesters
// read fg_wait_ms of rows another block owns, so no kernel may write it
// in the launch that selects.
//
// The holder policy (config.holder_selection, reference :993-1051) is a
// template parameter POL of TK1 and select_admit: POL_SPREAD hashes the
// requester onto one eligible holder; POL_ADAPTIVE hashes it onto the
// eligible holders of the lowest tier, scored by the requester's own load
// on the offset (another of its slots rides it as an active P2P transfer)
// and by the per-edge penalty window holder_penalty_ms ([B, P, K]);
// POL_RANKED takes the holder of the (skip + 1)-th lowest peer id, with
// skip C - 1 for the foreground and c - 1 for prefetch slot c, and is not
// pinned to its stored holder.  The penalty window has the same one-writer
// rule as fg_wait_ms: the selection reads it (halo requesters included) and
// only TK3 writes it, which drains it every step and re-arms it on the
// holder of a foreground BUSY deny and of every prefetch abort (TK3's PEN
// instantiation, :1356-1358, :1405-1417, :1459-1466).
//
// Layout: scenario lanes.  Every array carries a leading lane axis of
// n_lanes (B), and the lane is the grid's y dimension: one launch steps
// every lane.  TK1-TK3 run one thread per peer of a lane over the grid's x
// dimension; select_admit runs a tile of one lane's peers per block (see
// there).  Per-peer fields are [B, P] arrays and per-slot fields [B, P, C]
// (the entry of slot c of row r at r * C + c); the packed cache map `avail`
// is [B, P, W] u32 (stored by PyTorch as int32 with the same bit pattern),
// `dl_flags` is [B, P] u32 (bit 2c = slot c active, bit 2c + 1 = slot c
// is_p2p).
// Per-lane scalars (the clock t_s, the policy knobs) are [B] device
// arrays read through pointers, so a step never waits on the host, and the
// ladder `bitrates` is [B, L].  A lane's rows start at lane * P; that
// offset and every index derived from it are 64-bit (48 lanes of 1,048,576
// peers put a map row 2.4 GB from the base).  Neighbours wrap mod P inside
// their lane: no thread reads another lane's rows.
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

#include "lane_sums.cuh"

#define MAX_OFFS 32
#define BLOCK 256
static_assert(BLOCK == LS_THREADS,
              "peer_update's blocks are the offload sums' partials");

// the general path's gathers issued together: neighbours (TK1) or inbound
// edges (TK2) a run
#define GATHER_RUN 8

// the most transfer slots: two dl_flags bits each in one u32
#define MAX_SLOTS 16
// slots the per-slot register arrays of a CT instantiation hold
#define SLOT_CAP(CT) ((CT) > 0 ? (CT) : MAX_SLOTS)

// the holder policies (SelectArgs::policy, the POL template parameter)
#define POL_SPREAD 0
#define POL_ADAPTIVE 1
#define POL_RANKED 2

// ---------------------------------------------------------------------------
// TK1 elig_select (reference K1 + K2)
//
// Replaces: circulant_eligibility (swarm_sim.py:681-772), spread_holder_only
// (:959-991) through select_holder (:1015-1018), the estimate / ABR level /
// next segment (:825-840), slot targets (:882-894), urgency and budget
// (:1060-1074), each slot's start decision (:1093-1183) and pinning
// (:1207-1228).
//
// Per peer i and slot c in order: reads its own row and, for each offset
// o_k, the wanted word of neighbour (i + o_k) mod P plus that neighbour's
// presence and p2p_ok.  Writes the slot record into its own row of the
// state (in place: no other thread reads those fields) and two [B, P, C]
// scratch words: slot_flags (per slot bit 0 may, bit 1 active, bit 2
// is_p2p, bit 3 have_n; on slot 0 only, bit 4 blocked on the live stagger
// and bit 5 absorbed from the own cache) and req, the offset index k of the
// slot's selected holder where the slot places demand, else -1.
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
  int n_lanes;
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
  // live mode, read only by the LIVE instantiations: per peer the stagger
  // rank and wait clock, per lane the cushion, stagger window and announce
  // lag; live selects the instantiation
  const float* edge_rank;
  const float* fg_wait_ms;
  const float* live_sync_s;
  const float* live_spread_s;
  const float* announce_delay_s;
  float dt_ms;
  int live;
  // the prefetch slots' retry cooldown ([B, P, C]) and the slot count C
  const float* dl_cooldown_ms;
  int n_slots;
  // the holder policy, which selects the instantiation; adaptive's penalty
  // window ([B, P, K], K = n_offs; read only by the POL_ADAPTIVE
  // instantiations), and ranked's announce order: the offset indices by
  // offs ascending
  const float* holder_penalty_ms;
  int policy;
  int rank_order[MAX_OFFS];
  // the general path (read only by elig_select_gather_kernel): the
  // neighbour list [B, P, K], K = n_offs, of lane-local peer ids (a self
  // entry is padding)
  const int* neighbors;
};

__device__ __forceinline__ float corrected(float alpha, float est,
                                           float total_w) {
  // ops/ewma.py get_estimate: bias correction of one EWMA
  float zero_factor = 1.0f - powf(alpha, total_w);
  return total_w > 0.0f ? est / fmaxf(zero_factor, 1e-12f) : 0.0f;
}

__device__ __forceinline__ bool is_present(float t, const float* join_s,
                                           const float* leave_s,
                                           long long r) {
  return (t >= join_s[r]) && (t < leave_s[r]);
}

// Live mode's playhead floor (reference :814-822): a joiner starts
// live_sync_s behind the edge, its join time, so once t >= join the
// playhead is at least max(join - live_sync_s, 0).  The selection and TK3
// both step from the floored playhead, and only TK3 writes it back, so both
// take it from here.
__device__ __forceinline__ float live_playhead(float playhead, float join,
                                               float t, float sync) {
  const float live_start = fmaxf(join - sync, 0.0f);
  return fmaxf(playhead, t >= join ? live_start : 0.0f);
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
  float edge_rank;  // live mode only
  float fg_wait;    // live mode only
  uint32_t pen_bits;  // POL_ADAPTIVE only: bit k, holder_penalty_ms[k] > 0
};

// Adaptive's penalty bits of requester row r (K = KT, or n_offs for KT =
// 0): bit k where its window on offset k is still open.  The selection
// never writes the window, so it goes through the read-only path; a K = 8
// row is 32 bytes, two 16-byte loads (the wrapper checks the alignment).
template <int KT>
__device__ __forceinline__ uint32_t penalty_bits(const SelectArgs& a,
                                                 long long r) {
  if (KT == 8) {
    const float4* row =
        reinterpret_cast<const float4*>(a.holder_penalty_ms + r * 8);
    const float4 lo = __ldg(row), hi = __ldg(row + 1);
    return (lo.x > 0.0f ? 1u : 0u) | (lo.y > 0.0f ? 2u : 0u) |
           (lo.z > 0.0f ? 4u : 0u) | (lo.w > 0.0f ? 8u : 0u) |
           (hi.x > 0.0f ? 16u : 0u) | (hi.y > 0.0f ? 32u : 0u) |
           (hi.z > 0.0f ? 64u : 0u) | (hi.w > 0.0f ? 128u : 0u);
  }
  const int K = a.n_offs;
  uint32_t bits = 0u;
  for (int k = 0; k < K; ++k)
    if (__ldg(&a.holder_penalty_ms[r * K + k]) > 0.0f) bits |= 1u << k;
  return bits;
}

// A requester's live inputs (load_live): its floored playhead, its stagger
// rank and wait clock.  Every requester loads them, select_admit's halo
// included: the start decision, and so req, depends on them.
template <bool LIVE>
__device__ __forceinline__ void load_live(const SelectArgs& a, int lane,
                                          long long r, float t, PeerIn& in) {
  if (!LIVE) return;
  in.playhead =
      live_playhead(in.playhead, a.join_s[r], t, a.live_sync_s[lane]);
  in.edge_rank = a.edge_rank[r];
  in.fg_wait = a.fg_wait_ms[r];
}

// What a requester wants, whatever the slot: its ABR level, its next
// segment and the foreground's wish.
struct Wish {
  int want_level;
  int next_seg;
  bool fg_wants;
};

template <bool LIVE>
__device__ __forceinline__ Wish select_wish(const SelectArgs& a, int lane,
                                            const PeerIn& in, float t) {
  const int S = a.n_segments;
  Wish w;
  // estimate and ABR level (:825-830, ewma.get_estimate, _abr_pick)
  const float fast = corrected(a.fast_alpha, in.fast_est, in.fast_w);
  const float slow = corrected(a.slow_alpha, in.slow_est, in.slow_w);
  const float estimate = in.fast_w > 0.0f ? fminf(fast, slow)
                                          : a.default_estimate_bps;
  const float thr = estimate * a.bandwidth_safety;
  const float* rates = a.bitrates + (long long)lane * a.n_levels;
  int pick = 0;
  for (int l = 0; l < a.n_levels; ++l)
    if (rates[l] <= thr && l > pick) pick = l;
  w.want_level = min(pick, in.cap_level);

  // next segment: truncate toward zero, then cap (:831-836)
  const float pb = in.playhead + in.buffer;
  w.next_seg = min((int)(pb * a.inv_seg_duration_s), S - 1);
  const bool timeline_left = pb < a.end_s;
  w.fg_wants = in.present && !(in.fl & 1u) && timeline_left &&
               (in.buffer < a.max_buffer_s);
  // live: only fully published segments are downloadable (:837-840)
  if (LIVE)
    w.fg_wants = w.fg_wants &&
                 (((float)w.next_seg + 1.0f) * a.seg_duration_s <= t);
  return w;
}

// Each slot's transfer in flight: its active bit and flat (level * S +
// seg) target, and its stored segment; under POL_ADAPTIVE also its is_p2p
// bit and holder offset, which adaptive's own-load key reads (:1185-1205).
// Before a slot is processed these are its old record, loaded by
// load_flight; after, its new one (slot_finish).  In-place invariant:
// dl_seg, dl_level and dl_holder_off of slot c are read only where slot c
// is active, and written (by the owner, in slot_finish) only where it is
// not (`may` implies !active).
// select_admit recomputes the requesters of its halo, whose rows another
// block owns and writes in the same launch; the active bits come from
// dl_flags, which neither kernel writes, so no thread reads a field that
// this launch writes.  Keep these loads under their slot's own active bit:
// never speculative.  The dedup guard of slot c reads the processed slots'
// new records from these registers, never from memory.
template <int CT>
struct Flight {
  uint32_t active;  // bit c: slot c in flight
  uint32_t p2p;     // bit c: slot c is P2P (POL_ADAPTIVE only)
  int seg[SLOT_CAP(CT)];
  int flat[SLOT_CAP(CT)];
  int attempts[SLOT_CAP(CT)];  // the slot's failed attempts (read only)
  int off[SLOT_CAP(CT)];       // the slot's holder offset (POL_ADAPTIVE)
};

// Loads each slot's old record with the requester's other inputs: its
// attempt count (which the selection never writes) always, its target
// (and under POL_ADAPTIVE its holder offset) under its own active bit.
template <int CT, int POL>
__device__ __forceinline__ void load_flight(const SelectArgs& a, long long r,
                                            int C, uint32_t fl,
                                            Flight<CT>& f) {
  f.active = 0u;
  f.p2p = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    f.attempts[c] = a.dl_attempts[r * C + c];
    f.seg[c] = 0;
    f.flat[c] = 0;
    if (POL == POL_ADAPTIVE) {
      f.off[c] = 0;
      if ((fl >> (2 * c + 1)) & 1u) f.p2p |= 1u << c;
    }
    if ((fl >> (2 * c)) & 1u) {
      f.active |= 1u << c;
      f.seg[c] = a.dl_seg[r * C + c];
      f.flat[c] = a.dl_level[r * C + c] * a.n_segments + f.seg[c];
      if (POL == POL_ADAPTIVE) f.off[c] = a.dl_holder_off[r * C + c];
    }
  }
}

// What slot c asks for: its old active and is_p2p bits, its wish (the
// foreground's for slot 0; for a prefetch slot the window (:1099-1108): in
// the timeline, within max_buffer_s of the playhead, its retry cooldown
// out, published in live mode), its target segment, and the map bit it
// asks its neighbours for (its stored target while active, :882-894).
struct Target {
  bool active;
  bool p2p;
  bool wants;
  int seg;
  int gi_seg;
  int wi;
  int bit;
};

template <bool LIVE, int CT>
__device__ __forceinline__ Target slot_target(const SelectArgs& a,
                                              long long r, int c, int C,
                                              const PeerIn& in, const Wish& w,
                                              const Flight<CT>& f, float t) {
  const int S = a.n_segments;
  Target tg;
  tg.active = ((f.active >> c) & 1u) != 0u;
  tg.p2p = ((in.fl >> (2 * c + 1)) & 1u) != 0u;
  if (c == 0) {
    tg.seg = w.next_seg;
    tg.wants = w.fg_wants;
  } else {
    const int raw = w.next_seg + c;
    tg.seg = min(raw, S - 1);
    tg.wants = in.present && !tg.active && raw <= S - 1 &&
               ((float)raw * a.seg_duration_s <
                in.playhead + a.max_buffer_s) &&
               a.dl_cooldown_ms[r * C + c] <= 0.0f;
    if (LIVE)
      tg.wants = tg.wants &&
                 (((float)raw + 1.0f) * a.seg_duration_s <= t);
  }
  tg.gi_seg = tg.active ? f.seg[c] : tg.seg;
  const int gi_flat = tg.active ? f.flat[c] : w.want_level * S + tg.seg;
  tg.wi = gi_flat >> 5;
  tg.bit = gi_flat & 31;
  return tg;
}

// The slot's own cache bit (own_c): with prefetch slots, a foreground wish
// the cache holds is absorbed, and a prefetch never fetches what is
// cached.  Read only where the slot wishes; the map is not written while
// the selection runs.
__device__ __forceinline__ bool own_bit(const SelectArgs& a, long long r,
                                        int C, const Target& tg) {
  return C > 1 && tg.wants &&
         ((__ldg(&a.avail[r * a.n_words + tg.wi]) >> tg.bit) & 1u);
}

// The prefetch dedup guard (:1110-1118): slot c's target is already in
// flight on another slot (the processed slots' new records, the later
// slots' old ones).
template <int CT>
__device__ __forceinline__ bool in_flight_elsewhere(const Flight<CT>& f,
                                                    int c, int C, int flat) {
  bool conflict = false;
#pragma unroll
  for (int o = 0; o < C; ++o)
    if (o != c && ((f.active >> o) & 1u) && f.flat[o] == flat)
      conflict = true;
  return conflict;
}

// Adaptive's tier (:1019-1033): each eligible offset k scores own_used[k]
// * 2 + (its penalty window open), where own_used[k] says that another slot
// of the requester rides offset k as an active P2P transfer (the processed
// slots' new records, the later slots' old ones); the offsets of the
// lowest score.  A subset of elig_bits, empty only where it is.
template <int CT>
__device__ __forceinline__ uint32_t adaptive_tier(const Flight<CT>& f, int c,
                                                  int C, uint32_t elig_bits,
                                                  uint32_t pen_bits) {
  uint32_t used = 0u;
#pragma unroll
  for (int o = 0; o < C; ++o)
    if (o != c && (((f.active & f.p2p) >> o) & 1u) &&
        (unsigned)f.off[o] < 32u)
      used |= 1u << f.off[o];
  uint32_t tier = elig_bits & ~used & ~pen_bits;
  if (!tier) tier = elig_bits & ~used & pen_bits;
  if (!tier) tier = elig_bits & used & ~pen_bits;
  if (!tier) tier = elig_bits & used & pen_bits;
  return tier;
}

// Ranked's pick (nth_holder_only, :919-947): the eligible holder of the
// (skip + 1)-th lowest peer id, the last one found where fewer exist.
// Holder k is peer (i + offs[k]) mod P; with the offsets in ascending order
// (rank_order), those that wrap past P - 1 have the lowest ids, so the ids
// ascend over the wrapped offsets, then the others.  -1 where none is
// eligible.
__device__ __forceinline__ int ranked_pick(const SelectArgs& a, long long i,
                                           uint32_t elig_bits, int skip) {
  const long long room = a.n_peers - i;  // offs[k] >= room wraps
  int pick = -1, seen = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int n = 0; n < a.n_offs; ++n) {
      const int k = a.rank_order[n];
      if ((a.offs[k] >= room) != (pass == 0)) continue;
      if ((elig_bits >> k) & 1u) {
        if (seen <= skip) pick = k;
        ++seen;
      }
    }
  return pick;
}

// Ranked's pick on the general path (nth_holder_only :948-957): the
// eligible neighbour of the (skip + 1)-th lowest peer id, the last one found
// where fewer exist; the ids are row r's entries, distinct where they are
// real (make_scenario refuses a repeated one under ranked).  -1 where none
// is eligible.
__device__ __forceinline__ int ranked_pick_ids(const SelectArgs& a,
                                               long long r,
                                               uint32_t elig_bits, int skip) {
  const int* row = a.neighbors + r * a.n_offs;
  int prev = -1, pick = -1;
  for (int s = 0; s <= skip; ++s) {
    int best = 0, best_k = -1;
    for (uint32_t rest = elig_bits; rest; rest &= rest - 1u) {
      const int k = __ffs(rest) - 1;
      const int id = __ldg(&row[k]);
      if (id > prev && (best_k < 0 || id < best)) {
        best = id;
        best_k = k;
      }
    }
    if (best_k < 0) break;
    prev = best;
    pick = best_k;
  }
  return pick;
}

// Slot c's selection after eligibility: elig_bits has bit k set where
// neighbour k holds the slot's target bit and serves (:681-772, serve_ok
// :805).  Writes the slot's outputs only where `owner` holds, sets its new
// flight record, and returns its req.  i is the requester's peer index in
// its lane (the hash's), r its row, t the lane's clock.  NBR: the general
// path, where bit k is the row's k-th neighbour and ranked picks by the ids
// the row holds.
template <bool LIVE, int CT, int POL, bool NBR = false>
__device__ __forceinline__ int slot_finish(const SelectArgs& a, int lane,
                                           long long i, long long r, int c,
                                           int C, const PeerIn& in,
                                           const Wish& w, const Target& tg,
                                           uint32_t elig_bits, bool own,
                                           bool owner, float t,
                                           Flight<CT>& f) {
  const int S = a.n_segments;
  const float n_count = (float)__popc(elig_bits);
  // requester-side connectivity gate (:905-906): elig_k * p2p_req
  const float n_holders = n_count * in.p2p_req;
  if (!(in.p2p_req > 0.0f)) elig_bits = 0u;
  const bool have_n = n_holders > 0.0f;

  // urgency, budget and segment bytes (:1060-1074)
  const float margin = (float)w.next_seg * a.seg_duration_s - in.playhead;
  const bool urgent = margin < (a.urgent_margin_s[lane] + in.margin_off);
  const float budget =
      fminf(fmaxf(margin * 1000.0f * a.p2p_budget_fraction[lane],
                  a.p2p_budget_floor_ms[lane]),
            a.p2p_budget_cap_ms[lane]);
  // the reference's one-hot sum over the ladder: 0 off the ladder
  const float want_rate =
      (w.want_level >= 0 && w.want_level < a.n_levels)
          ? a.bitrates[(long long)lane * a.n_levels + w.want_level]
          : 0.0f;
  const float want_bytes = want_rate * (a.seg_duration_s / 8.0f);

  bool may, is_p2p;
  int extra = 0;
  if (c == 0) {
    // the foreground's start decision (:1133-1175); with prefetch slots
    // a wish the own cache holds is absorbed (:1133-1141)
    const bool absorb = own;
    const bool wants_dl = tg.wants && !absorb;
    bool start_p2p = wants_dl && have_n && !urgent;
    bool start_cdn = wants_dl && !start_p2p;
    if (LIVE) {
      // P2P visibility: the target is announced announce_delay_s after it
      // is published (:1121-1128); the edge stagger: the CDN waits for the
      // peer's stable share of the spread, unless the fetch is urgent
      // (:1143-1164)
      const bool visible =
          t >= ((float)tg.seg + 1.0f) * a.seg_duration_s +
                   a.announce_delay_s[lane];
      const float waited = in.fg_wait + a.dt_ms;
      const bool cdn_allowed =
          waited >= in.edge_rank * a.live_spread_s[lane] * 1000.0f;
      start_p2p = start_p2p && visible;
      start_cdn = wants_dl && !start_p2p && (cdn_allowed || urgent);
    }
    may = start_p2p || start_cdn;
    is_p2p = (may ? start_p2p : tg.p2p) && have_n;
    // bit 4: blocked on the stagger, which TK3's wait clock reads (never
    // in VOD, where every wish starts); bit 5: absorbed
    extra = ((LIVE && wants_dl && !may) ? 16 : 0) | (absorb ? 32 : 0);
  } else {
    // a prefetch start (:1176-1183): P2P only, in the window, uncached,
    // with holders, announced in live mode, not in flight on another slot
    may = tg.wants && have_n && !own &&
          !in_flight_elsewhere<CT>(f, c, C, w.want_level * S + tg.seg);
    if (LIVE)
      may = may && (t >= ((float)tg.seg + 1.0f) * a.seg_duration_s +
                             a.announce_delay_s[lane]);
    is_p2p = tg.p2p || may;
  }
  const bool active = tg.active || may;

  int sel = -1;
  if (POL == POL_RANKED) {
    sel = NBR ? ranked_pick_ids(a, r, elig_bits, c == 0 ? C - 1 : c - 1)
              : ranked_pick(a, i, elig_bits, c == 0 ? C - 1 : c - 1);
  } else {
    // spread holder selection (:959-991), salt (c * 2246822519 + 97) mod
    // 2^32, the rank advanced by the slot's failed attempts: the rank-th
    // set bit of elig_bits, or under adaptive of its lowest tier, whose
    // count takes the holder count's place
    const uint32_t pick_bits =
        POL == POL_ADAPTIVE
            ? adaptive_tier<CT>(f, c, C, elig_bits, in.pen_bits)
            : elig_bits;
    const float n_pick =
        POL == POL_ADAPTIVE ? (float)__popc(pick_bits) : n_holders;
    const uint32_t h = (uint32_t)i * 2654435761u +
                       (uint32_t)tg.gi_seg * 40503u +
                       ((uint32_t)c * 2246822519u + 97u);
    const uint32_t nu = (uint32_t)fmaxf(n_pick, 1.0f);
    const int rank = (int)((h % nu + (uint32_t)f.attempts[c]) % nu);
    if (rank < __popc(pick_bits)) {
      uint32_t rest = pick_bits;
      for (int n = 0; n < rank; ++n) rest &= rest - 1u;
      sel = __ffs(rest) - 1;
    }
  }
  const int new_off = sel >= 0 ? sel : 0;
  // pinning (:1207-1228): under spread and adaptive an active transfer
  // keeps its stored holder, and rides it only while that holder is still
  // eligible; ranked's pick is made anew every step (its stored holder is
  // kept, not ridden)
  int off = new_off;
  if (tg.active && POL != POL_RANKED) {
    off = POL == POL_ADAPTIVE ? f.off[c] : a.dl_holder_off[r * C + c];
    sel = (off >= 0 && off < a.n_offs && ((elig_bits >> off) & 1u)) ? off
                                                                    : -1;
  }
  const bool demand = active && is_p2p && in.present;
  const int req = (demand && sel >= 0) ? sel : -1;
  // the slot's new flight record, which the later slots' guard (and
  // adaptive's own-load key) reads
  if (may) f.flat[c] = w.want_level * S + tg.seg;
  f.active = active ? (f.active | (1u << c)) : (f.active & ~(1u << c));
  if (POL == POL_ADAPTIVE) {
    f.p2p = is_p2p ? (f.p2p | (1u << c)) : (f.p2p & ~(1u << c));
    f.off[c] = off;
  }
  if (!owner) return req;
  const long long rc = r * C + c;
  a.req[rc] = req;
  a.slot_flags[rc] = (may ? 1 : 0) | (active ? 2 : 0) | (is_p2p ? 4 : 0) |
                     (have_n ? 8 : 0) | extra;
  if (!tg.active) a.dl_holder_off[rc] = off;
  if (may) {
    if (c == 0) a.level[r] = w.want_level;
    a.dl_seg[rc] = tg.seg;
    a.dl_level[rc] = w.want_level;
    a.dl_total_bytes[rc] = want_bytes;
    a.dl_done_bytes[rc] = 0.0f;
    a.dl_elapsed_ms[rc] = 0.0f;
    a.dl_budget_ms[rc] = budget;
  }
  return req;
}

template <bool LIVE, int CT, int POL>
__global__ void elig_select_kernel(const SelectArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (i >= P) return;
  const int C = CT > 0 ? CT : a.n_slots;
  const int lane = blockIdx.y;
  const long long lb = (long long)lane * P;  // the lane's first row
  const long long r = lb + i;
  const float t = a.t_s[lane];
  PeerIn in;
  in.present = is_present(t, a.join_s, a.leave_s, r);
  in.p2p_req = a.p2p_ok[r];
  in.fl = a.dl_flags[r];
  in.playhead = a.playhead_s[r];
  in.buffer = a.buffer_s[r];
  in.fast_est = a.fast_estimate[r];
  in.fast_w = a.fast_weight[r];
  in.slow_est = a.slow_estimate[r];
  in.slow_w = a.slow_weight[r];
  in.cap_level = a.abr_cap_level[r];
  in.margin_off = a.urgent_margin_off_s[r];
  if (POL == POL_ADAPTIVE) in.pen_bits = penalty_bits<0>(a, r);
  Flight<CT> f;
  load_flight<CT, POL>(a, r, C, in.fl, f);
  load_live<LIVE>(a, lane, r, t, in);
  const Wish w = select_wish<LIVE>(a, lane, in, t);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Target tg = slot_target<LIVE, CT>(a, r, c, C, in, w, f, t);
    // circulant eligibility (:681-772): neighbour k is (i + o_k) mod P;
    // the holder side is gated on presence and p2p_ok (serve_ok, :805)
    const uint32_t bm = 1u << tg.bit;
    uint32_t elig_bits = 0u;
    for (int k = 0; k < a.n_offs; ++k) {
      long long j = i + a.offs[k];
      if (j >= P) j -= P;
      j += lb;
      const bool serve = is_present(t, a.join_s, a.leave_s, j) &&
                         (a.p2p_ok[j] > 0.0f);
      const bool have = (a.avail[j * a.n_words + tg.wi] & bm) != 0u;
      if (have && serve) elig_bits |= 1u << k;
    }
    const bool own = own_bit(a, r, C, tg);
    slot_finish<LIVE, CT, POL>(a, lane, i, r, c, C, in, w, tg, elig_bits,
                               own, true, t, f);
  }
}

// ---------------------------------------------------------------------------
// TK1 elig_select, gather form: the general [P, K] neighbour-list path
//
// Replaces: the general branch's eligibility (swarm_sim.py:859-866,
// :907-917: nbr_valid, serve_ok[nbr], avail_p[nbr, gi_flat >> 5]) and its
// holder policies and pinning (:948-957, :981-991, :1021-1040,
// :1199-1228), with every other line TK1 replaces.
//
// One thread a requester, as TK1.  It loads its [K] neighbour row once
// and, once for every slot, the serve bits of its real edges (not a self
// entry, the holder present and p2p_ok); per wishing slot it then gathers
// one map word of each serving neighbour.  Bit k of elig_bits is the
// row's k-th entry, so the selection, the pinning to the stored holder
// index k and adaptive's per-edge window read k as on the ring; ranked
// picks by the ids the row holds (ranked_pick_ids).
//
// What bounds it on an H100: the random gathers, each one 32-byte sector
// for 4 useful bytes (a map word, or the three serve fields of a
// neighbour), and their latency: a thread's gathers are issued
// GATHER_RUN at a time, so that they are in flight together.  A lane's map
// at 262,144 peers x 128 segments is 4 MB: the lanes in flight (grid y)
// fit in the 50 MB L2.
template <bool LIVE, int CT, int POL>
__global__ void elig_select_gather_kernel(const SelectArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (i >= P) return;
  const int C = CT > 0 ? CT : a.n_slots;
  const int K = a.n_offs;
  const int lane = blockIdx.y;
  const long long lb = (long long)lane * P;  // the lane's first row
  const long long r = lb + i;
  const float t = a.t_s[lane];
  PeerIn in;
  in.present = is_present(t, a.join_s, a.leave_s, r);
  in.p2p_req = a.p2p_ok[r];
  in.fl = a.dl_flags[r];
  in.playhead = a.playhead_s[r];
  in.buffer = a.buffer_s[r];
  in.fast_est = a.fast_estimate[r];
  in.fast_w = a.fast_weight[r];
  in.slow_est = a.slow_estimate[r];
  in.slow_w = a.slow_weight[r];
  in.cap_level = a.abr_cap_level[r];
  in.margin_off = a.urgent_margin_off_s[r];
  if (POL == POL_ADAPTIVE) in.pen_bits = penalty_bits<0>(a, r);
  Flight<CT> f;
  load_flight<CT, POL>(a, r, C, in.fl, f);
  load_live<LIVE>(a, lane, r, t, in);
  const Wish w = select_wish<LIVE>(a, lane, in, t);
  // the row's real edges whose holder serves (nbr_valid * present_nbr),
  // GATHER_RUN neighbours at a time: their loads go out together
  const int* row = a.neighbors + r * K;
  uint32_t serve_bits = 0u;
  for (int k0 = 0; k0 < K; k0 += GATHER_RUN) {
    long long j[GATHER_RUN];
    float join[GATHER_RUN], leave[GATHER_RUN], ok[GATHER_RUN];
#pragma unroll
    for (int u = 0; u < GATHER_RUN; ++u)
      j[u] = k0 + u < K ? (long long)__ldg(&row[k0 + u]) : i;
#pragma unroll
    for (int u = 0; u < GATHER_RUN; ++u) {
      join[u] = leave[u] = ok[u] = 0.0f;
      if (j[u] != i) {  // a self entry pads the row
        join[u] = __ldg(&a.join_s[lb + j[u]]);
        leave[u] = __ldg(&a.leave_s[lb + j[u]]);
        ok[u] = __ldg(&a.p2p_ok[lb + j[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER_RUN; ++u)
      if (j[u] != i && t >= join[u] && t < leave[u] && ok[u] > 0.0f)
        serve_bits |= 1u << (k0 + u);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Target tg = slot_target<LIVE, CT>(a, r, c, C, in, w, f, t);
    const uint32_t bm = 1u << tg.bit;
    uint32_t elig_bits = 0u;
    for (int k0 = 0; k0 < K; k0 += GATHER_RUN) {
      uint32_t word[GATHER_RUN];
#pragma unroll
      for (int u = 0; u < GATHER_RUN; ++u) {
        const int k = k0 + u;
        word[u] = 0u;
        if (k < K && ((serve_bits >> k) & 1u))
          word[u] = __ldg(
              &a.avail[(lb + __ldg(&row[k])) * a.n_words + tg.wi]);
      }
#pragma unroll
      for (int u = 0; u < GATHER_RUN; ++u)
        if (word[u] & bm) elig_bits |= 1u << (k0 + u);
    }
    const bool own = own_bit(a, r, C, tg);
    slot_finish<LIVE, CT, POL, true>(a, lane, i, r, c, C, in, w, tg,
                                     elig_bits, own, true, t, f);
  }
}

// ---------------------------------------------------------------------------
// TK2 admit_service (reference K3)
//
// Replaces: the circulant admission and service of swarm_sim.py:1259-1303
// (the cap > 0 branch).  Holder side: holder j walks (slot c, offset k) in
// order over requesters r = (j - o_k) mod P, admits each one whose slot c
// selected offset k until max_total_serves (one load count across the
// slots), and writes its service uplink * efficiency / max(load, 1) and,
// per slot, a bit mask of the admitted k ([B, P, C]).  Requesters read
// both back in TK3 (one reader per selected edge), so no flag is
// scattered.
struct AdmitArgs {
  const int* req;
  const float* uplink_bps;
  const float* uplink_efficiency;
  float* service;
  int* adm_mask;
  long long n_peers;
  int n_lanes;
  int n_offs;
  float cap;  // +inf: the uncapped fair share
  int offs[MAX_OFFS];
  int n_slots;
  // the general path (admit_gather_kernel): the inbound edge lists [B, P,
  // n_in] (flat i * K + k, K = n_offs, ascending, padded with -1 at the
  // end); there adm_mask is per (requester, slot) the admitted flag
  const int* in_edges;
  int n_in;
};

template <int CT>
__global__ void admit_service_kernel(const AdmitArgs a) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (j >= P) return;
  const int C = CT > 0 ? CT : a.n_slots;
  const int lane = blockIdx.y;
  const long long lb = (long long)lane * P;
  float cum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint32_t adm = 0u;
    for (int k = 0; k < a.n_offs; ++k) {
      long long r = j - a.offs[k];
      if (r < 0) r += P;
      if (a.req[(lb + r) * C + c] == k && cum < a.cap) {
        cum += 1.0f;
        adm |= 1u << k;
      }
    }
    a.adm_mask[(lb + j) * C + c] = (int)adm;
  }
  a.service[lb + j] =
      a.uplink_bps[lb + j] * a.uplink_efficiency[lane] / fmaxf(cum, 1.0f);
}

// ---------------------------------------------------------------------------
// TK2 admit_gather: the general path's admission and service
//
// Replaces: swarm_sim.py:1304-1349.  Holder j walks, slot by slot, its
// inbound edge list in_edges[j] in order (requester-id-major, as the
// reference's cumsum over the row): edge f = i * K + k contributes where
// requester i's slot c selected its k-th neighbour (req[i, c] == k) and is
// admitted while the holder's count, across the slots, is below the cap
// (+inf uncapped).  Then service[j] = uplink * efficiency / max(load, 1).
//
// The admitted flag goes to the requester's side, adm_mask[i, c], which TK3
// reads: a requester does not know its position in j's row, so it cannot
// read a holder-indexed mask as on the ring.  The flag has exactly one
// writer, the one holder that slot selected, so it needs no atomics; it is
// written wherever req[i, c] >= 0, and TK3 reads it only there, so no pass
// clears it.  What bounds it: the gathers of req, one 32-byte sector per
// edge walked, and their latency: GATHER_RUN edges' loads are issued
// together (req is read-only here, so they may pass the flag stores).
template <int CT>
__global__ void admit_gather_kernel(const AdmitArgs a) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = a.n_peers;
  if (j >= P) return;
  const int C = CT > 0 ? CT : a.n_slots;
  const int K = a.n_offs;
  const int lane = blockIdx.y;
  const long long lb = (long long)lane * P;
  const int* edges = a.in_edges + (lb + j) * a.n_in;
  float cum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // GATHER_RUN edges at a time: their req loads go out together, then
    // the admission walks them in order
    for (int e0 = 0; e0 < a.n_in; e0 += GATHER_RUN) {
      int fl[GATHER_RUN], rq[GATHER_RUN];
#pragma unroll
      for (int u = 0; u < GATHER_RUN; ++u)
        fl[u] = e0 + u < a.n_in ? __ldg(&edges[e0 + u]) : -1;
#pragma unroll
      for (int u = 0; u < GATHER_RUN; ++u)
        rq[u] = fl[u] >= 0 ? __ldg(&a.req[(lb + fl[u] / K) * C + c]) : -1;
#pragma unroll
      for (int u = 0; u < GATHER_RUN; ++u) {
        if (fl[u] < 0) continue;  // the padding trails the row
        const int i = fl[u] / K;
        if (rq[u] == fl[u] - i * K) {
          const bool admit = cum < a.cap;
          if (admit) cum += 1.0f;
          a.adm_mask[(lb + i) * C + c] = admit ? 1 : 0;
        }
      }
      if (fl[GATHER_RUN - 1] < 0) break;
    }
  }
  a.service[lb + j] =
      a.uplink_bps[lb + j] * a.uplink_efficiency[lane] / fmaxf(cum, 1.0f);
}

// ---------------------------------------------------------------------------
// select_admit (reference K1 + K2 + K3, one launch)
//
// Replaces: the same reference lines as TK1 followed by TK2
// (swarm_sim.py:681-772, :959-991, :1053-1183, :1207-1228, :1259-1303).
// Its outputs equal TK1 then TK2 to the bit; TK1 and TK2 remain the route
// for offset tuples whose halo is too wide for a tile (the wrapper in
// ops/swarm_kernels.py picks the route from the offsets before launch).
//
// Tile plus halo.  A block owns SA_TILE consecutive peers [b, b + SA_TILE)
// of one lane (blockIdx.y) as holders and as requesters.  With o_max = max(offsets, 0), o_min =
// min(offsets, 0) and span = o_max - o_min, the requesters of its holders
// are the R = SA_TILE + span peers [b - o_max, b + SA_TILE - o_min), one
// per thread, and their neighbours the H = SA_TILE + 2 span peers from
// b - o_max + o_min.  Every index is taken mod P, so the ring may wrap
// more than once when P < SA_TILE + span; the wrap stays inside the lane.
//   1. Serve bits (present, present && p2p_ok > 0) of the neighbour range
//      go to shared memory once, so each neighbour test reads a byte of
//      shared memory instead of three global arrays.
//   2. Each requester, slot by slot, computes the slot's target
//      (slot_target), tests its K neighbours' map words (K template: the K
//      loads go out together), finishes its selection (slot_finish) and
//      keeps its req in shared memory, one entry per (requester, slot);
//      only the block that owns the peer writes its outputs.  The halo
//      costs span / SA_TILE of recompute.
//   3. Each holder of the tile walks its requesters in (slot, offset) order
//      from shared memory (admission up to the cap, then its service), as
//      TK2.
// Each thread loads its requester's inputs from global memory itself, and
// the map words directly (the K loads of a slot go out together), so the
// map's width is not limited.  Shared memory a block, all static: the
// serve bits, SA_TILE + 2 SA_MAX_SPAN bytes, and req, SA_TILE +
// SA_MAX_SPAN bytes a slot (352 bytes at one slot, 672 at three, 2,752
// for the generic instantiation).  A design that staged the neighbour
// range's map rows whole in dynamic shared memory was timed against this
// one and read slower at one slot; PERF.md §6 records it.  What bounds it
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
// with prefetch slots a requester carries each slot's flight record
// besides: 5 blocks per SM leave it 80 registers
#define SA_SLOT_MIN_BLOCKS 5
// blocks per SM an instantiation asks for: 8 for one slot, 5 for more
#define SA_BLOCKS(CT) ((CT) == 1 ? SA_MIN_BLOCKS : SA_SLOT_MIN_BLOCKS)

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

template <int KT, bool LIVE, int CT, int POL>
__global__ void __launch_bounds__(SA_THREADS, SA_BLOCKS(CT))
    select_admit_kernel(const SelectAdmitArgs a) {
  // the serve bits of the neighbour range (bit 0 present, bit 1 serves)
  // and the req of each (requester, slot) of the requester range
  __shared__ unsigned char serve_s[SA_TILE + 2 * SA_MAX_SPAN];
  __shared__ signed char req_s[(SA_TILE + SA_MAX_SPAN) * SLOT_CAP(CT)];
  const SelectArgs& s = a.sel;
  const long long P = s.n_peers;
  const int C = CT > 0 ? CT : s.n_slots;
  const int K = KT > 0 ? KT : s.n_offs;
  const int span = a.o_max - a.o_min;
  const int R = SA_TILE + span;
  const int H = SA_TILE + 2 * span;
  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const long long lb = (long long)lane * P;  // the lane's first row
  const float t = s.t_s[lane];
  const long long b = (long long)blockIdx.x * SA_TILE;
  const long long q0 = b - a.o_max;   // requester q is peer (q0 + q) mod P
  const long long h0 = q0 + a.o_min;  // neighbour h is peer (h0 + h) mod P

  // 1. serve bits of the neighbour range.  The three loads are taken
  // before the test, so they go out together: behind `&&` the compiler
  // waited for join_s before it loaded leave_s and p2p_ok.
  for (int h = tid; h < H; h += blockDim.x) {
    const long long x = lb + wrap(h0 + h, P);
    const float join = s.join_s[x], leave = s.leave_s[x], p2p = s.p2p_ok[x];
    const bool present = (t >= join) && (t < leave);
    serve_s[h] = (unsigned char)((present ? 1 : 0) |
                                 ((present && p2p > 0.0f) ? 2 : 0));
  }
  __syncthreads();

  // 2. requester q = tid: per slot, its target, its neighbours' words, its
  // selection
  const int q = tid;
  if (q < R) {
    const long long i = wrap(q0 + q, P);
    const long long r = lb + i;
    const int hq = q - a.o_min;  // requester q in the neighbour range
    PeerIn in;
    in.present = (serve_s[hq] & 1) != 0;
    in.p2p_req = s.p2p_ok[r];
    in.fl = s.dl_flags[r];
    in.playhead = s.playhead_s[r];
    in.buffer = s.buffer_s[r];
    in.fast_est = s.fast_estimate[r];
    in.fast_w = s.fast_weight[r];
    in.slow_est = s.slow_estimate[r];
    in.slow_w = s.slow_weight[r];
    in.cap_level = s.abr_cap_level[r];
    in.margin_off = s.urgent_margin_off_s[r];
    if (POL == POL_ADAPTIVE) in.pen_bits = penalty_bits<KT>(s, r);
    Flight<CT> f;
    load_flight<CT, POL>(s, r, C, in.fl, f);
    load_live<LIVE>(s, lane, r, t, in);
    const Wish w = select_wish<LIVE>(s, lane, in, t);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Target tg = slot_target<LIVE, CT>(s, r, c, C, in, w, f, t);
      // circulant eligibility (:681-772); the map is not written in this
      // launch, so its words go through the read-only path.  Each
      // neighbour's serve bit is read whatever its map word holds, and the
      // two are combined without a branch, so the K shared loads go out
      // together.
      uint32_t elig_bits = 0u;
      if (KT > 0) {
        uint32_t wd[KT > 0 ? KT : 1];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          long long j = i + s.offs[k];
          if (j >= P) j -= P;
          wd[k] = __ldg(&s.avail[(lb + j) * s.n_words + tg.wi]);
        }
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const uint32_t serves = (serve_s[hq + a.soffs[k]] >> 1) & 1u;
          elig_bits |= (((wd[k] >> tg.bit) & serves) & 1u) << k;
        }
      } else {
        for (int k = 0; k < K; ++k) {
          long long j = i + s.offs[k];
          if (j >= P) j -= P;
          const uint32_t serves = (serve_s[hq + a.soffs[k]] >> 1) & 1u;
          elig_bits |= (((__ldg(&s.avail[(lb + j) * s.n_words + tg.wi]) >>
                          tg.bit) &
                         serves) & 1u) << k;
        }
      }
      const bool own = own_bit(s, r, C, tg);
      const long long u = (long long)q - a.o_max;  // position in the tile
      const bool owner = u >= 0 && u < SA_TILE && b + u < P;
      req_s[q * C + c] = (signed char)slot_finish<LIVE, CT, POL>(
          s, lane, i, r, c, C, in, w, tg, elig_bits, own, owner, t, f);
    }
  }
  __syncthreads();

  // 3. admission and service of the tile's holders (TK2's walk over
  // (slot, offset)): requester (j - o_k) mod P sits at q = jl - o_k + o_max
  const float eff = a.uplink_efficiency[lane];
  for (int jl = tid; jl < SA_TILE; jl += blockDim.x) {
    if (b + jl >= P) break;
    const long long j = lb + b + jl;
    float cum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t adm = 0u;
#pragma unroll
      for (int k = 0; k < (KT > 0 ? KT : K); ++k) {
        if (req_s[(jl - a.soffs[k] + a.o_max) * C + c] == k && cum < a.cap) {
          cum += 1.0f;
          adm |= 1u << k;
        }
      }
      a.adm_mask[j * C + c] = (int)adm;
    }
    a.service[j] = a.uplink_bps[j] * eff / fmaxf(cum, 1.0f);
  }
}

// ---------------------------------------------------------------------------
// TK3 peer_update (reference K4 + K3's readback)
//
// Replaces: swarm_sim.py:1297-1303 (service readback), the per-slot update
// :1351-1493 with ops/ewma.py update, and playback and the state repack
// :1495-1525.  Per peer, slot by slot in order: reads back the service of
// the slot's selected holder, then progress after the setup time,
// completion; for slot 0 BUSY fast-fail and budget failover, for a
// prefetch slot its abort (holders lost, the request timeout, a BUSY deny),
// its retry cooldown and its attempt rotation (:1436-1466); the byte
// counters, the cache bit-OR into its own row and the EWMA sample.  Then
// playback (an absorbed foreground adds a segment, :1355) and the dl_flags
// word.  Updates the state in place; each thread writes only its own
// peer's row.  Live mode (LIVE) adds the playhead floor (live_playhead),
// the playback cushion (playback starts live_sync_s after the join,
// :1500-1507) and the stagger's wait clock: fg_wait_ms runs on by dt_ms
// where the selection reported the foreground blocked (slot 0's flag bit
// 4), else resets (:1165-1166).  Under "adaptive" (PEN) it also drains and
// re-arms the row's penalty window (update_penalty).
//
// Epilogue (TK4 lane_sums fused in; reference _scan_swarm's step sums and
// ratio :1643-1647): the block sums the cdn_bytes and p2p_bytes its
// threads have just written in lane_sums.cuh's order, TK4's own, so the
// step no longer re-reads 8 B a peer in a launch of its own: each warp its
// run of 32 by shuffles, then warp 0 the 8 runs; the other warps are done.
// The two-level arrival there (32 blocks to a super-partial, then the
// lane's super-partials) keeps each tail to one load a warp lane, since at
// B = 1 the whole grid runs in one wave and the last block's tail is the
// kernel's end.  A thread past the lane's last peer skips the update and
// adds zeros: every thread reaches the barrier.
//
// The clock (reference _scan_swarm's t_s + dt): the lane's last block to
// arrive, after every block of the lane has read t_s, writes t_s[lane] =
// t + dt_s, with t the clock its warp 0 read before arriving: the float32
// add the step's callers made in PyTorch before, so a step is two
// launches (three on the wide-span route) and no clock kernel.  Whatever
// runs after peer_update (the next step, TK5's row) reads the advanced
// clock.
struct UpdateArgs {
  const float* t_s;  // advanced by each lane's last block (the epilogue)
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
  float* partials;  // [B, n_blocks + n_sup, 2] (lane_sums.cuh scratch)
  int* counters;    // [B + B * n_sup], zero between launches
  float* sums;      // [B, 2]: cdn, p2p
  float* series;    // null: sums only
  long long n_peers;
  long long series_stride;
  int n_lanes;
  int n_words;
  int n_segments;
  int n_offs;
  int column;       // series[b * series_stride + column]
  float seg_duration_s;
  float end_s;
  float dt_ms;
  float dt_s;
  float p2p_bps;
  float fast_alpha;
  float slow_alpha;
  float min_sample_ms;
  int offs[MAX_OFFS];
  // live mode, used only by the LIVE instantiation: the per-lane cushion
  // and the per-peer wait clock; live selects the instantiation
  const float* live_sync_s;
  float* fg_wait_ms;
  int live;
  // the prefetch slots: their attempt counts ([B, P, C]), the per-lane
  // request timeout and retry cooldown, and the slot count C
  int* dl_attempts;
  const float* request_timeout_ms;
  const float* retry_dead_ms;
  int n_slots;
  // adaptive's penalty window ([B, P, K], K = n_offs), each slot's holder
  // offset ([B, P, C], as the selection left it) and the per-lane value a
  // failed attempt re-arms the window to; penalty selects the PEN
  // instantiation
  float* holder_penalty_ms;
  const int* dl_holder_off;
  const float* penalty_ms;
  int penalty;
  // the general path (peer_update_gather_kernel): the neighbour list [B, P,
  // K], K = n_offs; there adm_mask holds the requester's admitted flags
  const int* neighbors;
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

// Adaptive's penalty window of row i (:1356-1358, :1405-1417,
// :1459-1466): every offset drains by dt_ms, floored at 0, then the
// offsets in `rearm` (the holders of this step's foreground BUSY deny and
// prefetch aborts) re-open at the lane's holder_penalty_ms, which is the
// reference's where() after its drain in slot order (every re-arm writes
// the same value).  Only this thread touches the row.  A row of +0.0 words
// that re-arms nothing drains to itself and is not written back.  A K = 8
// row is 32 bytes, two 16-byte accesses (the wrapper checks the
// alignment), so a warp's rows are one contiguous kilobyte.
__device__ __forceinline__ void update_penalty(const UpdateArgs& a,
                                               long long i, int lane,
                                               uint32_t rearm) {
  const int K = a.n_offs;
  const float dt = a.dt_ms;
  if (K == 8) {
    float4* row = reinterpret_cast<float4*>(a.holder_penalty_ms + i * 8);
    float4 lo = row[0], hi = row[1];
    const uint32_t open =
        __float_as_uint(lo.x) | __float_as_uint(lo.y) |
        __float_as_uint(lo.z) | __float_as_uint(lo.w) |
        __float_as_uint(hi.x) | __float_as_uint(hi.y) |
        __float_as_uint(hi.z) | __float_as_uint(hi.w);
    if (open == 0u && rearm == 0u) return;
    const float v = rearm ? a.penalty_ms[lane] : 0.0f;
    lo.x = (rearm & 1u) ? v : fmaxf(lo.x - dt, 0.0f);
    lo.y = (rearm & 2u) ? v : fmaxf(lo.y - dt, 0.0f);
    lo.z = (rearm & 4u) ? v : fmaxf(lo.z - dt, 0.0f);
    lo.w = (rearm & 8u) ? v : fmaxf(lo.w - dt, 0.0f);
    hi.x = (rearm & 16u) ? v : fmaxf(hi.x - dt, 0.0f);
    hi.y = (rearm & 32u) ? v : fmaxf(hi.y - dt, 0.0f);
    hi.z = (rearm & 64u) ? v : fmaxf(hi.z - dt, 0.0f);
    hi.w = (rearm & 128u) ? v : fmaxf(hi.w - dt, 0.0f);
    row[0] = lo;
    row[1] = hi;
    return;
  }
  for (int k = 0; k < K; ++k) {
    float* w = a.holder_penalty_ms + i * K + k;
    const bool hit = (rearm >> k) & 1u;
    const float old = *w;
    if (__float_as_uint(old) == 0u && !hit) continue;
    *w = hit ? a.penalty_ms[lane] : fmaxf(old - dt, 0.0f);
  }
}

// Bit `off` of a re-arm mask, for a holder offset the window has.
__device__ __forceinline__ uint32_t rearm_bit(int off, int K) {
  return (off >= 0 && off < K) ? 1u << off : 0u;
}

// One peer's update; returns its new (cdn_bytes, p2p_bytes).  NBR: the
// general path, where the slot's holder is its row's req-th neighbour and
// its admitted flag is its own (admit_gather_kernel).
template <bool LIVE, int CT, bool PEN, bool NBR = false>
__device__ __forceinline__ float2 update_peer(const UpdateArgs& a,
                                              long long p, int lane) {
  const long long P = a.n_peers;
  const int C = CT > 0 ? CT : a.n_slots;
  const long long lb = (long long)lane * P;  // the lane's first row
  const long long i = lb + p;                // this peer's row
  const float t = a.t_s[lane];
  const bool present = is_present(t, a.join_s, a.leave_s, i);
  const int fl0 = a.slot_flags[i * C];
  float cdn_new = a.cdn_bytes[i];
  float p2p_new = a.p2p_bytes[i];
  // an absorbed foreground wish adds its segment (slot 0's bit 5, only
  // with prefetch slots)
  float buffer_add = (C > 1 && (fl0 & 32)) ? a.seg_duration_s : 0.0f;
  uint32_t flags = 0u;
  uint32_t rearm = 0u;  // PEN: the offsets whose window re-arms

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long ic = i * C + c;
    const int fl = c == 0 ? fl0 : a.slot_flags[ic];
    const bool may = (fl & 1) != 0;
    const bool active0 = (fl & 2) != 0;
    const bool is_p2p0 = (fl & 4) != 0;
    const bool have_n = (fl & 8) != 0;

    // service readback through the slot's selected edge (:1297-1303; on
    // the general path :1347-1349)
    const int k = a.req[ic];
    bool admitted = false;
    float svc = 0.0f;
    if (k >= 0) {
      long long j;
      if (NBR) {
        j = lb + __ldg(&a.neighbors[i * a.n_offs + k]);
        admitted = a.adm_mask[ic] != 0;
      } else {
        j = p + a.offs[k];
        if (j >= P) j -= P;
        j += lb;
        admitted = ((a.adm_mask[j * C + c] >> k) & 1) != 0;
      }
      if (admitted) svc = a.service[j];
    }

    // progress (:1362-1394); a prefetch is P2P only
    const float demand = (active0 && is_p2p0 && present) ? 1.0f : 0.0f;
    const float p2p_rate = fminf(demand * svc, a.p2p_bps);
    const bool progressing = active0 && present;
    float elapsed = a.dl_elapsed_ms[ic] + (progressing ? a.dt_ms : 0.0f);
    const float live_ms =
        fminf(fmaxf(elapsed - a.p2p_setup_ms[lane], 0.0f), a.dt_ms);
    const float p2p_step = p2p_rate * live_ms * (1.0f / 8000.0f);
    const float step_bytes =
        (c > 0 || is_p2p0) ? p2p_step : a.cdn_bps[i] * a.dt_s * (1.0f / 8.0f);
    const float total = a.dl_total_bytes[ic];
    const float done0 = a.dl_done_bytes[ic];
    float done = done0 + (progressing ? step_bytes : 0.0f);
    const bool completed = progressing && (done >= total);
    bool active = active0 && !completed;
    bool is_p2p = is_p2p0;
    float cooldown = fmaxf(a.dl_cooldown_ms[ic] - a.dt_ms, 0.0f);

    if (c == 0) {
      const float cdn_accrue = (progressing && !is_p2p0)
                                   ? fminf(step_bytes, fmaxf(total - done0, 0.0f))
                                   : 0.0f;
      // BUSY fast-fail and budget failover (:1397-1427)
      const bool denied = may && is_p2p && have_n && !admitted;
      is_p2p = is_p2p && !denied;
      if (denied) {
        done = 0.0f;
        elapsed = 0.0f;
        if (PEN) rearm |= rearm_bit(a.dl_holder_off[ic], a.n_offs);
      }
      const bool expired = active && is_p2p && (elapsed >= a.dl_budget_ms[ic]);
      is_p2p = is_p2p && !expired;
      if (expired) {
        done = 0.0f;
        elapsed = 0.0f;
      }
      cdn_new = cdn_new + cdn_accrue;
      p2p_new = p2p_new + ((completed && is_p2p) ? total : 0.0f);
      buffer_add = buffer_add + (completed ? a.seg_duration_s : 0.0f);
    } else {
      // prefetch abort (:1436-1466): holders lost, the request timed out,
      // or the holder denied the start; the slot cools down, and its
      // attempts rotate the holder rank until one completes
      const bool aborted =
          (active && !have_n) ||
          (active && elapsed >= a.request_timeout_ms[lane]) ||
          (may && active && have_n && !admitted);
      active = active && !aborted;
      if (aborted) {
        done = 0.0f;
        elapsed = 0.0f;
        cooldown = a.retry_dead_ms[lane];
        a.dl_attempts[ic] = a.dl_attempts[ic] + 1;
        if (PEN) rearm |= rearm_bit(a.dl_holder_off[ic], a.n_offs);
      }
      if (completed) a.dl_attempts[ic] = 0;
      p2p_new = p2p_new + (completed ? total : 0.0f);
    }
    a.dl_cooldown_ms[ic] = cooldown;
    a.dl_done_bytes[ic] = done;
    a.dl_elapsed_ms[ic] = elapsed;
    flags |= ((active ? 1u : 0u) | (is_p2p ? 2u : 0u)) << (2 * c);

    if (completed) {
      // cache insert (:1472): one bit of the own row
      const int gi_flat = a.dl_level[ic] * a.n_segments + a.dl_seg[ic];
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
  }
  a.cdn_bytes[i] = cdn_new;
  a.p2p_bytes[i] = p2p_new;
  a.dl_flags[i] = flags;
  if (PEN) update_penalty(a, i, lane, rearm);

  // playback (:1495-1511)
  float playhead = a.playhead_s[i];
  float buf = a.buffer_s[i] + buffer_add;
  bool can_play;
  if (LIVE) {
    const float join = a.join_s[i];
    const float sync = a.live_sync_s[lane];
    playhead = live_playhead(playhead, join, t, sync);
    can_play = present && (playhead < a.end_s) && (t >= join + sync);
    a.fg_wait_ms[i] = (fl0 & 16) ? a.fg_wait_ms[i] + a.dt_ms : 0.0f;
  } else {
    can_play = present && (playhead < a.end_s);
  }
  const float advance = fminf(buf, a.dt_s) * (can_play ? 1.0f : 0.0f);
  a.playhead_s[i] = playhead + advance;
  a.rebuffer_s[i] = a.rebuffer_s[i] + (can_play ? a.dt_s - advance : 0.0f);
  a.buffer_s[i] = buf - advance;
  return make_float2(cdn_new, p2p_new);
}

// The whole of TK3 for one thread: its peer's update, then the block's
// sums and the lane's epilogue.
template <bool LIVE, int CT, bool PEN, bool NBR>
__device__ __forceinline__ void update_and_sum(const UpdateArgs& a) {
  __shared__ float2 red[BLOCK / 32];
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = blockIdx.y;
  float2 bytes = make_float2(0.0f, 0.0f);
  if (p < a.n_peers) bytes = update_peer<LIVE, CT, PEN, NBR>(a, p, lane);
  const float2 b = ls_block_sum(bytes, red);
  if (threadIdx.x >= 32) return;
  // The clock, read before this block's arrival (so that the lane's last
  // block need not load it in its tail) and after the update (so that it
  // holds no register there); t_s is const for update_peer's reads.
  const float t = a.t_s[lane];
  const LsOut out = {a.sums, a.series, a.series_stride, a.column,
                     const_cast<float*>(a.t_s), t + a.dt_s};
  ls_block_epilogue(b, a.partials, a.counters, a.n_lanes, gridDim.x,
                    blockIdx.x, lane, out);
}

template <bool LIVE, int CT, bool PEN>
__global__ void __launch_bounds__(BLOCK) peer_update_kernel(
    const UpdateArgs a) {
  update_and_sum<LIVE, CT, PEN, false>(a);
}

// TK3 peer_update, gather form: the general path.  Replaces, besides TK3's
// lines, the general branch's readback (swarm_sim.py:1347-1349): the
// holder of slot c is neighbors[i, req], the admitted flag the requester's
// own.  With the uncapped fair share (:1398, :1445) every demand was
// admitted, so no deny or admission abort fires; svc reaches nothing but
// the P2P rate (:1363).
template <bool LIVE, int CT, bool PEN>
__global__ void __launch_bounds__(BLOCK) peer_update_gather_kernel(
    const UpdateArgs a) {
  update_and_sum<LIVE, CT, PEN, true>(a);
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes.  Each launches on the caller's stream
// and returns cudaGetLastError(), so a refused launch reaches the caller.
// A slot count outside 1..MAX_SLOTS is refused before any launch.

// The grid of a per-peer kernel: peers on x, lanes on y.
static inline dim3 grid_for(long long n, int lanes) {
  return dim3((unsigned int)((n + BLOCK - 1) / BLOCK), (unsigned int)lanes);
}

static inline bool slots_ok(int n_slots) {
  return n_slots >= 1 && n_slots <= MAX_SLOTS;
}

// The instantiation for a slot count: CT = 1 and CT = 3 compiled for
// their C, CT = 0 for any other.
#define FOR_SLOTS(n_slots, CALL) \
  do {                           \
    if ((n_slots) == 1)          \
      CALL(1);                   \
    else if ((n_slots) == 3)     \
      CALL(3);                   \
    else                         \
      CALL(0);                   \
  } while (0)

static inline bool policy_ok(const SelectArgs* a) {
  if (a->policy == POL_SPREAD || a->policy == POL_RANKED) return true;
  return a->policy == POL_ADAPTIVE && a->holder_penalty_ms != nullptr;
}

// The instantiation for a holder policy.
#define FOR_POLICY(policy, CALL)     \
  do {                               \
    if ((policy) == POL_ADAPTIVE)    \
      CALL(POL_ADAPTIVE);            \
    else if ((policy) == POL_RANKED) \
      CALL(POL_RANKED);              \
    else                             \
      CALL(POL_SPREAD);              \
  } while (0)

template <int CT, int POL>
static void launch_elig_select_pol(const SelectArgs* a, cudaStream_t st) {
  const dim3 grid = grid_for(a->n_peers, a->n_lanes);
  if (a->live)
    elig_select_kernel<true, CT, POL><<<grid, BLOCK, 0, st>>>(*a);
  else
    elig_select_kernel<false, CT, POL><<<grid, BLOCK, 0, st>>>(*a);
}

template <int CT>
static void launch_elig_select(const SelectArgs* a, cudaStream_t st) {
#define CALL_POL(POL) launch_elig_select_pol<CT, POL>(a, st)
  FOR_POLICY(a->policy, CALL_POL);
#undef CALL_POL
}

extern "C" int swarm_elig_select(const SelectArgs* args, void* stream) {
  if (!slots_ok(args->n_slots) || !policy_ok(args))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
#define CALL(CT) launch_elig_select<CT>(args, st)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

// The gather form of TK1: the neighbour list given, at most MAX_OFFS wide
// (the selection's bit masks).
template <int CT, int POL>
static void launch_elig_select_gather_pol(const SelectArgs* a,
                                          cudaStream_t st) {
  const dim3 grid = grid_for(a->n_peers, a->n_lanes);
  if (a->live)
    elig_select_gather_kernel<true, CT, POL><<<grid, BLOCK, 0, st>>>(*a);
  else
    elig_select_gather_kernel<false, CT, POL><<<grid, BLOCK, 0, st>>>(*a);
}

template <int CT>
static void launch_elig_select_gather(const SelectArgs* a,
                                      cudaStream_t st) {
#define CALL_POL(POL) launch_elig_select_gather_pol<CT, POL>(a, st)
  FOR_POLICY(a->policy, CALL_POL);
#undef CALL_POL
}

extern "C" int swarm_elig_select_gather(const SelectArgs* args,
                                        void* stream) {
  if (!slots_ok(args->n_slots) || !policy_ok(args) || args->n_offs < 0 ||
      args->n_offs > MAX_OFFS ||
      (args->n_offs > 0 && args->neighbors == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
#define CALL(CT) launch_elig_select_gather<CT>(args, st)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

extern "C" int swarm_admit_gather(const AdmitArgs* args, void* stream) {
  if (!slots_ok(args->n_slots) || args->n_in < 0 ||
      (args->n_in > 0 && (args->in_edges == nullptr || args->n_offs <= 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
    const dim3 grid = grid_for(args->n_peers, args->n_lanes);
#define CALL(CT) admit_gather_kernel<CT><<<grid, BLOCK, 0, st>>>(*args)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

extern "C" int swarm_admit_service(const AdmitArgs* args, void* stream) {
  if (!slots_ok(args->n_slots)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
    const dim3 grid = grid_for(args->n_peers, args->n_lanes);
#define CALL(CT) admit_service_kernel<CT><<<grid, BLOCK, 0, st>>>(*args)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

template <int CT, bool PEN, bool NBR>
static void launch_peer_update_pen(const UpdateArgs* a, cudaStream_t st) {
  const dim3 grid = grid_for(a->n_peers, a->n_lanes);
  if (NBR) {
    if (a->live)
      peer_update_gather_kernel<true, CT, PEN><<<grid, BLOCK, 0, st>>>(*a);
    else
      peer_update_gather_kernel<false, CT, PEN><<<grid, BLOCK, 0, st>>>(*a);
  } else {
    if (a->live)
      peer_update_kernel<true, CT, PEN><<<grid, BLOCK, 0, st>>>(*a);
    else
      peer_update_kernel<false, CT, PEN><<<grid, BLOCK, 0, st>>>(*a);
  }
}

template <int CT, bool NBR>
static void launch_peer_update(const UpdateArgs* a, cudaStream_t st) {
  if (a->penalty)
    launch_peer_update_pen<CT, true, NBR>(a, st);
  else
    launch_peer_update_pen<CT, false, NBR>(a, st);
}

// The arguments TK3 needs in both forms, and on the general path the
// neighbour list.
static bool update_args_ok(const UpdateArgs* args, bool nbr) {
  if (args->partials == nullptr || args->counters == nullptr ||
      args->sums == nullptr || args->t_s == nullptr)
    return false;
  if (args->live && (args->live_sync_s == nullptr ||
                     args->fg_wait_ms == nullptr))
    return false;
  if (!slots_ok(args->n_slots) ||
      (args->n_slots > 1 &&
       (args->dl_attempts == nullptr || args->request_timeout_ms == nullptr ||
        args->retry_dead_ms == nullptr)))
    return false;
  if (args->penalty &&
      (args->holder_penalty_ms == nullptr || args->dl_holder_off == nullptr ||
       args->penalty_ms == nullptr))
    return false;
  return !nbr || args->n_offs == 0 || args->neighbors != nullptr;
}

extern "C" int swarm_peer_update(const UpdateArgs* args, void* stream) {
  if (!update_args_ok(args, false)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
#define CALL(CT) launch_peer_update<CT, false>(args, st)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

extern "C" int swarm_peer_update_gather(const UpdateArgs* args,
                                        void* stream) {
  if (!update_args_ok(args, true)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->n_peers > 0 && args->n_lanes > 0) {
#define CALL(CT) launch_peer_update<CT, true>(args, st)
    FOR_SLOTS(args->n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

// select_admit's launch: SA_TILE peers of one lane per block (lanes on the
// grid's y), one thread per requester of the tile and its halo (rounded up
// to a warp).
template <int KT, bool LIVE, int CT, int POL>
static void launch_select_admit_kt(const SelectAdmitArgs* a,
                                   cudaStream_t stream) {
  const long long P = a->sel.n_peers;
  const int span = a->o_max - a->o_min;
  select_admit_kernel<KT, LIVE, CT, POL>
      <<<dim3((unsigned int)((P + SA_TILE - 1) / SA_TILE),
              (unsigned int)a->sel.n_lanes),
         (SA_TILE + span + 31) / 32 * 32, 0, stream>>>(*a);
}

template <int CT, int POL>
static void launch_select_admit_pol(const SelectAdmitArgs* a,
                                    cudaStream_t st) {
  const bool ring8 = a->sel.n_offs == 8;
  if (a->sel.live) {
    if (ring8)
      launch_select_admit_kt<8, true, CT, POL>(a, st);
    else
      launch_select_admit_kt<0, true, CT, POL>(a, st);
  } else {
    if (ring8)
      launch_select_admit_kt<8, false, CT, POL>(a, st);
    else
      launch_select_admit_kt<0, false, CT, POL>(a, st);
  }
}

template <int CT>
static void launch_select_admit(const SelectAdmitArgs* a, cudaStream_t st) {
#define CALL_POL(POL) launch_select_admit_pol<CT, POL>(a, st)
  FOR_POLICY(a->sel.policy, CALL_POL);
#undef CALL_POL
}

// A halo wider than SA_MAX_SPAN is refused; the wrapper never sends one.
extern "C" int swarm_select_admit(const SelectAdmitArgs* args, void* stream) {
  const int span = args->o_max - args->o_min;
  if (span < 0 || span > SA_MAX_SPAN || !slots_ok(args->sel.n_slots) ||
      !policy_ok(&args->sel))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (args->sel.n_peers > 0 && args->sel.n_lanes > 0) {
#define CALL(CT) launch_select_admit<CT>(args, st)
    FOR_SLOTS(args->sel.n_slots, CALL);
#undef CALL
  }
  return (int)cudaGetLastError();
}

// Load every kernel of this library onto the card now, so that none is
// loaded lazily at its first launch, which may fall inside a CUDA graph
// capture.  Called once, when the library is bound.
static cudaError_t preload(const void* const* kernels, int n) {
  cudaFuncAttributes attr;
  for (int i = 0; i < n; ++i) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernels[i]);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int CT, int POL>
static cudaError_t preload_policy() {
  const void* kernels[] = {
      (const void*)elig_select_kernel<false, CT, POL>,
      (const void*)elig_select_kernel<true, CT, POL>,
      (const void*)select_admit_kernel<8, false, CT, POL>,
      (const void*)select_admit_kernel<0, false, CT, POL>,
      (const void*)select_admit_kernel<8, true, CT, POL>,
      (const void*)select_admit_kernel<0, true, CT, POL>,
      (const void*)elig_select_gather_kernel<false, CT, POL>,
      (const void*)elig_select_gather_kernel<true, CT, POL>};
  return preload(kernels, 8);
}

template <int CT>
static cudaError_t preload_slots() {
  const void* kernels[] = {
      (const void*)admit_service_kernel<CT>,
      (const void*)peer_update_kernel<false, CT, false>,
      (const void*)peer_update_kernel<true, CT, false>,
      (const void*)peer_update_kernel<false, CT, true>,
      (const void*)peer_update_kernel<true, CT, true>,
      (const void*)admit_gather_kernel<CT>,
      (const void*)peer_update_gather_kernel<false, CT, false>,
      (const void*)peer_update_gather_kernel<true, CT, false>,
      (const void*)peer_update_gather_kernel<false, CT, true>,
      (const void*)peer_update_gather_kernel<true, CT, true>};
  cudaError_t e = preload(kernels, 10);
  if (e == cudaSuccess) e = preload_policy<CT, POL_SPREAD>();
  if (e == cudaSuccess) e = preload_policy<CT, POL_ADAPTIVE>();
  if (e == cudaSuccess) e = preload_policy<CT, POL_RANKED>();
  return e;
}

extern "C" int swarm_preload(void) {
  cudaError_t e = preload_slots<1>();
  if (e == cudaSuccess) e = preload_slots<3>();
  if (e == cudaSuccess) e = preload_slots<0>();
  return (int)e;
}

// Struct sizes, so the Python side can check its ctypes mirrors.
extern "C" int swarm_args_sizes(long long* out) {
  out[0] = (long long)sizeof(SelectArgs);
  out[1] = (long long)sizeof(AdmitArgs);
  out[2] = (long long)sizeof(UpdateArgs);
  out[3] = (long long)sizeof(SelectAdmitArgs);
  return 0;
}
