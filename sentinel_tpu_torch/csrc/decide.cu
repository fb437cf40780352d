// The decide step of the cluster token server, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU megakernel sentinel_tpu/ops/decide_pallas.py
// (decide_core_pallas -> _call_decide_kernel -> _make_decide_kernel). It
// computes what that kernel computes, per grouped micro-batch of N requests:
//
//   1. the roll: zero column idx_cur of the [F, B, E] flow plane when its
//      recorded window start is stale (launch 1, roll_kernel);
//   2. one gather of each request's [B, E] flow row and [B] occupy row, the
//      PASS + matured borrows + LEASED window read, the warmup curve, the
//      threshold, grouped segment-prefix admission (odd refinement passes or
//      the uniform closed form), the pacing closed form, the priority-occupy
//      headroom check, and the per-segment event totals written back once,
//      at each segment's tail row (launch 2, decide_kernel).
//
// What bounds it. The work is memory traffic: N rows x B buckets x 7 i32
// gathered (flow + occupy), N x 6 i32 written back, and once per 100 ms
// bucket an F x 6 i32 column zeroed. At N=16384, B=10 that is ~4.6 MB read,
// ~0.4 MB written and (when stale) 2.4 MB zeroed at F=100k: about 1.4 us at
// 3.35 TB/s. The arithmetic is a few dozen flops per row.
//
// Design (the simple one, right first): launch 2 is ONE thread block of
// 1024 threads that walks the batch in tiles of 1024 rows, carrying a block
// scan across tiles. Every in-batch segment prefix is such a carried,
// segmented block scan (segments are runs of equal safe_slot: the grouped
// contract). Per-row intermediates live in a global scratch workspace,
// which stays in L2. One block keeps the prefix passes free of grid-wide
// synchronisation; its cost is a dozen sequential passes over the batch.
// The roll is a separate grid-wide launch that reads the stale flag and
// never writes the starts vector, so no block can see a half-updated ring;
// launch 2 reads the pre-roll starts and writes the new start at its end.
//
// Parity with the reference (bitwise):
// - Built with --fmad=false and without --use_fast_math: no a*b+c is
//   contracted behind our back, and every float expression keeps the
//   reference's order. The reference is held as XLA compiles it: XLA turns
//   `x / 1000.0` into `x * 0.001f` and contracts the warmup curve's
//   `above * slope + 1.0 / cnt_safe` into a fused multiply-add; those two
//   sites are written out here (a reciprocal multiply and one fmaf).
// - jnp.round is round-half-to-even: rintf. astype(int32) truncates: a C cast.
// - Integer // and % of the reference are floor ops; the host passes every
//   floor-divided quantity (ring slot, window start, second) precomputed.
//   Integer sums wrap like int32 (unsigned arithmetic, no signed overflow).
// - Precondition: prefix sums are exact because every summed value is an
//   integer-valued float32 and the batch-wide total of each summed quantity
//   stays below 2^24. The reference takes a global cumsum minus a running
//   max of segment bases (engine/prefix.py::_grouped_prefix); the per-segment
//   sums here agree with it exactly under that precondition only.
// - Segment-tail stores are plain stores: the grouped contract gives each
//   flow row exactly one writer (the last in-range row of its segment).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_B = 64;
constexpr int E = 6;
constexpr unsigned FULL = 0xffffffffu;

enum : int {
  EV_PASS = 0,
  EV_PASS_REQUEST = 1,
  EV_BLOCK = 2,
  EV_BLOCK_REQUEST = 3,
  EV_OCCUPIED_PASS = 4,
  EV_LEASED = 5,
};

// per-row float workspace planes, each [N]
enum : int {
  WF_EXPIRING = 0,
  WF_WAITING,
  WF_COST,
  WF_INCL,
  WF_LREL,
  WF_SEGVAL,
  WF_COUNT
};

struct Params {
  int32_t* flow;           // [F, B, E] in/out
  const int32_t* occ;      // [F, B, 1]
  int32_t* fstarts;        // [B] in/out (written at the end)
  const int32_t* ostarts;  // [B]
  int B, N, now, idx_cur, cur_start, cur_sec, horizon, interval_ms;
  int uniform, refine_iters;
  float exceed_count, interval_scale, pass_qps_scale, max_occupy_ratio;
  const int32_t* slot;
  const uint8_t* write_ok;
  const int32_t* acquire;
  const uint8_t* live;
  const uint8_t* active;
  const int32_t* beh;
  const uint8_t* prio;
  const float* factor;
  const float* cnt;
  const float* warn;
  const float* max_token;
  const float* slope;
  const float* cold_count;
  const int32_t* max_queue_ms;
  const int32_t* lpt;
  const float* wtok;
  const int32_t* wfill;
  uint8_t* admit;
  uint8_t* can_occ;
  uint8_t* pace_acc;
  int32_t* pace_wait;
  float* passed;
  float* thr;
  float* admp;
  float* wtok_new;
  uint8_t* do_sync;
  int32_t* lpt_sched;
  float* work_f;    // [WF_COUNT, N]
  int32_t* work_i;  // [N] segment head index
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

struct Smem {
  int fstart[MAX_B];
  int f_valid[MAX_B];
  int o_valid[MAX_B];
  int o_future[MAX_B];
  int exp_mask[MAX_B];
  int warp_flag[WARPS];
  float warp_val[8][WARPS];
  float carry[8];
  int warp_max[WARPS];
  int carry_max;
  float a;
};

// Segmented inclusive scan of K float sums across one tile of THREADS rows,
// continuing the carry of the earlier tiles of this pass. `head` marks the
// first row of a segment; rows past the batch end pass head=false.
template <int K>
__device__ void seg_scan_tile(float (&v)[K], bool head, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = head ? 1 : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(FULL, f, d);
    float ov[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ov[k] = __shfl_up_sync(FULL, v[k], d);
    if (lane >= d) {
      if (!f) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = ov[k] + v[k];
      }
      f |= of;
    }
  }
  if (lane == 31) {
    sm.warp_flag[warp] = f;
#pragma unroll
    for (int k = 0; k < K; ++k) sm.warp_val[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    int wf = sm.warp_flag[lane];
    float wv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wv[k] = sm.warp_val[k][lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int of = __shfl_up_sync(FULL, wf, d);
      float ov[K];
#pragma unroll
      for (int k = 0; k < K; ++k) ov[k] = __shfl_up_sync(FULL, wv[k], d);
      if (lane >= d) {
        if (!wf) {
#pragma unroll
          for (int k = 0; k < K; ++k) wv[k] = ov[k] + wv[k];
        }
        wf |= of;
      }
    }
    sm.warp_flag[lane] = wf;
#pragma unroll
    for (int k = 0; k < K; ++k) sm.warp_val[k][lane] = wv[k];
  }
  __syncthreads();
  if (warp > 0 && !f) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = sm.warp_val[k][warp - 1] + v[k];
    f = sm.warp_flag[warp - 1];
  }
  if (!f) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = sm.carry[k] + v[k];
  }
  __syncthreads();
  if (threadIdx.x == THREADS - 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) sm.carry[k] = v[k];
  }
  __syncthreads();
}

// Inclusive running max of ints across one tile, continuing the carry.
__device__ int max_scan_tile(int v, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, o);
  }
  if (lane == 31) sm.warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = sm.warp_max[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = max(w, o);
    }
    sm.warp_max[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, sm.warp_max[warp - 1]);
  v = max(v, sm.carry_max);
  __syncthreads();
  if (threadIdx.x == THREADS - 1) sm.carry_max = v;
  __syncthreads();
  return v;
}

__device__ __forceinline__ void reset_carry(Smem& sm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) sm.carry[k] = 0.0f;
    sm.carry_max = -1;
  }
  __syncthreads();
}

__device__ __forceinline__ bool is_head(const Params& p, int r) {
  return r == 0 || p.slot[r - 1] != p.slot[r];
}

__device__ __forceinline__ bool active_window(const Params& p, int r) {
  const int b = p.beh[r];
  return p.active[r] != 0 && !(b == 2 || b == 3);
}

__device__ __forceinline__ bool pace_try(const Params& p, int r) {
  const int b = p.beh[r];
  return p.active[r] != 0 && (b == 2 || b == 3);
}

// Launch 1: zero the stale current column over all F flow rows. Every block
// reads the flag from the PRE-roll starts; nobody writes the starts here.
__global__ void roll_kernel(int32_t* flow, const int32_t* fstarts, long long F,
                            int B, int idx_cur, int cur_start) {
  if (fstarts[idx_cur] == cur_start) return;
  const long long total = F * E;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long f = i / E;
    const int e = (int)(i - f * E);
    flow[(f * B + idx_cur) * E + e] = 0;
  }
}

// One pacing pass (the reference's pace_pass): l_rel for every row under
// the acceptance mask in pace_acc. refresh=true first recomputes the mask
// from the previous pass's l_rel.
__device__ void pace_pass(const Params& p, Smem& sm, bool refresh) {
  const int N = p.N;
  float* cost = p.work_f + (size_t)WF_COST * N;
  float* incl = p.work_f + (size_t)WF_INCL * N;
  float* lrel = p.work_f + (size_t)WF_LREL * N;
  float* segval = p.work_f + (size_t)WF_SEGVAL * N;
  const int32_t* seghead = p.work_i;
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    if (r < N && is_head(p, r)) segval[r] = 0.0f;
  }
  __syncthreads();
  reset_carry(sm);
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    const bool in = r < N;
    bool acc = false;
    float c = 0.0f;
    if (in) {
      if (refresh) {
        acc = pace_try(p, r) && (lrel[r] <= (float)p.max_queue_ms[r]);
        p.pace_acc[r] = acc ? 1 : 0;
      } else {
        acc = p.pace_acc[r] != 0;
      }
      c = cost[r];
    }
    float v[2] = {acc ? c : 0.0f, acc ? 1.0f : 0.0f};
    const float c0 = v[0], c1 = v[1];
    seg_scan_tile<2>(v, in && is_head(p, r), sm);
    if (in) {
      const float prefix = v[0] - c0;
      const float rank_p = v[1] - c1;
      incl[r] = prefix + c;
      // at most one first accepted row per segment: a plain store
      if (acc && rank_p == 0.0f) segval[seghead[r]] = c;
    }
  }
  __syncthreads();
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    if (r < N) {
      const float rel0 =
          (float)max(wrap_sub(p.lpt[r], p.now), -(1 << 20));
      const float c_first = segval[seghead[r]];
      lrel[r] = fmaxf(rel0, -c_first) + incl[r];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) decide_kernel(Params p) {
  __shared__ Smem sm;
  const int N = p.N, B = p.B;
  float* expiring = p.work_f + (size_t)WF_EXPIRING * N;
  float* waiting = p.work_f + (size_t)WF_WAITING * N;
  float* cost = p.work_f + (size_t)WF_COST * N;
  float* lrel = p.work_f + (size_t)WF_LREL * N;
  int32_t* seghead = p.work_i;

  // ---- window validity masks from the PRE-roll starts ------------------
  if (threadIdx.x < B) {
    const int b = threadIdx.x;
    const int fs = p.fstarts[b];
    const int os = p.ostarts[b];
    const int f_age = wrap_sub(p.now, fs);
    const int o_age = wrap_sub(p.now, os);
    const int o_ahead = wrap_sub(os, p.now);
    sm.fstart[b] = fs;
    sm.f_valid[b] = (f_age >= 0 && f_age < p.interval_ms) ? 1 : 0;
    sm.o_valid[b] = (o_age >= 0 && o_age < p.interval_ms) ? 1 : 0;
    sm.o_future[b] = (o_ahead > 0 && o_ahead <= p.interval_ms) ? 1 : 0;
    sm.exp_mask[b] = (sm.f_valid[b] && fs <= p.horizon) ? 1 : 0;
  }
  reset_carry(sm);

  // ---- pass 1: gather, window read, warmup curve, threshold ------------
  int my_amax = 0;
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    const bool in = r < N;
    const bool head = in && is_head(p, r);
    const int h = max_scan_tile(head ? r : -1, sm);
    if (!in) continue;
    seghead[r] = h;
    const int s = p.slot[r];
    const int32_t* frow = p.flow + (size_t)s * B * E;
    const int32_t* orow = p.occ + (size_t)s * B;
    int sp = 0, so = 0, sl = 0, se = 0, sw = 0;
    for (int b = 0; b < B; ++b) {
      const int pv = frow[b * E + EV_PASS];
      const int lv = frow[b * E + EV_LEASED];
      const int ov = orow[b];
      sp = wrap_add(sp, wrap_mul(pv, sm.f_valid[b]));
      so = wrap_add(so, wrap_mul(ov, sm.o_valid[b]));
      sl = wrap_add(sl, wrap_mul(lv, sm.f_valid[b]));
      se = wrap_add(se, wrap_mul(pv, sm.exp_mask[b]));
      sw = wrap_add(sw, wrap_mul(ov, sm.o_future[b]));
    }
    const float passed = (float)wrap_add(wrap_add(sp, so), sl);
    expiring[r] = (float)se;
    waiting[r] = (float)sw;

    const int beh = p.beh[r];
    const bool act = p.active[r] != 0;
    const bool is_warm = beh == 1 || beh == 3;
    const bool is_pace = beh == 2 || beh == 3;
    const bool warm_rows = act && is_warm;
    if (p.live[r]) my_amax = max(my_amax, p.acquire[r]);

    // warmup curve (engine/decide.py::_warmup_curve, same op order)
    const float cnt = p.cnt[r];
    const float cnt_safe = fmaxf(cnt, 1e-6f);
    const float warn = p.warn[r];
    const float tokens = p.wtok[r];
    const int filled = p.wfill[r];
    const float pass_qps = passed * p.pass_qps_scale;
    const bool can_refill =
        (tokens < warn) || ((tokens > warn) && (pass_qps < p.cold_count[r]));
    const float elapsed = (float)wrap_sub(p.cur_sec, filled);
    // the reference's `elapsed * cnt_safe / 1000.0`, as XLA evaluates it:
    // a division by a constant becomes a multiply by its reciprocal
    const float cooled = fminf(
        tokens + (can_refill ? elapsed * cnt_safe * 0.001f : 0.0f),
        p.max_token[r]);
    const float synced = fmaxf(cooled - pass_qps, 0.0f);
    const bool sync = warm_rows && (p.cur_sec > filled);
    const float tokens_new = sync ? synced : tokens;
    const float above = fmaxf(tokens_new - warn, 0.0f);
    // `above * slope + 1.0 / cnt_safe`, which XLA contracts into one fused
    // multiply-add: the one explicit fmaf of this file
    const float warning_qps = 1.0f / fmaf(above, p.slope[r], 1.0f / cnt_safe);
    const float qps = (warm_rows && tokens_new >= warn) ? warning_qps : cnt;

    const float rate_qps = qps * p.factor[r] * p.exceed_count;
    const float threshold = rate_qps * p.interval_scale;
    const float acq_f = (float)p.acquire[r];
    p.passed[r] = passed;
    p.thr[r] = threshold;
    p.wtok_new[r] = tokens_new;
    p.do_sync[r] = sync ? 1 : 0;
    cost[r] = rintf(1000.0f * acq_f / fmaxf(rate_qps, 1e-6f));
    p.admit[r] = active_window(p, r) ? 1 : 0;
    p.pace_acc[r] = (act && is_pace) ? 1 : 0;
  }
  // block max of live acquires (uniform closed form)
  for (int d = 16; d > 0; d >>= 1) {
    my_amax = max(my_amax, __shfl_xor_sync(FULL, my_amax, d));
  }
  if ((threadIdx.x & 31) == 0) sm.warp_max[threadIdx.x >> 5] = my_amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < WARPS; ++w) m = max(m, sm.warp_max[w]);
    sm.a = (float)m;
  }
  __syncthreads();

  // ---- admission --------------------------------------------------------
  if (p.uniform) {
    const float a = sm.a;
    const float a_safe = fmaxf(a, 1.0f);
    reset_carry(sm);
    for (int t = 0; t < N; t += THREADS) {
      const int r = t + threadIdx.x;
      const bool in = r < N;
      const bool aw = in && active_window(p, r);
      float v[1] = {aw ? 1.0f : 0.0f};
      const float c0 = v[0];
      seg_scan_tile<1>(v, in && is_head(p, r), sm);
      if (!in) continue;
      const float rank = v[0] - c0;
      const float passed = p.passed[r], thr = p.thr[r];
      p.admit[r] = (aw && (passed + rank * a + a <= thr)) ? 1 : 0;
      const float quota = floorf(fmaxf(thr - passed, 0.0f) / a_safe);
      p.admp[r] = fminf(rank, quota) * a;
    }
  } else {
    for (int it = 0; it <= p.refine_iters; ++it) {
      // iterations 0..refine_iters-1 refine the mask; the last pass only
      // takes the admitted prefix
      const bool last = it == p.refine_iters;
      reset_carry(sm);
      for (int t = 0; t < N; t += THREADS) {
        const int r = t + threadIdx.x;
        const bool in = r < N;
        const bool adm = in && p.admit[r] != 0;
        const float acq_f = in ? (float)p.acquire[r] : 0.0f;
        float v[1] = {adm ? acq_f : 0.0f};
        const float c0 = v[0];
        seg_scan_tile<1>(v, in && is_head(p, r), sm);
        if (!in) continue;
        const float prefix = v[0] - c0;
        if (last) {
          p.admp[r] = prefix;
        } else {
          p.admit[r] = (active_window(p, r) &&
                        (p.passed[r] + prefix + acq_f <= p.thr[r]))
                           ? 1
                           : 0;
        }
      }
    }
  }

  // ---- priority occupy headroom ------------------------------------------
  reset_carry(sm);
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    const bool in = r < N;
    bool try_occ = false;
    float acq_f = 0.0f;
    if (in) {
      try_occ = active_window(p, r) && p.admit[r] == 0 && p.prio[r] != 0 &&
                p.beh[r] == 0;
      acq_f = (float)p.acquire[r];
    }
    float v[1] = {try_occ ? acq_f : 0.0f};
    const float c0 = v[0];
    seg_scan_tile<1>(v, in && is_head(p, r), sm);
    if (!in) continue;
    const float occ_prefix = v[0] - c0;
    p.can_occ[r] =
        (try_occ && (p.passed[r] - expiring[r] + p.admp[r] + waiting[r] +
                         occ_prefix + acq_f <=
                     p.max_occupy_ratio * p.thr[r]))
            ? 1
            : 0;
  }

  // ---- pacing closed form -----------------------------------------------
  pace_pass(p, sm, false);
  const int refine = p.uniform ? 0 : p.refine_iters;
  for (int i = 0; i < refine; ++i) pace_pass(p, sm, true);

  // ---- final pacing verdicts, event totals, segment-tail write-back -----
  reset_carry(sm);
  for (int t = 0; t < N; t += THREADS) {
    const int r = t + threadIdx.x;
    const bool in = r < N;
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (in) {
      const float l = lrel[r];
      const bool ptry = pace_try(p, r);
      const bool acc = ptry && (l <= (float)p.max_queue_ms[r]);
      const int wait_i = (int)fmaxf(l, 0.0f);
      p.pace_acc[r] = acc ? 1 : 0;
      p.pace_wait[r] = wait_i;
      p.lpt_sched[r] = wrap_add(p.now, (int)rintf(l));
      const bool adm = p.admit[r] != 0;
      const bool pace_now = acc && wait_i == 0;
      const bool hard = (active_window(p, r) && !adm && p.can_occ[r] == 0) ||
                        (ptry && !acc);
      const int acq = p.acquire[r];
      const int admit_i = (adm || pace_now) ? 1 : 0;
      const int hard_i = hard ? 1 : 0;
      v[EV_PASS] = (float)wrap_mul(acq, admit_i);
      v[EV_PASS_REQUEST] = (float)admit_i;
      v[EV_BLOCK] = (float)wrap_mul(acq, hard_i);
      v[EV_BLOCK_REQUEST] = (float)hard_i;
      v[EV_OCCUPIED_PASS] =
          (float)wrap_mul(acq, (adm && p.prio[r] != 0) ? 1 : 0);
    }
    seg_scan_tile<5>(v, in && is_head(p, r), sm);
    if (in && p.write_ok[r]) {
      int32_t* cell = p.flow + ((size_t)p.slot[r] * B + p.idx_cur) * E;
#pragma unroll
      for (int e = 0; e < 5; ++e) cell[e] = wrap_add(cell[e], (int)v[e]);
    }
  }
  if (threadIdx.x == 0) p.fstarts[p.idx_cur] = p.cur_start;
}

}  // namespace

extern "C" int sentinel_decide_rows(
    int32_t* flow, const int32_t* occ, int32_t* fstarts,
    const int32_t* ostarts, long long F, int B, int N, int now, int idx_cur,
    int cur_start, int cur_sec, int horizon, int interval_ms, int uniform,
    int refine_iters, float exceed_count, float interval_scale,
    float pass_qps_scale, float max_occupy_ratio, const int32_t* slot,
    const uint8_t* write_ok, const int32_t* acquire, const uint8_t* live,
    const uint8_t* active, const int32_t* beh, const uint8_t* prio,
    const float* factor, const float* cnt, const float* warn,
    const float* max_token, const float* slope, const float* cold_count,
    const int32_t* max_queue_ms, const int32_t* lpt, const float* wtok,
    const int32_t* wfill, uint8_t* admit, uint8_t* can_occ,
    uint8_t* pace_acc, int32_t* pace_wait, float* passed, float* thr,
    float* admp, float* wtok_new, uint8_t* do_sync, int32_t* lpt_sched,
    float* work_f, int32_t* work_i, void* stream) {
  if (B < 1 || B > MAX_B || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = F * E;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  roll_kernel<<<(unsigned)blocks, 256, 0, st>>>(flow, fstarts, F, B, idx_cur,
                                                cur_start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.flow = flow;
  p.occ = occ;
  p.fstarts = fstarts;
  p.ostarts = ostarts;
  p.B = B;
  p.N = N;
  p.now = now;
  p.idx_cur = idx_cur;
  p.cur_start = cur_start;
  p.cur_sec = cur_sec;
  p.horizon = horizon;
  p.interval_ms = interval_ms;
  p.uniform = uniform;
  p.refine_iters = refine_iters;
  p.exceed_count = exceed_count;
  p.interval_scale = interval_scale;
  p.pass_qps_scale = pass_qps_scale;
  p.max_occupy_ratio = max_occupy_ratio;
  p.slot = slot;
  p.write_ok = write_ok;
  p.acquire = acquire;
  p.live = live;
  p.active = active;
  p.beh = beh;
  p.prio = prio;
  p.factor = factor;
  p.cnt = cnt;
  p.warn = warn;
  p.max_token = max_token;
  p.slope = slope;
  p.cold_count = cold_count;
  p.max_queue_ms = max_queue_ms;
  p.lpt = lpt;
  p.wtok = wtok;
  p.wfill = wfill;
  p.admit = admit;
  p.can_occ = can_occ;
  p.pace_acc = pace_acc;
  p.pace_wait = pace_wait;
  p.passed = passed;
  p.thr = thr;
  p.admp = admp;
  p.wtok_new = wtok_new;
  p.do_sync = do_sync;
  p.lpt_sched = lpt_sched;
  p.work_f = work_f;
  p.work_i = work_i;
  decide_kernel<<<1, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int sentinel_decide_work_planes() { return WF_COUNT; }
