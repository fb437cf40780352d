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
// What bounds it. The work is memory traffic: each distinct flow row's
// B x 7 i32 (flow + occupy) gathered, the [N] input columns read, the [N]
// outputs and one [E] cell a segment written, and once per 100 ms bucket an
// F x 6 i32 column zeroed. chip_smoke.py::decide_bytes counts those bytes for
// the batch it times and prints the bound beside the measured time; the
// arithmetic is a few dozen flops a row.
//
// Design. Under the grouped contract (rows of one safe_slot are one
// contiguous run, a segment) everything a row's answer depends on lies in
// its own segment: the segment head, every admission, occupy and pacing
// prefix, the first accepted pacing cost, the tail totals, and the one flow
// row the segment reads and writes. So launch 2 is a grid of about one block
// per SM, and a block owns WHOLE segments:
//
// - Block b has the nominal range [b*C, (b+1)*C). It owns the rows from the
//   first segment head at or after b*C to the first head at or after
//   (b+1)*C (or N); it finds both by a forward ballot search over `slot`.
//   The owned ranges tile [0, N) exactly; a block whose nominal range holds
//   no head owns nothing and exits. Blocks never talk to each other.
// - Inside its range a block walks tiles of T rows (T = 1024, its width:
//   the fastest of 256, 512 and 1024 on the Zipf batch, PERF.md). Every
//   prefix is a segmented block scan whose carry runs across the block's own
//   tiles in registers, so a hot segment longer than a tile (or than C) is
//   still right; the all-one-flow batch degenerates to one block.
// - The scans of independent chains share a tile loop. Round k does
//   admission pass k and pacing pass k in one scan; round 0 also gathers
//   and numbers the segment heads, the last round also takes the occupy
//   prefix; one more scan sums the event totals. A mixed step with three
//   refinement passes is 5 scans a tile (the uniform form 3), one
//   __syncthreads each (the warp totals are double-buffered and every warp
//   scans them for itself).
// - Per-row intermediates live in shared memory (13 planes of up to SROWS
//   rows; a row is always handled by the same thread). Only a block whose
//   owned range exceeds SROWS uses its own rows of the global workspace
//   instead, through the same pointers. Every output column is stored once,
//   when its value is final.
// - The two values that are not per segment come from launch 1, through a
//   small scratch: the five window masks, computed from the PRE-roll starts
//   by one block of roll_kernel, and the uniform form's `a` (the max of the
//   live acquires) as per-block partial maxima that every decide block
//   reduces. Launch 2 never reads `fstarts`; one thread records the new
//   start. No atomics, no memset.
// - A step with no rows (a mesh shard that owns none of a frame) still
//   rolls: launch 1 alone, over the F x E column as always, then one thread
//   (start_kernel) records the new start. No grid over rows is launched.
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
//   integer-valued float32 and each SEGMENT's total of each summed quantity
//   stays below 2^24 (no sum here crosses a segment). The reference takes a
//   batch-wide cumsum minus a running max of segment bases
//   (engine/prefix.py::_grouped_prefix), exact while the BATCH total stays
//   below 2^24: the stronger condition, so wherever the reference is exact
//   this kernel agrees with it.
// - Precondition: the in-range rows of one slot are contiguous. Rows out of
//   range (no rule, padding) carry safe_slot 0 wherever they stand: sorted
//   as slot -1 they join the real slot-0 segment, as padding they form a
//   run of their own at the batch's end. They never write, but they read
//   flow row 0 while another block may be storing its current cell. So
//   launch 1 snapshots that one PASS count (post-roll) into the scratch, and
//   every slot-0 row reads it from there: what the reference's gather sees.
// - Segment-tail stores are plain stores: each flow row has exactly one
//   writer (the last in-range row of its segment), in the block that also
//   holds its only other readers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_B = 64;
constexpr int E = 6;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SROWS = 4096;     // rows a block keeps in shared memory
constexpr int MAX_PARTS = 64;   // partial maxima of the live acquires
constexpr int ROLL_THREADS = 256;
constexpr int T = 1024;  // threads of a decide block, and rows of a tile
// scratch (int32): [0, MAX_B) the window masks, then MAX_PARTS partial
// maxima, then the post-roll PASS count of flow row 0's current cell
constexpr int SCRATCH_PARTS = MAX_B;
constexpr int SCRATCH_SNAP = MAX_B + MAX_PARTS;
constexpr int SCRATCH_INTS = SCRATCH_SNAP + 1;

enum : int {
  EV_PASS = 0,
  EV_PASS_REQUEST = 1,
  EV_BLOCK = 2,
  EV_BLOCK_REQUEST = 3,
  EV_OCCUPIED_PASS = 4,
  EV_LEASED = 5,
};

// window masks of one ring bucket, one bit each
enum : int { M_F_VALID = 1, M_O_VALID = 2, M_O_FUTURE = 4, M_EXPIRING = 8 };

// per-row planes of 32-bit words, local to a block's owned rows
enum : int {
  PL_PASSED = 0,
  PL_THR,
  PL_COST,
  PL_ACQ,  // int32
  PL_REL0,
  PL_MAXQ,
  PL_LREL,  // incl inside a round, l_rel after its sweep
  PL_EXPIRING,
  PL_WAITING,
  PL_ADMP,
  PL_SEGVAL,   // at a segment head's row: its first accepted pacing cost
  PL_FLAGS,    // int32, FL_* bits
  PL_SEGHEAD,  // int32, local index of the row's segment head
  PL_COUNT
};

enum : int {
  FL_HEAD = 1,
  FL_AW = 2,     // active, window-admitted behaviors
  FL_PTRY = 4,   // active, pacing behaviors
  FL_PRIO = 8,
  FL_BEH0 = 16,
  FL_WRITE = 32,
  FL_ADMIT = 64,
  FL_PACC = 128,
  FL_CANOCC = 256,
};

struct Params {
  int32_t* flow;       // [F, B, E] in/out
  const int32_t* occ;  // [F, B, 1]
  int32_t* fstarts;    // [B]: only written (the new start), never read here
  int B, N, now, idx_cur, cur_start, cur_sec;
  int uniform, refine_iters, chunk, parts;
  float exceed_count, interval_scale, pass_qps_scale, max_occupy_ratio;
  const int32_t* slot;
  const uint8_t* write_ok;
  const int32_t* acquire;
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
  uint32_t* work;          // [PL_COUNT, N] words, used by oversized blocks
  const int32_t* scratch;  // [SCRATCH_INTS], written by launch 1
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

// Warp totals of one block scan, double-buffered: scan n uses buffer n & 1,
// so one barrier a scan orders its writes before its reads, and the barrier
// of scan n + 1 orders those reads before scan n + 2 writes the buffer again.
struct ScanBuf {
  int flag[2][32];
  float val[2][5][32];
};

// Segmented inclusive scan of K float sums over one tile of T rows (thread
// t holds row t of the tile), continuing `carry` from the block's earlier
// tiles of this pass. `head` marks the first row of a segment; rows past the
// owned range pass head=false and zeros. `carry` and `par` are the same in
// every thread of the block.
template <int K>
__device__ __forceinline__ void seg_scan(float (&v)[K], bool head,
                                         float (&carry)[K], ScanBuf& sb,
                                         int& par) {
  constexpr int WARPS = T / 32;
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
    sb.flag[par][warp] = f;
#pragma unroll
    for (int k = 0; k < K; ++k) sb.val[par][k][warp] = v[k];
  }
  __syncthreads();
  // every warp scans the warp totals for itself
  int wf = lane < WARPS ? sb.flag[par][lane] : 0;
  float wv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wv[k] = lane < WARPS ? sb.val[par][k][lane] : 0.0f;
#pragma unroll
  for (int d = 1; d < WARPS; d <<= 1) {
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
  const int src = warp > 0 ? warp - 1 : 0;
  const int pf_any = __shfl_sync(FULL, wf, src);
  const int tf = __shfl_sync(FULL, wf, WARPS - 1);
  const int pf = warp > 0 ? pf_any : 0;  // a head in an earlier warp
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float pv = __shfl_sync(FULL, wv[k], src);
    const float tv = __shfl_sync(FULL, wv[k], WARPS - 1);
    if (!f) {
      if (warp > 0) v[k] = pv + v[k];
      if (!pf) v[k] = carry[k] + v[k];
    }
    carry[k] = tf ? tv : carry[k] + tv;
  }
  par ^= 1;
}

// Launch 1. Block 0 writes the window masks from the PRE-roll starts and
// the snapshot of flow row 0's current PASS count as the roll leaves it; the
// first `parts` blocks write partial maxima of the live acquires (parts = 0
// unless the step is uniform); then every block zeroes its share of the
// stale current column. Nobody writes the starts here, so every block sees
// the same flag.
__global__ void __launch_bounds__(ROLL_THREADS)
    roll_kernel(int32_t* flow, const int32_t* fstarts, const int32_t* ostarts,
                long long F, int B, int idx_cur, int cur_start, int now,
                int interval_ms, int horizon, int N, const int32_t* acquire,
                const uint8_t* live, int parts, int32_t* scratch) {
  __shared__ int s_max[ROLL_THREADS / 32];
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < B) {
    const int fs = fstarts[tid];
    const int os = ostarts[tid];
    const int f_age = wrap_sub(now, fs);
    const int o_age = wrap_sub(now, os);
    const int o_ahead = wrap_sub(os, now);
    const bool f_valid = f_age >= 0 && f_age < interval_ms;
    int m = f_valid ? M_F_VALID : 0;
    if (o_age >= 0 && o_age < interval_ms) m |= M_O_VALID;
    if (o_ahead > 0 && o_ahead <= interval_ms) m |= M_O_FUTURE;
    if (f_valid && fs <= horizon) m |= M_EXPIRING;
    scratch[tid] = m;
    if (tid == 0)
      scratch[SCRATCH_SNAP] = fstarts[idx_cur] == cur_start
                                  ? flow[(long long)idx_cur * E + EV_PASS]
                                  : 0;
  }
  if ((int)blockIdx.x < parts) {
    int m = 0;
    for (int i = blockIdx.x * ROLL_THREADS + tid; i < N;
         i += parts * ROLL_THREADS)
      if (live[i]) m = max(m, acquire[i]);
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(FULL, m, d));
    if ((tid & 31) == 0) s_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < ROLL_THREADS / 32; ++w) m = max(m, s_max[w]);
      scratch[SCRATCH_PARTS + blockIdx.x] = m;
    }
  }
  if (fstarts[idx_cur] == cur_start) return;
  const long long total = F * E;
  for (long long i = blockIdx.x * (long long)ROLL_THREADS + tid; i < total;
       i += (long long)gridDim.x * ROLL_THREADS) {
    const long long f = i / E;
    const int e = (int)(i - f * E);
    flow[(f * B + idx_cur) * E + e] = 0;
  }
}

// A step with no rows: what launch 2's first thread does besides its rows,
// recording the new window start once launch 1 has read the old one.
__global__ void start_kernel(int32_t* fstarts, int idx_cur, int cur_start) {
  fstarts[idx_cur] = cur_start;
}

// The first segment head in [start, end) (N when there is none), found by
// the whole block; `found` is a shared int preset to N.
__device__ int first_head(const int32_t* slot, int N, int start, int end,
                          int* found) {
  const int lane = threadIdx.x & 31;
  for (int base = start; base < end; base += T) {
    const int r = base + threadIdx.x;
    const bool h = r < end && (r == 0 || slot[r - 1] != slot[r]);
    const unsigned m = __ballot_sync(FULL, h);
    if (m != 0 && lane == 0) atomicMin(found, r + __ffs(m) - 1);
    if (__syncthreads_or(h ? 1 : 0)) return *found;
  }
  return N;
}

// The block's per-row planes: shared memory, or its own rows of the global
// workspace when it owns more than SROWS rows.
struct Planes {
  float *passed, *thr, *cost, *rel0, *maxq, *lrel, *expiring, *waiting, *admp,
      *segval;
  int *acq, *flags, *seghead;
};

__global__ void __launch_bounds__(T, 1) decide_kernel(Params p) {
  extern __shared__ uint32_t dyn[];
  __shared__ ScanBuf sb;
  __shared__ int s_mask[MAX_B];
  __shared__ int s_bound[2];
  __shared__ float s_a;
  const int tid = threadIdx.x;
  const int N = p.N, B = p.B;

  if (tid < B) s_mask[tid] = p.scratch[tid];
  if (tid < 2) s_bound[tid] = N;
  if (p.uniform && tid < 32) {
    int m = 0;
    for (int i = tid; i < p.parts; i += 32)
      m = max(m, p.scratch[SCRATCH_PARTS + i]);
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(FULL, m, d));
    if (tid == 0) s_a = (float)m;
  }
  if (blockIdx.x == 0 && tid == 0) p.fstarts[p.idx_cur] = p.cur_start;
  __syncthreads();

  // ---- the owned range: whole segments whose head lies in [c0, c1) --------
  const int c0 = blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, N);
  const int lo = first_head(p.slot, N, c0, c1, &s_bound[0]);
  if (lo >= c1) return;  // no head in the nominal range (the whole block)
  const int hi =
      c1 >= N ? N : first_head(p.slot, N, c1, N, &s_bound[1]);
  const int n = hi - lo;

  Planes w;
  {
    const bool fits = n <= SROWS;
    uint32_t* base = fits ? dyn : p.work + lo;
    const size_t stride = fits ? (size_t)SROWS : (size_t)N;
    w.passed = (float*)(base + PL_PASSED * stride);
    w.thr = (float*)(base + PL_THR * stride);
    w.cost = (float*)(base + PL_COST * stride);
    w.acq = (int*)(base + PL_ACQ * stride);
    w.rel0 = (float*)(base + PL_REL0 * stride);
    w.maxq = (float*)(base + PL_MAXQ * stride);
    w.lrel = (float*)(base + PL_LREL * stride);
    w.expiring = (float*)(base + PL_EXPIRING * stride);
    w.waiting = (float*)(base + PL_WAITING * stride);
    w.admp = (float*)(base + PL_ADMP * stride);
    w.segval = (float*)(base + PL_SEGVAL * stride);
    w.flags = (int*)(base + PL_FLAGS * stride);
    w.seghead = (int*)(base + PL_SEGHEAD * stride);
  }

  const float a = p.uniform ? s_a : 0.0f;
  const float a_safe = fmaxf(a, 1.0f);
  const int snap0 = p.scratch[SCRATCH_SNAP];
  // rounds 0..R: admission pass k and pacing pass k share scan k
  const int R = p.uniform ? 0 : p.refine_iters;
  int par = 0;

  for (int it = 0; it <= R; ++it) {
    const bool last = it == R;
    float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < n; t += T) {
      const int j = t + tid;
      const bool in = j < n;
      const int r = lo + j;
      int fl = 0, acq = 0;
      float passed = 0.0f, thr = 0.0f, cost = 0.0f;
      // v: rows (round 0), admission contribution, accepted pacing cost and
      // count; in the last mixed round v[0] is the occupy contribution
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (in && it == 0) {
        // ---- gather, window read, warmup curve, threshold ----------------
        const int s = p.slot[r];
        const int32_t* frow = p.flow + (size_t)s * B * E;
        const int32_t* orow = p.occ + (size_t)s * B;
        int sp = 0, so = 0, sl = 0, se = 0, sw = 0;
        for (int b = 0; b < B; ++b) {
          // flow row 0's current cell may be being stored by its segment's
          // block: read the snapshot launch 1 took
          const int pv = (s == 0 && b == p.idx_cur) ? snap0
                                                    : frow[b * E + EV_PASS];
          const int lv = frow[b * E + EV_LEASED];
          const int ov = orow[b];
          const int m = s_mask[b];
          const int fv = m & M_F_VALID ? 1 : 0;
          sp = wrap_add(sp, wrap_mul(pv, fv));
          so = wrap_add(so, wrap_mul(ov, m & M_O_VALID ? 1 : 0));
          sl = wrap_add(sl, wrap_mul(lv, fv));
          se = wrap_add(se, wrap_mul(pv, m & M_EXPIRING ? 1 : 0));
          sw = wrap_add(sw, wrap_mul(ov, m & M_O_FUTURE ? 1 : 0));
        }
        passed = (float)wrap_add(wrap_add(sp, so), sl);

        const int beh = p.beh[r];
        const bool act = p.active[r] != 0;
        const bool is_warm = beh == 1 || beh == 3;
        const bool is_pace = beh == 2 || beh == 3;
        const bool warm_rows = act && is_warm;
        acq = p.acquire[r];

        // warmup curve (engine/decide.py::_warmup_curve, same op order)
        const float cnt = p.cnt[r];
        const float cnt_safe = fmaxf(cnt, 1e-6f);
        const float warn = p.warn[r];
        const float tokens = p.wtok[r];
        const int filled = p.wfill[r];
        const float pass_qps = passed * p.pass_qps_scale;
        const bool can_refill =
            (tokens < warn) ||
            ((tokens > warn) && (pass_qps < p.cold_count[r]));
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
        // `above * slope + 1.0 / cnt_safe`, which XLA contracts into one
        // fused multiply-add: the one explicit fmaf of this file
        const float warning_qps =
            1.0f / fmaf(above, p.slope[r], 1.0f / cnt_safe);
        const float qps =
            (warm_rows && tokens_new >= warn) ? warning_qps : cnt;

        const float rate_qps = qps * p.factor[r] * p.exceed_count;
        thr = rate_qps * p.interval_scale;
        cost = rintf(1000.0f * (float)acq / fmaxf(rate_qps, 1e-6f));

        if (r == 0 || p.slot[r - 1] != s) fl |= FL_HEAD;
        if (act && !is_pace) fl |= FL_AW | FL_ADMIT;
        if (act && is_pace) fl |= FL_PTRY | FL_PACC;
        if (p.prio[r]) fl |= FL_PRIO;
        if (beh == 0) fl |= FL_BEH0;
        if (p.write_ok[r]) fl |= FL_WRITE;

        w.passed[j] = passed;
        w.thr[j] = thr;
        w.cost[j] = cost;
        w.acq[j] = acq;
        w.rel0[j] = (float)max(wrap_sub(p.lpt[r], p.now), -(1 << 20));
        w.maxq[j] = (float)p.max_queue_ms[r];
        w.expiring[j] = (float)se;
        w.waiting[j] = (float)sw;
        p.passed[r] = passed;
        p.thr[r] = thr;
        p.wtok_new[r] = tokens_new;
        p.do_sync[r] = sync ? 1 : 0;
        v[0] = 1.0f;
      } else if (in) {
        fl = w.flags[j];
        acq = w.acq[j];
        passed = w.passed[j];
        thr = w.thr[j];
        cost = w.cost[j];
        // this pass's acceptance mask, from the previous pass's l_rel
        fl &= ~FL_PACC;
        if ((fl & FL_PTRY) && w.lrel[j] <= w.maxq[j]) fl |= FL_PACC;
      }
      const float acq_f = (float)acq;
      const bool aw = fl & FL_AW;
      bool try_occ = false;
      if (in) {
        v[1] = p.uniform ? (aw ? 1.0f : 0.0f)
                         : ((fl & FL_ADMIT) ? acq_f : 0.0f);
        v[2] = (fl & FL_PACC) ? cost : 0.0f;
        v[3] = (fl & FL_PACC) ? 1.0f : 0.0f;
        if (last && it > 0) {
          // the admission mask is final: the occupy prefix rides along
          try_occ = aw && !(fl & FL_ADMIT) && (fl & FL_PRIO) && (fl & FL_BEH0);
          v[0] = try_occ ? acq_f : 0.0f;
        }
        // a head resets its segment's first accepted cost; the write below
        // comes after this tile's barrier (or in a later tile)
        if (fl & FL_HEAD) w.segval[j] = 0.0f;
      }
      const float c0v = v[0], c1v = v[1], c2v = v[2], c3v = v[3];
      seg_scan<4>(v, in && (fl & FL_HEAD), carry, sb, par);
      if (!in) continue;

      if (it == 0) w.seghead[j] = j - ((int)v[0] - 1);
      const float prefix = v[1] - c1v;
      if (p.uniform) {
        const float rank = prefix;
        if (!(aw && (passed + rank * a + a <= thr))) fl &= ~FL_ADMIT;
        const float quota = floorf(fmaxf(thr - passed, 0.0f) / a_safe);
        const float admp = fminf(rank, quota) * a;
        w.admp[j] = admp;
        p.admp[r] = admp;
      } else if (last) {
        // the mask is final: this prefix is the admitted prefix
        w.admp[j] = prefix;
        p.admp[r] = prefix;
        if (it > 0) {
          const float occ_prefix = v[0] - c0v;
          if (try_occ && (passed - w.expiring[j] + prefix + w.waiting[j] +
                              occ_prefix + acq_f <=
                          p.max_occupy_ratio * thr))
            fl |= FL_CANOCC;
        }
      } else {
        fl &= ~FL_ADMIT;
        if (aw && (passed + prefix + acq_f <= thr)) fl |= FL_ADMIT;
      }
      // pacing: inclusive accepted cost up to this row, and the segment's
      // first accepted cost (at most one such row a segment: a plain store)
      w.lrel[j] = (v[2] - c2v) + cost;
      if ((fl & FL_PACC) && (v[3] - c3v) == 0.0f)
        w.segval[w.seghead[j]] = cost;
      w.flags[j] = fl;
    }
    // the sweep: l_rel of this pass, once every first cost is stored
    __syncthreads();
    for (int t = 0; t < n; t += T) {
      const int j = t + tid;
      if (j < n)
        w.lrel[j] =
            fmaxf(w.rel0[j], -w.segval[w.seghead[j]]) + w.lrel[j];
    }
    __syncthreads();  // before the next round's heads reset segval
  }

  // ---- priority occupy headroom, where no round carried it ----------------
  if (R == 0) {
    float carry[1] = {0.0f};
    for (int t = 0; t < n; t += T) {
      const int j = t + tid;
      const bool in = j < n;
      int fl = 0;
      float acq_f = 0.0f;
      bool try_occ = false;
      if (in) {
        fl = w.flags[j];
        acq_f = (float)w.acq[j];
        try_occ = (fl & FL_AW) && !(fl & FL_ADMIT) && (fl & FL_PRIO) &&
                  (fl & FL_BEH0);
      }
      float v[1] = {try_occ ? acq_f : 0.0f};
      const float c0v = v[0];
      seg_scan<1>(v, in && (fl & FL_HEAD), carry, sb, par);
      if (!in) continue;
      const float occ_prefix = v[0] - c0v;
      if (try_occ && (w.passed[j] - w.expiring[j] + w.admp[j] + w.waiting[j] +
                          occ_prefix + acq_f <=
                      p.max_occupy_ratio * w.thr[j]))
        w.flags[j] = fl | FL_CANOCC;
    }
  }

  // ---- final pacing verdicts, event totals, segment-tail write-back -------
  {
    float carry[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < n; t += T) {
      const int j = t + tid;
      const bool in = j < n;
      const int r = lo + j;
      int fl = 0;
      float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (in) {
        fl = w.flags[j];
        const float l = w.lrel[j];
        const bool ptry = fl & FL_PTRY;
        const bool acc = ptry && (l <= w.maxq[j]);
        const int wait_i = (int)fmaxf(l, 0.0f);
        const bool adm = fl & FL_ADMIT;
        const bool can = fl & FL_CANOCC;
        p.pace_acc[r] = acc ? 1 : 0;
        p.pace_wait[r] = wait_i;
        p.lpt_sched[r] = wrap_add(p.now, (int)rintf(l));
        p.admit[r] = adm ? 1 : 0;
        p.can_occ[r] = can ? 1 : 0;
        const bool pace_now = acc && wait_i == 0;
        const bool hard = ((fl & FL_AW) && !adm && !can) || (ptry && !acc);
        const int acq = w.acq[j];
        const int admit_i = (adm || pace_now) ? 1 : 0;
        const int hard_i = hard ? 1 : 0;
        v[EV_PASS] = (float)wrap_mul(acq, admit_i);
        v[EV_PASS_REQUEST] = (float)admit_i;
        v[EV_BLOCK] = (float)wrap_mul(acq, hard_i);
        v[EV_BLOCK_REQUEST] = (float)hard_i;
        v[EV_OCCUPIED_PASS] =
            (float)wrap_mul(acq, (adm && (fl & FL_PRIO)) ? 1 : 0);
      }
      seg_scan<5>(v, in && (fl & FL_HEAD), carry, sb, par);
      if (in && (fl & FL_WRITE)) {
        int32_t* cell = p.flow + ((size_t)p.slot[r] * B + p.idx_cur) * E;
#pragma unroll
        for (int e = 0; e < 5; ++e) cell[e] = wrap_add(cell[e], (int)v[e]);
      }
    }
  }
}

cudaError_t launch_decide(const Params& p, int blocks, cudaStream_t st) {
  static bool configured[64] = {};  // by device
  constexpr int dyn_bytes = PL_COUNT * SROWS * 4;
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return dev_err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn_bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  decide_kernel<<<blocks, T, dyn_bytes, st>>>(p);
  return cudaGetLastError();
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
    int32_t* work, int32_t* scratch, int blocks, int chunk, void* stream) {
  if (F < 1 || B < 1 || B > MAX_B || N < 0 || refine_iters < 0 ||
      (N > 0 && (blocks < 1 || chunk < 1 || (long long)blocks * chunk < N)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = F * E;
  long long roll_blocks = (total + ROLL_THREADS - 1) / ROLL_THREADS;
  if (roll_blocks > 132 * 16) roll_blocks = 132 * 16;
  if (roll_blocks < 1) roll_blocks = 1;
  const int parts = uniform && N > 0
                        ? (int)(roll_blocks < MAX_PARTS ? roll_blocks
                                                        : MAX_PARTS)
                        : 0;
  roll_kernel<<<(unsigned)roll_blocks, ROLL_THREADS, 0, st>>>(
      flow, fstarts, ostarts, F, B, idx_cur, cur_start, now, interval_ms,
      horizon, N, acquire, live, parts, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (N == 0) {
    start_kernel<<<1, 1, 0, st>>>(fstarts, idx_cur, cur_start);
    return (int)cudaGetLastError();
  }

  Params p;
  p.flow = flow;
  p.occ = occ;
  p.fstarts = fstarts;
  p.B = B;
  p.N = N;
  p.now = now;
  p.idx_cur = idx_cur;
  p.cur_start = cur_start;
  p.cur_sec = cur_sec;
  p.uniform = uniform;
  p.refine_iters = refine_iters;
  p.chunk = chunk;
  p.parts = parts;
  p.exceed_count = exceed_count;
  p.interval_scale = interval_scale;
  p.pass_qps_scale = pass_qps_scale;
  p.max_occupy_ratio = max_occupy_ratio;
  p.slot = slot;
  p.write_ok = write_ok;
  p.acquire = acquire;
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
  p.work = (uint32_t*)work;
  p.scratch = scratch;
  return (int)launch_decide(p, blocks, st);
}

// The workspace layout the wrapper allocates: planes of N words, scratch ints.
extern "C" int sentinel_decide_work_planes() { return PL_COUNT; }
extern "C" int sentinel_decide_scratch_ints() { return SCRATCH_INTS; }
