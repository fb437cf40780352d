// Parts shared by the two param-sketch kernels, csrc/cms.cu and
// csrc/salsa.cu: the call's prologue (the roll and the ring's window mask),
// the in-batch prefix key, the greedy prefix admission and the launch.
//
// Parity with the reference (bitwise):
// - The prefix key is `key = key * int32(-1640531527) + idx[d]` over the
//   lanes, wrapping in int32; here it is computed in uint32, which wraps
//   the same bits with no signed overflow.
// - Admission is `float(est) + prefix + float(acq) <= thr` in float32, left
//   to right, as the reference's XLA core writes it (built with
//   --fmad=false; additions are never contracted anyway).
// - The prefix is a sum of integer acquires. The reference sums them as
//   float32 (a cumsum over a sorted copy); that equals this integer sum
//   because every contribution is an integer-valued float32 and the batch
//   total stays below 2^24, the precondition the reference's own kernels
//   state (ops/decide_pallas.py).
// - Integer division and modulo of the ring (current slot, bucket start)
//   are floor operations; the host passes them precomputed.
//
// One launch a call. The roll is decided on the device, in the same block:
// every thread reads the PRE-roll start of the current bucket; when it is
// stale the block zeroes the current plane (P x D x W 32-bit words, 4 MiB at
// the service's default sketch) before the barrier that ends the prologue,
// so the same step's estimate reads that bucket as zero; the new start is
// written at the end of the call. A host-side copy of the starts could not
// decide it: the service's epoch rebase and state imports rewrite them.
// One block zeroing 4 MiB costs tens of microseconds, once per bucket (500
// ms at the default); a grid-wide roll launch, or a cooperative grid with a
// grid barrier, would cost every other call a second launch or a larger
// one, and that call is the common one.
//
// The admission (REFINE_ITERS greedy passes: a row is admitted when its
// estimate, plus the acquires of the earlier rows on its key admitted by the
// previous pass, plus its own acquire, stays within its threshold):
// - N <= WARP_ROWS (the service sends 8 rows): one warp, which holds two
//   rows a lane. A row's earlier same-key rows are found once, as lane
//   masks, by shuffling the keys past it; a pass sums their contributions
//   with 64 shuffles. No barrier of the whole block (33-64 rows: one of the
//   two rows' warps), where the sort below costs tens of barriers whatever
//   N.
// - Above: the keys are sorted once with their rows (seg_scan.cuh), and each
//   pass is one segmented exclusive scan over the sorted order, O(N) a pass.
//   Up to SORT_CAP rows the sort and the passes run in shared memory; above,
//   the same code runs on the global workspace.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace param {

constexpr int THREADS = seg::MAX_THREADS;  // the launch is one such block
constexpr int MAX_B = 64;
constexpr int REFINE_ITERS = 3;  // odd: the admitted set never overshoots
constexpr uint32_t KEY_MIX = 0x9E3779B9u;
constexpr int WARP_ROWS = 64;   // one warp admits up to this many rows
constexpr int SORT_CAP = 8192;  // rows sorted in shared memory
// shared bytes a row above WARP_ROWS: two key buffers, two row buffers, the
// estimate and threshold in sorted order, a flag byte
constexpr int ROW_SMEM = 4 + 4 + 2 + 2 + 4 + 4 + 1;

// The [N] row columns of one launch and its workspace.
struct Rows {
  int N;
  const int32_t* slot;   // [N], -1 -> no rule
  const int32_t* idx;    // [N, D] cell indices
  const int32_t* acq;    // [N]
  const float* thr;      // [N]
  const uint8_t* valid;  // [N]
  uint8_t* admit;        // [N] out
  int32_t* est;          // [N] out
  uint32_t* key;         // [N] work: prefix key
  uint8_t* live;         // [N] work
  // above SORT_CAP, in the global workspace (else null): the sort's key and
  // row buffers [2N] each, the estimate and threshold [N] each in sorted
  // order, the flags [N]
  uint32_t* gkey;
  uint32_t* grow;
  float* gest;
  float* gthr;
  uint8_t* gbits;
};

struct Smem {
  int ok[MAX_B];  // 1 where a ring bucket lies inside the window
  seg::SortScratch sc;
};

inline long long byte_words(int N) { return ((long long)N + 3) / 4; }

// Workspace words (int32) a launch of N rows needs.
inline long long work_words(int N) {
  long long w = N + byte_words(N);  // key, live
  if (N > SORT_CAP) w += 6LL * N + byte_words(N);
  return w;
}

inline size_t dyn_smem(int N) {
  return (N > WARP_ROWS && N <= SORT_CAP) ? (size_t)N * ROW_SMEM : 0;
}

inline Rows make_rows(int N, const int32_t* slot, const int32_t* idx,
                      const int32_t* acq, const float* thr,
                      const uint8_t* valid, uint8_t* admit, int32_t* est,
                      int32_t* work) {
  Rows r{};
  r.N = N;
  r.slot = slot;
  r.idx = idx;
  r.acq = acq;
  r.thr = thr;
  r.valid = valid;
  r.admit = admit;
  r.est = est;
  r.key = reinterpret_cast<uint32_t*>(work);
  r.live = reinterpret_cast<uint8_t*>(work + N);
  if (N > SORT_CAP) {
    uint32_t* g = reinterpret_cast<uint32_t*>(work + N + byte_words(N));
    r.gkey = g;
    r.grow = g + 2LL * N;
    r.gest = reinterpret_cast<float*>(g + 4LL * N);
    r.gthr = reinterpret_cast<float*>(g + 5LL * N);
    r.gbits = reinterpret_cast<uint8_t*>(g + 6LL * N);
  }
  return r;
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// The prologue, by the whole block: the roll (when bucket `cur`'s recorded
// start is stale, zero ring slot `cur` of the [P, B, per_bucket] plane of
// 32-bit words) and the window mask from the post-roll starts (bucket `cur`
// holds cur_start; age = now - start wraps like the reference's int32).
// Ends with a barrier.
__device__ void begin(Smem& sm, uint32_t* words, const int32_t* starts,
                      int P, int B, long long per_bucket, int now, int cur,
                      int cur_start, int interval_ms) {
  if (starts[cur] != cur_start) {  // the same value in every thread
    const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
    if ((per_bucket & 3) == 0 && aligned) {
      const long long quads = per_bucket >> 2;
      for (int p = 0; p < P; ++p) {
        uint4* q = reinterpret_cast<uint4*>(
            words + ((long long)p * B + cur) * per_bucket);
        for (long long w = threadIdx.x; w < quads; w += blockDim.x)
          q[w] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int p = 0; p < P; ++p) {
        uint32_t* q = words + ((long long)p * B + cur) * per_bucket;
        for (long long w = threadIdx.x; w < per_bucket; w += blockDim.x)
          q[w] = 0u;
      }
    }
  }
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int start = (b == cur) ? cur_start : starts[b];
    const int age = wrap_sub(now, start);
    sm.ok[b] = (age >= 0 && age < interval_ms) ? 1 : 0;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t mix_key(int safe, const int32_t* ix,
                                            int D) {
  uint32_t key = (uint32_t)safe;
  for (int d = 0; d < D; ++d) key = key * KEY_MIX + (uint32_t)ix[d];
  return key;
}

// N <= 32 * R, warp 0: lane l holds rows l, 32 + l, ... (row q * 32 + l in
// slot q). earlier[q][s] marks the lanes j whose row s * 32 + j comes
// before row q * 32 + l on the same key; a pass sums their contributions
// with shuffles. O(N^2 / 32) a pass, in one warp, with no block barrier.
template <int R>
__device__ void admit_warp(const Rows& r) {
  const int lane = threadIdx.x;
  bool in[R], live[R], ok[R];
  uint32_t key[R], rows[R], earlier[R][R];
  int est[R], acq[R];
  float thr[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * 32 + lane;
    in[q] = i < r.N;
    rows[q] = __ballot_sync(seg::FULL, in[q]);
    key[q] = in[q] ? r.key[i] : 0u;
    live[q] = in[q] && r.live[i];
    est[q] = in[q] ? r.est[i] : 0;
    acq[q] = in[q] ? r.acq[i] : 0;
    thr[q] = in[q] ? r.thr[i] : 0.0f;
    ok[q] = live[q];
#pragma unroll
    for (int s = 0; s < R; ++s) earlier[q][s] = 0u;
  }
#pragma unroll
  for (int s = 0; s < R; ++s)
    for (int j = 0; j < 32; ++j) {
      const uint32_t kj = __shfl_sync(seg::FULL, key[s], j);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (kj == key[q] && s * 32 + j < q * 32 + lane)
          earlier[q][s] |= 1u << j;
    }
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int q = 0; q < R; ++q) earlier[q][s] &= rows[s];
  for (int pass = 0; pass < REFINE_ITERS; ++pass) {
    int con[R];
    unsigned pre[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      con[q] = ok[q] ? acq[q] : 0;
      pre[q] = 0u;
    }
#pragma unroll
    for (int s = 0; s < R; ++s)
      for (int j = 0; j < 32; ++j) {
        const int c = __shfl_sync(seg::FULL, con[s], j);
#pragma unroll
        for (int q = 0; q < R; ++q)
          if ((earlier[q][s] >> j) & 1u) pre[q] += (unsigned)c;
      }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float lhs = (float)est[q] + (float)(int)pre[q];
      lhs = lhs + (float)acq[q];
      ok[q] = live[q] && lhs <= thr[q];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (in[q]) r.admit[q * 32 + lane] = ok[q] ? 1 : 0;
}

constexpr uint8_t HEAD = 1, LIVE = 2, CUR = 4;  // bits of a sorted item

// N > WARP_ROWS, by the first nt threads: sort (key, row) once, stage each
// sorted item's acquire, estimate, threshold and flags in sorted order, then
// one segmented scan a pass; CUR is the item's admission of the last pass.
template <typename V>
__device__ void admit_sorted(const Rows& r, seg::SortScratch& sc, int nt,
                             uint32_t* ka, uint32_t* kb, V* va, V* vb,
                             float* est_s, float* thr_s, uint8_t* bits) {
  const int n = r.N;
  for (int i = threadIdx.x; i < n; i += nt) {
    ka[i] = r.key[i];
    va[i] = (V)i;
  }
  const bool in_b = seg::radix_sort(ka, kb, va, vb, n, nt, sc);
  const uint32_t* ks = in_b ? kb : ka;
  const V* vs = in_b ? vb : va;
  int32_t* acq_s = reinterpret_cast<int32_t*>(in_b ? ka : kb);  // free now
  int k0, k1;
  seg::blocked_run(n, nt, &k0, &k1);
  for (int k = k0; k < k1; ++k) {
    const int row = (int)vs[k];
    const bool live = r.live[row] != 0;
    acq_s[k] = r.acq[row];
    est_s[k] = (float)r.est[row];
    thr_s[k] = r.thr[row];
    bits[k] = (seg::is_head(ks, k) ? HEAD : 0) | (live ? LIVE | CUR : 0);
  }
  for (int pass = 0; pass < REFINE_ITERS; ++pass) {
    bool f = false;
    unsigned s = 0;
    for (int k = k0; k < k1; ++k) {
      const uint8_t b = bits[k];
      if (b & HEAD) {
        f = true;
        s = 0;
      }
      if (b & CUR) s += (unsigned)acq_s[k];
    }
    unsigned run =
        seg::block_seg_excl<unsigned>(f, s, sc.scan, nt, pass & 1);
    for (int k = k0; k < k1; ++k) {
      const uint8_t b = bits[k];
      if (b & HEAD) run = 0;
      const int acq = acq_s[k];
      float lhs = est_s[k] + (float)(int)run;
      lhs = lhs + (float)acq;
      if (b & CUR) run += (unsigned)acq;
      const bool ok = (b & LIVE) && lhs <= thr_s[k];
      bits[k] = (b & (HEAD | LIVE)) | (ok ? CUR : 0);
    }
  }
  for (int k = k0; k < k1; ++k) r.admit[vs[k]] = (bits[k] & CUR) ? 1 : 0;
  seg::sync(nt);
}

// The admission: writes r.admit. Called by the whole block after the
// per-row pass (est, key, live written; row i by thread i % THREADS). Only
// the first threads_for(N) threads (those that wrote the rows) take part
// and synchronise, on their own barrier; the other warps go straight on (to
// the next __syncthreads, or the end of the kernel), and own no row.
// N <= 32: warp 0, thread i admitting row i itself, so a later per-row loop
// reads its own admit[i] with no barrier. N <= WARP_ROWS: warp 0 for both
// warps, between two barriers of those 64 threads. Above: the sort.
__device__ void admit(const Rows& r, Smem& sm) {
  if (r.N <= 32) {
    if (threadIdx.x < 32) admit_warp<1>(r);
    return;
  }
  const int nt = seg::threads_for(r.N);
  if ((int)threadIdx.x >= nt) return;
  if (r.N <= WARP_ROWS) {
    seg::sync(nt);
    if (threadIdx.x < 32) admit_warp<WARP_ROWS / 32>(r);
    seg::sync(nt);
    return;
  }
  const int n = r.N;
  if (n <= SORT_CAP) {
    extern __shared__ __align__(16) unsigned char param_dyn[];
    uint32_t* ka = reinterpret_cast<uint32_t*>(param_dyn);
    float* est_s = reinterpret_cast<float*>(ka + 2 * n);
    float* thr_s = est_s + n;
    uint16_t* va = reinterpret_cast<uint16_t*>(thr_s + n);
    uint8_t* bits = reinterpret_cast<uint8_t*>(va + 2 * n);
    admit_sorted<uint16_t>(r, sm.sc, nt, ka, ka + n, va, va + n, est_s,
                           thr_s, bits);
  } else {
    admit_sorted<uint32_t>(r, sm.sc, nt, r.gkey, r.gkey + n, r.grow,
                           r.grow + n, r.gest, r.gthr, r.gbits);
  }
}

// Checks shared by the two entry points; 0 when the launch may go ahead.
inline int check_args(int P, int B, int D, int W, int N, int cur,
                      long long work_given) {
  if (P < 1 || B < 1 || B > MAX_B || D < 1 || W < 1 || N < 1 || cur < 0 ||
      cur >= B || work_given < work_words(N))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Allows the kernel SORT_CAP rows of dynamic shared memory, once per device.
template <typename Kernel>
inline int configure(Kernel kernel) {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SORT_CAP * ROW_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}

}  // namespace param

// Workspace words (int32) a launch of N rows needs; the wrappers size the
// buffer they pass with it.
extern "C" long long sentinel_param_work_words(int N) {
  return param::work_words(N);
}
