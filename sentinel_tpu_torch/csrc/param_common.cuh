// Parts shared by the two param-sketch kernels, csrc/cms.cu and
// csrc/salsa.cu: the roll launch, the ring's window mask, the in-batch
// prefix key and the greedy prefix admission.
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

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace param {

constexpr int THREADS = 1024;  // the decide launch is one block of these
constexpr int MAX_B = 64;
constexpr int REFINE_ITERS = 3;  // odd: the admitted set never overshoots
constexpr uint32_t KEY_MIX = 0x9E3779B9u;

// The [N] row columns of one decide launch and its workspace.
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
  uint8_t* pass_a;       // [N] work: admission of pass 1
  uint8_t* pass_b;       // [N] work: admission of pass 2
};

struct Smem {
  int ok[MAX_B];  // 1 where a ring bucket lies inside the window
  uint32_t key[THREADS];
  int32_t con[THREADS];
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Zero ring slot `cur` of a [P, B, per_bucket] plane of 32-bit words when
// its recorded start is stale. Reads the PRE-roll start and never writes
// it, so every block sees the same flag; the decide launch records the new
// start at its end.
__global__ void roll_kernel(uint32_t* words, const int32_t* starts, int P,
                            int B, long long per_bucket, int cur,
                            int cur_start) {
  if (starts[cur] == cur_start) return;
  const long long total = (long long)P * per_bucket;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += stride) {
    const long long p = q / per_bucket;
    const long long w = q - p * per_bucket;
    words[(p * B + cur) * per_bucket + w] = 0u;
  }
}

inline int roll_launch(uint32_t* words, const int32_t* starts, int P, int B,
                       long long per_bucket, int cur, int cur_start,
                       cudaStream_t st) {
  long long blocks = ((long long)P * per_bucket + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  roll_kernel<<<(unsigned)blocks, 256, 0, st>>>(words, starts, P, B,
                                                per_bucket, cur, cur_start);
  return (int)cudaGetLastError();
}

// The window mask from the post-roll starts (bucket `cur` holds
// cur_start); age = now - start wraps like the reference's int32.
__device__ void load_ok(Smem& sm, const int32_t* starts, int B, int now,
                        int cur, int cur_start, int interval_ms) {
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

// REFINE_ITERS greedy passes: a row is admitted when its estimate, plus the
// acquires of the earlier rows on its key admitted by the previous pass,
// plus its own acquire, stays within its threshold. Pass 1 starts from the
// live rows; the last pass writes r.admit. Each row's prefix is an O(N)
// scan of the earlier rows through shared-memory tiles, O(N^2) a pass in
// this one block.
__device__ void admit_passes(const Rows& r, Smem& sm) {
  const int tid = threadIdx.x;
  const uint8_t* prev = r.live;
  for (int pass = 0; pass < REFINE_ITERS; ++pass) {
    uint8_t* out = (pass == REFINE_ITERS - 1) ? r.admit
                   : (pass & 1)               ? r.pass_b
                                              : r.pass_a;
    for (int r0 = 0; r0 < r.N; r0 += THREADS) {
      const int i = r0 + tid;
      const uint32_t ki = (i < r.N) ? r.key[i] : 0u;
      unsigned pre = 0;
      for (int c0 = 0; c0 <= r0; c0 += THREADS) {
        const int j = c0 + tid;
        sm.key[tid] = (j < r.N) ? r.key[j] : 0u;
        sm.con[tid] = (j < r.N && prev[j]) ? r.acq[j] : 0;
        __syncthreads();
        if (i < r.N) {  // threads past the batch only stage tiles
          const int lim = min(THREADS, i - c0);  // columns j < i
          for (int jj = 0; jj < lim; ++jj)
            pre += (sm.key[jj] == ki) ? (unsigned)sm.con[jj] : 0u;
        }
        __syncthreads();
      }
      if (i < r.N) {
        float lhs = (float)r.est[i] + (float)(int)pre;
        lhs = lhs + (float)r.acq[i];
        out[i] = (r.live[i] && lhs <= r.thr[i]) ? 1 : 0;
      }
    }
    __syncthreads();
    prev = out;
  }
}

}  // namespace param
