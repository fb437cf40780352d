// The SALSA decide + update of the hot-param path, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sentinel_tpu/ops/salsa_pallas.py
// (salsa_decide_update_pallas -> _make_kernel, with _pairs and _qdecode).
// The count-min decide of csrc/cms.cu over int16 pair-encoded cells
// counts[P, B, D, 2W] (sketch/salsa.py: an unmerged pair holds two
// counters; a merged pair holds v as (v % CAP, -(v / CAP) - 1), the negative
// high cell being the merge flag):
//
//   1. the roll (launch 1, param::roll_kernel): zeroed cells are unmerged
//      zeros, so the roll clears merge state with the counts;
//   2. per row: the estimate over decoded gathers (a merged pair reads its
//      joint value at either cell), the in-batch prefix admission, and the
//      admitted adds, routed to the even cell when the pair is merged and
//      summed by int32 atomics into a decoded delta of the current plane
//      (launch 2, salsa_decide_kernel);
//   3. the re-encode of the WHOLE current plane, as the reference does every
//      step: decode, add the delta, merge an unmerged pair with a side above
//      SAT (taking the max of the two, clamped to MERGE_CEIL), encode, and
//      count each newly merged pair into merges[slot] (launch 3,
//      salsa_encode_kernel). All arithmetic is int32; cells are cast to
//      int16 only on store.
//
// What bounds it. Memory traffic: the whole-plane re-encode reads and
// writes the P x D x 2W int16 current plane (4 MiB each way at the service's
// default P=256, D=2, W=2048) every step, plus the decoded int32 delta it
// reads; per row, D x B gathered pairs. Launch 3 is a grid-stride pass of
// one 32-bit word (one pair) a thread, coalesced.
//
// Design. As csrc/cms.cu for launches 1 and 2 (one block, O(N^2) prefix a
// pass). The TPU kernel's lane rolls that pair cells on full-width vectors
// are a Mosaic idiom; here a thread owns a pair as one 32-bit word
// (little-endian: the even cell is the low half). Floor division and modulo
// by CAP (a power of two) are an arithmetic shift and a mask, which match
// the reference's floor semantics for any sign.

#include "param_common.cuh"

namespace {

constexpr int LOGCAP = 12;
constexpr int CAP = 1 << LOGCAP;
constexpr int SAT = 1 << 14;
constexpr int MERGE_CEIL = CAP * 32767 - 1;

__global__ void __launch_bounds__(param::THREADS, 1)
    salsa_decide_kernel(param::Rows r, const int16_t* counts, int32_t* starts,
                        int32_t* delta, int P, int B, int D, int C, int now,
                        int cur, int cur_start, int interval_ms) {
  __shared__ param::Smem sm;
  param::load_ok(sm, starts, B, now, cur, cur_start, interval_ms);

  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    const int s = r.slot[i];
    const int safe = s >= 0 ? s : 0;
    const int32_t* ix = r.idx + (long long)i * D;
    bool inside = safe < P;
    for (int d = 0; d < D; ++d) inside = inside && ix[d] >= 0 && ix[d] < C;
    int e = 0;
    if (inside) {
      e = INT_MAX;
      for (int d = 0; d < D; ++d) {
        const int c = ix[d];
        unsigned sum = 0;
        for (int b = 0; b < B; ++b) {
          if (!sm.ok[b]) continue;
          const int16_t* cell =
              counts + (((long long)safe * B + b) * D + d) * C + (c & ~1);
          const int lo = cell[0], hi = cell[1];
          const int v = hi < 0 ? lo + CAP * (-hi - 1) : ((c & 1) ? hi : lo);
          sum += (unsigned)v;
        }
        e = min(e, (int)sum);
      }
    }
    r.est[i] = e;
    r.key[i] = param::mix_key(safe, ix, D);
    r.live[i] = (r.valid[i] && s >= 0 && inside) ? 1 : 0;
  }
  __syncthreads();

  param::admit_passes(r, sm);

  // the current plane is not written in this launch, so its merge flags
  // are the pre-update ones the reference routes by
  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    if (!r.admit[i]) continue;
    const int safe = r.slot[i];
    const int32_t* ix = r.idx + (long long)i * D;
    for (int d = 0; d < D; ++d) {
      const int c = ix[d];
      const int pair = c & ~1;
      const int hi =
          counts[(((long long)safe * B + cur) * D + d) * C + pair + 1];
      const int tgt = hi < 0 ? pair : c;
      atomicAdd(&delta[((long long)safe * D + d) * C + tgt], r.acq[i]);
    }
  }
  if (threadIdx.x == 0) starts[cur] = cur_start;
}

// One thread a pair (W pairs per lane): decode, add the delta, merge on
// saturation, encode.
__global__ void salsa_encode_kernel(uint32_t* words, const int2* delta,
                                    int32_t* merges, int P, int B, int D,
                                    int W, int cur) {
  const long long per_slot = (long long)D * W;
  const long long total = (long long)P * per_slot;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += stride) {
    const long long p = q / per_slot;
    const long long rem = q - p * per_slot;  // d * W + w
    const long long d = rem / W;
    const long long w = rem - d * W;
    uint32_t* word = words + ((p * B + cur) * D + d) * W + w;
    const uint32_t v = *word;
    const int lo = (int)(int16_t)(uint16_t)(v & 0xffffu);
    const int hi = (int)(int16_t)(uint16_t)(v >> 16);
    const int2 dl = delta[q];
    const bool merged = hi < 0;
    const int ev = (merged ? lo + CAP * (-hi - 1) : lo) + dl.x;
    const int od = (merged ? 0 : hi) + dl.y;
    const bool newly = !merged && (ev > SAT || od > SAT);
    const bool m2 = merged || newly;
    int val = newly ? max(ev, od) : ev;
    val = min(val, MERGE_CEIL);
    const int lo_out = m2 ? (val & (CAP - 1)) : ev;
    const int hi_out = m2 ? (-(val >> LOGCAP) - 1) : od;
    *word = (uint32_t)(uint16_t)(int16_t)lo_out |
            ((uint32_t)(uint16_t)(int16_t)hi_out << 16);
    if (newly) atomicAdd(&merges[p], 1);
  }
}

}  // namespace

extern "C" int sentinel_salsa_decide(
    int16_t* counts, int32_t* starts, int32_t* merges, int P, int B, int D,
    int W, const int32_t* slot, const int32_t* idx, const int32_t* acq,
    const float* thr, const uint8_t* valid, int N, int now, int cur,
    int cur_start, int interval_ms, uint8_t* admit, int32_t* est,
    int32_t* work_key, uint8_t* work_flags, int32_t* delta, void* stream) {
  if (P < 1 || B < 1 || B > param::MAX_B || D < 1 || W < 1 || N < 1 ||
      cur < 0 || cur >= B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // a pair is one 32-bit word: D * W words per slot and bucket
  int err = param::roll_launch((uint32_t*)counts, starts, P, B,
                               (long long)D * W, cur, cur_start, st);
  if (err != 0) return err;
  param::Rows r{N,     slot,  idx,
                acq,   thr,   valid,
                admit, est,   (uint32_t*)work_key,
                work_flags, work_flags + N, work_flags + 2 * (long long)N};
  salsa_decide_kernel<<<1, param::THREADS, 0, st>>>(
      r, counts, starts, delta, P, B, D, 2 * W, now, cur, cur_start,
      interval_ms);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long blocks = ((long long)P * D * W + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  salsa_encode_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (uint32_t*)counts, (const int2*)delta, merges, P, B, D, W, cur);
  return (int)cudaGetLastError();
}
