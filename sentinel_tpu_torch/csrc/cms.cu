// The windowed count-min decide + update of the hot-param path,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sentinel_tpu/ops/cms_pallas.py
// (cms_decide_update_pallas -> _make_kernel). Per batch of N requests on a
// sketch counts[P, B, D, W] int32 (the state's own layout):
//
//   1. the roll: zero ring slot `cur` of every slot's [D, W] lanes when its
//      recorded start is stale (launch 1, param::roll_kernel);
//   2. per row: the estimate, min over the D lanes of the cell sums over
//      the window's buckets; the greedy in-batch prefix admission on the
//      (slot, index-tuple) key (param::admit_passes); then each admitted
//      row adds its acquire to its D current-bucket cells with int32
//      atomics, which commute, so the result is the same bits in any order
//      (launch 2, cms_decide_kernel).
//
// What bounds it. Memory traffic: per row D x B gathered cells, D cells
// written when admitted, a few [N] columns; and once per bucket (500 ms at
// the service's default) the P x D x W current plane zeroed, 4 MiB at
// P=256, D=2, W=2048. The arithmetic is a few dozen operations a row, plus
// the prefix admission.
//
// Design (the simple one, right first). The TPU kernel gathers and scatters
// with one-hot matmuls on the MXU; here a row reads its cells directly and
// adds with atomics. Launch 2 is ONE block of 1024 threads: the three
// admission passes need every row's previous pass, and one block orders
// them with __syncthreads alone. Each row's in-batch prefix is an O(N) scan
// of the earlier rows, so a pass is O(N^2); at the service's N=8 that is
// nothing, at N=4096 it dominates the step. The roll is its own grid-wide
// launch so that a stale bucket reads as zero in the same step's estimate.
// Rows whose slot or index lies outside the sketch are not live and
// estimate 0 (the reference clamps such gathers and drops such scatters;
// its callers never pass them).

#include "param_common.cuh"

namespace {

__global__ void __launch_bounds__(param::THREADS, 1)
    cms_decide_kernel(param::Rows r, int32_t* counts, int32_t* starts, int P,
                      int B, int D, int W, int now, int cur, int cur_start,
                      int interval_ms) {
  __shared__ param::Smem sm;
  param::load_ok(sm, starts, B, now, cur, cur_start, interval_ms);

  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    const int s = r.slot[i];
    const int safe = s >= 0 ? s : 0;
    const int32_t* ix = r.idx + (long long)i * D;
    bool inside = safe < P;
    for (int d = 0; d < D; ++d) inside = inside && ix[d] >= 0 && ix[d] < W;
    int e = 0;
    if (inside) {
      e = INT_MAX;
      for (int d = 0; d < D; ++d) {
        unsigned sum = 0;
        for (int b = 0; b < B; ++b)
          if (sm.ok[b])
            sum += (unsigned)counts[(((long long)safe * B + b) * D + d) * W +
                                    ix[d]];
        e = min(e, (int)sum);
      }
    }
    r.est[i] = e;
    r.key[i] = param::mix_key(safe, ix, D);
    r.live[i] = (r.valid[i] && s >= 0 && inside) ? 1 : 0;
  }
  __syncthreads();

  param::admit_passes(r, sm);

  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    if (!r.admit[i]) continue;  // admitted rows are live: slot in range
    const long long base = (long long)r.slot[i] * B + cur;
    const int32_t* ix = r.idx + (long long)i * D;
    for (int d = 0; d < D; ++d)
      atomicAdd(&counts[(base * D + d) * W + ix[d]], r.acq[i]);
  }
  if (threadIdx.x == 0) starts[cur] = cur_start;
}

}  // namespace

extern "C" int sentinel_cms_decide(
    int32_t* counts, int32_t* starts, int P, int B, int D, int W,
    const int32_t* slot, const int32_t* idx, const int32_t* acq,
    const float* thr, const uint8_t* valid, int N, int now, int cur,
    int cur_start, int interval_ms, uint8_t* admit, int32_t* est,
    int32_t* work_key, uint8_t* work_flags, void* stream) {
  if (P < 1 || B < 1 || B > param::MAX_B || D < 1 || W < 1 || N < 1 ||
      cur < 0 || cur >= B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = param::roll_launch((uint32_t*)counts, starts, P, B,
                               (long long)D * W, cur, cur_start, st);
  if (err != 0) return err;
  param::Rows r{N,     slot,  idx,
                acq,   thr,   valid,
                admit, est,   (uint32_t*)work_key,
                work_flags, work_flags + N, work_flags + 2 * (long long)N};
  cms_decide_kernel<<<1, param::THREADS, 0, st>>>(
      r, counts, starts, P, B, D, W, now, cur, cur_start, interval_ms);
  return (int)cudaGetLastError();
}
