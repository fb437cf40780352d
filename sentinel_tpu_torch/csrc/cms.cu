// The windowed count-min decide + update of the hot-param path,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sentinel_tpu/ops/cms_pallas.py
// (cms_decide_update_pallas -> _make_kernel). Per batch of N requests on a
// sketch counts[P, B, D, W] int32 (the state's own layout), in ONE launch of
// one block (cms_decide_kernel):
//
//   1. the roll: when the current bucket's recorded start is stale, the
//      block zeroes ring slot `cur` of every slot's [D, W] lanes before any
//      read of it (param::begin);
//   2. per row: the estimate, min over the D lanes of the cell sums over
//      the window's buckets; the greedy in-batch prefix admission on the
//      (slot, index-tuple) key (param::admit); then each admitted row adds
//      its acquire to its D current-bucket cells with int32 atomics, which
//      commute, so the result is the same bits in any order.
//
// What bounds it. Memory traffic: per row D x B gathered cells, D cells
// written when admitted, a few [N] columns; and once per bucket (500 ms at
// the service's default) the P x D x W current plane zeroed, 4 MiB at
// P=256, D=2, W=2048. The arithmetic is a few dozen operations a row. At
// the service's N=8 the call moves a few hundred bytes, so what bounds it
// in practice is the launch and the chain of dependent loads; at N=4096,
// the admission's sort and each thread's chains of dependent gathers.
//
// Design. The TPU kernel gathers and scatters with one-hot matmuls on the
// MXU; here a row reads its cells directly and adds with atomics. The
// three admission passes need every row's previous pass, and one block
// orders them with barriers. The roll is decided and done in the same
// block (param_common.cuh says why), so a call that does not roll is one
// small launch. The admission is one warp's at N <= 32 (no block barrier)
// and above that a stable radix sort of the keys, once, and a segmented
// scan a pass (seg_scan.cuh): O(N) a pass instead of O(N^2).
//
// Rows whose slot or index lies outside the sketch are not live and
// estimate 0, and add nothing. The reference has no single behaviour for
// them: its XLA core (engine/param.py::_param_decide_jax) clamps such
// gathers (a non-zero estimate from the last slot or cell; a negative index
// wraps), admits the row and drops its scatters lane by lane (mode="drop");
// its Pallas kernel estimates 0, admits the row and adds the lanes that are
// in range. No caller passes such rows: request_params_token maps unknown
// rules to slot -1 and hashes indices into range.

#include "param_common.cuh"

namespace {

__global__ void __launch_bounds__(param::THREADS, 1)
    cms_decide_kernel(param::Rows r, int32_t* counts, int32_t* starts, int P,
                      int B, int D, int W, int now, int cur, int cur_start,
                      int interval_ms) {
  __shared__ param::Smem sm;
  param::begin(sm, reinterpret_cast<uint32_t*>(counts), starts, P, B,
               (long long)D * W, now, cur, cur_start, interval_ms);

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

  param::admit(r, sm);

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
    int32_t* work, long long work_words, void* stream) {
  int err = param::check_args(P, B, D, W, N, cur, work_words);
  if (err != 0) return err;
  err = param::configure(cms_decide_kernel);
  if (err != 0) return err;
  const param::Rows r =
      param::make_rows(N, slot, idx, acq, thr, valid, admit, est, work);
  cms_decide_kernel<<<1, param::THREADS, param::dyn_smem(N),
                      (cudaStream_t)stream>>>(r, counts, starts, P, B, D, W,
                                              now, cur, cur_start,
                                              interval_ms);
  return (int)cudaGetLastError();
}
