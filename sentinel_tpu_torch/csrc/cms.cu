// The windowed count-min decide + update of the hot-param path,
// hand-written for Hopper (sm_90a), with the slim twin's pre- and post-step
// in the same launch.
//
// Replaces the TPU kernel sentinel_tpu/ops/cms_pallas.py
// (cms_decide_update_pallas -> _make_kernel) and, on the card, the torch
// ops of sketch/slim.py::slim_prestep / slim_poststep around it. Per batch
// of N requests on a sketch counts[P, B, D, W] int32 (the state's own
// layout), in ONE launch of one block (cms_decide_kernel):
//
//   1. the roll: when the current bucket's recorded start is stale, the
//      block zeroes ring slot `cur` of every slot's [D, W] lanes before any
//      read of it (param::begin), and with the twin on, slot `cur` of the
//      twin slim[P, B, Ds, Ws] and its authority flag slim_auth[cur];
//   2. per row, with the twin on: the slim estimate, min over the Ds lanes
//      of the slim cell sums over the buckets both inside the window and
//      authoritative (0 for rows without a rule), and the threshold less it
//      in float32;
//   3. per row: the estimate, min over the D lanes of the cell sums over
//      the window's buckets; the greedy in-batch prefix admission on the
//      (slot, index-tuple) key (param::admit); then each admitted row adds
//      its acquire to its D current-bucket cells with int32 atomics, which
//      commute, so the result is the same bits in any order;
//   4. with the twin on, after a block barrier: each live row's post-update
//      current-bucket estimate (min over the D lanes) scatter-maxed into its
//      Ds current-bucket slim cells (atomicMax, order-free), and the row's
//      estimate returned as fat + slim.
//
// With the twin off (Ws = 0) steps 2 and 4 are skipped and the call is the
// plain count-min step, bit for bit. On the CPU, and under SALSA, the twin
// stays the torch-op composition of sketch/slim.py around the core, which is
// what this launch is held against on the card.
//
// What bounds it. Memory traffic: per row D x B gathered cells, D cells
// written when admitted, a few [N] columns (the twin: Ds x B gathered slim
// cells, D re-read and Ds max'd cells a live row); and once per bucket (500
// ms at the service's default) the P x D x W current plane zeroed, 4 MiB at
// P=256, D=2, W=2048 (the twin's plane: 512 KiB at Ds=2, Ws=256). The
// arithmetic is a few dozen operations a row. At the service's N=8 the call
// moves a few hundred bytes, so what bounds it in practice is the launch and
// the chain of dependent loads; at N=4096, the admission's sort and each
// thread's chains of dependent gathers.
//
// Design. The TPU kernel gathers and scatters with one-hot matmuls on the
// MXU; here a row reads its cells directly and adds with atomics. The
// three admission passes need every row's previous pass, and one block
// orders them with barriers. The roll is decided and done in the same
// block (param_common.cuh says why), so a call that does not roll is one
// small launch. The admission is one warp's at N <= 32 (no block barrier)
// and above that a stable radix sort of the keys, once, and a segmented
// scan a pass (seg_scan.cuh): O(N) a pass instead of O(N^2). The twin
// needs no launch of its own: its roll reads the same pre-roll start, its
// estimate lowers the thresholds the admission reads (a workspace column),
// and its scatter-max needs only every row's update done, one barrier.
//
// Rows whose slot, index or slim index lies outside the sketch are not live
// and estimate 0, and add and max nothing. The reference has no single
// behaviour for them: its XLA core (engine/param.py::_param_decide_jax)
// clamps such gathers (a non-zero estimate from the last slot or cell; a
// negative index wraps), admits the row and drops its scatters lane by lane
// (mode="drop"); its Pallas kernel estimates 0, admits the row and adds the
// lanes that are in range. No caller passes such rows: request_params_token
// maps unknown rules to slot -1 and hashes indices into range.

#include "param_common.cuh"

namespace {

// The slim twin's plane and columns; W = 0: no twin.
struct Slim {
  int32_t* cells;       // [P, B, D, W], updated in place
  uint8_t* auth;        // [B] bool: buckets whose slim cells count
  const int32_t* idx;   // [N, D] slim cell indices
  int D;
  int W;
  float* thr;           // [N] work: the threshold less the slim estimate
  int32_t* est;         // [N] work: the slim estimate
};

__global__ void __launch_bounds__(param::THREADS, 1)
    cms_decide_kernel(param::Rows r, Slim sl, int32_t* counts,
                      int32_t* starts, int P, int B, int D, int W, int now,
                      int cur, int cur_start, int interval_ms) {
  __shared__ param::Smem sm;
  __shared__ int auth[param::MAX_B];  // the twin's flags after its roll
  const bool twin = sl.W > 0;
  if (twin) {
    // the fat ring's pre-roll start decides both rolls
    const bool stale = starts[cur] != cur_start;
    if (stale)
      param::zero_bucket(reinterpret_cast<uint32_t*>(sl.cells), P, B,
                         (long long)sl.D * sl.W, cur);
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const bool dropped = b == cur && stale;
      auth[b] = sl.auth[b] && !dropped;
      if (dropped) sl.auth[b] = 0;  // this thread alone reads flag b
    }
  }
  param::begin(sm, reinterpret_cast<uint32_t*>(counts), starts, P, B,
               (long long)D * W, now, cur, cur_start, interval_ms);

  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    const int s = r.slot[i];
    const int safe = s >= 0 ? s : 0;
    const int32_t* ix = r.idx + (long long)i * D;
    const int32_t* jx = sl.idx + (long long)i * sl.D;
    bool inside = safe < P;
    for (int d = 0; d < D; ++d) inside = inside && ix[d] >= 0 && ix[d] < W;
    if (twin)
      for (int d = 0; d < sl.D; ++d)
        inside = inside && jx[d] >= 0 && jx[d] < sl.W;
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
    if (twin) {
      int es = 0;
      if (inside && s >= 0) {
        es = INT_MAX;
        for (int d = 0; d < sl.D; ++d) {
          unsigned sum = 0;
          for (int b = 0; b < B; ++b)
            if (sm.ok[b] && auth[b])
              sum += (unsigned)sl.cells[(((long long)safe * B + b) * sl.D +
                                         d) * sl.W + jx[d]];
          es = min(es, (int)sum);
        }
      }
      sl.est[i] = es;
      sl.thr[i] = r.thr[i] - (float)es;
    }
  }

  param::Rows a = r;
  if (twin) a.thr = sl.thr;  // the admission reads the lowered thresholds
  param::admit(a, sm);

  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    if (!r.admit[i]) continue;  // admitted rows are live: slot in range
    const long long base = (long long)r.slot[i] * B + cur;
    const int32_t* ix = r.idx + (long long)i * D;
    for (int d = 0; d < D; ++d)
      atomicAdd(&counts[(base * D + d) * W + ix[d]], r.acq[i]);
  }

  if (twin) {
    __syncthreads();  // every row's adds are in before any row reads them
    for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
      r.est[i] = (int)((unsigned)r.est[i] + (unsigned)sl.est[i]);
      if (!r.live[i]) continue;  // live rows: slot and indices in range
      const long long base = (long long)r.slot[i] * B + cur;
      const int32_t* ix = r.idx + (long long)i * D;
      int e = INT_MAX;
      for (int d = 0; d < D; ++d)
        e = min(e, counts[(base * D + d) * W + ix[d]]);
      const int32_t* jx = sl.idx + (long long)i * sl.D;
      for (int d = 0; d < sl.D; ++d)
        atomicMax(&sl.cells[(base * sl.D + d) * sl.W + jx[d]], e);
    }
  }
  if (threadIdx.x == 0) starts[cur] = cur_start;
}

}  // namespace

// Workspace words (int32) a launch of N rows needs, with the twin or not.
extern "C" long long sentinel_cms_work_words(int N, int twin) {
  return param::work_words(N) + (twin ? 2LL * N : 0);
}

// slim_width 0 (and null twin pointers) is the plain count-min step.
extern "C" int sentinel_cms_decide(
    int32_t* counts, int32_t* starts, int P, int B, int D, int W,
    const int32_t* slot, const int32_t* idx, const int32_t* acq,
    const float* thr, const uint8_t* valid, int N, int now, int cur,
    int cur_start, int interval_ms, uint8_t* admit, int32_t* est,
    int32_t* slim, uint8_t* slim_auth, const int32_t* idx_slim, int Ds,
    int Ws, int32_t* work, long long work_words, void* stream) {
  const bool twin = Ws > 0;
  int err = param::check_args(P, B, D, W, N, cur, work_words);
  if (err != 0) return err;
  if (Ws < 0 || (twin && (Ds < 1 || !slim || !slim_auth || !idx_slim ||
                          work_words < sentinel_cms_work_words(N, 1))))
    return (int)cudaErrorInvalidValue;
  err = param::configure(cms_decide_kernel);
  if (err != 0) return err;
  const param::Rows r =
      param::make_rows(N, slot, idx, acq, thr, valid, admit, est, work);
  Slim sl{};
  if (twin) {
    int32_t* extra = work + param::work_words(N);
    sl = Slim{slim, slim_auth, idx_slim, Ds, Ws,
              reinterpret_cast<float*>(extra), extra + N};
  }
  cms_decide_kernel<<<1, param::THREADS, param::dyn_smem(N),
                      (cudaStream_t)stream>>>(r, sl, counts, starts, P, B, D,
                                              W, now, cur, cur_start,
                                              interval_ms);
  return (int)cudaGetLastError();
}
