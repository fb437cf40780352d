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
//   1. the roll (param::begin, in the call's one launch of one block):
//      zeroed cells are unmerged zeros, so the roll clears merge state with
//      the counts;
//   2. per row (salsa_decide_kernel): the estimate over decoded
//      gathers (a merged pair reads its joint value at either cell), the
//      in-batch prefix admission, and the update of the pairs the admitted
//      rows address: their adds, routed to the even cell when the pair is
//      merged, are summed per pair, and each touched pair is decoded, added
//      to, merged when an unmerged side rises above SAT (taking the max of
//      the two, clamped to MERGE_CEIL), encoded and stored by exactly one
//      thread, which counts a newly merged pair into merges[slot]. All
//      arithmetic is int32; cells are cast to int16 only on store.
//
// The reference re-encodes the WHOLE current plane every step. That pass is
// the identity on every pair that received no add, given this
// precondition: the plane was produced by this encoder (from zeros, through
// rolls and updates). An unmerged pair then has both sides <= SAT (else it
// would have merged), a merged pair's low cell lies in [0, CAP) and its
// value is <= MERGE_CEIL, and zeroed cells encode to zeros. Every producer
// of a plane in the reference keeps it: sketch/salsa.py::encode_plane, the
// Pallas kernel, and the MOVE import sketch/__init__.py::fold_param_sums,
// which itself re-encodes only the rows it touched. A plane built by hand
// with an unmerged side above SAT would be merged by the reference's pass
// and is left alone here.
//
// What bounds it. Memory traffic: per row D x B gathered pairs and a few
// [N] columns, and per touched pair 4 bytes read and written
// (chip_smoke.py::param_bytes); the arithmetic is the prefix admission.
// Work after the admission is O(N * D).
//
// Design. As csrc/cms.cu for the roll and the admission (one launch of one
// block; param_common.cuh). Summing the adds of one pair before its single
// encode uses `delta`, an int32 [P, D, 2W] buffer that is ALL ZERO between
// calls: admitted rows atomicAdd their routed acquire into it; after a barrier
// each admitted (row, lane) takes its pair's two sums with one 64-bit
// atomicExch(..., 0) (a pair is 8-byte aligned). The one thread that gets a
// non-zero pair encodes it; the others, and pairs whose adds sum to zero, skip
// (the encode is then the identity). So the buffer is zero again when the
// launch ends, with no memset and no whole-plane pass; the wrapper allocates
// it once per sketch shape. Routing reads the merge flags before the barrier
// and the stores come after it, so it sees the pre-update flags the reference
// routes by. The TPU kernel's lane rolls that pair cells on full-width vectors
// are a Mosaic idiom; here a thread owns a pair as one 32-bit word (little-
// endian: the even cell is the low half). Floor division and modulo by CAP (a
// power of two) are an arithmetic shift and a mask, which match the
// reference's floor semantics for any sign.
// Rows whose slot or index lies outside the sketch are not live and
// estimate 0 (the reference's XLA core clamps such gathers and drops such
// scatters lane by lane, its Pallas kernel estimates 0 and still adds the
// lanes that are in range; its callers never pass such rows).

#include "param_common.cuh"

namespace {

constexpr int LOGCAP = 12;
constexpr int CAP = 1 << LOGCAP;
constexpr int SAT = 1 << 14;
constexpr int MERGE_CEIL = CAP * 32767 - 1;

__global__ void __launch_bounds__(param::THREADS, 1)
    salsa_decide_kernel(param::Rows r, int16_t* counts, int32_t* starts,
                        int32_t* merges, int32_t* delta, int P, int B, int D,
                        int C, int now, int cur, int cur_start,
                        int interval_ms) {
  __shared__ param::Smem sm;
  // a pair is one 32-bit word: D * C / 2 words per slot and bucket
  param::begin(sm, reinterpret_cast<uint32_t*>(counts), starts, P, B,
               (long long)D * (C / 2), now, cur, cur_start, interval_ms);

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

  param::admit(r, sm);

  // Sum the admitted adds per cell. The current plane is not stored to
  // before the barrier, so its merge flags are the pre-update ones.
  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    if (!r.admit[i]) continue;  // admitted rows are live: all in range
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
  __syncthreads();
  // Each touched pair: one thread takes its sums (leaving zeros), decodes,
  // adds, merges on saturation, encodes and stores.
  for (int i = threadIdx.x; i < r.N; i += blockDim.x) {
    if (!r.admit[i]) continue;
    const int safe = r.slot[i];
    const int32_t* ix = r.idx + (long long)i * D;
    for (int d = 0; d < D; ++d) {
      const int pair = ix[d] & ~1;
      unsigned long long* dp = reinterpret_cast<unsigned long long*>(
          &delta[((long long)safe * D + d) * C + pair]);
      const unsigned long long sums = atomicExch(dp, 0ull);
      if (sums == 0ull) continue;
      const int dl_ev = (int)(uint32_t)(sums & 0xffffffffull);
      const int dl_od = (int)(uint32_t)(sums >> 32);
      uint32_t* word = reinterpret_cast<uint32_t*>(
          counts + (((long long)safe * B + cur) * D + d) * C + pair);
      const uint32_t v = *word;
      const int lo = (int)(int16_t)(uint16_t)(v & 0xffffu);
      const int hi = (int)(int16_t)(uint16_t)(v >> 16);
      const bool merged = hi < 0;
      const int ev = (merged ? lo + CAP * (-hi - 1) : lo) + dl_ev;
      const int od = (merged ? 0 : hi) + dl_od;
      const bool newly = !merged && (ev > SAT || od > SAT);
      const bool m2 = merged || newly;
      int val = newly ? max(ev, od) : ev;
      val = min(val, MERGE_CEIL);
      const int lo_out = m2 ? (val & (CAP - 1)) : ev;
      const int hi_out = m2 ? (-(val >> LOGCAP) - 1) : od;
      *word = (uint32_t)(uint16_t)(int16_t)lo_out |
              ((uint32_t)(uint16_t)(int16_t)hi_out << 16);
      if (newly) atomicAdd(&merges[safe], 1);
    }
  }
  if (threadIdx.x == 0) starts[cur] = cur_start;
}

}  // namespace

extern "C" int sentinel_salsa_decide(
    int16_t* counts, int32_t* starts, int32_t* merges, int P, int B, int D,
    int W, const int32_t* slot, const int32_t* idx, const int32_t* acq,
    const float* thr, const uint8_t* valid, int N, int now, int cur,
    int cur_start, int interval_ms, uint8_t* admit, int32_t* est,
    int32_t* work, long long work_words, int32_t* delta, void* stream) {
  int err = param::check_args(P, B, D, W, N, cur, work_words);
  if (err != 0) return err;
  err = param::configure(salsa_decide_kernel);
  if (err != 0) return err;
  const param::Rows r =
      param::make_rows(N, slot, idx, acq, thr, valid, admit, est, work);
  salsa_decide_kernel<<<1, param::THREADS, param::dyn_smem(N),
                        (cudaStream_t)stream>>>(
      r, counts, starts, merges, delta, P, B, D, 2 * W, now, cur, cur_start,
      interval_ms);
  return (int)cudaGetLastError();
}
