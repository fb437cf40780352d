// The exclusive segment prefix over ungrouped keys, hand-written for Hopper
// (sm_90a): out[i] = sum of contrib[j] over j < i with keys[j] == keys[i].
//
// Replaces the TPU kernel sentinel_tpu/ops/prefix_pallas.py
// (segment_prefix_pallas -> _kernel), which builds the same-key, strictly
// lower [N, N] mask tile by tile in VMEM and multiplies it by the
// contributions on the MXU. It serves the ungrouped decide step
// (EngineConfig(prefix_impl="pallas")), which calls it 13 times a step on
// ONE key vector (engine/decide.py builds the prefix once per step).
//
// What bounds it. The function must read 8 B a row and write 4 B a row; the
// mask form does O(N^2) compare-adds, 134M at N=16384, and repeats its key
// matching on every call.
//
// Design: a plan, once per key vector, and an apply, once per call.
//
// - plan_kernel: one block sorts (key, row) stably by the key's bits
//   (seg::radix_sort) and writes plan[k] = the row of sorted item k, with
//   bit 31 set where item k starts a run of equal keys. Up to PLAN_CAP rows
//   the sort runs in shared memory (two 32-bit key and two 16-bit row
//   buffers, 192 KB at 16384 rows); above, the same block sorts in a global
//   workspace.
// - apply_kernel: gathers contrib in sorted order, scans it with
//   seg::block_seg_excl and scatters each item's prefix to its row: O(N),
//   12 B a row of traffic beside the 4 B plan word. A thread takes ITEMS
//   consecutive items and issues all their loads before it uses any, so
//   its gathers overlap: the call is bound by the latency of two dependent
//   loads, not by a long per-thread loop. Up to TILE rows it is one block
//   and one launch. Above, blocks of TILE items run in parallel and each
//   records its tile's (any head, sum since the last head, first head);
//   carry_kernel then adds, to the items of each tile before its first
//   head, the sum carried in from the tiles before it (walking back to the
//   nearest tile with a head): two launches.
//
// Exactness: every contribution is an integer-valued float32 and the batch
// total stays below 2^24 (the precondition engine/prefix.py states for
// every implementation), so every partial sum is exact and the order of the
// additions, which differs from the mask's, does not change a bit.

#include "seg_scan.cuh"

namespace {

constexpr int PLAN_CAP = 16384;  // rows the plan sorts in shared memory
constexpr int PLAN_SMEM = PLAN_CAP * (4 + 4 + 2 + 2);
constexpr int ITEMS = 4;           // items an apply thread takes
constexpr int APPLY_THREADS = 256;
constexpr int TILE = ITEMS * APPLY_THREADS;  // items an apply block takes
constexpr uint32_t HEAD = 0x80000000u;
constexpr uint32_t ROW = 0x7fffffffu;

template <typename V>
__device__ void plan_block(const int32_t* keys, int n, int32_t* plan,
                           uint32_t* ka, uint32_t* kb, V* va, V* vb,
                           seg::SortScratch& sc) {
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < n; i += nt) {
    ka[i] = (uint32_t)keys[i];
    va[i] = (V)i;
  }
  const bool in_b = seg::radix_sort(ka, kb, va, vb, n, nt, sc);
  const uint32_t* ks = in_b ? kb : ka;
  const V* vs = in_b ? vb : va;
  for (int k = threadIdx.x; k < n; k += nt) {
    const uint32_t head = seg::is_head(ks, k) ? HEAD : 0u;
    plan[k] = (int32_t)((uint32_t)vs[k] | head);
  }
}

// One block of seg::threads_for(n) threads.
__global__ void __launch_bounds__(seg::MAX_THREADS, 1)
    plan_kernel(const int32_t* keys, int n, int32_t* plan, uint32_t* gkey,
                uint32_t* grow) {
  __shared__ seg::SortScratch sc;
  if (n <= PLAN_CAP) {
    extern __shared__ __align__(16) unsigned char prefix_dyn[];
    uint32_t* ka = reinterpret_cast<uint32_t*>(prefix_dyn);
    uint16_t* va = reinterpret_cast<uint16_t*>(ka + 2 * n);
    plan_block<uint16_t>(keys, n, plan, ka, ka + n, va, va + n, sc);
  } else {
    plan_block<uint32_t>(keys, n, plan, gkey, gkey + n, grow, grow + n, sc);
  }
}

// Block b applies items [b * TILE, (b + 1) * TILE), thread t of them
// [t * ITEMS, (t + 1) * ITEMS). With `agg`, it also records its tile:
// agg[3b] the sum since its last head (float bits), agg[3b + 1] whether it
// holds a head, agg[3b + 2] its first head's index.
__global__ void __launch_bounds__(APPLY_THREADS)
    apply_kernel(const int32_t* plan, const float* contrib, float* out, int n,
                 int32_t* agg) {
  __shared__ seg::ScanScratch sc;
  __shared__ int first_head;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(n, t0 + TILE);
  const int k0 = t0 + (int)threadIdx.x * ITEMS;
  if (threadIdx.x == 0) first_head = t1;
  uint32_t p[ITEMS];
  float c[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    p[j] = k0 + j < t1 ? (uint32_t)plan[k0 + j] : 0u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    c[j] = k0 + j < t1 ? contrib[p[j] & ROW] : 0.0f;
  bool f = false;
  float s = 0.0f;
  int first = t1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (k0 + j < t1 && (p[j] & HEAD)) {
      if (!f) first = k0 + j;
      f = true;
      s = 0.0f;
    }
    s += c[j];
  }
  bool tot_f;
  float tot_s;
  float run = seg::block_seg_excl<float>(f, s, sc, blockDim.x, 0, &tot_f,
                                         &tot_s);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (k0 + j >= t1) break;
    if (p[j] & HEAD) run = 0.0f;
    out[p[j] & ROW] = run;
    run += c[j];
  }
  if (agg == nullptr) return;
  if (f) atomicMin(&first_head, first);  // after the scan's barriers
  seg::sync(blockDim.x);
  if (threadIdx.x == 0) {
    agg[3 * blockIdx.x] = __float_as_int(tot_s);
    agg[3 * blockIdx.x + 1] = tot_f ? 1 : 0;
    agg[3 * blockIdx.x + 2] = first_head;
  }
}

// Block b (b >= 1) adds the sum carried into tile b to its items before the
// tile's first head.
__global__ void __launch_bounds__(APPLY_THREADS)
    carry_kernel(const int32_t* plan, float* out, const int32_t* agg) {
  const int b = blockIdx.x + 1;
  __shared__ float carry;
  if (threadIdx.x == 0) {
    float c = 0.0f;
    for (int t = b - 1; t >= 0; --t) {
      c += __int_as_float(agg[3 * t]);
      if (agg[3 * t + 1]) break;
    }
    carry = c;
  }
  __syncthreads();
  if (carry == 0.0f) return;
  const int end = agg[3 * b + 2];
  for (int k = b * TILE + threadIdx.x; k < end; k += blockDim.x)
    out[(uint32_t)plan[k] & ROW] += carry;
}

long long apply_tiles(int n) { return ((long long)n + TILE - 1) / TILE; }

}  // namespace

// Workspace words (int32) the plan and the apply of n rows need.
extern "C" long long sentinel_prefix_plan_work(int n) {
  return n > PLAN_CAP ? 4LL * n : 0;
}

extern "C" long long sentinel_prefix_apply_work(int n) {
  return apply_tiles(n) > 1 ? 3 * apply_tiles(n) : 0;
}

extern "C" int sentinel_prefix_plan(const int32_t* keys, int n,
                                    int32_t* plan, int32_t* work,
                                    long long work_words, void* stream) {
  if (n < 1 || work_words < sentinel_prefix_plan_work(n))
    return (int)cudaErrorInvalidValue;
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PLAN_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const size_t smem = n <= PLAN_CAP ? (size_t)n * (4 + 4 + 2 + 2) : 0;
  uint32_t* g = reinterpret_cast<uint32_t*>(work);
  plan_kernel<<<1, seg::threads_for(n), smem, (cudaStream_t)stream>>>(
      keys, n, plan, g, n > PLAN_CAP ? g + 2LL * n : nullptr);
  return (int)cudaGetLastError();
}

extern "C" int sentinel_prefix_apply(const int32_t* plan,
                                     const float* contrib, float* out, int n,
                                     int32_t* work, long long work_words,
                                     void* stream) {
  if (n < 1 || work_words < sentinel_prefix_apply_work(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = apply_tiles(n);
  if (tiles == 1) {
    const int threads = seg::threads_for((n + ITEMS - 1) / ITEMS);
    apply_kernel<<<1, threads, 0, st>>>(plan, contrib, out, n, nullptr);
    return (int)cudaGetLastError();
  }
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  apply_kernel<<<(unsigned)tiles, APPLY_THREADS, 0, st>>>(plan, contrib, out,
                                                          n, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<(unsigned)(tiles - 1), APPLY_THREADS, 0, st>>>(plan, out,
                                                                work);
  return (int)cudaGetLastError();
}
