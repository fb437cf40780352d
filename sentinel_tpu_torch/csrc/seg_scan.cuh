// Block-level building blocks of the exclusive same-key prefix, shared by
// the param-sketch kernels (csrc/cms.cu and csrc/salsa.cu, through
// param_common.cuh) and the segment-prefix kernels (csrc/prefix.cu).
//
// Both compute, over rows in batch order whose 32-bit keys are NOT grouped,
// pre[i] = sum of con[j] over j < i with key[j] == key[i]. On the TPU the
// reference does that with a same-key, strictly lower [N, N] mask on the
// MXU (ops/prefix_pallas.py; the param kernels ops/cms_pallas.py and
// ops/salsa_pallas.py build the same mask per tile), O(N^2) work. Here it
// is done in O(N) per contribution vector once the keys are grouped:
//
//   1. radix_sort: a stable sort of (key, row) pairs by the key's 32 bits,
//      one block, passes of 8 bits. Each warp owns a contiguous chunk of
//      the input and walks it 32 rows at a time; eight ballots rank a row
//      among the earlier rows of its batch with the same digit, and a
//      per-(warp, digit) counter, scanned in digit-major order, gives the
//      place of the batch. So each pass is stable, and so is the sort: rows
//      of one key keep batch order. A pass whose 8 bits are equal in every
//      key is skipped (it would move nothing): flow ids below 2^24 sort in
//      three passes or fewer. The order of two different keys is the bits'
//      order; it only has to group equal keys.
//   2. block_seg_excl: a block-wide segmented exclusive scan in the blocked
//      arrangement (thread t owns a contiguous run of sorted items): each
//      thread folds its run into (any head, sum since the last head), the
//      warps scan those pairs with shuffles and the warp totals are scanned
//      by one warp; a thread then walks its run from its carry.
//
// Exactness. The sums are of integer-valued contributions (int acquires, or
// float32 holding integers) whose batch total stays below 2^24, so every
// partial sum is exact and the order of the additions, which differs from
// the mask's, cannot change a bit.
//
// Cost. A sort pass is five barriers of the active threads, two walks over
// the keys and a scan of 256 counters per active warp. That fixed part
// dominates below a few thousand rows, which is why the param kernels admit
// up to 64 rows in one warp without sorting. Each warp's counters sit in
// its own row of 256 words, so the lanes of a batch mostly hit distinct
// banks. A segmented scan is two barriers and a read of each item.
//
// Every function here is called by the first `nt` threads of the block, a
// multiple of 32 (the rows' warps; the other warps of a param launch only
// help with its roll), which synchronise on named barrier 1 alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int RADIX_BITS = 8;
constexpr int DIGITS = 1 << RADIX_BITS;
constexpr unsigned FULL = 0xffffffffu;

// Warp totals of a block scan, double-buffered: consecutive scans take
// alternate buffers, so a scan never overwrites totals a slow warp of the
// previous one is still reading.
struct ScanScratch {
  int flag[2][MAX_WARPS];
  uint32_t sum[2][MAX_WARPS];
};

struct SortScratch {
  uint32_t hist[MAX_WARPS * DIGITS];  // [warp][digit] counters
  uint32_t key_and[MAX_WARPS], key_or[MAX_WARPS];
  uint32_t row_total[DIGITS / 32];  // counters of 32 digits each
  ScanScratch scan;
};

// The barrier of the first nt threads (named barrier 1).
__device__ __forceinline__ void sync(int nt) {
  asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}

// The active threads for n items: a warp per 32 items up to a full block.
__host__ __device__ __forceinline__ int threads_for(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

// Exclusive segmented scan across the first nt threads. (f, s) is this
// thread's run: whether it holds a segment head, and its sum since the last
// head (all of it when none). Returns the sum carried into the thread's
// first item; with `tot_f` / `tot_s`, also the pair of all nt threads.
template <typename T>
__device__ T block_seg_excl(bool f, T s, ScanScratch& sc, int nt, int parity,
                            bool* tot_f = nullptr, T* tot_s = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = nt >> 5;
  int fi = f ? 1 : 0;
  T si = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int uf = __shfl_up_sync(FULL, fi, o);
    const T us = __shfl_up_sync(FULL, si, o);
    if (lane >= o) {
      if (!fi) si = us + si;
      fi |= uf;
    }
  }
  int ef = __shfl_up_sync(FULL, fi, 1);
  T es = __shfl_up_sync(FULL, si, 1);
  if (lane == 0) {
    ef = 0;
    es = T(0);
  }
  T* wsum = reinterpret_cast<T*>(sc.sum[parity]);
  int* wflag = sc.flag[parity];
  if (lane == 31) {
    wflag[warp] = fi;
    wsum[warp] = si;
  }
  sync(nt);
  if (warp == 0) {
    int wf = lane < nw ? wflag[lane] : 0;
    T ws = lane < nw ? wsum[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const int uf = __shfl_up_sync(FULL, wf, o);
      const T us = __shfl_up_sync(FULL, ws, o);
      if (lane >= o) {
        if (!wf) ws = us + ws;
        wf |= uf;
      }
    }
    if (lane < nw) {
      wflag[lane] = wf;
      wsum[lane] = ws;
    }
  }
  sync(nt);
  const T base = warp > 0 ? wsum[warp - 1] : T(0);
  if (tot_f) *tot_f = wflag[nw - 1] != 0;
  if (tot_s) *tot_s = wsum[nw - 1];
  return ef ? es : base + es;
}

// The blocked arrangement of n items over nt threads: this thread's run
// [*k0, *k1).
__device__ __forceinline__ void blocked_run(int n, int nt, int* k0,
                                            int* k1) {
  const int per = (n + nt - 1) / nt;
  const int a = min(n, (int)threadIdx.x * per);
  *k0 = a;
  *k1 = min(n, a + per);
}

// The lanes of this warp that hold the same digit d, among those with ok
// (by the digit's bits, one ballot each).
__device__ __forceinline__ uint32_t digit_peers(uint32_t d, bool ok) {
  uint32_t peers = __ballot_sync(FULL, ok);
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    const uint32_t bit = (d >> b) & 1u;
    const uint32_t set = __ballot_sync(FULL, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The counters of the first nw warps, [warp][digit], turned into the
// exclusive prefix in (digit, warp) order. Warp v of the first nt threads
// takes digits [32v, 32v + 32), a digit a lane (and v + nt/32, ... when nt
// has fewer than 8 warps). Ends with a barrier.
__device__ void scan_counters(SortScratch& sc, int nw, int nt) {
  constexpr int ROWS = DIGITS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwt = nt >> 5;
  uint32_t excl[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int v = warp + i * nwt;
    excl[i] = 0u;
    if (v < ROWS) {
      const int d = v * 32 + lane;
      uint32_t tot = 0u;
      for (int w = 0; w < nw; ++w) tot += sc.hist[w * DIGITS + d];
      uint32_t incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) sc.row_total[v] = incl;
      excl[i] = incl - tot;
    }
  }
  sync(nt);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int v = warp + i * nwt;
    if (v < ROWS) {
      const int d = v * 32 + lane;
      uint32_t run = excl[i];
      for (int u = 0; u < v; ++u) run += sc.row_total[u];
      for (int w = 0; w < nw; ++w) {
        const uint32_t h = sc.hist[w * DIGITS + d];
        sc.hist[w * DIGITS + d] = run;
        run += h;
      }
    }
  }
  sync(nt);
}

// Stable sort of n (key, value) pairs by the key's bits, by the first nt
// threads. On entry ka / va hold the pairs (written by those threads, not
// yet behind a barrier); kb / vb are scratch of the same size. Returns true
// when the sorted pairs are in kb / vb, false when in ka / va. The buffers
// may be shared or global memory (generic pointers).
template <typename V>
__device__ bool radix_sort(uint32_t* ka, uint32_t* kb, V* va, V* vb, int n,
                           int nt, SortScratch& sc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  sync(nt);
  // which 8-bit digits differ anywhere
  uint32_t a = FULL, o = 0u;
  for (int i = tid; i < n; i += nt) {
    a &= ka[i];
    o |= ka[i];
  }
  a = __reduce_and_sync(FULL, a);
  o = __reduce_or_sync(FULL, o);
  if (lane == 0) {
    sc.key_and[warp] = a;
    sc.key_or[warp] = o;
  }
  sync(nt);
  a = FULL;
  o = 0u;
  for (int w = 0; w < (nt >> 5); ++w) {
    a &= sc.key_and[w];
    o |= sc.key_or[w];
  }
  const uint32_t varying = a ^ o;

  // warp w owns rows [lo, hi); only the first nw warps own any
  const int nw = min(nt >> 5, (n + 31) / 32);
  const int chunk = (((n + nw - 1) / nw) + 31) & ~31;
  const int lo = min(n, warp * chunk), hi = min(n, lo + chunk);
  uint32_t* my_hist = sc.hist + warp * DIGITS;
  const uint32_t lt = (1u << lane) - 1u;

  bool in_b = false;
  for (int shift = 0; shift < 32; shift += RADIX_BITS) {
    if (((varying >> shift) & (DIGITS - 1)) == 0u) continue;
    const uint32_t* ks = in_b ? kb : ka;
    uint32_t* kd = in_b ? ka : kb;
    const V* vs = in_b ? vb : va;
    V* vd = in_b ? va : vb;
    for (int e = tid; e < nw * DIGITS; e += nt) sc.hist[e] = 0u;
    sync(nt);
    for (int base = lo; base < hi; base += 32) {  // warp-uniform bounds
      const int i = base + lane;
      const bool ok = i < hi;
      const uint32_t d = ok ? (ks[i] >> shift) & (DIGITS - 1) : 0u;
      const uint32_t peers = digit_peers(d, ok);
      if (ok && lane == __ffs(peers) - 1) my_hist[d] += __popc(peers);
      __syncwarp();
    }
    sync(nt);
    scan_counters(sc, nw, nt);
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const bool ok = i < hi;
      uint32_t k = 0u, d = 0u;
      V v = V(0);
      if (ok) {
        k = ks[i];
        v = vs[i];
        d = (k >> shift) & (DIGITS - 1);
      }
      const uint32_t peers = digit_peers(d, ok);
      uint32_t pos = 0u;
      if (ok) pos = my_hist[d] + __popc(peers & lt);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) my_hist[d] += __popc(peers);
      __syncwarp();
      if (ok) {
        kd[pos] = k;
        vd[pos] = v;
      }
    }
    sync(nt);
    in_b = !in_b;
  }
  return in_b;
}

// Whether sorted item k starts a run of equal keys.
__device__ __forceinline__ bool is_head(const uint32_t* ks, int k) {
  return k == 0 || ks[k] != ks[k - 1];
}

}  // namespace seg
