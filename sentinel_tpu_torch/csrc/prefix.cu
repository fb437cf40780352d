// The exclusive segment prefix over ungrouped keys, hand-written for Hopper
// (sm_90a): out[i] = sum of contrib[j] over j < i with keys[j] == keys[i].
//
// Replaces the TPU kernel sentinel_tpu/ops/prefix_pallas.py
// (segment_prefix_pallas -> _kernel), which builds the same-key, strictly
// lower [N, N] mask tile by tile in VMEM and multiplies it by the
// contributions on the MXU. It serves the ungrouped decide step
// (EngineConfig(prefix_impl="pallas")).
//
// What bounds it. The function must read 8 B a row and write 4 B a row; the
// mask form does O(N^2) compare-adds, 134M at N=16384, which on this card
// is a few microseconds of integer and float issue spread over the SMs.
//
// Design. A 2-D grid of 256-row by 256-column tiles, lower triangle only:
// each block stages one column tile's keys and contributions in shared
// memory, each thread sums its row's same-key earlier columns in order, and
// adds the tile's partial to out[i] with a float atomic (out is zeroed
// first). The result does not depend on the order of those adds: every
// contribution is an integer-valued float32 and the batch total stays
// below 2^24, so every partial sum is exact (the precondition
// engine/prefix.py states for every implementation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;

__global__ void __launch_bounds__(TILE)
    prefix_kernel(const int32_t* keys, const float* contrib, float* out,
                  int N) {
  const int rt = blockIdx.x, ct = blockIdx.y;
  if (ct > rt) return;  // columns after every row of the tile
  __shared__ int32_t sk[TILE];
  __shared__ float sc[TILE];
  const int j = ct * TILE + threadIdx.x;
  sk[threadIdx.x] = j < N ? keys[j] : 0;
  sc[threadIdx.x] = j < N ? contrib[j] : 0.0f;
  __syncthreads();
  const int i = rt * TILE + threadIdx.x;
  if (i >= N) return;
  const int ki = keys[i];
  const int lim = min(TILE, i - ct * TILE);  // columns j < i
  float acc = 0.0f;
  for (int jj = 0; jj < lim; ++jj)
    if (sk[jj] == ki) acc += sc[jj];
  if (acc != 0.0f) atomicAdd(&out[i], acc);
}

}  // namespace

extern "C" int sentinel_segment_prefix(const int32_t* keys,
                                       const float* contrib, float* out,
                                       int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)N * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((N + TILE - 1) / TILE);
  if (tiles > 65535u) return (int)cudaErrorInvalidValue;  // grid.y limit
  prefix_kernel<<<dim3(tiles, tiles), TILE, 0, st>>>(keys, contrib, out, N);
  return (int)cudaGetLastError();
}
