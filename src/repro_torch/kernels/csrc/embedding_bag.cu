// Padded embedding bag (gather + sum), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py
// (embedding_bag_pallas, body _kernel): the naive / nMARS datapath that
// gathers each query's rows by row id and sums them, with no grouping and
// no tile locality.
//
//   out[b, :] = sum_{k : indices[b, k] >= 0} table[min(indices[b, k], rows - 1), :]
//
// table (rows, D) f32 or bf16, D % 128 == 0; indices (B, K) int32, -1 =
// padding; out (B, D) in the table dtype, float32 accumulation rounded
// once at the end.
//
// Bound: memory.  Each valid lookup reads one D-wide row and does D adds
// on it (1 add per 4 bytes in f32), far under the card's ridge; the least
// bytes are the valid rows, the indices and one write of the output.  The
// design moves exactly those: a warp owns one (bag, 128-column chunk),
// each lane loads 4 neighbouring columns of a row (16 B in f32, 8 B in
// bf16), so a row chunk is one coalesced 512 B (256 B) request; the sums
// stay in registers and the output is written once.  A padding index is
// skipped by the whole warp (every lane sees the same index), so no
// padding row is read.  The warp reads its 32 next indices with one
// coalesced load and broadcasts them with __shfl_sync; the row loop is
// unrolled so several independent row loads are in flight per warp.
//
// The TPU kernel's (batch, bag) grid with its "arbitrary" bag axis and
// VMEM f32 scratch becomes a loop over K inside the warp with the sum in
// registers; its (block_rows, D) slab DMA and table row padding are TPU
// artefacts and are gone: rows are gathered directly.
//
// Grid: blockIdx.x = group of kWarps bags, blockIdx.y = 128-column chunk;
// 32 * kWarps threads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;   // columns per warp: 32 lanes x 4
constexpr int kWarps = 4;    // bags per CUDA block

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     T* __restrict__ out,
                     int rows, int D, int B, int K) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp: no block-wide sync below
  const int col = blockIdx.y * kCols + lane * 4;
  const int32_t* bag = indices + (int64_t)b * K;
  const T* base = table + col;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    const int mine = lane < n ? bag[k0 + lane] : -1;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      int idx = __shfl_sync(0xffffffffu, mine, j);
      if (idx >= 0) {  // padding: uniform across the warp
        idx = min(idx, rows - 1);
        const float4 x = load4(base + (int64_t)idx * D);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
    }
  }
  store4(out + (int64_t)b * D + col, acc);
}

template <typename T>
cudaError_t launch(const void* table, const void* indices, void* out, int rows,
                   int D, int B, int K, cudaStream_t stream) {
  dim3 grid((B + kWarps - 1) / kWarps, D / kCols);
  embedding_bag_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(indices),
      static_cast<T*>(out), rows, D, B, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller validated shapes, dtypes, alignment
// and that rows >= 1 and D % 128 == 0.
int embedding_bag_launch(const void* table, const void* indices, void* out,
                         int rows, int dim, int batch, int bag, int dtype,
                         void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(table, indices, out, rows, dim, batch, bag, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(table, indices, out, rows, dim, batch, bag, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
