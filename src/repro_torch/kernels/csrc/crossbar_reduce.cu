// Crossbar reduction with the dynamic READ/MAC switch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/crossbar_reduce.py
// (crossbar_reduce_pallas, bodies _kernel and _blocked_kernel).  One kernel
// serves both layouts: the flat layout is the query-blocked one at Q = 1.
//
//   out[n*Q + k, :] = sum_s bitmaps[n, s, k, :] @ image[tile_ids[n, s], :, :]
//
// image (T, R, D) f32 or bf16; tile_ids (nb, S) int32, -1 = padding;
// bitmaps (nb, S, Q, R) in the image dtype, 0/1; out (nb*Q, D) image dtype,
// float32 accumulation.
//
// Bound: memory.  Each non-padding slot reads one R x D tile and does
// 2*Q*R*D flops on it: at Q = 8 that is 16 flops per 4 bytes of an f32
// tile, about 4 flop/byte, far under the card's ridge.  The design keeps
// every tile byte read exactly once per slot (one block walks its own
// schedule), reads each tile row with neighbouring threads on neighbouring
// columns, and keeps the Q partial sums in registers, so device memory sees
// the tiles, the bitmaps and one write of the output and nothing else.
//
// Grid: blockIdx.x = query block n, blockIdx.y = chunk of 128 output
// columns; 128 threads, one column each.  The tile loop over s runs inside
// the block (the TPU's sequential "arbitrary" grid axis and its VMEM
// scratch carry become a loop and registers).  Each block reads its own
// tile ids (the TPU's scalar prefetch) and skips padding slots uniformly.
// The (Q, R) bitmap of a slot is staged in shared memory; two
// __syncthreads_count calls give "at most one nonzero in the block", which
// selects the READ path (add value * the one active row into that query's
// sum) over the MAC path (stream the R tile rows).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int Q>
__global__ void __launch_bounds__(kCols)
crossbar_reduce_kernel(const T* __restrict__ image,
                       const int32_t* __restrict__ tile_ids,
                       const T* __restrict__ bitmaps,
                       T* __restrict__ out,
                       int num_tiles, int R, int D, int S,
                       int dynamic_switch) {
  extern __shared__ float bm[];  // (Q, R) bitmap of the current slot
  __shared__ int active;         // flat index of a nonzero bitmap entry

  const int n = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const int QR = Q * R;

  float acc[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) acc[k] = 0.f;

  for (int s = 0; s < S; ++s) {
    int tid = tile_ids[(int64_t)n * S + s];
    if (tid < 0) continue;  // padding slot: uniform across the block
    if (tid >= num_tiles) tid = num_tiles - 1;

    // stage the bitmap; count this thread's nonzeros
    __syncthreads();  // previous slot's readers are done with bm / active
    const T* src = bitmaps + ((int64_t)n * S + s) * QR;
    int local = 0;
    for (int i = threadIdx.x; i < QR; i += kCols) {
      const float v = to_f32(src[i]);
      bm[i] = v;
      if (v != 0.f) {
        ++local;
        active = i;
      }
    }
    // block popcount <= 1  <=>  no thread holds two and at most one holds one
    const int holders = __syncthreads_count(local >= 1);
    const int doubles = __syncthreads_count(local >= 2);
    const bool read_path = dynamic_switch && doubles == 0 && holders <= 1;

    const T* tile = image + (int64_t)tid * R * D + col;
    if (read_path) {
      if (holders == 1) {
        const int i = active;
        const int q = i / R;
        const float v = bm[i] * to_f32(tile[(int64_t)(i % R) * D]);
#pragma unroll
        for (int k = 0; k < Q; ++k)
          if (k == q) acc[k] += v;
      }
    } else {
      float part[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) part[k] = 0.f;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const float x = to_f32(tile[(int64_t)r * D]);
#pragma unroll
        for (int k = 0; k < Q; ++k) part[k] = fmaf(bm[k * R + r], x, part[k]);
      }
#pragma unroll
      for (int k = 0; k < Q; ++k) acc[k] += part[k];
    }
  }

  T* dst = out + (int64_t)n * Q * D + col;
#pragma unroll
  for (int k = 0; k < Q; ++k) store(dst + (int64_t)k * D, acc[k]);
}

template <typename T, int Q>
cudaError_t launch(const void* image, const void* tile_ids, const void* bitmaps,
                   void* out, int num_tiles, int R, int D, int nb, int S,
                   int dynamic_switch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Q * R;
  dim3 grid(nb, D / kCols);
  crossbar_reduce_kernel<T, Q><<<grid, kCols, smem, stream>>>(
      static_cast<const T*>(image), static_cast<const int32_t*>(tile_ids),
      static_cast<const T*>(bitmaps), static_cast<T*>(out),
      num_tiles, R, D, S, dynamic_switch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_q(int q_block, const void* image, const void* tile_ids,
                       const void* bitmaps, void* out, int num_tiles, int R,
                       int D, int nb, int S, int dynamic_switch,
                       cudaStream_t stream) {
  switch (q_block) {
    case 1: return launch<T, 1>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, dynamic_switch, stream);
    case 2: return launch<T, 2>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, dynamic_switch, stream);
    case 4: return launch<T, 4>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, dynamic_switch, stream);
    case 8: return launch<T, 8>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, dynamic_switch, stream);
    case 16: return launch<T, 16>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, dynamic_switch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller validated shapes, dtypes and q_block.
int crossbar_reduce_launch(const void* image, const void* tile_ids,
                           const void* bitmaps, void* out, int num_tiles,
                           int tile_rows, int dim, int num_blocks,
                           int max_tiles, int q_block, int dtype,
                           int dynamic_switch, void* stream) {
  if (num_blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_q<float>(q_block, image, tile_ids, bitmaps, out, num_tiles,
                            tile_rows, dim, num_blocks, max_tiles,
                            dynamic_switch, st);
  else if (dtype == 1)
    err = dispatch_q<__nv_bfloat16>(q_block, image, tile_ids, bitmaps, out,
                                    num_tiles, tile_rows, dim, num_blocks,
                                    max_tiles, dynamic_switch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
