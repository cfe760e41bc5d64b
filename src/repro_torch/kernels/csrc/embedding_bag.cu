// Padded embedding bag (gather + sum), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py
// (embedding_bag_pallas, body _kernel): the naive / nMARS datapath that
// gathers each query's rows by row id and sums them, with no grouping and
// no tile locality.
//
//   out[b, :] = sum_{k : indices[b, k] >= 0} table[min(indices[b, k], rows - 1), :]
//
// table (rows, D) f32, bf16 or f16, D % 128 == 0; indices (B, K) int32, -1
// = padding anywhere in a bag; out (B, D) in the table dtype, float32
// accumulation rounded once at the end.
//
// Bound: memory.  Each valid lookup reads one D-wide row and does D adds
// on it (1 add per 4 bytes in f32), far under the card's ridge; the least
// bytes are the valid rows, the indices and one write of the output.  On
// the main path (256 bags of about 32 ids) those bytes take ~1 us, so
// what bounds a launch is latency: how many dependent DRAM round trips the
// slowest bag's chain holds, and how many rows are in flight at once.
//
// Design:
// - A lane group of 128 / (16 / sizeof(T)) lanes (a warp in f32, a
//   half-warp in bf16/f16) owns one 128-column chunk of one bag's split;
//   each lane moves 16 bytes of a row (4 f32 or 8 16-bit columns), so a
//   group request is one 512 B (f32) or 256 B (16-bit) row chunk and a
//   16-bit warp request covers two rows at full width.
// - Each bag's positions [0, K) are split into n_split contiguous ranges,
//   [i*K/n, (i+1)*K/n) (kernels.ref.embedding_bag_k_ranges); the splits
//   of one bag sit in one CUDA block.  The host picks the largest n_split
//   whose grid fits one wave of the kernel's occupancy and whose ranges
//   hold at least kRowsInFlight positions
//   (kernels.embedding_bag.embedding_bag_launch_plan).
// - A group loads one id a lane (one coalesced request), compacts the
//   valid ones in order with __ballot_sync / __popc into shared memory,
//   then issues kRowsInFlight independent 16-byte row loads into registers
//   before its first add; rows are added in id order in f32.
// - The splits' partial sums meet in shared memory and the split-0 group
//   adds them in split order (split 0 first): no atomics, so two launches
//   give the same bits (kernels.ref.embedding_bag_split_ref repeats the
//   order).
//
// The TPU kernel's (batch, bag) grid with its "arbitrary" bag axis and
// VMEM f32 scratch becomes contiguous bag ranges over lane groups with the
// sums in registers; its (block_rows, D) slab DMA and table row padding
// are TPU artefacts and are gone: rows are gathered directly.
//
// Grid: blockIdx.x = group of bags_per_block bags, blockIdx.y = 128-column
// chunk; a block of `threads` threads holds bags_per_block * n_split lane
// groups (any spare groups idle).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;        // columns a lane group covers
constexpr int kRowsInFlight = 8;  // row loads a lane issues before its first add
                                  // (ROWS_IN_FLIGHT in kernels/embedding_bag.py)
constexpr int kMaxThreads = 512;  // a block's threads at most (16 f32 splits)

template <typename T>
struct Lanes {
  static constexpr int kVec = 16 / sizeof(T);   // columns a lane moves
  static constexpr int kGroup = kCols / kVec;   // lanes of a group: 32 or 16
};

// Two packed 16-bit values to f32 (exact) and back (round to nearest even),
// by value: nothing is taken by address, so nothing goes to local memory.
__device__ __forceinline__ float2 to_float2(uint32_t w, const __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float2 to_float2(uint32_t w, const __half*) {
  return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(w))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}

__device__ __forceinline__ void accumulate(float (&acc)[4], uint4 r, const float*) {
  acc[0] += __uint_as_float(r.x);
  acc[1] += __uint_as_float(r.y);
  acc[2] += __uint_as_float(r.z);
  acc[3] += __uint_as_float(r.w);
}

template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[8], uint4 r, const T* tag) {
  const float2 a = to_float2(r.x, tag), b = to_float2(r.y, tag);
  const float2 c = to_float2(r.z, tag), d = to_float2(r.w, tag);
  acc[0] += a.x; acc[1] += a.y; acc[2] += b.x; acc[3] += b.y;
  acc[4] += c.x; acc[5] += c.y; acc[6] += d.x; acc[7] += d.y;
}

__device__ __forceinline__ uint32_t pack2(float a, float b, const __nv_bfloat16*) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, const __half*) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16);
}

__device__ __forceinline__ void store(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&a)[8]) {
  const uint4 r = make_uint4(pack2(a[0], a[1], p), pack2(a[2], a[3], p),
                             pack2(a[4], a[5], p), pack2(a[6], a[7], p));
  *reinterpret_cast<uint4*>(p) = r;
}

// Dynamic shared memory of a block of `threads` threads: each group's f32
// partial (kCols floats), then each group's compacted ids (a lane's one).
template <typename T>
size_t smem_bytes(int threads) {
  const int groups = threads / Lanes<T>::kGroup;
  return sizeof(float) * groups * kCols + sizeof(int) * threads;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     T* __restrict__ out,
                     int rows, int D, int B, int K, int n_split,
                     int bags_per_block) {
  constexpr int kVec = Lanes<T>::kVec;
  constexpr int kGroup = Lanes<T>::kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  float* partials = reinterpret_cast<float*>(smem);  // (groups, kCols)
  int* ids = reinterpret_cast<int*>(partials + (blockDim.x / kGroup) * kCols);

  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / kGroup;
  const int gl = threadIdx.x % kGroup;                  // lane in the group
  const int shift = kGroup == 32 ? 0 : (lane & 16);
  const unsigned gmask = kGroup == 32 ? 0xffffffffu : (0xffffu << shift);
  const int bag_local = group / n_split;
  const int split = group - bag_local * n_split;
  const int b = blockIdx.x * bags_per_block + bag_local;
  const bool live = bag_local < bags_per_block && b < B;  // uniform in a group
  const int col = blockIdx.y * kCols + gl * kVec;

  float acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.f;

  if (live) {
    const int lo = static_cast<int>(static_cast<int64_t>(split) * K / n_split);
    const int hi = static_cast<int>(static_cast<int64_t>(split + 1) * K / n_split);
    const int32_t* bag = indices + static_cast<int64_t>(b) * K;
    const T* base = table + col;
    int* mine = ids + group * kGroup;
    for (int k0 = lo; k0 < hi; k0 += kGroup) {
      const int k = k0 + gl;
      const int idx = k < hi ? bag[k] : -1;
      const unsigned valid = (__ballot_sync(gmask, idx >= 0) & gmask) >> shift;
      if (idx >= 0) mine[__popc(valid & ((1u << gl) - 1u))] = min(idx, rows - 1);
      __syncwarp(gmask);
      const int n = __popc(valid);
      for (int j0 = 0; j0 < n; j0 += kRowsInFlight) {
        // every load of the batch is issued before the first add; a short
        // batch leaves the unrolled loops early rather than running the
        // rest predicated off
        const int m = min(n - j0, kRowsInFlight);
        uint4 r[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          if (u == m) break;
          r[u] = __ldg(reinterpret_cast<const uint4*>(
              base + static_cast<int64_t>(mine[j0 + u]) * D));
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          if (u == m) break;
          accumulate(acc, r[u], table);
        }
      }
      __syncwarp(gmask);  // every lane has read `mine` before it is rewritten
    }
  }

  if (n_split > 1) {  // uniform across the block
    float* p = partials + group * kCols + gl * kVec;
    if (live && split > 0) {
#pragma unroll
      for (int v = 0; v < kVec; v += 4)
        *reinterpret_cast<float4*>(p + v) =
            make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    }
    __syncthreads();
    if (live && split == 0) {
      for (int s = 1; s < n_split; ++s) {
        const float* q = p + s * kCols;
#pragma unroll
        for (int v = 0; v < kVec; v += 4) {
          const float4 x = *reinterpret_cast<const float4*>(q + v);
          acc[v] += x.x;
          acc[v + 1] += x.y;
          acc[v + 2] += x.z;
          acc[v + 3] += x.w;
        }
      }
    }
  }
  if (live && split == 0) store(out + static_cast<int64_t>(b) * D + col, acc);
}

template <typename T>
cudaError_t launch(const void* table, const void* indices, void* out, int rows,
                   int D, int B, int K, int n_split, int bags_per_block,
                   int threads, cudaStream_t stream) {
  constexpr int kGroup = Lanes<T>::kGroup;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || n_split < 1 ||
      bags_per_block < 1 || bags_per_block * n_split * kGroup > threads ||
      D % kCols != 0 || rows < 1)
    return cudaErrorInvalidValue;
  dim3 grid((B + bags_per_block - 1) / bags_per_block, D / kCols);
  embedding_bag_kernel<T><<<grid, threads, smem_bytes<T>(threads), stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(indices),
      static_cast<T*>(out), rows, D, B, K, n_split, bags_per_block);
  return cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int threads) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, embedding_bag_kernel<T>, threads, smem_bytes<T>(threads));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  The launch (n_split,
// bags_per_block, threads) comes from embedding_bag_launch_plan.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a launch the kernel cannot take; the caller
// validated shapes, dtypes, alignment and that rows >= 1.
int embedding_bag_launch(const void* table, const void* indices, void* out,
                         int rows, int dim, int batch, int bag, int dtype,
                         int n_split, int bags_per_block, int threads,
                         void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(table, indices, out, rows, dim, batch, bag, n_split,
                        bags_per_block, threads, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(table, indices, out, rows, dim, batch, bag,
                                n_split, bags_per_block, threads, st);
  else if (dtype == 2)
    err = launch<__half>(table, indices, out, rows, dim, batch, bag, n_split,
                         bags_per_block, threads, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Blocks of `threads` threads that one SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA
// error.
int embedding_bag_blocks_per_sm(int dtype, int threads) {
  if (dtype == 0) return blocks_per_sm<float>(threads);
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(threads);
  if (dtype == 2) return blocks_per_sm<__half>(threads);
  return -static_cast<int>(cudaErrorInvalidValue);
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
