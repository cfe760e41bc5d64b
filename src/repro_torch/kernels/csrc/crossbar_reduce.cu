// Crossbar reduction with the dynamic READ/MAC switch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/crossbar_reduce.py
// (crossbar_reduce_pallas, bodies _kernel and _blocked_kernel).  One kernel
// serves both layouts: the flat layout is the query-blocked one at Q = 1.
//
//   out[n*Q + k, :] = sum_s bitmaps[n, s, k, :] @ image[tile_ids[n, s], :, :]
//
// image (T, R, D) f32, bf16 or f16; tile_ids (nb, S) int32, -1 = padding, an
// id at or past T reads the last tile; bitmaps (nb, S, Q, R) in the image
// dtype, 0/1; out (nb*Q, D) image dtype, float32 accumulation.
//
// Bound: memory.  Each non-padding slot reads one R x D tile and does
// 2*Q*R*D flops on it: at Q = 8 that is 16 flops per 4 bytes of an f32
// tile, about 4 flop/byte, far under the card's ridge.  A serving flush
// holds only 16 query blocks, so what limits the kernel is how many bytes
// are in flight, and the design is about keeping many there:
//
// - Grid: x = query block n times n_split, y = chunk of 128 output columns,
//   z = chunk of at most 16 queries (QC, a template) of the block.  The
//   n_split blocks of a query block form a thread-block cluster.  A row's
//   width W is one past its last non-padding slot; block rank i takes the
//   contiguous slots [i*W/n_split, (i+1)*W/n_split).  (A launch's rows are
//   padded to its widest, so splitting S instead would leave the splits
//   past a short row's width idle.)
// - Inside a block, 4 warps take the slots of its range in turn (warp w:
//   slots lo+w, lo+w+4, ...).  A warp covers a 128-column tile row, 4
//   columns a lane (one 16-byte load for f32, one 8-byte load for 16-bit
//   types), keeps two batches of kU rows in flight (the next batch's loads
//   go out before this batch's products), and keeps QC x 4 partial sums in
//   registers.  A slot's bitmap does not depend on its tile id, so the next
//   slot's bitmap is loaded while this slot's rows are.
// - The slot's bitmap is read with 16-byte loads into the warp's own slice
//   of shared memory, transposed to [row][query] so a row's QC values are a
//   broadcast read; two __ballot_sync over the lanes' nonzero counts give
//   "at most one nonzero entry", the READ path: one tile row times the one
//   value, added to that query's sums.  Otherwise (and always with the
//   switch off) the MAC path streams all R rows.  Both add each product with
//   one fmaf in row order, and a zero entry leaves a sum unchanged, so the
//   two paths give the same bits.  Bitmaps are staged 64 rows at a time, so
//   any tile_rows that is a multiple of 8 fits in static shared memory.
// - The warps' partial sums are added in warp order through shared memory;
//   then each block of the cluster adds a slice of the output over the
//   cluster's blocks in rank order through distributed shared memory and
//   writes it once; a block whose range holds no slot adds zeros.  The
//   order of every sum is fixed by (split, warp, slot, row): no atomics, and
//   two launches give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;            // output columns a block covers
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;          // the portable cluster size
constexpr int kPre = 4;               // bitmap vectors a lane prefetches for the next slot
constexpr unsigned kFull = 0xffffffffu;

// --- element types: a lane's 4 tile columns, and 16-byte bitmap vectors ---

template <typename T> struct Elem;
template <> struct Elem<float> { using Row = float4; };
template <> struct Elem<__nv_bfloat16> { using Row = uint2; };
template <> struct Elem<__half> { using Row = uint2; };

// element 2j is the low half of word j (little-endian)
__device__ __forceinline__ float2 pair_f32(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 pair_f32(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float4 row_f32(float4 v, float) { return v; }
template <typename T>
__device__ __forceinline__ float4 row_f32(uint2 v, T tag) {
  const float2 a = pair_f32(v.x, tag), b = pair_f32(v.y, tag);
  return make_float4(a.x, a.y, b.x, b.y);
}

// the 4 values of a lane's columns in one tile row
template <typename T>
__device__ __forceinline__ typename Elem<T>::Row load_row(const T* p) {
  return __ldg(reinterpret_cast<const typename Elem<T>::Row*>(p));
}

// 16 bytes of bitmap as floats: 4 for f32, 8 for 16-bit types
template <typename T> struct BmVec { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void bm_f32(uint4 u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = pair_f32(w[j], T());
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The staged bitmap [row][query] of a warp: 64 rows at a time, row stride
// a multiple of 4 floats for the vector reads, padded past QC to spread the
// staging stores over banks (at QC = 16 a block holds 28 KB of it and its
// partial sums: static shared memory, under 48 KB)
template <int QC> struct Stage {
  static constexpr int stride = QC >= 4 ? QC + 4 : QC;
  static constexpr int rows = 64;
};

// rows a batch; two batches are in flight (8 KB a warp for f32 and for
// 16-bit rows, at twice the rows); half that at QC = 16 for registers
template <typename T, int QC> struct Rows {
  static constexpr int base = sizeof(T) == 4 ? 8 : 16;
  static constexpr int value = QC >= 16 ? base / 2 : base;
};

// The bitmap values of one staged row: QC floats from shared memory.
template <int QC>
__device__ __forceinline__ void stage_row(const float* st, float* b) {
  if constexpr (QC >= 4) {
#pragma unroll
    for (int j = 0; j < QC / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(st)[j];
      b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
    }
  } else if constexpr (QC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(st);
    b[0] = v.x; b[1] = v.y;
  } else {
    b[0] = st[0];
  }
}

// acc[k] += bitmap[k][r] * tile[r] for the N rows in raw, whose bitmap
// rows start at st: in row order, one fmaf a product
template <typename T, int QC, int N>
__device__ __forceinline__ void mac_batch(const typename Elem<T>::Row (&raw)[N],
                                          const float* st, float (&acc)[QC][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 x = row_f32(raw[i], T());
    float b[QC];
    stage_row<QC>(st + i * Stage<QC>::stride, b);
#pragma unroll
    for (int k = 0; k < QC; ++k) {
      acc[k][0] = fmaf(b[k], x.x, acc[k][0]);
      acc[k][1] = fmaf(b[k], x.y, acc[k][1]);
      acc[k][2] = fmaf(b[k], x.z, acc[k][2]);
      acc[k][3] = fmaf(b[k], x.w, acc[k][3]);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_batch(const T* t, int64_t D,
                                           typename Elem<T>::Row (&raw)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) raw[i] = load_row(t + i * D);
}

// The MAC over `rows` (a multiple of 8) tile rows from `t`: batches of N
// rows, each batch's loads issued before the previous batch's products.
template <typename T, int QC, int N>
__device__ __forceinline__ void mac_rows(const T* t, int64_t D, const float* st, int rows,
                                         float (&acc)[QC][4]) {
  using Row = typename Elem<T>::Row;
  int r = 0;
  if (rows >= N) {
    Row cur[N], nxt[N];
    load_batch<T, N>(t, D, cur);
    for (; r + N <= rows; r += N) {
      const bool more = r + 2 * N <= rows;
      if (more) load_batch<T, N>(t + (r + N) * D, D, nxt);
      mac_batch<T, QC, N>(cur, st + r * Stage<QC>::stride, acc);
      if (more) {
#pragma unroll
        for (int i = 0; i < N; ++i) cur[i] = nxt[i];
      }
    }
  }
  for (; r < rows; r += 8) {
    Row tail[8];
    load_batch<T, 8>(t + r * D, D, tail);
    mac_batch<T, QC, 8>(tail, st + r * Stage<QC>::stride, acc);
  }
}

// Stages one 16-byte bitmap vector: vector v of a slot's chunk is elements
// [v*V, v*V + V) of its (qv, R) bitmap, query k = v / per_q, rows from r.
// Rows under Stage<QC>::rows go to st; every nonzero entry is counted.
template <typename T, int QC>
__device__ __forceinline__ void stage_vec(uint4 u, int v, int per_q, int R, float* st,
                                          int& count, int& act, float& act_v) {
  constexpr int V = BmVec<T>::n;
  const int k = v / per_q;
  const int r = (v - k * per_q) * V;
  float f[V];
  bm_f32<T>(u, f);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (r < Stage<QC>::rows) st[(r + e) * Stage<QC>::stride + k] = f[e];
    if (f[e] != 0.f) {
      ++count;
      act = k * R + r + e;
      act_v = f[e];
    }
  }
}

// Stages bitmap rows [r0, r0 + rows) of queries [0, qv) into st (row r at
// st[(r - r0) * stride + k]).  Vectors never straddle a query: R % 8 == 0.
template <typename T, int QC>
__device__ __forceinline__ void stage_rows(const T* bm, int qv, int R, int r0, int rows,
                                           float* st, int lane) {
  constexpr int V = BmVec<T>::n;
  const int per_q = rows / V;
  for (int v = lane; v < qv * per_q; v += 32) {
    const int k = v / per_q;
    const int r = (v - k * per_q) * V;
    float f[V];
    bm_f32<T>(__ldg(reinterpret_cast<const uint4*>(bm + (int64_t)k * R + r0 + r)), f);
#pragma unroll
    for (int j = 0; j < V; ++j) st[(r + j) * Stage<QC>::stride + k] = f[j];
  }
}

template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
crossbar_reduce_kernel(const T* __restrict__ image,
                       const int32_t* __restrict__ tile_ids,
                       const T* __restrict__ bitmaps,
                       T* __restrict__ out,
                       int num_tiles, int R, int D, int S, int Q, int dynamic_switch) {
  constexpr int kStride = Stage<QC>::stride;
  constexpr int kRowChunk = Stage<QC>::rows;
  constexpr int kU = Rows<T, QC>::value;
  constexpr int V = BmVec<T>::n;
  __shared__ __align__(16) float stage[kWarps][kRowChunk * kStride];
  __shared__ __align__(16) float part[QC * kCols];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int64_t n = blockIdx.x / n_split;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int q0 = blockIdx.z * QC;
  const int qv = min(QC, Q - q0);  // real queries of this chunk
  // the row's width: every slot past its last non-padding one is padding
  __shared__ int width;
  if (threadIdx.x == 0) width = 0;
  __syncthreads();
  {
    int w = 0;
    for (int i = threadIdx.x; i < S; i += kThreads)
      if (__ldg(tile_ids + n * S + i) >= 0) w = i + 1;
    w = __reduce_max_sync(kFull, w);
    if (lane == 0) atomicMax(&width, w);
  }
  __syncthreads();
  const int lo = (int)((int64_t)split * width / n_split);
  const int hi = (int)((int64_t)(split + 1) * width / n_split);

  float acc[QC][4];
#pragma unroll
  for (int k = 0; k < QC; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  float* st = stage[warp];
  // staged columns k >= qv stay zero
  for (int i = lane; i < kRowChunk * kStride; i += 32) st[i] = 0.f;
  __syncwarp();

  // the warp's slots: first, first + 4, ... < hi
  const int first = lo + warp;
  const int nslots = first < hi ? (hi - first + kWarps - 1) / kWarps : 0;
  const int32_t* ids = tile_ids + n * S + first;
  const int per_q = R / V;            // bitmap vectors a query's row
  const int nvec = qv * per_q;        // bitmap vectors a slot's chunk
  const T* bm0 = bitmaps + ((n * S + first) * Q + q0) * (int64_t)R;
  const int64_t bm_step = (int64_t)kWarps * Q * R;  // from one of the warp's slots to the next
  const int64_t tile_elems = (int64_t)R * D;

  // A slot's bitmap does not depend on its tile id: the first kPre*32
  // vectors of the next slot's bitmap are loaded while this slot's rows are.
  uint4 pre[kPre] = {};
  auto prefetch = [&](int m) {
    const uint4* src = reinterpret_cast<const uint4*>(bm0 + m * bm_step);
#pragma unroll
    for (int i = 0; i < kPre; ++i)
      if (lane + 32 * i < nvec) pre[i] = __ldg(src + lane + 32 * i);
  };
  int my_id = -1;  // lane j: the id of the warp's slot 32g + j
  if (nslots > 0) {
    if (lane < nslots) my_id = __ldg(ids + lane * kWarps);
    prefetch(0);
  }
  for (int m = 0; m < nslots; ++m) {
    int tid = __shfl_sync(kFull, my_id, m & 31);
    if ((m & 31) == 31 && m + 1 < nslots) {
      const int g = m + 1 + lane;
      my_id = g < nslots ? __ldg(ids + g * kWarps) : -1;
    }
    uint4 cur[kPre];
#pragma unroll
    for (int i = 0; i < kPre; ++i) cur[i] = pre[i];
    if (m + 1 < nslots) prefetch(m + 1);
    if (tid < 0) continue;  // padding: uniform across the warp
    if (tid >= num_tiles) tid = num_tiles - 1;
    const T* bm = bm0 + m * bm_step;
    const T* tile = image + tid * tile_elems + col0 + 4 * lane;

    // stage rows [0, kRowChunk) of the bitmap and count every nonzero entry
    int count = 0, act = 0;
    float act_v = 0.f;
#pragma unroll
    for (int i = 0; i < kPre; ++i)
      if (lane + 32 * i < nvec)
        stage_vec<T, QC>(cur[i], lane + 32 * i, per_q, R, st, count, act, act_v);
    for (int v = lane + 32 * kPre; v < nvec; v += 32)
      stage_vec<T, QC>(__ldg(reinterpret_cast<const uint4*>(bm) + v), v, per_q, R, st,
                       count, act, act_v);
    const unsigned holders = __ballot_sync(kFull, count >= 1);
    const unsigned doubles = __ballot_sync(kFull, count >= 2);
    __syncwarp();  // the staged rows are visible to every lane

    if (dynamic_switch && doubles == 0 && __popc(holders) <= 1) {
      // READ: at most one active wordline; an empty slot adds nothing
      if (holders) {
        const int src = __ffs(holders) - 1;
        const int a = __shfl_sync(kFull, act, src);
        const float v = __shfl_sync(kFull, act_v, src);
        const int k = a / R;
        const float4 x = row_f32(load_row(tile + (int64_t)(a - k * R) * D), T());
#pragma unroll
        for (int kk = 0; kk < QC; ++kk) {
          if (kk == k) {
            acc[kk][0] = fmaf(v, x.x, acc[kk][0]);
            acc[kk][1] = fmaf(v, x.y, acc[kk][1]);
            acc[kk][2] = fmaf(v, x.z, acc[kk][2]);
            acc[kk][3] = fmaf(v, x.w, acc[kk][3]);
          }
        }
      }
    } else {
      // MAC: every row of the tile, in order
      for (int r0 = 0; r0 < R; r0 += kRowChunk) {
        const int rows = min(kRowChunk, R - r0);
        if (r0 > 0) {
          __syncwarp();
          stage_rows<T, QC>(bm, qv, R, r0, rows, st, lane);
          __syncwarp();
        }
        mac_rows<T, QC, kU>(tile + (int64_t)r0 * D, D, st, rows, acc);
      }
    }
    __syncwarp();  // every lane is done with the staged rows
  }

  // the block's partial sums, added in warp order: ((w0 + w1) + w2) + w3
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < QC; ++k) {
        float4* p = reinterpret_cast<float4*>(part + k * kCols) + lane;
        float4 v = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        if (w > 0) {
          const float4 o = *p;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *p = v;
      }
    }
    __syncthreads();
  }

  // the cluster's sum in rank order; each block writes a slice of the output
  cluster.sync();
  const int n4 = qv * (kCols / 4);
  for (int e = split * kThreads + (int)threadIdx.x; e < n4; e += n_split * kThreads) {
    float4 sum = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0))[e];
    for (int r = 1; r < n_split; ++r) {
      const float4 o = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[e];
      sum = make_float4(sum.x + o.x, sum.y + o.y, sum.z + o.z, sum.w + o.w);
    }
    const int k = e / (kCols / 4);
    const int c = (e - k * (kCols / 4)) * 4;
    store4(out + (n * Q + q0 + k) * (int64_t)D + col0 + c, sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int QC>
cudaError_t launch(const void* image, const void* tile_ids, const void* bitmaps, void* out,
                   int num_tiles, int R, int D, int nb, int S, int Q, int n_split,
                   int dynamic_switch, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb * n_split, D / kCols, (Q + QC - 1) / QC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, crossbar_reduce_kernel<T, QC>, static_cast<const T*>(image),
      static_cast<const int32_t*>(tile_ids), static_cast<const T*>(bitmaps),
      static_cast<T*>(out), num_tiles, R, D, S, Q, dynamic_switch);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int QC>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, crossbar_reduce_kernel<T, QC>, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int blocks_per_sm_qc(int q_chunk) {
  switch (q_chunk) {
    case 1: return blocks_per_sm<T, 1>();
    case 2: return blocks_per_sm<T, 2>();
    case 4: return blocks_per_sm<T, 4>();
    case 8: return blocks_per_sm<T, 8>();
    case 16: return blocks_per_sm<T, 16>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
cudaError_t dispatch_qc(int q_chunk, const void* image, const void* tile_ids,
                        const void* bitmaps, void* out, int num_tiles, int R, int D,
                        int nb, int S, int Q, int n_split, int dynamic_switch,
                        cudaStream_t stream) {
  switch (q_chunk) {
    case 1: return launch<T, 1>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, Q, n_split, dynamic_switch, stream);
    case 2: return launch<T, 2>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, Q, n_split, dynamic_switch, stream);
    case 4: return launch<T, 4>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, Q, n_split, dynamic_switch, stream);
    case 8: return launch<T, 8>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, Q, n_split, dynamic_switch, stream);
    case 16: return launch<T, 16>(image, tile_ids, bitmaps, out, num_tiles, R, D, nb, S, Q, n_split, dynamic_switch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q_chunk (1, 2, 4, 8 or 16)
// queries a block, n_split (1..8) blocks a cluster: crossbar_launch_plan in
// crossbar_reduce.py picks both.  Returns the launch's error (0 on success);
// the caller validated shapes, dtypes and alignment.
int crossbar_reduce_launch(const void* image, const void* tile_ids,
                           const void* bitmaps, void* out, int num_tiles,
                           int tile_rows, int dim, int num_blocks,
                           int max_tiles, int q_block, int q_chunk, int n_split,
                           int dtype, int dynamic_switch, void* stream) {
  if (num_blocks == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplit || q_block < 1 || tile_rows % 8 != 0 ||
      dim % kCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_qc<float>(q_chunk, image, tile_ids, bitmaps, out, num_tiles, tile_rows,
                             dim, num_blocks, max_tiles, q_block, n_split, dynamic_switch, st);
  else if (dtype == 1)
    err = dispatch_qc<__nv_bfloat16>(q_chunk, image, tile_ids, bitmaps, out, num_tiles,
                                     tile_rows, dim, num_blocks, max_tiles, q_block, n_split,
                                     dynamic_switch, st);
  else if (dtype == 2)
    err = dispatch_qc<__half>(q_chunk, image, tile_ids, bitmaps, out, num_tiles, tile_rows,
                              dim, num_blocks, max_tiles, q_block, n_split, dynamic_switch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Blocks of the (dtype, q_chunk) instance an SM holds at once on the
// current device (its registers and shared memory decide); -error on failure.
int crossbar_blocks_per_sm(int dtype, int q_chunk) {
  if (dtype == 0) return blocks_per_sm_qc<float>(q_chunk);
  if (dtype == 1) return blocks_per_sm_qc<__nv_bfloat16>(q_chunk);
  if (dtype == 2) return blocks_per_sm_qc<__half>(q_chunk);
  return -static_cast<int>(cudaErrorInvalidValue);
}

const char* crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
