// Fused flash-decode attention over an int8 K/V cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (fused_decode_attention_pallas :94, body _kernel :43): the cache half of
// one decode step's attention.  For every (batch b, KV head h) and each of
// its g query rows:
//
//   k[t] = float(k_q[b,t,h,:]) * k_s[b,t,h]      (likewise v)
//   s[t] = (q . k[t]) * (1/sqrt(hd)),  s[t] = -1e30 where t >= length
//   m = max_t s[t],  l = sum_t exp(s[t] - m),  out = sum_t exp(s[t] - m) v[t]
//
// out is UNNORMALIZED (the caller merges the new token's own K/V with a
// two-softmax combine and divides).  q (b, kvh, g, hd) f32 or bf16; k_q,
// v_q (b, S, kvh, hd) int8; k_s, v_s (b, S, kvh) f32 or bf16; length an
// int32 on the device, read here (the TPU kernel's scalar prefetch), so
// the host never waits for it; out (b, kvh, g, hd), m and l (b, kvh, g)
// f32.
//
// The mask value is -1e30, never -inf: at length = 0 every position is
// masked, m stays -1e30 and every weight is exp(0) = 1, so l = S and
// out = sum v, exactly as the plain version gives (the caller's merge
// then multiplies all of it by exp(-1e30 - s_new) = 0).  For that reason
// a chunk lying wholly past length is skipped only when length >= 1: its
// weights exp(-1e30 - m) are then exactly 0 and its correction exactly 1.
//
// Bound.  With g query rows per KV head the two products do 4 g hd flop
// per cached position for 2 hd + 4 bytes read; at g = 16 that is 29 flop
// a byte, above the f32 CUDA-core ridge (67e12 / 3.35e12 = 20), so in
// f32 the kernel is bound by operations (one decode_32k layer: 6.9e10
// flop = 1.03 ms at 67 TFLOP/s against 0.65 ms for its 2.18 GB).  The
// design keeps the int8 cache the only large traffic (the dequantized
// cache never exists in device memory) and feeds the FMAs from shared
// memory with register tiles: QK^T gives each thread 4 query rows x 1
// position (one float4 of K and four broadcast float4s of q per 16 FMAs;
// K rows padded by 4 floats, so a quarter-warp's float4 reads hit 32
// distinct banks), PV gives each thread 4 rows x 4 columns over a slice
// of the chunk's positions (weights read as float4 along t).  The next
// chunk's int8 rows are fetched into registers (16-byte loads, a row's
// lanes on neighbouring addresses) while the current chunk computes.
// Moving the products to tensor cores (int8 or bf16 mma) and splitting S
// across blocks are later work.
//
// Grid: (kvh, b), one block per (b, h) looping over S in chunks of kT =
// 64 positions: the TPU grid's sequential "arbitrary" S axis with its
// VMEM carries (m, l, acc) becomes this loop with m and l in shared
// memory and acc in registers.  256 threads; the block holds kG = 16
// query rows (rows past g are zero and never written), hd in {16, 32, 64,
// 128, 256}.  Dynamic shared memory: 79 KB at hd = 128, 149 KB at 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // cache positions per chunk
constexpr int kG = 16;       // query rows a block holds (g <= kG)
constexpr int kRows = 4;     // query rows per thread in both products
constexpr float kMasked = -1e30f;

static_assert(kT == 64, "the softmax step maps a chunk onto 2 x 32 lanes");
static_assert((kThreads / 32) * 2 == kG, "one warp per 2 rows in the softmax");
static_assert((kThreads / kT) * kRows == kG, "QK^T tiles cover kG x kT");

__device__ __forceinline__ float load_f(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Shared-memory layout, in floats.
template <int HD>
struct Layout {
  static constexpr int kKStride = HD + 4;          // padded K rows
  static constexpr int q = 0;                      // [kG][HD]; the split merge reuses it
  static constexpr int k = q + kG * HD;            // [kT][kKStride] dequantized K
  static constexpr int v = k + kT * kKStride;      // [kT][HD] dequantized V
  static constexpr int p = v + kT * HD;            // [kG][kT] scores, then weights
  static constexpr int corr = p + kG * kT;         // [kG] exp(m_prev - m_new)
  static constexpr int m = corr + kG;              // [kG] running max
  static constexpr int l = m + kG;                 // [kG] running denominator
  static constexpr size_t bytes = (l + kG) * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q, int q_bf16,
                        const int8_t* __restrict__ k_q, const void* __restrict__ k_s,
                        const int8_t* __restrict__ v_q, const void* __restrict__ v_s,
                        int s_bf16, const int32_t* __restrict__ length,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int S, int kvh, int g,
                        float scale) {
  static_assert(HD >= 16 && HD <= 256 && kThreads % HD == 0, "head dim");
  using L = Layout<HD>;
  constexpr int kVecRow = HD / 16;                 // 16-byte vectors per cache row
  constexpr int kVecs = kT * kVecRow;              // per chunk, K or V
  constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  constexpr int kCols4 = HD / 4;                   // PV: float4 columns
  constexpr int kGroups = kG / kRows;              // PV: row groups
  constexpr int kSplit = kThreads / (kCols4 * kGroups);  // PV: position slices
  constexpr int kTS = kT / kSplit;
  static_assert(kTS % 4 == 0, "PV reads weights as float4 along t");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem + L::q;
  float* k_sm = smem + L::k;
  float* v_sm = smem + L::v;
  float* p_s = smem + L::p;
  float* corr_s = smem + L::corr;
  float* m_s = smem + L::m;
  float* l_s = smem + L::l;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t bh = (int64_t)b * kvh + h;

  for (int i = tid; i < kG * HD; i += kThreads) {
    const int r = i / HD;
    q_s[i] = r < g ? load_f(q, (bh * g + r) * HD + i % HD, q_bf16) : 0.f;
  }
  if (tid < kG) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }

  const int len = *length;
  // length <= 0: every position is masked and every one carries weight 1
  const int visit = len <= 0 ? S : min(len, S);
  const int n_chunks = (visit + kT - 1) / kT;

  int4 k_reg[kPer], v_reg[kPer];
  float ks_reg[kPer], vs_reg[kPer];
  auto fetch = [&](int c) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      const int pos = c * kT + i / kVecRow;
      if (i < kVecs && pos < S) {
        const int64_t row = ((int64_t)b * S + pos) * kvh + h;
        k_reg[j] = __ldg(reinterpret_cast<const int4*>(k_q + row * HD) + i % kVecRow);
        v_reg[j] = __ldg(reinterpret_cast<const int4*>(v_q + row * HD) + i % kVecRow);
        ks_reg[j] = load_f(k_s, row, s_bf16);
        vs_reg[j] = load_f(v_s, row, s_bf16);
      } else {
        k_reg[j] = make_int4(0, 0, 0, 0);
        v_reg[j] = make_int4(0, 0, 0, 0);
        ks_reg[j] = 0.f;
        vs_reg[j] = 0.f;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i >= kVecs) continue;
      const int t = i / kVecRow;
      const int col = (i % kVecRow) * 16;
      const int8_t* ke = reinterpret_cast<const int8_t*>(&k_reg[j]);
      const int8_t* ve = reinterpret_cast<const int8_t*>(&v_reg[j]);
      float* kd = k_sm + t * L::kKStride + col;
      float* vd = v_sm + t * HD + col;
#pragma unroll
      for (int u = 0; u < 16; u += 4) {
        *reinterpret_cast<float4*>(kd + u) = make_float4(
            (float)ke[u] * ks_reg[j], (float)ke[u + 1] * ks_reg[j],
            (float)ke[u + 2] * ks_reg[j], (float)ke[u + 3] * ks_reg[j]);
        *reinterpret_cast<float4*>(vd + u) = make_float4(
            (float)ve[u] * vs_reg[j], (float)ve[u + 1] * vs_reg[j],
            (float)ve[u + 2] * vs_reg[j], (float)ve[u + 3] * vs_reg[j]);
      }
    }
  };

  // PV tile of this thread: rows pv_r0.., columns pv_c.., positions of its slice
  const int pv_c = (tid % kCols4) * 4;
  const int pv_r0 = ((tid / kCols4) % kGroups) * kRows;
  const int pv_split = tid / (kCols4 * kGroups);
  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's PV is done with K, V and weights
    stage();
    if (c + 1 < n_chunks) fetch(c + 1);
    __syncthreads();

    {  // scores: rows qk_r0..+3 at position t of the chunk
      const int t = tid % kT;
      const int qk_r0 = (tid / kT) * kRows;
      const float* krow = k_sm + t * L::kKStride;
      float dot[kRows] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + (qk_r0 + r) * HD + d);
          dot[r] = fmaf(qv.x, kv.x, dot[r]);
          dot[r] = fmaf(qv.y, kv.y, dot[r]);
          dot[r] = fmaf(qv.z, kv.z, dot[r]);
          dot[r] = fmaf(qv.w, kv.w, dot[r]);
        }
      }
      const bool masked = c * kT + t >= len;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p_s[(qk_r0 + r) * kT + t] = masked ? kMasked : dot[r] * scale;
    }
    __syncthreads();

    {  // online softmax: one warp per 2 rows, 2 positions per lane
      const int warp = tid >> 5;
      const int lane = tid & 31;
      const int p0 = c * kT + lane;
      const int p1 = p0 + 32;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        float* pr = p_s + r * kT;
        const float s0 = pr[lane];
        const float s1 = pr[lane + 32];
        // positions past S (a ragged last chunk) take no part at all
        const float mx = warp_max(fmaxf(p0 < S ? s0 : kMasked, p1 < S ? s1 : kMasked));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float w0 = p0 < S ? expf(s0 - m_new) : 0.f;
        const float w1 = p1 < S ? expf(s1 - m_new) : 0.f;
        pr[lane] = w0;
        pr[lane + 32] = w1;
        const float sum = warp_sum(w0 + w1);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    {  // acc = acc * corr + weights @ V over this thread's slice of the chunk
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float cr = corr_s[pv_r0 + r];
        acc[r].x *= cr;
        acc[r].y *= cr;
        acc[r].z *= cr;
        acc[r].w *= cr;
      }
      const int t0 = pv_split * kTS;
#pragma unroll 2
      for (int t = t0; t < t0 + kTS; t += 4) {
        float4 w[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          w[r] = *reinterpret_cast<const float4*>(p_s + (pv_r0 + r) * kT + t);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(v_sm + (t + u) * HD + pv_c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float wr = comp(w[r], u);
            acc[r].x = fmaf(wr, vv.x, acc[r].x);
            acc[r].y = fmaf(wr, vv.y, acc[r].y);
            acc[r].z = fmaf(wr, vv.z, acc[r].z);
            acc[r].w = fmaf(wr, vv.w, acc[r].w);
          }
        }
      }
    }
  }

  // sum the position slices into slice 0, one slice at a time (a fixed
  // order: the result does not depend on scheduling), then write once
  __syncthreads();
  float* red = q_s;
  for (int s = 1; s < kSplit; ++s) {
    if (pv_split == s) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        *reinterpret_cast<float4*>(red + (pv_r0 + r) * HD + pv_c) = acc[r];
    }
    __syncthreads();
    if (pv_split == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 o = *reinterpret_cast<const float4*>(red + (pv_r0 + r) * HD + pv_c);
        acc[r].x += o.x;
        acc[r].y += o.y;
        acc[r].z += o.z;
        acc[r].w += o.w;
      }
    }
    __syncthreads();
  }
  if (pv_split == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = pv_r0 + r;
      if (row < g)
        *reinterpret_cast<float4*>(out + (bh * g + row) * HD + pv_c) = acc[r];
    }
  }
  if (tid < g) {
    m_out[bh * g + tid] = m_s[tid];
    l_out[bh * g + tid] = l_s[tid];
  }
}

template <int HD>
cudaError_t launch(const void* q, int q_bf16, const void* k_q, const void* k_s,
                   const void* v_q, const void* v_s, int s_bf16,
                   const void* length, void* out, void* m, void* l, int b,
                   int S, int kvh, int g, float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(kvh, b);
  decode_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, q_bf16, static_cast<const int8_t*>(k_q), k_s,
      static_cast<const int8_t*>(v_q), v_s, s_bf16,
      static_cast<const int32_t*>(length), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), S, kvh, g, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype / s_dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).  The caller
// validated shapes, dtypes, contiguity, 16-byte alignment of k_q and v_q,
// b <= 65535, 1 <= g <= 16 and S >= 1.
int decode_attention_launch(const void* q, int q_dtype, const void* k_q,
                            const void* k_s, const void* v_q, const void* v_s,
                            int s_dtype, const void* length, void* out, void* m,
                            void* l, int b, int S, int kvh, int g, int hd,
                            float scale, void* stream) {
  if (b == 0 || kvh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype < 0 || q_dtype > 1 || s_dtype < 0 || s_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return launch<16>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, b, S, kvh, g, scale, st);
    case 32:
      return launch<32>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, b, S, kvh, g, scale, st);
    case 64:
      return launch<64>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, b, S, kvh, g, scale, st);
    case 128:
      return launch<128>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, b, S, kvh, g, scale, st);
    case 256:
      return launch<256>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, b, S, kvh, g, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
