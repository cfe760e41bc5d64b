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
// Positions past S (a ragged last chunk) take no part at all.
//
// Bound.  The two products do 4 g hd flop per cached position for
// 2 hd + 4 bytes read, 29 flop a byte at g = 16: far under the bf16
// tensor-core ridge (295), so on the tensor cores the kernel is bound by
// bytes (one decode_32k layer: 2.18 GB = 0.65 ms at 3.35 TB/s).  The
// design keeps the int8 cache the only large traffic and the only cache
// data in shared memory:
//
// * Both products run on mma.sync.m16n8k16 with bf16 inputs and f32
//   accumulators.  The g <= 16 query rows fill m16 (rows past g are zero
//   and never written).  int8 converts to bf16 exactly (|x| <= 128 needs
//   8 significant bits), in registers, from 32-bit words: a prmt puts
//   two bytes in the two halves, two LOP3s build 128 + low7 and 128 or
//   256 as bf16, and one bf16x2 subtraction leaves the exact values
//   (int8x2_to_bf16).  So K and V enter the products unscaled:
//     QK^T: s[t] = (q . k_int[t]) * k_s[t] * (1/sqrt(hd)), the scale
//           applied to the f32 score after the product.  A bf16 q is one
//           bf16 term; an f32 q is 3 (hi, mid, lo), which hold it to
//           ~2^-24.  Each k step sums its terms, smallest first, into a
//           fresh fragment that is then added to the score in f32: the
//           tensor cores truncate as they accumulate, and a chain of
//           k steps in one fragment costs m about 10 ulp at decode_32k.
//     PV:   v_s[t] folded into the f32 weights, w'[r,t] = w[r,t] v_s[t],
//           split into 2 bf16 terms; l sums the unscaled f32 weights.
//   The online softmax stays in f32.
// * The reduction dimension is permuted so that every operand fragment is
//   a contiguous run of bytes in a cache row: in QK^T, lane (gid, tq) of
//   a warp takes bytes [tq hd/4, (tq + 1) hd/4) of K row gid (the same
//   permutation applied to q's fragments, prepared once in shared
//   memory); in PV, the weights' C fragments from QK^T are reused as A
//   fragments directly (positions are the k index), and a lane reads one
//   32-bit word of each of its 4 V rows and gathers byte i of each with
//   one prmt a row pair, so d = 32 grp + 4 gid + i is output column gid
//   of n-tile (grp, i).
// * K and V chunks come into shared memory by cp.async (16-byte copies,
//   the scales by 4-byte copies of the word that holds them) in a
//   kStages-deep ring.  Rows are hd bytes with their 16-byte chunks
//   XOR-swizzled by the row, so the fragment reads above and the copies
//   are free of bank conflicts at hd = 128.
//
// Grid: (kvh, b, n_split).  The block of split i takes chunks [i * per,
// (i + 1) * per) of the ceil(visit / kT) chunks that the device-side
// length needs (per = ceil(n_chunks / n_split); an empty range writes
// nothing).  Its 4 warps each own 16 positions of every 64-position
// chunk with their own (m, l, acc) in registers (the TPU grid's
// sequential S axis and its VMEM carries become this loop); at the end
// the warps merge through shared memory in a fixed order.  With
// n_split > 1 each split writes a partial (out, m, l) and
// decode_attention_merge_kernel combines them in a fixed order, split 0
// first.  Dynamic shared memory at hd = 128: 53.5 KB with a bf16 q
// (four blocks an SM), 61.5 KB with an f32 q.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kT = 64;              // cache positions per chunk
constexpr int kWarpT = kT / kWarps; // positions per warp and chunk: one m16n8k16 k step
constexpr int kG = 16;              // query rows a block holds (g <= kG): mma's m16
constexpr int kStages = 3;          // cp.async ring depth
constexpr float kMasked = -1e30f;
constexpr int kMergeThreads = 128;
static_assert(kWarpT == 16, "a warp's positions are one k step of PV");

__device__ __forceinline__ float load_f(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global into shared memory; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D += A B: m16n8k16, A row-major bf16 (4 regs), B col-major bf16 (2), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 as an exact bf16 pair: byte x0 in bits 0-7 and x1 in bits
// 16-23 of p (the other bits are ignored).  With x = low7 - 128 b7, the
// bf16 0x4300 | low7 is 128 + low7 (bf16 spaces [128, 256) by 1), and
// 0x4300 | (b7 << 7) is 128 or 256; their difference is x, exactly.
__device__ __forceinline__ uint32_t int8x2_to_bf16(uint32_t p) {
  const uint32_t y = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Four int8 in a word as two exact bf16 pairs: lo = bytes (0, 1), hi =
// bytes (2, 3), the lower byte in the lower half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = int8x2_to_bf16(__byte_perm(w, 0u, 0x4140));
  hi = int8x2_to_bf16(__byte_perm(w, 0u, 0x4342));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);  // a in the lower half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A scale from its staged word: an f32, or the bf16 half selected by bit
// 1 of the element's address.
__device__ __forceinline__ float scale_of(uint32_t w, int s_bf16, int high) {
  if (!s_bf16) return __uint_as_float(w);
  return __uint_as_float(high ? (w & 0xFFFF0000u) : (w << 16));
}

// Shared-memory layout, in bytes.  q's A fragments first ([term][k step]
// [lane] as uint4), then kStages stages of K rows, V rows and the scale
// words; the warps' merge scratch reuses the stages after the loop.
template <int HD>
struct Layout {
  static constexpr int kRow = HD;                    // bytes a cache row
  static constexpr int kChunks = HD / 16;            // 16-byte chunks a row
  static constexpr int kSwz = kChunks < 8 ? kChunks : 8;  // chunk XOR span
  static constexpr int kKSteps = HD / 16;
  static constexpr int kQTerm = kKSteps * 32 * 16;   // one term's fragments
  static constexpr int kK = 0;
  static constexpr int kV = kK + kT * kRow;
  static constexpr int kKs = kV + kT * kRow;         // [kT] k_s words
  static constexpr int kVs = kKs + kT * 4;           // [kT] v_s words
  static constexpr int kStage = kVs + kT * 4;
  static constexpr int kMerge = kWarps * (kG * HD + 3 * kG) * 4;
  static_assert(kMerge <= kStages * kStage, "merge scratch fits the stages");
  static size_t bytes(int q_terms) { return (size_t)q_terms * kQTerm + kStages * kStage; }
};

// byte offset of chunk c of row t in a stage's K or V block
template <int HD>
__device__ __forceinline__ int swz(int t, int c) {
  using L = Layout<HD>;
  return t * L::kRow + ((c ^ (t & (L::kSwz - 1))) << 4);
}

// One split of one (b, h): QT bf16 terms of q (1 for a bf16 q, 3 for f32).
template <int HD, int QT>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 4 : 2)
decode_attention_kernel(const void* __restrict__ q, const int8_t* __restrict__ k_q,
                        const void* __restrict__ k_s, const int8_t* __restrict__ v_q,
                        const void* __restrict__ v_s, int s_bf16,
                        const int32_t* __restrict__ length, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out, int b_count,
                        int S, int kvh, int g, int n_split, float scale) {
  static_assert(HD >= 16 && HD <= 256 && (HD & (HD - 1)) == 0, "head dim");
  static_assert(QT == 1 || QT == 3, "q terms");
  using L = Layout<HD>;
  constexpr int kKSteps = HD / 16;
  constexpr int kKBytes = HD / 4;                  // QK^T: bytes of a K row a lane reads
  constexpr int kKLoad = kKBytes >= 16 ? 4 : kKBytes / 4;  // words a K load brings
  constexpr int kWB = HD >= 32 ? 4 : 2;            // PV: bytes of a V row a lane reads
  constexpr int kGroupD = 8 * kWB;                 // PV: d columns of kWB n-tiles
  constexpr int kGroups = HD / kGroupD;
  constexpr int kNT = HD / 8;                      // PV: n-tiles
  static_assert(kGroups * kWB == kNT, "PV n-tiles");

  extern __shared__ uint4 smem16[];
  uint4* qf = smem16;                              // [QT][kKSteps][32] A fragments
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem16) + QT * L::kQTerm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;                       // fragment row / column group
  const int tq = lane & 3;                         // thread in the group
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int64_t bh = (int64_t)b * kvh + h;
  // this split's partial (out, m, l): [split][b][h][row]
  const int64_t sbh = ((int64_t)split * b_count + b) * kvh + h;

  // q's values for this thread's fragment entries, loaded while length
  // is read.  Entry i = 32 ks + lane (fg, fq) of k step ks holds rows fg
  // and fg + 8 at the permuted columns d = fq hd/4 + 4 ks + e: e = 0, 1
  // are A's k = 2 fq + {0, 1}, e = 2, 3 its k = 2 fq + {8, 9}.
  constexpr int kQE = (kKSteps * 32 + kThreads - 1) / kThreads;
  float qx[kQE][2][4];
#pragma unroll
  for (int k = 0; k < kQE; ++k) {
    const int i = tid + k * kThreads;
    const int fg = (i % 32) >> 2;
    const int d0 = (i % 4) * kKBytes + 4 * (i / 32);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = fg + 8 * rr;
        qx[k][rr][e] = i < kKSteps * 32 && row < g
                           ? load_f(q, (bh * g + row) * HD + d0 + e, QT == 1) : 0.f;
      }
  }

  const int len = *length;
  // length <= 0: every position is masked and every one carries weight 1
  const int visit = len <= 0 ? S : min(len, S);
  const int n_chunks = (visit + kT - 1) / kT;
  const int per = (n_chunks + n_split - 1) / n_split;
  const int c_begin = split * per;
  const int c_end = min(c_begin + per, n_chunks);
  if (c_begin >= c_end) return;  // an empty split writes nothing

  const int esize = s_bf16 ? 2 : 4;
  // bf16 scales: which half of its aligned word an element is in
  const unsigned ks_half = (unsigned)(reinterpret_cast<uintptr_t>(k_s) >> 1);
  const unsigned vs_half = (unsigned)(reinterpret_cast<uintptr_t>(v_s) >> 1);

  // chunk c's K and V rows and scale words into stage st (zeros past S)
  auto issue = [&](int c, int st) {
    uint8_t* base = stages + st * L::kStage;
    const int pos0 = c * kT;
#pragma unroll
    for (int i = tid; i < 2 * kT * L::kChunks; i += kThreads) {
      const int kv = i / (kT * L::kChunks);        // 0: K, 1: V
      const int r = i % (kT * L::kChunks);
      const int t = r / L::kChunks;
      const int ch = r % L::kChunks;
      const int pos = pos0 + t;
      const bool ok = pos < S;
      const int64_t row = ((int64_t)b * S + (ok ? pos : 0)) * kvh + h;
      cp_async16(base + (kv ? L::kV : L::kK) + swz<HD>(t, ch),
                 (kv ? v_q : k_q) + row * HD + ch * 16, ok ? 16 : 0);
    }
    static_assert(kThreads == 2 * kT, "one scale word a thread");
    {
      const int kv = tid / kT;
      const int t = tid % kT;
      const int pos = pos0 + t;
      const bool ok = pos < S;
      const int64_t row = ((int64_t)b * S + (ok ? pos : 0)) * kvh + h;
      const uintptr_t addr = (reinterpret_cast<uintptr_t>(kv ? v_s : k_s) + row * esize) &
                             ~static_cast<uintptr_t>(3);
      cp_async4(base + (kv ? L::kVs : L::kKs) + t * 4, reinterpret_cast<const void*>(addr),
                ok ? 4 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (c_begin + s < c_end) issue(c_begin + s, s);
    cp_async_commit();
  }

  // q's A fragments, QT bf16 terms, while the first chunks arrive
#pragma unroll
  for (int k = 0; k < kQE; ++k) {
    const int i = tid + k * kThreads;
    if (i >= kKSteps * 32) break;
#pragma unroll
    for (int term = 0; term < QT; ++term) {
      uint4 a;
      a.x = pack_bf16(qx[k][0][0], qx[k][0][1]);
      a.y = pack_bf16(qx[k][1][0], qx[k][1][1]);
      a.z = pack_bf16(qx[k][0][2], qx[k][0][3]);
      a.w = pack_bf16(qx[k][1][2], qx[k][1][3]);
      qf[(term * kKSteps + i / 32) * 32 + i % 32] = a;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) qx[k][rr][e] -= bf16_round(qx[k][rr][e]);
    }
  }

  // this warp's running state: rows gid (index 0) and gid + 8 (index 1)
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_r[2] = {kMasked, kMasked};
  float l_r[2] = {0.f, 0.f};
  const int t0 = warp * kWarpT;                    // the warp's rows in a chunk

  for (int c = c_begin; c < c_end; ++c) {
    const int it = c - c_begin;
    cp_async_wait<kStages - 2>();                  // chunk c has landed (this thread's part)
    __syncthreads();                               // ... everyone's; chunk c - 1 is done
    if (c + kStages - 1 < c_end) issue(c + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const uint8_t* st = stages + (it % kStages) * L::kStage;
    const uint8_t* k_sm = st + L::kK;
    const uint8_t* v_sm = st + L::kV;
    const uint32_t* ks_w = reinterpret_cast<const uint32_t*>(st + L::kKs);
    const uint32_t* vs_w = reinterpret_cast<const uint32_t*>(st + L::kVs);

    // QK^T over the warp's 16 positions: n-tile j holds positions t0 + 8 j + n
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kb = 0; kb < kKSteps; kb += kKLoad) {
      uint32_t kw[2][kKLoad];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = tq * kKBytes + 4 * kb;
        const uint8_t* p = k_sm + swz<HD>(t0 + 8 * j + gid, off >> 4) + (off & 15);
        if constexpr (kKLoad == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(p);
          kw[j][0] = v.x, kw[j][1] = v.y, kw[j][2] = v.z, kw[j][3] = v.w;
        } else if constexpr (kKLoad == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(p);
          kw[j][0] = v.x, kw[j][1] = v.y;
        } else {
          kw[j][0] = *reinterpret_cast<const uint32_t*>(p);
        }
      }
#pragma unroll
      for (int w = 0; w < kKLoad; ++w) {
        uint32_t bk[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) int8x4_to_bf16(kw[j][w], bk[j][0], bk[j][1]);
        // the tensor cores truncate as they accumulate: each k step sums
        // its terms (smallest first) into a fresh fragment, which is added
        // to the score with a rounded f32 add
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int term = QT - 1; term >= 0; --term) {
          const uint4 a4 = qf[(term * kKSteps + kb + w) * 32 + lane];
          const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(part[j], a, bk[j][0], bk[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] += part[j][i];
      }
    }

    // scores (scale after the product), mask, online softmax in f32.  The
    // lane holds positions p = 8 j + 2 tq + e of rows gid (sc[j][e]) and
    // gid + 8 (sc[j][2 + e]).
    const int pbase = c * kT + t0;
    float vsv[2][2];
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * j + 2 * tq + e;
        const int pos = pbase + p;
        const unsigned row = ((unsigned)b * S + pos) * (unsigned)kvh + (unsigned)h;
        const float ksv = scale_of(ks_w[t0 + p], s_bf16, (ks_half + row) & 1u);
        vsv[j][e] = scale_of(vs_w[t0 + p], s_bf16, (vs_half + row) & 1u);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float s = pos < len ? sc[j][2 * rr + e] * ksv * scale : kMasked;
          sc[j][2 * rr + e] = s;
          if (pos < S) mx[rr] = fmaxf(mx[rr], s);
        }
      }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      corr[rr] = __expf(m_r[rr] - m_new);
      m_r[rr] = m_new;
    }
    float lsum[2] = {0.f, 0.f};
    float wv[2][4];                                // weights times v_s
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = pbase + 8 * j + 2 * tq + e < S;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float w = in ? __expf(sc[j][2 * rr + e] - m_r[rr]) : 0.f;
          lsum[rr] += w;
          wv[j][2 * rr + e] = w * vsv[j][e];
        }
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_r[rr] = l_r[rr] * corr[rr] + lsum[rr];
    // rescale only when a row's max moved: at long lengths it rarely does
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][0] *= corr[0];
        acc[nt][1] *= corr[0];
        acc[nt][2] *= corr[1];
        acc[nt][3] *= corr[1];
      }
    }
    // the C fragments of QK^T are PV's A fragments (k = position): 2 bf16 terms
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      const int rr = i & 1;
      const float w0 = wv[j][2 * rr], w1 = wv[j][2 * rr + 1];
      a_hi[i] = pack_bf16(w0, w1);
      a_lo[i] = pack_bf16(w0 - bf16_round(w0), w1 - bf16_round(w1));
    }

    // PV: lane reads kWB bytes at d = grp kGroupD + kWB gid of rows
    // 2 tq + {0, 1, 8, 9} and transposes them: byte i is n-tile (grp, i)
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
      const int off = grp * kGroupD + kWB * gid;
      uint32_t vw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + 2 * tq + (r & 1) + (r >> 1) * 8;
        const uint8_t* p = v_sm + swz<HD>(t, off >> 4) + (off & 15);
        if constexpr (kWB == 4) vw[r] = *reinterpret_cast<const uint32_t*>(p);
        else vw[r] = *reinterpret_cast<const uint16_t*>(p);
      }
#pragma unroll
      for (int i = 0; i < kWB; ++i) {
        // byte i of rows (0, 1) and of rows (2, 3) into bits 0-7 and 16-23
        const uint32_t b0 = int8x2_to_bf16(__byte_perm(vw[0], vw[1], 0x0400 + i * 0x0101));
        const uint32_t b1 = int8x2_to_bf16(__byte_perm(vw[2], vw[3], 0x0400 + i * 0x0101));
        mma_bf16(acc[grp * kWB + i], a_hi, b0, b1);
        mma_bf16(acc[grp * kWB + i], a_lo, b0, b1);
      }
    }
  }

  // the warps' states meet in shared memory (the stages are free now)
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
  }
  float* scratch = reinterpret_cast<float*>(stages);
  float* w_out = scratch + warp * kG * HD;         // [kWarps][kG][HD]
  float* w_m = scratch + kWarps * kG * HD;         // [kWarps][kG]
  float* w_l = w_m + kWarps * kG;                  // [kWarps][kG]
  float* corr_s = w_l + kWarps * kG;               // [kWarps][kG]
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    // C column n of n-tile (grp, i) is d = grp kGroupD + kWB n + i
    const int d = (nt / kWB) * kGroupD + kWB * 2 * tq + nt % kWB;
    w_out[gid * HD + d] = acc[nt][0];
    w_out[gid * HD + d + kWB] = acc[nt][1];
    w_out[(gid + 8) * HD + d] = acc[nt][2];
    w_out[(gid + 8) * HD + d + kWB] = acc[nt][3];
  }
  if (tq == 0) {
    w_m[warp * kG + gid] = m_r[0];
    w_m[warp * kG + gid + 8] = m_r[1];
    w_l[warp * kG + gid] = l_r[0];
    w_l[warp * kG + gid + 8] = l_r[1];
  }
  __syncthreads();
  if (tid < g) {  // merge the warps in a fixed order, warp 0 first
    float mx = w_m[tid];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * kG + tid]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(w_m[w * kG + tid] - mx);
      corr_s[w * kG + tid] = cw;
      l += w_l[w * kG + tid] * cw;
    }
    m_out[sbh * g + tid] = mx;
    l_out[sbh * g + tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += scratch[w * kG * HD + i] * corr_s[w * kG + r];
    out[sbh * g * HD + i] = o;
  }
}

// Merges the splits' partials of one (b, h) in a fixed order, split 0
// first: M = max m_i, l = sum l_i exp(m_i - M), out = sum out_i exp(m_i - M).
// It recomputes from length which splits did work, as the split kernel
// decided it, so empty splits (never written) are never read.  One thread
// per float4 of the output; grid (kvh, b, ceil(g hd / 4 / kMergeThreads)).
__global__ void __launch_bounds__(kMergeThreads)
decode_attention_merge_kernel(const float* __restrict__ out_p, const float* __restrict__ m_p,
                              const float* __restrict__ l_p, const int32_t* __restrict__ length,
                              float* __restrict__ out, float* __restrict__ m_out,
                              float* __restrict__ l_out, int b_count, int S, int kvh,
                              int g, int hd, int n_split) {
  const int cols4 = hd / 4;
  const int i = blockIdx.z * kMergeThreads + threadIdx.x;
  if (i >= g * cols4) return;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t stride = (int64_t)b_count * kvh * g;  // one split's (m, l)
  const int len = *length;
  const int visit = len <= 0 ? S : min(len, S);
  const int n_chunks = (visit + kT - 1) / kT;
  const int per = (n_chunks + n_split - 1) / n_split;
  const int n_work = (n_chunks + per - 1) / per;
  const int r = i / cols4;
  const int c = (i % cols4) * 4;
  const int64_t row = ((int64_t)b * kvh + h) * g + r;
  float mx = m_p[row];
#pragma unroll 4
  for (int s = 1; s < n_work; ++s) mx = fmaxf(mx, m_p[s * stride + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_work; ++s) {
    const float corr = expf(m_p[s * stride + row] - mx);
    l += l_p[s * stride + row] * corr;
    const float4 o = *reinterpret_cast<const float4*>(out_p + (s * stride + row) * hd + c);
    acc.x += o.x * corr;
    acc.y += o.y * corr;
    acc.z += o.z * corr;
    acc.w += o.w * corr;
  }
  *reinterpret_cast<float4*>(out + row * hd + c) = acc;
  if (c == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

template <int HD, int QT>
cudaError_t launch_split(const void* q, const void* k_q, const void* k_s, const void* v_q,
                         const void* v_s, int s_bf16, const void* length, float* out,
                         float* m, float* l, int b, int S, int kvh, int g, int n_split,
                         float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes(QT);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<HD, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_attention_kernel<HD, QT><<<dim3(kvh, b, n_split), kThreads, smem, stream>>>(
      q, static_cast<const int8_t*>(k_q), k_s, static_cast<const int8_t*>(v_q), v_s, s_bf16,
      static_cast<const int32_t*>(length), out, m, l, b, S, kvh, g, n_split, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, int q_bf16, const void* k_q, const void* k_s,
                   const void* v_q, const void* v_s, int s_bf16,
                   const void* length, void* out, void* m, void* l, void* ws_out,
                   void* ws_m, void* ws_l, int b, int S, int kvh, int g,
                   int n_split, float scale, cudaStream_t stream) {
  // one split writes the result itself; more write partials to merge
  const bool merge = n_split > 1;
  float* o = static_cast<float*>(merge ? ws_out : out);
  float* mm = static_cast<float*>(merge ? ws_m : m);
  float* ll = static_cast<float*>(merge ? ws_l : l);
  cudaError_t err =
      q_bf16 ? launch_split<HD, 1>(q, k_q, k_s, v_q, v_s, s_bf16, length, o, mm, ll, b, S,
                                   kvh, g, n_split, scale, stream)
             : launch_split<HD, 3>(q, k_q, k_s, v_q, v_s, s_bf16, length, o, mm, ll, b, S,
                                   kvh, g, n_split, scale, stream);
  if (err != cudaSuccess || !merge) return err;
  const int items = g * (HD / 4);
  const dim3 grid(kvh, b, (items + kMergeThreads - 1) / kMergeThreads);
  decode_attention_merge_kernel<<<grid, kMergeThreads, 0, stream>>>(
      static_cast<const float*>(ws_out), static_cast<const float*>(ws_m),
      static_cast<const float*>(ws_l), static_cast<const int32_t*>(length),
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(l),
      b, S, kvh, g, HD, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype / s_dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launches (0 on success).  The caller
// validated shapes, dtypes, contiguity, 16-byte alignment of k_q and v_q,
// b <= 65535, 1 <= g <= 16, S >= 1 and 1 <= n_split <= ceil(S / 64), and
// for n_split > 1 allocated the f32 partials ws_out (n_split, b, kvh, g,
// hd) and ws_m, ws_l (n_split, b, kvh, g).
int decode_attention_launch(const void* q, int q_dtype, const void* k_q,
                            const void* k_s, const void* v_q, const void* v_s,
                            int s_dtype, const void* length, void* out, void* m,
                            void* l, void* ws_out, void* ws_m, void* ws_l, int b,
                            int S, int kvh, int g, int hd, int n_split, float scale,
                            void* stream) {
  if (b == 0 || kvh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype < 0 || q_dtype > 1 || s_dtype < 0 || s_dtype > 1 || n_split < 1 ||
      (n_split > 1 && (!ws_out || !ws_m || !ws_l)))
    return static_cast<int>(cudaErrorInvalidValue);
#define DA_LAUNCH(HD_)                                                             \
  case HD_:                                                                        \
    return launch<HD_>(q, q_dtype, k_q, k_s, v_q, v_s, s_dtype, length, out, m, l, \
                       ws_out, ws_m, ws_l, b, S, kvh, g, n_split, scale, st);
  switch (hd) {
    DA_LAUNCH(16)
    DA_LAUNCH(32)
    DA_LAUNCH(64)
    DA_LAUNCH(128)
    DA_LAUNCH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_LAUNCH
}

// The card's SM count, which the wrapper's split rule reads.
int decode_attention_sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return n;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
