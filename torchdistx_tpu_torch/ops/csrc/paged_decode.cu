// Ragged paged-attention decode for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torchdistx_tpu_torch/ops/paged_attention.py).
//
// Replaces the Pallas TPU kernel
// torchdistx_tpu/ops/paged_attention.py::_decode_kernel (l.134, launched
// by pallas_call at l.264).  It computes the same function, not the same
// blocks: one query token per sequence attends every cached position
// < lengths[b] of that sequence, reached through its page table; GQA query
// heads of one kv head share each K/V row; a sequence with lengths[b] == 0
// (an idle batch lane) gets a zero output row.
//
// What bounds it on the H100: memory bandwidth.  Per live cached position
// a (sequence, kv head) pair reads one K row and one V row (2*D elements)
// and does 4*G*D flops on them (G = query heads per kv head, a few), one
// to two flops per byte, far under the ~295 flops/byte where the card's
// compute would become the limit.  The least time is the live K/V bytes
// over 3.35 TB/s (llama3-8b width in bf16: 4 KB per position, 0.0127 ms
// for 10,405 live positions), and only the whole card, with enough bytes
// in flight on every SM, comes near it.  The design reads every live K/V
// byte from device memory once (for G <= 8):
//   * the positions are split: one CTA per (kv head, sequence, chunk of GC
//     query heads, split of `span` positions), so a long lane is walked
//     by many SMs, not one; the wrapper picks the split count
//     from static facts only (the page table's width and the card's SM
//     count), never from `lengths`, so the launch reads no device value on
//     the host and can be captured into a CUDA graph;
//   * each warp walks its own blocks of U consecutive positions of its
//     split: it issues all 2*U K/V row loads of a block at once, one block
//     ahead of the one it computes (each lane one vector load of its D/32
//     consecutive elements per row, kept as raw bits until the dot
//     product), dots each K row with every query
//     head of the chunk, and keeps its own online softmax (running max,
//     running sum and the [GC, D] accumulator) in f32 registers, so no
//     block-wide barrier sits in the loop; GC (the largest of 8, 4, 2, 1
//     dividing G) is a template argument, so the heads' work has no branch
//     between and its shuffles and exp2s interleave;
//   * the CTA first copies its split's page ids from page_table[b] into
//     shared memory (the TPU's scalar prefetch has no counterpart here),
//     so no row load waits on a table load, and a warp steps through
//     pages and slots without a division per position; positions past
//     lengths[b] are never read, so the tail page needs no mask beyond
//     the loop bound, and a split wholly past lengths[b] returns at once;
//   * the warps' partial states merge through shared memory, rescaled to
//     their common max.  A CTA whose split holds its whole sequence (every
//     CTA, with one split) writes its output rows; else it writes its
//     unnormalized f32 partial row, max and sum to a workspace, and
//     paged_merge_kernel, launched as a programmatic dependent so that it
//     is scheduled while the split kernel drains, weighs the splits of
//     each row by exp2(max - the row's max) and divides by the weighted
//     sums.  A split past lengths[b] is never read (it weighs 0), and an
//     idle lane writes an exact zero row: no (-inf) - (-inf) is formed.
// What bounds it now is the walk, not its bytes: f32 moves twice bf16's
// bytes in little more time.  Where every lane is shorter than a span
// and the table is wide (a serving engine's first tokens), the merge
// adds a launch and saves nothing.  Left for later work: the
// per-position work (the shuffle reductions, the rescale), cp.async/TMA
// pipelining and tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;  // largest head_dim the kernel takes
constexpr int kMergeThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// PL consecutive elements of a head_dim row as raw bits (4-byte words; a
// bf16 pair per word, low element in the low half), held from the load
// to the dot product.
template <typename T, int PL>
struct Row {
  static constexpr int kBytes = PL * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[e]);
    return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
  }
};

// Lane `lane`'s elements [lane*PL, lane*PL + PL) of a head_dim row in
// device memory: one vector load (16 bytes, or all PL elements if fewer)
// when D == 32*PL (`vec`; the pools are 16-byte aligned), else
// bounds-checked scalars with zeros past D.
template <typename T, int PL>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int lane,
                                         int D, bool vec, Row<T, PL>& r) {
  constexpr int kBytes = Row<T, PL>::kBytes;
  if (vec) {
    const T* a = p + lane * PL;
    if constexpr (kBytes == 2) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(a));
    } else if constexpr (kBytes == 4) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(a));
    } else if constexpr (kBytes == 8) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(a));
      r.w[0] = x.x;
      r.w[1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(a) + i);
        r.w[4 * i] = x.x;
        r.w[4 * i + 1] = x.y;
        r.w[4 * i + 2] = x.z;
        r.w[4 * i + 3] = x.w;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < Row<T, PL>::kWords; ++i) r.w[i] = 0u;
#pragma unroll
  for (int e = 0; e < PL; ++e) {
    const int d = lane * PL + e;
    if (d >= D) continue;
    if constexpr (sizeof(T) == 4)
      r.w[e] = __float_as_uint(p[d]);
    else
      r.w[e / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[d]))
                    << (16 * (e % 2));
  }
}

// The same lane's elements of a query row in shared memory (f32).
template <int PL>
__device__ __forceinline__ void q_row(const float* q, int lane, int D,
                                      bool vec, float (&r)[PL]) {
  if (vec && PL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PL / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(q + lane * PL)[i];
      r[4 * i] = x.x;
      r[4 * i + 1] = x.y;
      r[4 * i + 2] = x.z;
      r[4 * i + 3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < PL; ++e) {
    const int d = lane * PL + e;
    r[e] = d < D ? q[d] : 0.f;  // rows of K past D hold zeros, so q's may too
  }
}

// PL = elements of a head_dim row per lane, U = positions a warp takes
// per iteration, GC = query heads of the CTA (a divisor of G); all
// compile-time, so the per-warp state lives in registers sized to them and
// the heads' work interleaves with no branch between.  Grid (KV, B, G/GC
// head chunks x splits), split-major in z.  part_o is null for a single
// split (the CTA writes `out`); else [B*H, splits, D] partial rows and
// part_ml [B*H, splits, 2] (max, sum) that paged_merge_kernel reads.
template <typename T, int PL, int U, int GC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,           // [B, H, D]
    const T* __restrict__ k_pages,     // [P, page, KV, D]
    const T* __restrict__ v_pages,     // [P, page, KV, D]
    const int* __restrict__ lengths,   // [B]
    const int* __restrict__ table,     // [B, maxp]
    T* __restrict__ out,               // [B, H, D]
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int H, int KV, int D, int page, int maxp, int splits, int span,
    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int chunks = G / GC;
  const int split = blockIdx.z / chunks;
  const int g0 = (blockIdx.z % chunks) * GC;  // first head of this chunk
  const int len = lengths[b];
  const int start = split * span;
  const int end = min(len, start + span);  // this split's positions
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // The merge kernel may be scheduled now; it waits for this grid's writes.
  asm volatile("griddepcontrol.launch_dependents;");
  // The CTA writes the output rows itself when its split holds the whole
  // sequence (so does the merge's count of splits, ceil(len / span)).
  const bool direct = part_o == nullptr || (split == 0 && len <= span);

  // Head h = kvh * G + g of sequence b: the chunk's rows are contiguous.
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g0;
  if (start >= end) {
    // An idle lane's zero row (one split); a split past lengths[b] writes
    // nothing, since the merge never reads it.
    if (part_o == nullptr)
      for (int i = tid; i < GC * D; i += kThreads) store(out + head0 * D + i, 0.f);
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                     // [GC, D] scaled queries
  float* wm_s = q_s + GC * D;            // [kWarps, GC] per-warp max
  float* wl_s = wm_s + kWarps * GC;      // [kWarps, GC] per-warp sum
  float* wacc_s = wl_s + kWarps * GC;    // [kWarps, GC, D] per-warp acc
  int* pages_s = reinterpret_cast<int*>(wacc_s + kWarps * GC * D);

  // The queries scaled by scale * log2(e), so that scores are in base 2
  // (the softmax states and the merge use exp2), and the split's page ids
  // (its first page p0 on), so that no row load waits on a table load.
  const T* qg = q + head0 * D;
  const float qscale = scale * kLog2e;
  for (int i = tid; i < GC * D; i += kThreads) q_s[i] = to_f32(qg[i]) * qscale;
  const int p0 = start / page;
  const int* row = table + static_cast<size_t>(b) * maxp;
  for (int i = tid; i <= (end - 1) / page - p0; i += kThreads)
    pages_s[i] = row[p0 + i];
  __syncthreads();

  const bool vec = D == 32 * PL;
  const size_t slot_stride = static_cast<size_t>(KV) * D;
  const size_t page_stride = static_cast<size_t>(page) * slot_stride;
  const size_t head_off = static_cast<size_t>(kvh) * D;

  float m[GC], l[GC], acc[GC][PL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PL; ++e) acc[g][e] = 0.f;
  }

  // Warp w takes positions [start + w*U, start + w*U + U), then the same
  // block kWarps*U further on, and so on: U consecutive positions (mostly
  // one page) whose 2*U row loads are all issued together, one block
  // ahead: the next block's rows are in flight while this one computes.
  auto load_block = [&](int base, Row<T, PL>(&kd)[U], Row<T, PL>(&vd)[U]) {
    int pg = base / page - p0, sl = base % page;  // of position base + u
#pragma unroll
    for (int u = 0; u < U; ++u, ++sl) {
      while (sl >= page) {
        sl -= page;
        ++pg;
      }
      if (base + u < end) {
        const size_t off = static_cast<size_t>(pages_s[pg]) * page_stride +
                           static_cast<size_t>(sl) * slot_stride + head_off;
        load_row<T, PL>(k_pages + off, lane, D, vec, kd[u]);
        load_row<T, PL>(v_pages + off, lane, D, vec, vd[u]);
      } else {
#pragma unroll
        for (int i = 0; i < Row<T, PL>::kWords; ++i) kd[u].w[i] = vd[u].w[i] = 0u;
      }
    }
  };
  constexpr int kStep = kWarps * U;
  Row<T, PL> kr[U], vr[U], kn[U], vn[U];
  if (start + warp * U < end) load_block(start + warp * U, kr, vr);
  for (int base = start + warp * U; base < end; base += kStep) {
    if (base + kStep < end) load_block(base + kStep, kn, vn);
    // Every head's U scores, summed over the warp together, one butterfly
    // step for all of them at a time, so that their shuffles pipeline
    // instead of each waiting on the last; every lane holds each score.
    float s[GC][U];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float qr[PL];
      q_row<PL>(q_s + g * D, lane, D, vec, qr);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = 0.f;
#pragma unroll
        for (int e = 0; e < PL; ++e) s[g][u] += qr[e] * kr[u].at(e);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], o);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u < end) m_new = fmaxf(m_new, s[g][u]);
      const float c = exp2f(m[g] - m_new);  // 0 at the warp's first block
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = base + u < end ? exp2f(s[g][u] - m_new) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * c + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < PL; ++e) {
        float a = acc[g][e] * c;
#pragma unroll
        for (int u = 0; u < U; ++u) a += p[u] * vr[u].at(e);
        acc[g][e] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // Merge the warps' partial softmax states.  A warp that saw no position
  // keeps m = -inf, l = 0, acc = 0 and weighs exp2(-inf) = 0; warp 0 saw
  // the split's first position, so the common max is finite.
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      wm_s[warp * GC + g] = m[g];
      wl_s[warp * GC + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < PL; ++e) {
      const int d = lane * PL + e;
      if (d < D) wacc_s[(warp * GC + g) * D + d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < GC * D; i += kThreads) {
    const int g = i / D;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm_s[w * GC + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm_s[w * GC + g] - mx);
      den += wl_s[w * GC + g] * f;
      num += wacc_s[w * GC * D + i] * f;
    }
    if (direct) {
      store(out + head0 * D + i, num / fmaxf(den, 1e-30f));
      continue;
    }
    const size_t slot = (head0 + g) * splits + split;
    part_o[slot * D + i % D] = num;
    if (i % D == 0) {
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = den;
    }
  }
}

// One CTA per output row (b*H + h): the splits that hold positions of
// its sequence (the first ceil(lengths[b] / span)) weighed by exp2(max -
// their max) (maxima of base-2 scores); an idle lane's row is zeros, and
// a row that one split holds whole was written by that split.  Launched
// as the split kernel's programmatic dependent, so it is scheduled while
// the split kernel drains and waits for its writes.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) paged_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int D,
    int splits, int span) {
  const size_t row = blockIdx.x;
  const int len = lengths[row / H];
  const int n = len <= 0 ? 0 : min(splits, (len + span - 1) / span);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n == 1) return;
  const float* ml = part_ml + row * splits * 2;
  const float* po = part_o + row * splits * D;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[2 * s]);
  float den = 0.f;
  for (int s = 0; s < n; ++s) den += exp2f(ml[2 * s] - mx) * ml[2 * s + 1];
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float num = 0.f;
    for (int s = 0; s < n; ++s) num += exp2f(ml[2 * s] - mx) * po[s * D + d];
    store(out + row * D + d, n > 0 ? num / den : 0.f);
  }
}

template <typename T, int PL, int U, int GC>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const int* lengths, const int* table, void* out, float* part,
             int B, int H, int KV, int D, int page, int maxp, int splits,
             int span, float scale, cudaStream_t stream, int* merged) {
  // The page ids of one split: at most ceil(span / page) + 1.
  const int n_pages = span / page + 2 < maxp ? span / page + 2 : maxp;
  const size_t smem = static_cast<size_t>(GC * D + 2 * kWarps * GC +
                                          kWarps * GC * D + n_pages) *
                      sizeof(float);
  auto* kernel = paged_decode_kernel<T, PL, U, GC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  float* part_o = splits > 1 ? part : nullptr;
  float* part_ml =
      splits > 1 ? part + static_cast<size_t>(B) * H * splits * D : nullptr;
  const dim3 grid(KV, B, (H / KV / GC) * splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), lengths, table, static_cast<T*>(out),
      part_o, part_ml, H, KV, D, page, maxp, splits, span, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t m = cudaLaunchKernelEx(
      &cfg, paged_merge_kernel<T>, static_cast<const float*>(part_o),
      static_cast<const float*>(part_ml), lengths, static_cast<T*>(out), H, D,
      splits, span);
  if (m == cudaSuccess) *merged = 1;
  return static_cast<int>(m);
}

// Heads a CTA takes: the largest of 8, 4, 2, 1 that divides G.
int head_chunk(int G) { return G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1; }

template <typename T, int PL, int U>
int launch_g(const void* q, const void* k_pages, const void* v_pages,
             const int* lengths, const int* table, void* out, float* part,
             int B, int H, int KV, int D, int page, int maxp, int splits,
             int span, float scale, cudaStream_t stream, int* merged) {
#define TDX_LAUNCH(GC)                                                        \
  return launch_d<T, PL, U, GC>(q, k_pages, v_pages, lengths, table, out,     \
                                part, B, H, KV, D, page, maxp, splits, span,  \
                                scale, stream, merged)
  switch (head_chunk(H / KV)) {
    case 8: TDX_LAUNCH(8);
    case 4: TDX_LAUNCH(4);
    case 2: TDX_LAUNCH(2);
    default: TDX_LAUNCH(1);
  }
#undef TDX_LAUNCH
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* lengths, const int* table, void* out, float* part,
           int B, int H, int KV, int D, int page, int maxp, int splits,
           int span, float scale, cudaStream_t stream, int* merged) {
#define TDX_LAUNCH(PL, U)                                                    \
  return launch_g<T, PL, U>(q, k_pages, v_pages, lengths, table, out, part,  \
                            B, H, KV, D, page, maxp, splits, span, scale,    \
                            stream, merged)
  if (D <= 32) TDX_LAUNCH(1, 4);
  if (D <= 64) TDX_LAUNCH(2, 4);
  if (D <= 128) TDX_LAUNCH(4, 4);
  TDX_LAUNCH(8, 2);
#undef TDX_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The positions are cut into `splits`
// ranges of `span` (splits * span >= maxp * page); with more than one,
// `part` is an f32 workspace of B*H*splits*(D + 2) floats and a second
// kernel merges the splits; *merged is set to 1 where that merge kernel
// is launched, else 0.  Returns the cudaError_t of the launches (0 on
// success); the caller raises on anything else.
int tdx_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const int* lengths, const int* table, void* out,
                     float* part, int B, int H, int KV, int D, int page,
                     int maxp, int splits, int span, int dtype, float scale,
                     void* stream, int* merged) {
  *merged = 0;
  if (B <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > kMaxD || page <= 0 ||
      maxp <= 0 || splits <= 0 || span <= 0 ||
      static_cast<long long>(splits) * span <
          static_cast<long long>(maxp) * page ||
      (splits > 1 && part == nullptr) ||
      static_cast<long long>(H / KV / head_chunk(H / KV)) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, lengths, table, out, part, B, H,
                         KV, D, page, maxp, splits, span, scale, s, merged);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, lengths, table, out,
                                 part, B, H, KV, D, page, maxp, splits, span,
                                 scale, s, merged);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tdx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
