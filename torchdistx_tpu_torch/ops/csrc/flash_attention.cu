// Flash attention forward and backward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torchdistx_tpu_torch/ops/flash_attention.py).
//
// Replaces four Pallas TPU kernels of torchdistx_tpu/ops/flash_attention.py:
//   * _fwd_kernel (l.91, launched by _fwd_call l.446)     -> flash_fwd_bf16_kernel,
//                                                           flash_fwd_kernel (f32)
//   * _bwd_dq_kernel (l.206, via _bwd_call l.499)         -> flash_dq_bf16_kernel,
//                                                           flash_dq_kernel (f32)
//   * _bwd_dkv_kernel (l.257, via _bwd_call l.591)        -> flash_dkv_bf16_kernel,
//                                                           flash_dkv_f32_kernel
//   * _dbias_kernel (l.318, via _dbias_call l.619)        -> flash_dbias_bf16_kernel,
//                                                           flash_dbias_kernel (f32)
// It computes the same functions, not the same blocks.  Layout [B*H, S, D]
// for q/o/do/dq, [B*KV, T, D] for k/v/dk/dv, lse and delta [B*H, S] f32.
// Query head row bh reads kv row bh / G (G = H / KV).  Key j is visible to
// query i iff j < T, j <= i + T - S when causal (the last query aligned with
// the last key), and, with segment ids, qseg[b, i] == kseg[b, j].  A row
// that sees no key gets a zero output, lse = -1e30 and zero gradients, as
// in the TPU kernel.  On request the forward also writes O in f32 before
// its rounding to q's dtype: the backward's delta = rowsum(dO * O) is
// taken from it (ops/flash_attention.py says why).
//
// The additive bias is f32 [Hb, S, T] whatever q's dtype, Hb = H or 1:
// the score of row bh is s = (q k^T) * scale + bias[(bh % H) % Hb, i, j],
// added before the mask in the one elementwise pass each kernel has.  The
// f32 kernels read it straight from device memory there (lanes walk
// consecutive j, so the reads coalesce; every read is checked against i <
// S and j < T); the bf16 forward, dq and dk/dv kernels bring each bias
// tile into shared memory one step ahead, and bf16 d(bias) holds its tile
// in registers (below).  d(bias) = sum over the rows of one bias plane of
// p * (dp - delta): one CTA per (bias plane, q tile, k tile) walks those
// rows (the B batch items, or all B*H rows when Hb = 1), recomputing S =
// Q K^T and dP = dO V^T, and writes its tile once, from registers, with
// no atomics; tiles wholly past the causal diagonal are written as zeros.
//
// What bounds it on the H100.  Without a bias: operations.  At the
// training shapes (S = T = 1024..2048, D = 64..128) attention does ~S*D/2
// flops per byte of q/k/v/o, far above the ~295 flops/byte where bf16
// tensor cores stop waiting for memory; the least time is the
// causal-halved matmul flops over 989 TFLOP/s (bf16) or 67 TFLOP/s (f32,
// CUDA cores, no TF32).  With a bias, at T5's encoder shape (B 8, H 128,
// S = T = 512, D 128, bf16) the f32 [H, S, T] plane (134 MB) and q, k, v,
// o move 0.67 GB, 0.20 ms at 3.35 TB/s, against 0.14 ms of bf16 matmul:
// bytes bound the forward, dq and dk/dv kernels there.  They read the
// plane once per (batch, head) row, B*H*S*T*4 = 1.07 GB (0.32 ms), unless
// L2 serves the re-reads of the other batch items.  The d(bias) kernel
// reads q, k, v, do and the bias once and writes d(bias) once (0.81 GB in
// bf16, 0.24 ms) but recomputes two products per row (137 GFLOP: 0.14 ms
// in bf16, 2.05 ms in f32): bytes bound it in bf16, operations in f32.
// Its bf16 kernel (below) moves more than that through L2: each CTA reads
// its rows' Q and dO tiles and K and V tiles, 12 bytes per (query, key)
// pair of each row at D = 128 (3.2 GB at T5's encoder shape), which the
// plane-major grid keeps in L2 but which still fill shared memory, and
// its products read every operand again from there through ldmatrix.
//
// The f32 kernels are first, simple kernels:
//   * no [S, T] matrix ever reaches device memory: each CTA keeps its
//     q (or k) tile in shared memory, streams the other side's tiles
//     through shared memory and carries the online softmax (forward) or
//     the dq (dk, dv, d(bias)) sums in shared memory or registers in f32;
//   * tiles wholly past the causal diagonal are never loaded;
//   * products stay IEEE f32 (FMA on the CUDA cores, no TF32);
//   * the dk/dv kernel walks every (group head, q tile) of its kv head
//     inside the CTA and writes dk and dv once: no atomics, no GQA
//     broadcast of K/V and no reduction over the group afterwards;
//   * each kernel carves only the shared-memory tiles it uses.
// Staging every product through shared memory (scores, probabilities and
// accumulators all live there) makes them shared-memory-bandwidth bound
// well below the CUDA cores' rate.
//
// The bf16 kernels are built around registers instead.  Built like the
// f32 kernels, they were bound not by the
// tensor cores but by everything around them: f32 accumulators (O, dQ,
// dK, dV) in shared memory, each product reading C from there, adding one
// k step of 64 and writing it back; S and dP staged as f32 tiles and P
// and dS as bf16 tiles, the online softmax one warp per row over a shared
// tile with its m, l and correction in shared vectors; operand fragments
// gathered by scalar 16-bit loads where k is not contiguous (P V, dS K,
// P^T dO, dS^T Q); the next tile loaded after a barrier with nothing in
// flight; and the bias a dependent device load in the elementwise pass.
// At llama3-8b width the forward ran at 5 % and dq at 4 % of the
// operations bound; d(bias), built so too, read its bias tile once per
// row and ran its CTAs plane after plane, so a plane's tiles were out of
// L2 before its next CTA came.  These kernels:
//   * a warp owns 16 rows of the side the CTA walks against (queries in
//     the forward and dq, keys in dk/dv) and keeps their accumulators in
//     mma.sync fragments for the whole walk: O or dQ (64 f32 registers a
//     thread at D = 128), dK and dV (128); each is written once, to bf16;
//   * the scores (S, and dP in the backward) are computed into registers,
//     p and ds formed in those fragments, the mask applied only on tiles
//     that cross the diagonal or a ragged edge (or with segments), and
//     the two bf16 parts of p and of ds (hi + lo, ~2^-17 relative)
//     packed straight into the A operands of the next products (a C
//     fragment of m16n8k16 is half an A fragment); dk/dv computes S^T =
//     K Q^T so that its keys are the fragments' rows;
//   * the forward's online softmax runs in the fragments: a thread holds
//     two rows, a row's max is reduced over the 4 lanes of a quad, and
//     each thread keeps its share of l (the exact sum of p, for lse) and
//     of lp (the sum of the bf16 parts hi + lo of p, which O is divided
//     by: O stays a convex combination of the values it multiplied, so
//     the component they share passes through exactly and cancels from
//     dP - delta);
//   * p is split into hi + lo for P V and P^T dO as ds is: the reference
//     computes both products in f32, and p rounded once to bf16 (2^-9 of
//     its size) was the largest bf16 error left in the gradients, 3.9e-2
//     normwise on a T5-11B-width decoder's key projection;
//   * dS is split into hi + lo for dS K and dS^T Q: each row of dS sums
//     to zero in exact arithmetic, which cancels the component shared by
//     all keys from dq and by all positions' inputs from the key
//     projection's gradient; dS rounded once breaks those sums by 2^-9 of
//     its size, and that leaked 16 % (normwise) into a T5 decoder's
//     key-projection gradient at T5-11B width;
//   * every operand comes from shared memory through ldmatrix, with
//     .trans where k is not contiguous in memory (V and K as the B of
//     P V and dS K; Q and dO as the B of dK and dV); rows padded by 16
//     bytes keep both forms free of bank conflicts;
//   * a ring of two stages, filled by cp.async, holds one step each: the
//     forward and dq hold the k tile's K, V, key segment ids and bias
//     tile [BQ, 64] f32; dk/dv one (group head, q tile)'s Q, dO, lse,
//     delta, query segment ids and bias tile [BQ, 64].  Step n + 1 is
//     issued before step n computes, so the bias is read ahead of the
//     elementwise pass, from shared memory;
//   * two CTAs of 4 warps share an SM (8 warps), except for the forward
//     and dq at D = 128 with a bias, whose bias tiles leave room for one
//     4-warp CTA: there one CTA of 8 warps (128 rows) takes the SM;
//   * d(bias) (flash_dbias_bf16_kernel): a CTA of 8 warps owns a 64 x 128
//     tile of one bias plane, each warp 16 rows x 64 keys, and holds their
//     sum of p * (dp - delta) and their bias (read once per CTA, not once
//     per row) in C-fragment registers over the walk of the plane's rows;
//     S = Q K^T and dP = dO V^T come by ldmatrix (no .trans: all four are
//     contiguous in D); its ring of two stages holds one row each (Q, dO,
//     K, V, lse, delta and segment ids, 105,728 B at D = 128), so one CTA
//     takes the SM; the plane is the slowest grid dimension, so a plane's
//     32 CTAs at T5's shape run together and L2 serves their re-reads.
// The next steps for them are wgmma (64-row warpgroup products from
// shared memory), TMA loads and warp specialisation; for d(bias), a
// larger tile per CTA too, which cuts its L2 and shared-memory traffic
// per pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // the TPU kernel's masked logit

// Tile sizes of the f32 kernels, which stage every product through
// shared memory (the bf16 kernels have their own, in Dkv, Fq and Db
// below).
struct Tiles {
  static constexpr int kFwdQ = 64, kFwdK = 64;
  static constexpr int kDqQ = 64, kDqK = 64;
  static constexpr int kDbQ = 64, kDbK = 64;
  static constexpr int kDbBlocks = 1;  // CTAs per SM of the f32 d(bias)
};
// Row padding of an f32 tile: 16 bytes, which keeps rows 16-byte aligned
// and moves consecutive rows to other banks.
constexpr int kPadF = 4;
// The f32 dk/dv kernel walks q in tiles of 32 rows to stay under 227 KB.
constexpr int kDkvQ32 = 32, kDkvK32 = 64;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// shared-memory layout
// ---------------------------------------------------------------------------

// Bump allocator over the dynamic shared memory, 16-byte aligned pieces.
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~static_cast<size_t>(15);
    return at;
  }
};

// Tiles of one f32 kernel: `rows_a` rows of the side the CTA owns,
// `rows_b` rows of the side it streams; `n_s` [q rows, k cols] tiles
// (the probabilities and dS overwrite them in place) and `n_acc`
// accumulators, only as many as the kernel uses (shared memory decides
// how many CTAs share an SM).  Byte offsets, computed identically on the
// host (for the launch's shared-memory size) and on the device.
struct Layout {
  int ldt, lds, ldo;      // row strides: operand tiles, scores, accumulators
  size_t a0, a1, b0, b1;  // operand tiles: two of the owned side, two streamed
  size_t s0, s1;          // [q rows, k cols] tiles (scores, dP; n_s)
  size_t acc0, acc1;      // [owned rows, D] accumulators (n_acc of them)
  size_t r0, r1, r2;      // per-q-row vectors
  size_t qseg, kseg;      // int per-row segment ids
  size_t bytes;

  __host__ __device__ Layout(int D, int rows_a, int rows_b, int bq, int bk,
                             int n_a, int n_s, int n_acc) {
    ldt = D + kPadF;
    lds = bk + kPadF;
    ldo = D + kPadF;
    Carve c;
    const size_t ta = static_cast<size_t>(rows_a) * ldt * sizeof(float);
    const size_t tb = static_cast<size_t>(rows_b) * ldt * sizeof(float);
    a0 = c.take(ta);
    a1 = n_a > 1 ? c.take(ta) : a0;
    b0 = c.take(tb);
    b1 = c.take(tb);
    const size_t sf = static_cast<size_t>(bq) * lds * sizeof(float);
    s0 = c.take(sf);
    s1 = n_s > 1 ? c.take(sf) : s0;
    const size_t af = static_cast<size_t>(rows_a) * ldo * sizeof(float);
    acc0 = n_acc > 0 ? c.take(af) : 0;
    acc1 = n_acc > 1 ? c.take(af) : acc0;
    r0 = c.take(bq * sizeof(float));
    r1 = c.take(bq * sizeof(float));
    r2 = c.take(bq * sizeof(float));
    qseg = c.take(bq * sizeof(int));
    kseg = c.take(bk * sizeof(int));
    bytes = c.off;
  }
};

// f32 forward: owns q (one tile: q), streams k and v; S (P overwrites
// it); O; m, l, corr.
__host__ __device__ inline Layout fwd_layout(int D) {
  return Layout(D, Tiles::kFwdQ, Tiles::kFwdK, Tiles::kFwdQ, Tiles::kFwdK, 1,
                1, 1);
}
// f32 dq: owns q and do, streams k and v; S, dP (dS overwrites them); dQ;
// lse, delta.
__host__ __device__ inline Layout dq_layout(int D) {
  return Layout(D, Tiles::kDqQ, Tiles::kDqK, Tiles::kDqQ, Tiles::kDqK, 2, 2,
                1);
}
// f32 dk/dv: owns k and v, streams q and do; S, dP (P and dS overwrite
// them); dK, dV; lse, delta.
__host__ __device__ inline Layout dkv_layout_f32(int D) {
  return Layout(D, kDkvK32, kDkvQ32, kDkvQ32, kDkvK32, 2, 2, 2);
}

// f32 d(bias): owns q and do, streams k and v; S, dP; no accumulator tile
// (the [bq, bk] sum lives in registers); lse, delta.
__host__ __device__ inline Layout dbias_layout(int D) {
  return Layout(D, Tiles::kDbQ, Tiles::kDbK, Tiles::kDbQ, Tiles::kDbK, 2, 2,
                0);
}

// rows [row0, row0 + rows) of a [total, D] matrix into a tile of stride
// ld, rows past `total` as zeros; 16-byte vectors (D * 4 bytes is a
// multiple of 16 for every supported D).
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                          int row0, int total, int rows, int D) {
  constexpr int V = 4;
  const int vpr = D / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * V;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total)
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

__device__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                          int total, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    dst[r] = row0 + r < total ? src[row0 + r] : 0.f;
}

__device__ void load_seg(int* dst, const int* __restrict__ seg, int row0,
                         int total, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    dst[r] = (seg != nullptr && row0 + r < total) ? seg[row0 + r] : 0;
}

__device__ void zero_f32(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.f;
}

// ---------------------------------------------------------------------------
// block matrix products: C[M, N] = (acc ? rowscale * C : 0) + A[M, K] B[K, N]
// ---------------------------------------------------------------------------
// A(m, k) is A[m*lda + k] when A_K (k contiguous), else A[k*lda + m];
// B(k, n) is B[n*ldb + k] when B_K, else B[k*ldb + n].  C is f32, stride
// ldc; each element is owned by one thread, so no barrier is needed inside.
// M, N, K are multiples of 4.

// CUDA cores, IEEE f32 FMA: each thread takes 4x4 output elements in
// turn, rows m + i*M/4 and columns n + j*N/4, so neighbouring threads read
// neighbouring columns.
template <bool A_K, bool B_K>
__device__ void gemm(const float* A, int lda, const float* B, int ldb,
                     float* C, int ldc, int M, int N, int K, bool acc,
                     const float* rowscale) {
  const int a_m = A_K ? lda : 1, a_k = A_K ? 1 : lda;
  const int b_n = B_K ? ldb : 1, b_k = B_K ? 1 : ldb;
  const int sm = M / 4, sn = N / 4;  // strides between a thread's rows, columns
  for (int tile = threadIdx.x; tile < sm * sn; tile += kThreads) {
    const int m0 = tile / sn;
    const int n0 = tile % sn;
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
    const float* ap = A + m0 * a_m;
    const float* bp = B + n0 * b_n;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ap[i * sm * a_m + k * a_k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bp[j * sn * b_n + k * b_k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i * sm;
      const float s = acc ? (rowscale ? rowscale[m] : 1.f) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* out = C + m * ldc + n0 + j * sn;
        *out = (acc ? *out * s : 0.f) + c[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* bias;  // [Hb, S, T] f32 or null
  const int* qseg;    // [B, S] or null
  const int* kseg;    // [B, T] or null
  void* out;          // o (fwd), dq (dq kernel), dk (dkv kernel), dbias
  void* out2;         // dv (dkv kernel)
  float* lse;         // [B*H, S] (fwd)
  float* o32;         // [B*H, S, D] f32 copy of o (fwd), or null
  int B, H, KV, Hb, S, T, D, causal;
  int warps;  // requested W of the bf16 forward / dq; 0: the default rule
  float scale;
};

// Is key kpos visible to query qpos?  (Rows past S are padding: nothing.)
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos,
                                        int qs, int ks) {
  return qpos < p.S && kpos < p.T && (!p.causal || kpos <= qpos + p.T - p.S) &&
         (p.qseg == nullptr || qs == ks);
}

// The bias plane of query row bh: head bh % H of its batch item, or the
// one plane of a head-broadcast bias; null without a bias.
__device__ __forceinline__ const float* bias_plane(const Params& p, int bh) {
  if (p.bias == nullptr) return nullptr;
  const int hb = p.Hb == 1 ? 0 : bh % p.H;
  return p.bias + static_cast<size_t>(hb) * p.S * p.T;
}

// The scaled score s plus the bias at (qpos, kpos); callers read it only
// for a visible pair, so qpos < S and kpos < T.
__device__ __forceinline__ float biased(const Params& p, const float* plane,
                                        float s, int qpos, int kpos) {
  return plane == nullptr
             ? s
             : s + plane[static_cast<size_t>(qpos) * p.T + kpos];
}

// Number of k tiles a q tile starting at q0 needs: all of them, or up to
// the causal diagonal (the TPU kernel's _block_needed).
__device__ __forceinline__ int k_tiles_needed(const Params& p, int q0, int bq,
                                              int bk) {
  const int nk = (p.T + bk - 1) / bk;
  if (!p.causal) return nk;
  const int last = q0 + bq - 1 + p.T - p.S;  // last key any row may see
  return last < 0 ? 0 : min(nk, last / bk + 1);
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using T = float;
  constexpr int BQ = Tiles::kFwdQ, BK = Tiles::kFwdK;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = fwd_layout(p.D);
  T* qs = reinterpret_cast<T*>(smem + L.a0);
  T* ks = reinterpret_cast<T*>(smem + L.b0);
  T* vs = reinterpret_cast<T*>(smem + L.b1);
  float* ss = reinterpret_cast<float*>(smem + L.s0);
  float* ps = ss;  // P overwrites S in place
  float* os = reinterpret_cast<float*>(smem + L.acc0);
  float* m_s = reinterpret_cast<float*>(smem + L.r0);
  float* l_s = reinterpret_cast<float*>(smem + L.r1);
  float* c_s = reinterpret_cast<float*>(smem + L.r2);
  int* qseg_s = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L.kseg);

  const int D = p.D;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int b = bh / p.H;
  const int kvh = bh / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.S * D;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(kvh) * p.T * D;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(kvh) * p.T * D;
  const float* bplane = bias_plane(p, bh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(qs, L.ldt, q, q0, p.S, BQ, D);
  load_seg(qseg_s, p.qseg ? p.qseg + static_cast<size_t>(b) * p.S : nullptr,
           q0, p.S, BQ);
  zero_f32(os, BQ * L.ldo);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  const int nk = k_tiles_needed(p, q0, BQ, BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, L.ldt, k, k0, p.T, BK, D);
    load_tile(vs, L.ldt, v, k0, p.T, BK, D);
    load_seg(kseg_s, p.kseg ? p.kseg + static_cast<size_t>(b) * p.T : nullptr,
             k0, p.T, BK);
    __syncthreads();
    gemm<true, true>(qs, L.ldt, ks, L.ldt, ss, L.lds, BQ, BK, D, false, nullptr);
    __syncthreads();
    // Online softmax, one warp per row, BK / 32 columns per lane.
    for (int r = warp; r < BQ; r += kWarps) {
      float s[BK / 32];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int j = lane + 32 * c;
        s[c] = visible(p, q0 + r, k0 + j, qseg_s[r], kseg_s[j])
                   ? biased(p, bplane, ss[r * L.lds + j] * p.scale, q0 + r,
                            k0 + j)
                   : kNeg;
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int j = lane + 32 * c;
        const float pr = visible(p, q0 + r, k0 + j, qseg_s[r], kseg_s[j])
                             ? expf(s[c] - m_new)
                             : 0.f;
        ps[r * L.lds + j] = pr;
        psum += pr;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    gemm<true, false>(ps, L.lds, vs, L.ldt, os, L.ldo, BQ, D, BK, true, c_s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < p.S) {
      const size_t at = static_cast<size_t>(bh) * p.S * D +
                        static_cast<size_t>(q0 + r) * D + d;
      const float val = os[r * L.ldo + d] / fmaxf(l_s[r], 1e-30f);
      static_cast<T*>(p.out)[at] = val;
      if (p.o32 != nullptr) p.o32[at] = val;
    }
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads)
    if (q0 + r < p.S)
      p.lse[static_cast<size_t>(bh) * p.S + q0 + r] =
          m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// p = exp(s*scale [+ bias] - lse) where visible, else 0;
// ds = p*(dp - delta)*scale (the TPU kernel's _block_p_ds), for a [bq, bk]
// tile of query row with bias plane `bplane` (or null), for the f32
// kernels.
template <int BQ, int BK>
__device__ void block_p_ds(const Params& p, const float* bplane, int q0,
                           int k0, const float* ss, const float* dps,
                           float* ps, float* dss, int lds,
                           const float* lse_s, const float* delta_s,
                           const int* qseg_s, const int* kseg_s) {
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK, j = i % BK;
    const float s = ss[r * lds + j];
    const float dp = dps[r * lds + j];
    const float pr =
        visible(p, q0 + r, k0 + j, qseg_s[r], kseg_s[j])
            ? expf(biased(p, bplane, s * p.scale, q0 + r, k0 + j) - lse_s[r])
            : 0.f;
    if (ps != nullptr) ps[r * lds + j] = pr;
    dss[r * lds + j] = pr * (dp - delta_s[r]) * p.scale;
  }
}

__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  using T = float;
  constexpr int BQ = Tiles::kDqQ, BK = Tiles::kDqK;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = dq_layout(p.D);
  T* qs = reinterpret_cast<T*>(smem + L.a0);
  T* dos = reinterpret_cast<T*>(smem + L.a1);
  T* ks = reinterpret_cast<T*>(smem + L.b0);
  T* vs = reinterpret_cast<T*>(smem + L.b1);
  float* ss = reinterpret_cast<float*>(smem + L.s0);
  float* dps = reinterpret_cast<float*>(smem + L.s1);
  float* dss = ss;  // dS overwrites S in place
  float* dqs = reinterpret_cast<float*>(smem + L.acc0);
  float* lse_s = reinterpret_cast<float*>(smem + L.r0);
  float* delta_s = reinterpret_cast<float*>(smem + L.r1);
  int* qseg_s = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L.kseg);

  const int D = p.D;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H;
  const int kvh = bh / (p.H / p.KV);
  const size_t qoff = static_cast<size_t>(bh) * p.S * D;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(kvh) * p.T * D;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(kvh) * p.T * D;
  const float* bplane = bias_plane(p, bh);

  load_tile(qs, L.ldt, static_cast<const T*>(p.q) + qoff, q0, p.S, BQ, D);
  load_tile(dos, L.ldt, static_cast<const T*>(p.dout) + qoff, q0, p.S, BQ, D);
  load_rows(lse_s, p.lse_in + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
  load_rows(delta_s, p.delta + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
  load_seg(qseg_s, p.qseg ? p.qseg + static_cast<size_t>(b) * p.S : nullptr,
           q0, p.S, BQ);
  zero_f32(dqs, BQ * L.ldo);
  const int nk = k_tiles_needed(p, q0, BQ, BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(ks, L.ldt, k, k0, p.T, BK, D);
    load_tile(vs, L.ldt, v, k0, p.T, BK, D);
    load_seg(kseg_s, p.kseg ? p.kseg + static_cast<size_t>(b) * p.T : nullptr,
             k0, p.T, BK);
    __syncthreads();
    gemm<true, true>(qs, L.ldt, ks, L.ldt, ss, L.lds, BQ, BK, D, false, nullptr);
    gemm<true, true>(dos, L.ldt, vs, L.ldt, dps, L.lds, BQ, BK, D, false, nullptr);
    __syncthreads();
    block_p_ds<BQ, BK>(p, bplane, q0, k0, ss, dps, nullptr, dss, L.lds, lse_s,
                       delta_s, qseg_s, kseg_s);
    __syncthreads();
    gemm<true, false>(dss, L.lds, ks, L.ldt, dqs, L.ldo, BQ, D, BK, true, nullptr);
  }
  __syncthreads();
  T* dq = static_cast<T*>(p.out) + qoff;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < p.S)
      dq[static_cast<size_t>(q0 + r) * D + d] = dqs[r * L.ldo + d];
  }
}

// f32 dk/dv (IEEE FMA on the CUDA cores), every product staged through
// shared memory; the bf16 kernel is flash_dkv_bf16_kernel below.
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(Params p) {
  using T = float;
  constexpr int BQ = kDkvQ32, BK = kDkvK32;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = dkv_layout_f32(p.D);
  T* ks = reinterpret_cast<T*>(smem + L.a0);
  T* vs = reinterpret_cast<T*>(smem + L.a1);
  T* qs = reinterpret_cast<T*>(smem + L.b0);
  T* dos = reinterpret_cast<T*>(smem + L.b1);
  float* ss = reinterpret_cast<float*>(smem + L.s0);
  float* dps = reinterpret_cast<float*>(smem + L.s1);
  float* ps = ss;    // P overwrites S in place
  float* dss = dps;  // and dS dP
  float* dks = reinterpret_cast<float*>(smem + L.acc0);
  float* dvs = reinterpret_cast<float*>(smem + L.acc1);
  float* lse_s = reinterpret_cast<float*>(smem + L.r0);
  float* delta_s = reinterpret_cast<float*>(smem + L.r1);
  int* qseg_s = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L.kseg);

  const int D = p.D;
  const int G = p.H / p.KV;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = bkv / p.KV;
  const size_t koff = static_cast<size_t>(bkv) * p.T * D;

  load_tile(ks, L.ldt, static_cast<const T*>(p.k) + koff, k0, p.T, BK, D);
  load_tile(vs, L.ldt, static_cast<const T*>(p.v) + koff, k0, p.T, BK, D);
  load_seg(kseg_s, p.kseg ? p.kseg + static_cast<size_t>(b) * p.T : nullptr,
           k0, p.T, BK);
  zero_f32(dks, BK * L.ldo);
  zero_f32(dvs, BK * L.ldo);
  const int nq = (p.S + BQ - 1) / BQ;
  // First q tile with a row that may see key k0 (causal): the row i with
  // k0 <= i + T - S, i.e. i >= k0 - (T - S).
  int qt0 = 0;
  if (p.causal) {
    const int first_row = k0 - (p.T - p.S);
    qt0 = first_row <= 0 ? 0 : first_row / BQ;
  }
  for (int g = 0; g < G; ++g) {
    const int bh = bkv * G + g;  // query head (b, kv*G + g)
    const size_t qoff = static_cast<size_t>(bh) * p.S * D;
    const float* bplane = bias_plane(p, bh);  // that query head's plane
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile(qs, L.ldt, static_cast<const T*>(p.q) + qoff, q0, p.S, BQ, D);
      load_tile(dos, L.ldt, static_cast<const T*>(p.dout) + qoff, q0, p.S, BQ, D);
      load_rows(lse_s, p.lse_in + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
      load_rows(delta_s, p.delta + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
      load_seg(qseg_s, p.qseg ? p.qseg + static_cast<size_t>(b) * p.S : nullptr,
               q0, p.S, BQ);
      __syncthreads();
      gemm<true, true>(qs, L.ldt, ks, L.ldt, ss, L.lds, BQ, BK, D, false, nullptr);
      gemm<true, true>(dos, L.ldt, vs, L.ldt, dps, L.lds, BQ, BK, D, false, nullptr);
      __syncthreads();
      block_p_ds<BQ, BK>(p, bplane, q0, k0, ss, dps, ps, dss, L.lds, lse_s,
                         delta_s, qseg_s, kseg_s);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: A(m = key, k = query row) = P[k][m].
      gemm<false, false>(ps, L.lds, dos, L.ldt, dvs, L.ldo, BK, D, BQ, true, nullptr);
      gemm<false, false>(dss, L.lds, qs, L.ldt, dks, L.ldo, BK, D, BQ, true, nullptr);
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(p.out) + koff;
  T* dv = static_cast<T*>(p.out2) + koff;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (k0 + r < p.T) {
      dk[static_cast<size_t>(k0 + r) * D + d] = dks[r * L.ldo + d];
      dv[static_cast<size_t>(k0 + r) * D + d] = dvs[r * L.ldo + d];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: register accumulators, ldmatrix operands, a cp.async ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes from device to shared memory, asynchronously; when
// `full` is false nothing is read (src need only be a valid address) and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// row addresses of matrix i; lane 4r + c receives row r, columns 2c and
// 2c + 1 of each (with TRANS: column r, rows 2c and 2c + 1).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(ptr)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(ptr)));
}

// C += A B on the tensor cores.  Fragment layouts of mma.m16n8k16 (PTX
// ISA): lane = 4*g + t holds A rows g, g+8 at k = 2t, 2t+1, 2t+8, 2t+9; B
// column g at k = 2t, 2t+1, 2t+8, 2t+9; C rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half: two
// consecutive k of an mma operand fragment.
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The bias tile [BQ, BK] f32 of `plane` at (q0, k0) into `dst` (row
// stride LDB) by the CTA's NT threads, asynchronously: 16-byte copies when
// `vec` (every bias row starts 16-byte aligned: T % 4 = 0), else 4-byte
// ones; entries past S or T as zeros.
template <int BQ, int BK, int LDB, int NT>
__device__ __forceinline__ void bias_tile_async(float* dst, const float* plane,
                                                const Params& p, int q0, int k0,
                                                bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < BQ * BK / 4; i += NT) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool full = q0 + r < p.S && k0 + c < p.T;
      const size_t at = full ? static_cast<size_t>(q0 + r) * p.T + k0 + c : 0;
      cp_async16(dst + r * LDB + c, plane + at, full);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const bool full = q0 + r < p.S && k0 + c < p.T;
      const size_t at = full ? static_cast<size_t>(q0 + r) * p.T + k0 + c : 0;
      cp_async4(dst + r * LDB + c, plane + at, full);
    }
  }
}

// Tiles and shared-memory layout (byte offsets) of the bf16 dk/dv kernel:
// K and V [BK, D] once, then a ring of kStages stages of one (group
// head, q tile) each: Q and dO [BQ, D] bf16, the bias tile [BQ, BK] f32,
// lse, delta and the query segment ids.  Rows are padded by 16 bytes, so
// the 8 rows of an ldmatrix (and the bias reads of a fragment) fall in
// distinct banks.
template <int D>
struct Dkv {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BK = 16 * kWarps;  // 16 keys per warp
  // Queries per stage: at D = 128 the 128 f32 registers of dK and dV
  // leave room for S^T and dP^T of 32 queries, not 64.
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int LDT = D + 8;   // bf16 row stride
  static constexpr int LDB = BK + 4;  // f32 bias row stride
  static constexpr int kK = 0;
  static constexpr int kV = kK + BK * LDT * 2;
  static constexpr int kKseg = kV + BK * LDT * 2;
  static constexpr int kRing = kKseg + BK * 4;
  static constexpr int kQ = 0;  // offsets inside a stage
  static constexpr int kDo = kQ + BQ * LDT * 2;
  static constexpr int kBias = kDo + BQ * LDT * 2;
  static constexpr int kLse = kBias + BQ * LDB * 4;
  static constexpr int kDelta = kLse + BQ * 4;
  static constexpr int kQseg = kDelta + BQ * 4;
  static constexpr int kStage = kQseg + BQ * 4;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kStage % 16 == 0 && kRing % 16 == 0, "16-byte pieces");
};

// One CTA per (kv row, k tile of BK keys), as in the f32 kernel; each of
// its 4 warps owns 16 keys and keeps their dK and dV in mma.sync
// accumulator fragments for the whole walk over (group head g, q tile).
// Per step: S^T = K Q^T (16 keys x BQ queries, in registers; K through
// ldmatrix as the A operand, Q as the col-major B operand) and p^T in its
// fragments, dV += P^T dO; then dP^T = V dO^T and ds^T, dK += dS^T Q;
// the two bf16 parts of p and of ds are packed straight from the
// fragments into A operands (a C fragment of m16n8k16 is half an A
// fragment of the next product), dO and Q through ldmatrix.trans.  The next step's Q, dO, lse, delta, query
// segment ids and bias tile are in flight (cp.async) while this one
// computes.
template <int D>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 2)
    flash_dkv_bf16_kernel(Params p) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = C::LDT, LDB = C::LDB;
  constexpr int NQ = BQ / 8;  // n tiles of S^T (queries)
  constexpr int ND = D / 8;   // n tiles of dK, dV (head dim)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + C::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + C::kV);
  int* kseg_s = reinterpret_cast<int*>(smem + C::kKseg);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.H / p.KV;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = bkv / p.KV;
  const size_t koff = static_cast<size_t>(bkv) * p.T * D;
  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* dog = static_cast<const bf16*>(p.dout);
  // 16-byte bias vectors when every bias row starts 16-byte aligned.
  const bool bias_vec =
      p.T % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;

  // K and V once (rows past T as zeros), in the first stage's group.
  {
    const bf16* kg = static_cast<const bf16*>(p.k) + koff;
    const bf16* vg = static_cast<const bf16*>(p.v) + koff;
    for (int i = tid; i < BK * (D / 8); i += C::kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool full = k0 + r < p.T;
      const size_t at = full ? static_cast<size_t>(k0 + r) * D + c : 0;
      cp_async16(ks + r * LDT + c, kg + at, full);
      cp_async16(vs + r * LDT + c, vg + at, full);
    }
    for (int r = tid; r < BK; r += C::kThreads)
      kseg_s[r] = (p.kseg != nullptr && k0 + r < p.T)
                      ? p.kseg[static_cast<size_t>(b) * p.T + k0 + r]
                      : 0;
  }

  const int nq = (p.S + BQ - 1) / BQ;
  // First q tile with a row that may see key k0 (causal): the row i with
  // k0 <= i + T - S, i.e. i >= k0 - (T - S).
  int qt0 = 0;
  if (p.causal) {
    const int first_row = k0 - (p.T - p.S);
    qt0 = first_row <= 0 ? 0 : first_row / BQ;
  }
  const int per_head = nq - qt0;
  const int steps = G * per_head;  // the walk, flattened over (g, q tile)

  // Step n's operands into ring stage n % kStages, rows past S and keys
  // past T as zeros.
  auto issue = [&](int n) {
    unsigned char* st = smem + C::kRing + (n % C::kStages) * C::kStage;
    const int bh = bkv * G + n / per_head;  // query head (b, kv*G + g)
    const int q0 = (qt0 + n % per_head) * BQ;
    const size_t qoff = static_cast<size_t>(bh) * p.S * D;
    bf16* qs = reinterpret_cast<bf16*>(st + C::kQ);
    bf16* dos = reinterpret_cast<bf16*>(st + C::kDo);
    for (int i = tid; i < BQ * (D / 8); i += C::kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool full = q0 + r < p.S;
      const size_t at = full ? qoff + static_cast<size_t>(q0 + r) * D + c : 0;
      cp_async16(qs + r * LDT + c, qg + at, full);
      cp_async16(dos + r * LDT + c, dog + at, full);
    }
    float* lse_s = reinterpret_cast<float*>(st + C::kLse);
    float* delta_s = reinterpret_cast<float*>(st + C::kDelta);
    int* qseg_s = reinterpret_cast<int*>(st + C::kQseg);
    for (int r = tid; r < BQ; r += C::kThreads) {
      const bool full = q0 + r < p.S;
      const size_t at = full ? static_cast<size_t>(bh) * p.S + q0 + r : 0;
      cp_async4(lse_s + r, p.lse_in + at, full);
      cp_async4(delta_s + r, p.delta + at, full);
      if (p.qseg != nullptr)
        cp_async4(qseg_s + r,
                  p.qseg + (full ? static_cast<size_t>(b) * p.S + q0 + r : 0),
                  full);
    }
    const float* plane = bias_plane(p, bh);
    if (plane != nullptr)
      bias_tile_async<BQ, BK, LDB, C::kThreads>(
          reinterpret_cast<float*>(st + C::kBias), plane, p, q0, k0, bias_vec);
  };

  if (steps > 0) issue(0);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int kw = k0 + 16 * warp;  // the warp's first key
  // ldmatrix row addresses of this lane: the A operand (16 rows, k
  // contiguous); the B operand stored [n][k] (two n tiles); the B operand
  // stored [k][n] (two n tiles, through .trans).
  const bf16* ka = ks + (16 * warp + (lane & 15)) * LDT + (lane >> 4) * 8;
  const bf16* va = vs + (16 * warp + (lane & 15)) * LDT + (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;
  const bool has_bias = p.bias != nullptr;

  for (int n = 0; n < steps; ++n) {
    cp_async_wait_all();
    __syncthreads();  // stage n landed for all; stage n + 1's buffer is free
    if (n + 1 < steps) issue(n + 1);
    cp_async_commit();

    const unsigned char* st = smem + C::kRing + (n % C::kStages) * C::kStage;
    const bf16* qs = reinterpret_cast<const bf16*>(st + C::kQ);
    const bf16* dos = reinterpret_cast<const bf16*>(st + C::kDo);
    const float* bias_s = reinterpret_cast<const float*>(st + C::kBias);
    const float* lse_s = reinterpret_cast<const float*>(st + C::kLse);
    const float* delta_s = reinterpret_cast<const float*>(st + C::kDelta);
    const int* qseg_s = reinterpret_cast<const int*>(st + C::kQseg);
    const int q0 = (qt0 + n % per_head) * BQ;
    // A warp whose keys no row of this tile sees adds nothing.
    if (kw >= p.T || (p.causal && kw > q0 + BQ - 1 + p.T - p.S)) continue;
    // The mask only where the tile crosses the diagonal or a ragged edge,
    // or segments decide.
    const bool masked = p.qseg != nullptr || q0 + BQ > p.S || kw + 16 > p.T ||
                        (p.causal && kw + 15 > q0 + p.T - p.S);

    // P first, then dS, so that only one of S^T and dP^T is computed
    // while the other's products run: P's hi + lo split needs the room.
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_k[4];
      ldsm_x4<false>(a_k, ka + 16 * kk);
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        uint32_t b_q[4];
        ldsm_x4<false>(b_q, qs + (16 * j + b_row) * LDT + 16 * kk + b_col);
        mma_bf16(s[2 * j], a_k, b_q[0], b_q[1]);
        mma_bf16(s[2 * j + 1], a_k, b_q[2], b_q[3]);
      }
    }

    // p^T = exp(s*scale [+ bias] - lse) where visible, else 0.  Element e
    // of fragment j: key g + 8(e/2) of the warp's 16, query 8j + 2t + e%2
    // of the tile.
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const int kl = 16 * warp + g + 8 * (e >> 1);
        float x = s[j][e] * p.scale;
        if (has_bias) x += bias_s[qi * LDB + kl];
        float pr = expf(x - lse_s[qi]);
        if (masked && !visible(p, q0 + qi, k0 + kl, qseg_s[qi], kseg_s[kl]))
          pr = 0.f;
        s[j][e] = pr;
      }

    // dV += P^T_hi dO + P^T_lo dO over the tile's queries: fragments 2kk
    // and 2kk + 1 of S^T are the A operand of k step kk.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 2 * kk + (h >> 1), e = 2 * (h & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[j][e], s[j][e + 1]);
        a_hi[h] = bf16x2_bits(hi);
        a_lo[h] = bf16x2_bits(__floats2bfloat162_rn(
            s[j][e] - __low2float(hi), s[j][e + 1] - __high2float(hi)));
      }
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t b_do[4];
        ldsm_x4<true>(b_do, dos + (16 * kk + t_row) * LDT + 16 * j + t_col);
        mma_bf16(dv[2 * j], a_hi, b_do[0], b_do[1]);
        mma_bf16(dv[2 * j + 1], a_hi, b_do[2], b_do[3]);
        mma_bf16(dv[2 * j], a_lo, b_do[0], b_do[1]);
        mma_bf16(dv[2 * j + 1], a_lo, b_do[2], b_do[3]);
      }
    }

    // dP^T = V dO^T, then ds^T = p^T (dp^T - delta) scale in its
    // fragments.
    float dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_v[4];
      ldsm_x4<false>(a_v, va + 16 * kk);
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        uint32_t b_do[4];
        ldsm_x4<false>(b_do, dos + (16 * j + b_row) * LDT + 16 * kk + b_col);
        mma_bf16(dp[2 * j], a_v, b_do[0], b_do[1]);
        mma_bf16(dp[2 * j + 1], a_v, b_do[2], b_do[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        dp[j][e] = s[j][e] * (dp[j][e] - delta_s[qi]) * p.scale;
      }

    // dK += dS^T_hi Q + dS^T_lo Q.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 2 * kk + (h >> 1), e = 2 * (h & 1);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(dp[j][e], dp[j][e + 1]);
        a_hi[h] = bf16x2_bits(hi);
        a_lo[h] = bf16x2_bits(__floats2bfloat162_rn(
            dp[j][e] - __low2float(hi), dp[j][e + 1] - __high2float(hi)));
      }
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t b_q[4];
        ldsm_x4<true>(b_q, qs + (16 * kk + t_row) * LDT + 16 * j + t_col);
        mma_bf16(dk[2 * j], a_hi, b_q[0], b_q[1]);
        mma_bf16(dk[2 * j + 1], a_hi, b_q[2], b_q[3]);
        mma_bf16(dk[2 * j], a_lo, b_q[0], b_q[1]);
        mma_bf16(dk[2 * j + 1], a_lo, b_q[2], b_q[3]);
      }
    }
  }

  // dK and dV once, rounded to bf16, rows past T left alone.
  bf16* dkg = static_cast<bf16*>(p.out) + koff;
  bf16* dvg = static_cast<bf16*>(p.out2) + koff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + g + 8 * h;
    if (row >= p.T) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t at = static_cast<size_t>(row) * D + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkg + at) =
          __floats2bfloat162_rn(dk[j][2 * h], dk[j][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + at) =
          __floats2bfloat162_rn(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward and dq: register accumulators, ldmatrix operands, a cp.async
// ring over the k tiles
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

// Tiles and shared-memory layout (byte offsets) of the bf16 forward and dq
// kernels: W warps of 16 query rows each (BQ = 16 W), k tiles of 64 keys.
// The CTA's own [BQ, D] bf16 tiles come first (Q; Q and dO for dq), then a
// ring of kStages stages of one k tile each: K and V [BK, D] bf16, the key
// segment ids and, only when the launch has a bias, the bias tile [BQ, BK]
// f32.  Rows are padded by 16 bytes (bf16: the 8 rows of an ldmatrix fall
// in distinct banks) and 32 bytes (the bias tile: a quarter warp's 8-byte
// reads of one fragment do).
template <int D, int W>
struct Fq {
  static constexpr int kThreads = 32 * W;
  static constexpr int BQ = 16 * W, BK = 64;
  static constexpr int kStages = 2;
  static constexpr int LDT = D + 8;   // bf16 row stride
  static constexpr int LDB = BK + 8;  // f32 bias row stride
  static constexpr int kTile = BQ * LDT * 2;  // one owned [BQ, D] tile
  static constexpr int kK = 0;                // offsets inside a stage
  static constexpr int kV = kK + BK * LDT * 2;
  static constexpr int kKseg = kV + BK * LDT * 2;
  static constexpr int kBias = kKseg + BK * 4;
  static constexpr int kBiasBytes = BQ * LDB * 4;
  static_assert(kTile % 16 == 0 && kBias % 16 == 0, "16-byte pieces");
  __host__ __device__ static int stage(bool bias) {
    return kBias + (bias ? kBiasBytes : 0);
  }
  // With `owned` [BQ, D] tiles before the ring.
  __host__ __device__ static int bytes(int owned, bool bias) {
    return owned * kTile + kStages * stage(bias);
  }
};

// Rows r0 .. r0 + ROWS - 1 of an [n, D] bf16 matrix into a tile of row
// stride LDT by the CTA's NT threads, asynchronously, rows past n as zeros.
template <int D, int LDT, int ROWS, int NT>
__device__ __forceinline__ void rows_async(bf16* dst, const bf16* src, int r0,
                                           int n) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool full = r0 + r < n;
    const size_t at = full ? static_cast<size_t>(r0 + r) * D + c : 0;
    cp_async16(dst + r * LDT + c, src + at, full);
  }
}

// The k tile at k0 into ring stage `st`: K and V (keys past T as zeros),
// the key segment ids of batch item b, and the bias tile of `plane` for
// the CTA's rows from q0 (none without a bias).
template <int D, int W>
__device__ __forceinline__ void k_tile_async(unsigned char* st,
                                             const Params& p, const bf16* kg,
                                             const bf16* vg, const float* plane,
                                             int b, int q0, int k0,
                                             bool bias_vec) {
  using C = Fq<D, W>;
  rows_async<D, C::LDT, C::BK, C::kThreads>(
      reinterpret_cast<bf16*>(st + C::kK), kg, k0, p.T);
  rows_async<D, C::LDT, C::BK, C::kThreads>(
      reinterpret_cast<bf16*>(st + C::kV), vg, k0, p.T);
  if (p.kseg != nullptr) {
    int* kseg_s = reinterpret_cast<int*>(st + C::kKseg);
    for (int r = threadIdx.x; r < C::BK; r += C::kThreads) {
      const bool full = k0 + r < p.T;
      cp_async4(kseg_s + r,
                p.kseg + (full ? static_cast<size_t>(b) * p.T + k0 + r : 0),
                full);
    }
  }
  if (plane != nullptr)
    bias_tile_async<C::BQ, C::BK, C::LDB, C::kThreads>(
        reinterpret_cast<float*>(st + C::kBias), plane, p, q0, k0, bias_vec);
}

// One CTA per (query row bh, q tile of BQ rows), longest tiles first, as
// in the f32 kernel; each of its W warps owns 16 rows and keeps their O
// (64 f32 registers a thread at D = 128) in mma.sync accumulator
// fragments for the whole walk over the k tiles; their Q A-fragments
// come from the CTA's shared Q tile each k tile.  Per k tile: S = Q K^T into registers (K through
// ldmatrix as the col-major B operand), the scale and the bias tile added
// there, the online softmax in the fragments (a thread holds rows g and
// g + 8, the 4 lanes of a quad share a row), the two bf16 parts of p
// packed straight into the A operands of O += P_hi V + P_lo V (V through
// ldmatrix.trans).  The next k
// tile's K, V, key segment ids and bias tile are in flight (cp.async)
// while this one computes.
template <int D, int W>
__global__ void __launch_bounds__(32 * W, W == 4 ? 2 : 1)
    flash_fwd_bf16_kernel(Params p) {
  using C = Fq<D, W>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = C::LDT, LDB = C::LDB;
  constexpr int NK = BK / 8;  // n tiles of S (keys): 32 elements a thread
  constexpr int ND = D / 8;   // n tiles of O (head dim)
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  unsigned char* ring = smem + C::kTile;
  const bool has_bias = p.bias != nullptr;
  const int stage_bytes = C::stage(has_bias);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int b = bh / p.H;
  const size_t kvoff = static_cast<size_t>(bh / (p.H / p.KV)) * p.T * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvoff;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvoff;
  const float* plane = bias_plane(p, bh);
  const bool bias_vec =
      p.T % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  const int nk = k_tiles_needed(p, q0, BQ, BK);

  // Q once, with the first k tile.
  rows_async<D, LDT, BQ, C::kThreads>(
      reinterpret_cast<bf16*>(smem),
      static_cast<const bf16*>(p.q) + static_cast<size_t>(bh) * p.S * D, q0,
      p.S);
  if (nk > 0) k_tile_async<D, W>(ring, p, kg, vg, plane, b, q0, 0, bias_vec);
  cp_async_commit();

  const int rw = q0 + 16 * warp;  // the warp's first row
  int qseg[2] = {0, 0};           // of rows rw + g and rw + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (p.qseg != nullptr && rw + g + 8 * h < p.S)
      qseg[h] = p.qseg[static_cast<size_t>(b) * p.S + rw + g + 8 * h];
  // ldmatrix row addresses of this lane: the A operand (16 rows, k
  // contiguous); the B operand stored [n][k] (two n tiles); the B operand
  // stored [k][n] (two n tiles, through .trans).
  const int a_off = (16 * warp + (lane & 15)) * LDT + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDT + ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDT + (lane >> 4) * 8;

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Per row half h (rows g, g + 8): the running max, the sum of the exact
  // p (for lse) and the sum of its bf16 parts hi + lo (O's normalizer),
  // each over this thread's columns (the quad's partial sums share their
  // rescaling).
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, lp[2] = {0.f, 0.f};

  for (int n = 0; n < nk; ++n) {
    cp_async_wait_all();
    __syncthreads();  // tile n landed for all; stage n + 1's buffer is free
    if (n + 1 < nk)
      k_tile_async<D, W>(ring + ((n + 1) % C::kStages) * stage_bytes, p, kg,
                         vg, plane, b, q0, (n + 1) * BK, bias_vec);
    cp_async_commit();

    const unsigned char* st = ring + (n % C::kStages) * stage_bytes;
    const bf16* ks = reinterpret_cast<const bf16*>(st + C::kK);
    const bf16* vs = reinterpret_cast<const bf16*>(st + C::kV);
    const int* kseg_s = reinterpret_cast<const int*>(st + C::kKseg);
    const float* bias_s = reinterpret_cast<const float*>(st + C::kBias);
    const int k0 = n * BK;
    // A warp none of whose rows sees a key of this tile adds nothing.
    if (rw >= p.S || (p.causal && k0 > rw + 15 + p.T - p.S)) continue;
    // The mask only where the tile crosses the diagonal or a ragged edge,
    // or segments decide.
    const bool masked = p.qseg != nullptr || rw + 16 > p.S || k0 + BK > p.T ||
                        (p.causal && k0 + BK - 1 > rw + p.T - p.S);

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // The warp's Q fragment of k step kk, read again each tile: the 32
      // registers a thread would hold it in are P's hi + lo split's.
      uint32_t aq[4];
      ldsm_x4<false>(aq, qs + a_off + 16 * kk);
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4<false>(bk, ks + b_off + 16 * j * LDT + 16 * kk);
        mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
      }
    }

    // x = s*scale [+ bias], -1e30 where not visible (bit 4j + e of `vis`
    // cleared); the tile's row max.  Element e of fragment j: row g +
    // 8(e/2) of the warp's 16, key 8j + 2t + e%2 of the tile.
    uint32_t vis = 0xffffffffu;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = 16 * warp + g + 8 * h, kl = 8 * j + 2 * t;
        float x0 = s[j][2 * h] * p.scale, x1 = s[j][2 * h + 1] * p.scale;
        if (has_bias) {
          const float2 bb =
              *reinterpret_cast<const float2*>(bias_s + qi * LDB + kl);
          x0 += bb.x;
          x1 += bb.y;
        }
        if (masked) {
          if (!visible(p, q0 + qi, k0 + kl, qseg[h], kseg_s[kl])) {
            x0 = kNeg;
            vis &= ~(1u << (4 * j + 2 * h));
          }
          if (!visible(p, q0 + qi, k0 + kl + 1, qseg[h], kseg_s[kl + 1])) {
            x1 = kNeg;
            vis &= ~(1u << (4 * j + 2 * h + 1));
          }
        }
        s[j][2 * h] = x0;
        s[j][2 * h + 1] = x1;
        mx[h] = fmaxf(mx[h], fmaxf(x0, x1));
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
    }

    // p = exp(x - m) where visible, else 0, kept in f32 in the S
    // fragments (fragments 2kk and 2kk + 1 of S are the A operand of k
    // step kk of P V).
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0 = exp2f((s[j][2 * h] - m[h]) * kLog2e);
        float p1 = exp2f((s[j][2 * h + 1] - m[h]) * kLog2e);
        if (!((vis >> (4 * j + 2 * h)) & 1u)) p0 = 0.f;
        if (!((vis >> (4 * j + 2 * h + 1)) & 1u)) p1 = 0.f;
        s[j][2 * h] = p0;
        s[j][2 * h + 1] = p1;
        ps[h] += p0 + p1;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + ps[h];
      lp[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // O += P_hi V + P_lo V: each k step's two bf16 parts of p (hi =
    // bf16(p), lo = bf16(p - hi), ~2^-17 relative together) packed into
    // A operands just before its products, and their sum into lp.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 2 * kk + (r >> 1), h = r & 1;
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(s[j][2 * h], s[j][2 * h + 1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            s[j][2 * h] - __low2float(hi), s[j][2 * h + 1] - __high2float(hi));
        a_hi[r] = bf16x2_bits(hi);
        a_lo[r] = bf16x2_bits(lo);
        lp[h] += (__low2float(hi) + __high2float(hi)) +
                 (__low2float(lo) + __high2float(lo));
      }
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t bv[4];
        ldsm_x4<true>(bv, vs + t_off + 16 * kk * LDT + 16 * j);
        mma_bf16(o[2 * j], a_hi, bv[0], bv[1]);
        mma_bf16(o[2 * j + 1], a_hi, bv[2], bv[3]);
        mma_bf16(o[2 * j], a_lo, bv[0], bv[1]);
        mma_bf16(o[2 * j + 1], a_lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing in flight at exit (a CTA that walks no tile)

  // O is normalized by the sum of the P it multiplied (hi + lo, the two
  // bf16 parts the tensor cores took), so it stays a convex combination
  // of the values: the component they share passes through exactly, and
  // so cancels from dP - delta in the backward.  lse keeps the exact sum, so
  // the backward's recomputed P sums to one.  O once, to bf16 (and f32 on
  // request), rows past S left alone.
  const size_t qoff = static_cast<size_t>(bh) * p.S * D;
  bf16* og = static_cast<bf16*>(p.out) + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {  // the quad's partial sums
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], w);
      lp[h] += __shfl_xor_sync(0xffffffffu, lp[h], w);
    }
    const int row = rw + g + 8 * h;
    if (row >= p.S) continue;
    const float den = fmaxf(lp[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t at = static_cast<size_t>(row) * D + 8 * j + 2 * t;
      const float v0 = o[j][2 * h] / den, v1 = o[j][2 * h + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(og + at) = __floats2bfloat162_rn(v0, v1);
      if (p.o32 != nullptr)
        *reinterpret_cast<float2*>(p.o32 + qoff + at) = make_float2(v0, v1);
    }
    if (t == 0)
      p.lse[static_cast<size_t>(bh) * p.S + row] =
          m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

// Same grid, walk and ring as the forward.  The CTA keeps Q and dO in
// shared memory, and each of its W warps keeps dQ of its 16 rows (64 f32
// registers a thread at D = 128) in accumulator fragments.  Per k tile:
// S = Q K^T and dP = dO V^T into registers (K and V through ldmatrix as
// col-major B operands), p = exp(s*scale [+ bias] - lse) and ds = p (dp -
// delta) scale in those fragments, then dQ += dS_hi K + dS_lo K with the
// two bf16 parts of ds packed straight into A operands and K through
// ldmatrix.trans: the hi/lo split keeps the component shared by all keys
// out of dq.
template <int D, int W>
__global__ void __launch_bounds__(32 * W, W == 4 ? 2 : 1)
    flash_dq_bf16_kernel(Params p) {
  using C = Fq<D, W>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = C::LDT, LDB = C::LDB;
  constexpr int NK = BK / 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  const bf16* dos = reinterpret_cast<const bf16*>(smem + C::kTile);
  unsigned char* ring = smem + 2 * C::kTile;
  const bool has_bias = p.bias != nullptr;
  const int stage_bytes = C::stage(has_bias);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H;
  const size_t qoff = static_cast<size_t>(bh) * p.S * D;
  const size_t kvoff = static_cast<size_t>(bh / (p.H / p.KV)) * p.T * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvoff;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvoff;
  const float* plane = bias_plane(p, bh);
  const bool bias_vec =
      p.T % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  const int nk = k_tiles_needed(p, q0, BQ, BK);

  // Q and dO once, with the first k tile.
  rows_async<D, LDT, BQ, C::kThreads>(
      reinterpret_cast<bf16*>(smem), static_cast<const bf16*>(p.q) + qoff, q0,
      p.S);
  rows_async<D, LDT, BQ, C::kThreads>(
      reinterpret_cast<bf16*>(smem + C::kTile),
      static_cast<const bf16*>(p.dout) + qoff, q0, p.S);
  if (nk > 0) k_tile_async<D, W>(ring, p, kg, vg, plane, b, q0, 0, bias_vec);
  cp_async_commit();

  const int rw = q0 + 16 * warp;
  int qseg[2] = {0, 0};  // rows rw + g and rw + g + 8
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + g + 8 * h;
    if (row >= p.S) continue;
    lse[h] = p.lse_in[static_cast<size_t>(bh) * p.S + row];
    delta[h] = p.delta[static_cast<size_t>(bh) * p.S + row];
    if (p.qseg != nullptr) qseg[h] = p.qseg[static_cast<size_t>(b) * p.S + row];
  }
  const int a_off = (16 * warp + (lane & 15)) * LDT + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDT + ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDT + (lane >> 4) * 8;

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int n = 0; n < nk; ++n) {
    cp_async_wait_all();
    __syncthreads();  // tile n landed for all; stage n + 1's buffer is free
    if (n + 1 < nk)
      k_tile_async<D, W>(ring + ((n + 1) % C::kStages) * stage_bytes, p, kg,
                         vg, plane, b, q0, (n + 1) * BK, bias_vec);
    cp_async_commit();

    const unsigned char* st = ring + (n % C::kStages) * stage_bytes;
    const bf16* ks = reinterpret_cast<const bf16*>(st + C::kK);
    const bf16* vs = reinterpret_cast<const bf16*>(st + C::kV);
    const int* kseg_s = reinterpret_cast<const int*>(st + C::kKseg);
    const float* bias_s = reinterpret_cast<const float*>(st + C::kBias);
    const int k0 = n * BK;
    if (rw >= p.S || (p.causal && k0 > rw + 15 + p.T - p.S)) continue;
    const bool masked = p.qseg != nullptr || rw + 16 > p.S || k0 + BK > p.T ||
                        (p.causal && k0 + BK - 1 > rw + p.T - p.S);

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_q[4], a_do[4];
      ldsm_x4<false>(a_q, qs + a_off + 16 * kk);
      ldsm_x4<false>(a_do, dos + a_off + 16 * kk);
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4<false>(bk, ks + b_off + 16 * j * LDT + 16 * kk);
        ldsm_x4<false>(bv, vs + b_off + 16 * j * LDT + 16 * kk);
        mma_bf16(s[2 * j], a_q, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a_q, bk[2], bk[3]);
        mma_bf16(dp[2 * j], a_do, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], a_do, bv[2], bv[3]);
      }
    }

    // p = exp(s*scale [+ bias] - lse) where visible, else 0; ds = p (dp -
    // delta) scale, in dp's fragments (element layout as in the forward).
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = 16 * warp + g + 8 * h, kl = 8 * j + 2 * t;
        float2 bb = make_float2(0.f, 0.f);
        if (has_bias) bb = *reinterpret_cast<const float2*>(bias_s + qi * LDB + kl);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c;
          const float x = s[j][e] * p.scale + (c ? bb.y : bb.x);
          float pr = exp2f((x - lse[h]) * kLog2e);
          if (masked && !visible(p, q0 + qi, k0 + kl + c, qseg[h], kseg_s[kl + c]))
            pr = 0.f;
          dp[j][e] = pr * (dp[j][e] - delta[h]) * p.scale;
        }
      }

    // dQ += dS_hi K + dS_lo K over the tile's keys: fragments 2kk and
    // 2kk + 1 of dS are the A operand of k step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 2 * kk + (h >> 1), e = 2 * (h & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dp[j][e], dp[j][e + 1]);
        a_hi[h] = bf16x2_bits(hi);
        a_lo[h] = bf16x2_bits(__floats2bfloat162_rn(
            dp[j][e] - __low2float(hi), dp[j][e + 1] - __high2float(hi)));
      }
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4<true>(bk, ks + t_off + 16 * kk * LDT + 16 * j);
        mma_bf16(dq[2 * j], a_hi, bk[0], bk[1]);
        mma_bf16(dq[2 * j + 1], a_hi, bk[2], bk[3]);
        mma_bf16(dq[2 * j], a_lo, bk[0], bk[1]);
        mma_bf16(dq[2 * j + 1], a_lo, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing in flight at exit (a CTA that walks no tile)

  // dQ once, rounded to bf16, rows past S left alone.
  bf16* dqg = static_cast<bf16*>(p.out) + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + g + 8 * h;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + static_cast<size_t>(row) * D +
                                          8 * j + 2 * t) =
          __floats2bfloat162_rn(dq[j][2 * h], dq[j][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 d(bias): register sums over a cp.async ring of rows, plane-major grid
// ---------------------------------------------------------------------------

// Tiles and shared-memory layout (byte offsets) of the bf16 d(bias)
// kernel: 8 warps as 4 row groups of 16 queries x 2 key halves of 64
// (BQ 64, BK 128), and a ring of kStages stages of one row of the plane
// each: Q and dO [BQ, D] and K and V [BK, D] bf16 (rows padded by 16
// bytes, so the 8 rows of an ldmatrix fall in distinct banks), lse, delta
// and the query and key segment ids.
template <int D>
struct Db {
  static constexpr int kWarps = 8, kThreads = 32 * kWarps;
  static constexpr int BQ = 64, BK = 128, WK = 64;  // WK: keys a warp owns
  static constexpr int kStages = 2;
  static constexpr int LDT = D + 8;  // bf16 row stride
  static constexpr int kQ = 0;       // offsets inside a stage
  static constexpr int kDo = kQ + BQ * LDT * 2;
  static constexpr int kK = kDo + BQ * LDT * 2;
  static constexpr int kV = kK + BK * LDT * 2;
  static constexpr int kLse = kV + BK * LDT * 2;
  static constexpr int kDelta = kLse + BQ * 4;
  static constexpr int kQseg = kDelta + BQ * 4;
  static constexpr int kKseg = kQseg + BQ * 4;
  static constexpr int kStage = kKseg + BK * 4;
  static constexpr int kBytes = kStages * kStage;
  static_assert(kStage % 16 == 0 && kK % 16 == 0, "16-byte pieces");
};

// d(bias) for one (bias plane hb, q tile of 64, k tile of 128): the sum
// over the plane's rows (b*H + hb for every b, or all B*H rows when Hb =
// 1) of p * (dp - delta).  The plane is the slowest grid dimension, so
// the CTAs of one plane run together and L2 serves their re-reads of Q,
// dO, K and V.  Each warp owns 16 rows x 64 keys of the tile and keeps
// their sum in mma.sync C fragments over the whole walk, with the bias
// of those elements in registers too (read once per CTA, not per row).
// Per row: S = Q K^T and dP = dO V^T into fragments (every operand by
// ldmatrix: Q, dO, K and V are all contiguous in D), p = exp(s*scale +
// bias - lse), then sum += p (dp - delta) in place; the next row's Q, dO,
// K, V, lse, delta and segment ids are in flight (cp.async) meanwhile.
// The sum is f32 throughout; the tile is written once (zeros where no
// row sees a key: the output is not pre-zeroed).
template <int D>
__global__ void __launch_bounds__(Db<D>::kThreads, 1)
    flash_dbias_bf16_kernel(Params p) {
  using C = Db<D>;
  constexpr int BQ = C::BQ, BK = C::BK, WK = C::WK, LDT = C::LDT;
  constexpr int NK = WK / 8;  // n tiles of the warp's keys
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hb = blockIdx.z;
  const int q0 = blockIdx.y * BQ, k0 = blockIdx.x * BK;
  const int G = p.H / p.KV;
  const int rq = 16 * (warp & 3), kq = WK * (warp >> 2);  // in the tile
  const int rw = q0 + rq, kw = k0 + kq;  // the warp's first row and key
  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* dog = static_cast<const bf16*>(p.dout);
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  // A tile wholly past the causal diagonal walks no row.
  const bool needed = !p.causal || k0 <= q0 + BQ - 1 + p.T - p.S;
  const int steps = needed ? (p.Hb == 1 ? p.B * p.H : p.B) : 0;

  // Row n of the walk into ring stage n % kStages, rows past S and keys
  // past T as zeros.
  auto issue = [&](int n) {
    unsigned char* st = smem + (n % C::kStages) * C::kStage;
    const int bh = p.Hb == 1 ? n : n * p.H + hb;
    const int b = bh / p.H;
    const size_t qoff = static_cast<size_t>(bh) * p.S * D;
    const size_t koff = static_cast<size_t>(bh / G) * p.T * D;
    rows_async<D, LDT, BQ, C::kThreads>(reinterpret_cast<bf16*>(st + C::kQ),
                                        qg + qoff, q0, p.S);
    rows_async<D, LDT, BQ, C::kThreads>(reinterpret_cast<bf16*>(st + C::kDo),
                                        dog + qoff, q0, p.S);
    rows_async<D, LDT, BK, C::kThreads>(reinterpret_cast<bf16*>(st + C::kK),
                                        kg + koff, k0, p.T);
    rows_async<D, LDT, BK, C::kThreads>(reinterpret_cast<bf16*>(st + C::kV),
                                        vg + koff, k0, p.T);
    float* lse_s = reinterpret_cast<float*>(st + C::kLse);
    float* delta_s = reinterpret_cast<float*>(st + C::kDelta);
    int* qseg_s = reinterpret_cast<int*>(st + C::kQseg);
    int* kseg_s = reinterpret_cast<int*>(st + C::kKseg);
    for (int r = tid; r < BQ; r += C::kThreads) {
      const bool full = q0 + r < p.S;
      const size_t at = full ? static_cast<size_t>(bh) * p.S + q0 + r : 0;
      cp_async4(lse_s + r, p.lse_in + at, full);
      cp_async4(delta_s + r, p.delta + at, full);
      if (p.qseg != nullptr)
        cp_async4(qseg_s + r,
                  p.qseg + (full ? static_cast<size_t>(b) * p.S + q0 + r : 0),
                  full);
    }
    if (p.kseg != nullptr)
      for (int r = tid; r < BK; r += C::kThreads) {
        const bool full = k0 + r < p.T;
        cp_async4(kseg_s + r,
                  p.kseg + (full ? static_cast<size_t>(b) * p.T + k0 + r : 0),
                  full);
      }
  };

  if (steps > 0) issue(0);
  cp_async_commit();

  // A warp none of whose rows sees one of its keys adds nothing; the mask
  // only where its 16 x 64 crosses the diagonal or a ragged edge, or
  // segments decide.
  const bool active = needed && rw < p.S && kw < p.T &&
                      (!p.causal || kw <= rw + 15 + p.T - p.S);
  const bool masked = p.qseg != nullptr || rw + 16 > p.S || kw + WK > p.T ||
                      (p.causal && kw + WK - 1 > rw + p.T - p.S);

  // The warp's bias and sum, element e of fragment j: row rw + g + 8(e/2),
  // key kw + 8j + 2t + e%2.
  float bias[NK][4], acc[NK][4];
  const float* plane = p.bias + static_cast<size_t>(hb) * p.S * p.T;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rw + g + 8 * (e >> 1), c = kw + 8 * j + 2 * t + (e & 1);
      bias[j][e] = active && r < p.S && c < p.T
                       ? __ldg(plane + static_cast<size_t>(r) * p.T + c)
                       : 0.f;
      acc[j][e] = 0.f;
    }

  const int a_off = (rq + (lane & 15)) * LDT + (lane >> 4) * 8;
  const int b_off =
      (kq + (lane & 7) + ((lane >> 4) << 3)) * LDT + ((lane >> 3) & 1) * 8;

  for (int n = 0; n < steps; ++n) {
    cp_async_wait_all();
    __syncthreads();  // row n landed for all; stage n + 1's buffer is free
    if (n + 1 < steps) issue(n + 1);
    cp_async_commit();
    if (!active) continue;

    const unsigned char* st = smem + (n % C::kStages) * C::kStage;
    const bf16* qs = reinterpret_cast<const bf16*>(st + C::kQ);
    const bf16* dos = reinterpret_cast<const bf16*>(st + C::kDo);
    const bf16* ks = reinterpret_cast<const bf16*>(st + C::kK);
    const bf16* vs = reinterpret_cast<const bf16*>(st + C::kV);
    const float* lse_s = reinterpret_cast<const float*>(st + C::kLse);
    const float* delta_s = reinterpret_cast<const float*>(st + C::kDelta);
    const int* qseg_s = reinterpret_cast<const int*>(st + C::kQseg);
    const int* kseg_s = reinterpret_cast<const int*>(st + C::kKseg);

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_q[4], a_do[4];
      ldsm_x4<false>(a_q, qs + a_off + 16 * kk);
      ldsm_x4<false>(a_do, dos + a_off + 16 * kk);
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4<false>(bk, ks + b_off + 16 * j * LDT + 16 * kk);
        ldsm_x4<false>(bv, vs + b_off + 16 * j * LDT + 16 * kk);
        mma_bf16(s[2 * j], a_q, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a_q, bk[2], bk[3]);
        mma_bf16(dp[2 * j], a_do, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], a_do, bv[2], bv[3]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = rq + g + 8 * h;
      const float lse = lse_s[qi], delta = delta_s[qi];
      const int qseg = qseg_s[qi];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c, kl = kq + 8 * j + 2 * t + c;
          float pr = exp2f((s[j][e] * p.scale + bias[j][e] - lse) * kLog2e);
          if (masked && !visible(p, q0 + qi, k0 + kl, qseg, kseg_s[kl]))
            pr = 0.f;
          acc[j][e] += pr * (dp[j][e] - delta);
        }
    }
  }
  cp_async_wait_all();  // nothing in flight at exit

  // The tile once, in f32; entries past S or T left alone.
  float* out = static_cast<float*>(p.out) + static_cast<size_t>(hb) * p.S * p.T;
  const bool pairs = p.T % 2 == 0;  // (c, c + 1) 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    if (r >= p.S) continue;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = kw + 8 * j + 2 * t;
      float* o = out + static_cast<size_t>(r) * p.T + c;
      if (pairs && c + 1 < p.T) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (c < p.T) o[0] = acc[j][2 * h];
        if (c + 1 < p.T) o[1] = acc[j][2 * h + 1];
      }
    }
  }
}

// f32 d(bias) for one (bias plane hb, q tile, k tile): the sum of p * (dp -
// delta) over the rows of that plane (b*H + hb for every b, or all B*H
// rows when Hb = 1), in registers: thread t owns elements t + e*kThreads
// of the tile in every iteration.  The bias tile is read in every
// iteration (from L2 after the first).  The tile is written once.  The
// bf16 kernel is flash_dbias_bf16_kernel above.
__global__ void __launch_bounds__(kThreads, Tiles::kDbBlocks)
    flash_dbias_kernel(Params p) {
  using T = float;
  constexpr int BQ = Tiles::kDbQ, BK = Tiles::kDbK;
  constexpr int kPer = BQ * BK / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = dbias_layout(p.D);
  T* qs = reinterpret_cast<T*>(smem + L.a0);
  T* dos = reinterpret_cast<T*>(smem + L.a1);
  T* ks = reinterpret_cast<T*>(smem + L.b0);
  T* vs = reinterpret_cast<T*>(smem + L.b1);
  float* ss = reinterpret_cast<float*>(smem + L.s0);
  float* dps = reinterpret_cast<float*>(smem + L.s1);
  float* lse_s = reinterpret_cast<float*>(smem + L.r0);
  float* delta_s = reinterpret_cast<float*>(smem + L.r1);
  int* qseg_s = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L.kseg);

  const int D = p.D;
  const int G = p.H / p.KV;
  const int hb = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int k0 = blockIdx.z * BK;
  const size_t plane = static_cast<size_t>(hb) * p.S * p.T;
  const float* bplane = p.bias + plane;
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  // A tile wholly past the causal diagonal has no visible pair: it keeps
  // its zeros (and is still written: the output is not pre-zeroed).
  const bool needed = !p.causal || k0 <= q0 + BQ - 1 + p.T - p.S;
  const int n_rows = needed ? (p.Hb == 1 ? p.B * p.H : p.B) : 0;
  for (int it = 0; it < n_rows; ++it) {
    const int bh = p.Hb == 1 ? it : it * p.H + hb;
    const int b = bh / p.H;
    const int kvh = bh / G;
    const size_t qoff = static_cast<size_t>(bh) * p.S * D;
    const size_t koff = static_cast<size_t>(kvh) * p.T * D;
    __syncthreads();  // the previous row's readers are done
    load_tile(qs, L.ldt, static_cast<const T*>(p.q) + qoff, q0, p.S, BQ, D);
    load_tile(dos, L.ldt, static_cast<const T*>(p.dout) + qoff, q0, p.S, BQ, D);
    load_tile(ks, L.ldt, static_cast<const T*>(p.k) + koff, k0, p.T, BK, D);
    load_tile(vs, L.ldt, static_cast<const T*>(p.v) + koff, k0, p.T, BK, D);
    load_rows(lse_s, p.lse_in + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
    load_rows(delta_s, p.delta + static_cast<size_t>(bh) * p.S, q0, p.S, BQ);
    load_seg(qseg_s, p.qseg ? p.qseg + static_cast<size_t>(b) * p.S : nullptr,
             q0, p.S, BQ);
    load_seg(kseg_s, p.kseg ? p.kseg + static_cast<size_t>(b) * p.T : nullptr,
             k0, p.T, BK);
    __syncthreads();
    gemm<true, true>(qs, L.ldt, ks, L.ldt, ss, L.lds, BQ, BK, D, false, nullptr);
    gemm<true, true>(dos, L.ldt, vs, L.ldt, dps, L.lds, BQ, BK, D, false, nullptr);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * kThreads;
      const int r = i / BK, j = i % BK;
      if (visible(p, q0 + r, k0 + j, qseg_s[r], kseg_s[j])) {
        const float pr = expf(
            biased(p, bplane, ss[r * L.lds + j] * p.scale, q0 + r, k0 + j) -
            lse_s[r]);
        acc[e] += pr * (dps[r * L.lds + j] - delta_s[r]);
      }
    }
  }
  float* out = static_cast<float*>(p.out) + plane;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int r = i / BK, j = i % BK;
    if (q0 + r < p.S && k0 + j < p.T)
      out[static_cast<size_t>(q0 + r) * p.T + k0 + j] = acc[e];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Launches `kernel` with `threads` a CTA, or, when `shape` is given,
// launches nothing and stores how many of its CTAs fit on one SM, its
// threads and its dynamic shared memory there.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p,
           cudaStream_t stream, int* shape) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    // All of the SM's unified memory as shared memory, so that as many
    // CTAs as fit (two for most bf16 kernels) share an SM.
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (shape != nullptr) {
    shape[1] = threads;
    shape[2] = static_cast<int>(smem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        shape, kernel, threads, smem));
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward (which 0) or dq (which 1) kernel at D with W warps.
template <int D, int W>
int run_fq(int which, const Params& p, cudaStream_t stream, int* shape) {
  using C = Fq<D, W>;
  const dim3 grid(p.B * p.H, (p.S + C::BQ - 1) / C::BQ);
  const bool bias = p.bias != nullptr;
  if (which == 0)
    return launch(flash_fwd_bf16_kernel<D, W>, grid, C::kThreads,
                  C::bytes(1, bias), p, stream, shape);
  return launch(flash_dq_bf16_kernel<D, W>, grid, C::kThreads,
                C::bytes(2, bias), p, stream, shape);
}

// The default rule (p.warps == 0): four warps a CTA, two CTAs an SM,
// except at D = 128 with a bias: there the bias tiles of a two-stage ring
// leave room for one 4-warp CTA only, so one CTA of 8 warps (128 rows)
// takes the SM instead.  A requested W must be a built instantiation:
// W = 4 at every D, W = 8 at D = 128 (with or without a bias); any other
// request is cudaErrorInvalidValue.
int run_fq_bf16(int which, const Params& p, cudaStream_t stream, int* shape) {
  const int w = p.warps;
  if (w != 0 && w != 4 && !(w == 8 && p.D == 128))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.D) {
    case 16: return run_fq<16, 4>(which, p, stream, shape);
    case 32: return run_fq<32, 4>(which, p, stream, shape);
    case 64: return run_fq<64, 4>(which, p, stream, shape);
    default:
      return w == 8 || (w == 0 && p.bias != nullptr)
                 ? run_fq<128, 8>(which, p, stream, shape)
                 : run_fq<128, 4>(which, p, stream, shape);
  }
}

// The bf16 dk/dv (which 2) or d(bias) (which 3) kernel at D.  d(bias)'s
// grid puts the bias plane slowest (see flash_dbias_bf16_kernel).
template <int D>
int run_dkv_dbias_bf16(int which, const Params& p, cudaStream_t stream,
                       int* shape) {
  if (which == 2) {
    using C = Dkv<D>;
    return launch(flash_dkv_bf16_kernel<D>,
                  dim3(p.B * p.KV, (p.T + C::BK - 1) / C::BK), C::kThreads,
                  C::kBytes, p, stream, shape);
  }
  using C = Db<D>;
  return launch(flash_dbias_bf16_kernel<D>,
                dim3((p.T + C::BK - 1) / C::BK, (p.S + C::BQ - 1) / C::BQ,
                     p.Hb),
                C::kThreads, C::kBytes, p, stream, shape);
}

int run_f32(int which, const Params& p, cudaStream_t stream, int* shape) {
  const int nq_f = (p.S + Tiles::kFwdQ - 1) / Tiles::kFwdQ;
  const int nq_d = (p.S + Tiles::kDqQ - 1) / Tiles::kDqQ;
  if (which == 0)
    return launch(flash_fwd_kernel, dim3(p.B * p.H, nq_f), kThreads,
                  fwd_layout(p.D).bytes, p, stream, shape);
  if (which == 1)
    return launch(flash_dq_kernel, dim3(p.B * p.H, nq_d), kThreads,
                  dq_layout(p.D).bytes, p, stream, shape);
  if (which == 2)
    return launch(flash_dkv_f32_kernel,
                  dim3(p.B * p.KV, (p.T + kDkvK32 - 1) / kDkvK32), kThreads,
                  dkv_layout_f32(p.D).bytes, p, stream, shape);
  const int nq_b = (p.S + Tiles::kDbQ - 1) / Tiles::kDbQ;
  const int nk_b = (p.T + Tiles::kDbK - 1) / Tiles::kDbK;
  return launch(flash_dbias_kernel, dim3(p.Hb, nq_b, nk_b), kThreads,
                dbias_layout(p.D).bytes, p, stream, shape);
}

int run_bf16(int which, const Params& p, cudaStream_t stream, int* shape) {
  if (which == 0 || which == 1) return run_fq_bf16(which, p, stream, shape);
  switch (p.D) {
    case 16: return run_dkv_dbias_bf16<16>(which, p, stream, shape);
    case 32: return run_dkv_dbias_bf16<32>(which, p, stream, shape);
    case 64: return run_dkv_dbias_bf16<64>(which, p, stream, shape);
    default: return run_dkv_dbias_bf16<128>(which, p, stream, shape);
  }
}

int dispatch(int which, Params p, int dtype, void* stream,
             int* shape = nullptr) {
  if (p.B <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.S <= 0 || p.T <= 0 ||
      !(p.D == 16 || p.D == 32 || p.D == 64 || p.D == 128) ||
      (p.qseg == nullptr) != (p.kseg == nullptr) ||
      (p.bias != nullptr && !(p.Hb == 1 || p.Hb == p.H)) ||
      (which == 3 && p.bias == nullptr && shape == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.warps != 0)  // the f32 kernels have fixed tiles
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return run_f32(which, p, s, shape);
  if (dtype == 1) return run_bf16(which, p, s, shape);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* bias, const int* qseg, const int* kseg, int B,
                   int H, int KV, int Hb, int S, int T, int D, int causal,
                   float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.qseg = qseg;
  p.kseg = kseg;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Hb = Hb;
  p.S = S;
  p.T = T;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; qseg / kseg both null or both given;
// bias null (Hb ignored) or f32 [Hb, S, T] with Hb = 1 or H.  Each returns
// the cudaError_t of its launch (0 on success).

// out_f32: null, or an f32 [B*H, S, D] copy of the output before its
// rounding to q's dtype (the backward's delta = rowsum(do * o) is taken
// from it: see ops/flash_attention.py).  warps: the forward's and dq's
// launch shape, W warps of 16 query rows (0: the default rule; see
// run_fq_bf16), bf16 only.
int tdx_flash_fwd(const void* q, const void* k, const void* v,
                  const float* bias, const int* qseg, const int* kseg,
                  void* out, float* lse, float* out_f32, int B, int H, int KV,
                  int Hb, int S, int T, int D, int causal, int dtype,
                  int warps, float scale, void* stream) {
  Params p = make_params(q, k, v, bias, qseg, kseg, B, H, KV, Hb, S, T, D,
                         causal, scale);
  p.warps = warps;
  p.out = out;
  p.lse = lse;
  p.o32 = out_f32;
  return dispatch(0, p, dtype, stream);
}

int tdx_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const float* bias, const int* qseg, const int* kseg,
                     void* dq, int B, int H, int KV, int Hb, int S, int T,
                     int D, int causal, int dtype, int warps, float scale,
                     void* stream) {
  Params p = make_params(q, k, v, bias, qseg, kseg, B, H, KV, Hb, S, T, D,
                         causal, scale);
  p.warps = warps;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.out = dq;
  return dispatch(1, p, dtype, stream);
}

int tdx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, const int* qseg, const int* kseg,
                      void* dk, void* dv, int B, int H, int KV, int Hb, int S,
                      int T, int D, int causal, int dtype, float scale,
                      void* stream) {
  Params p = make_params(q, k, v, bias, qseg, kseg, B, H, KV, Hb, S, T, D,
                         causal, scale);
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return dispatch(2, p, dtype, stream);
}

// dbias: f32 [Hb, S, T], every element written.
int tdx_flash_dbias(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const float* bias, const int* qseg, const int* kseg,
                    float* dbias, int B, int H, int KV, int Hb, int S, int T,
                    int D, int causal, int dtype, float scale, void* stream) {
  Params p = make_params(q, k, v, bias, qseg, kseg, B, H, KV, Hb, S, T, D,
                         causal, scale);
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.out = dbias;
  return dispatch(3, p, dtype, stream);
}

// Kernel `which` (0 forward, 1 dq, 2 dk/dv, 3 d(bias)) at head dim D and
// dtype, for a launch with (bias = 1) or without a bias: shape[0] = its
// CTAs that fit on one SM, shape[1] = threads a CTA, shape[2] = dynamic
// shared memory bytes.  Launches nothing.
int tdx_flash_launch_shape(int which, int D, int dtype, int bias, int* shape) {
  static const float no_data = 0.f;  // a bias pointer, never read
  Params p = make_params(nullptr, nullptr, nullptr, bias ? &no_data : nullptr,
                         nullptr, nullptr, 1, 1, 1, 1, 1, 1, D, 0, 1.f);
  return dispatch(which, p, dtype, nullptr, shape);
}

const char* tdx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
