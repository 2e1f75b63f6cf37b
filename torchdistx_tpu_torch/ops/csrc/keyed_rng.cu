// Keyed, counter-based random draws for the materializer: Philox4x32-10
// over each element's GLOBAL index, written into a box region of the
// entry's full contiguous shape.
//
// Replaces no Pallas kernel.  It is the counterpart of the partitionable
// threefry that XLA generates for the JAX bridge's init programs
// (torchdistx_tpu/__init__.py turns jax_threefry_partitionable on, so a
// device computes only its own shard and every element's value depends
// only on (key, index)).  Here the key is the 64 bits of
// op_seed(seed, key_nr) (cuda_bridge/materialize.py) and the counter of
// element g (its flat index in the full shape) is g / 4: element g takes
// lane g % 4 of its block.  A rank draws its shard alone, and a shard
// equals its slice of the whole draw bit for bit.
//
//   uniform(lo, hi): u = (lane >> 8) * 2^-24 in [0, 1); lo + (hi - lo) * u
//   normal(mean, std): Box-Muller over the lane pairs (0, 1) and (2, 3)
//     of the element's block: u1 = ((x0 >> 8) + 1) * 2^-24 in (0, 1],
//     u2 = (x1 >> 8) * 2^-24, r = sqrt(-2 log u1), t = 2pi * u2; the even
//     lane takes r cos t, the odd lane r sin t; mean + std * z.
//
// Everything in f32, rounded once into the output dtype (f32, bf16, f16).
// Each product and sum is written with __fmul_rn / __fadd_rn so nvcc
// cannot contract them into an FMA: the plain PyTorch version
// (ops/keyed_rng.py) does the same separate roundings, and uniform draws
// are bitwise equal to it.  logf, sincosf and sqrtf are the precise
// library functions (no fast-math intrinsics); sincosf gives the bits of
// sinf and cosf on the same argument (chip_smoke.py's keyed_rng_kernel
// phase checks every t the kernel can form).
//
// Bound: bytes written (each output element once) over the card's memory
// rate.  Philox's 10 rounds are ~40 integer multiplies a block, and a
// normal pair adds a log, a square root and a sine-cosine: about 0.3 ms
// of issue for the uniform draws of Mixtral's expert stack against 0.56
// ms of stores, more for normal.  The design keeps every instruction on
// that work:
//
// * One thread per Philox block of a run (a run is a row of the region's
//   last merged dim, contiguous in the full tensor), never per 4 local
//   elements, so a run whose first element is not lane 0 still costs one
//   block per 4 elements.  The run's first and last blocks are masked
//   lane by lane.  Lanes are read from c[0..3] with static indices: no
//   register array is indexed at run time, so nothing goes to a local
//   stack frame.
// * ilp<KIND>() independent blocks per thread (2 for normal), their
//   Philox chains interleaved round by round.
// * Normal computes each pair's log, square root and sine-cosine once.
// * The host (keyed_rng.launch_plan) gives every run the same number of
//   blocks, so one division turns a thread's slot into (run, block); a
//   region of one run needs none.  Regions of a full tensor below 2^34
//   elements (a block index below 2^32) and of fewer than 2^31 local
//   elements take 32-bit index arithmetic throughout (WIDE = 0); the rest
//   take 64-bit (WIDE = 1).  At Mixtral's expert stack on an H100 the
//   64-bit path ran normal 9-12 % and bf16 uniform 13 % slower, f32
//   uniform 0.8 % (kernel_ab.py on trees that differ only in which path
//   launch_plan picks).
// * 16-byte (f32) or 8-byte (16-bit) stores where the block's 4 elements
//   are whole and aligned; scalar stores, coalesced across the warp,
//   elsewhere.
// * A grid of as many CTAs as the occupancy calculator fits on the SMs,
//   each looping over tiles of kThreads * ilp<KIND>() slots.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;
// Philox blocks a thread takes per tile: two interleaved chains for
// normal; one for uniform, which is nearer its stores' bound and ran
// faster so (at Mixtral's expert stack on an H100, bf16 by 15 % against
// two; kernel_ab.py on trees that differ in this number only).
template <int KIND>
__host__ __device__ constexpr int ilp() { return KIND == 0 ? 1 : 2; }
// The most slots the 32-bit path takes: a CTA's tile index stepping past
// the last slot by a whole grid of tiles must not wrap.
constexpr long long kNarrowSlots = (1ll << 32) - (1ll << 24);

// The launch plan (ops/keyed_rng.py::launch_plan), with each full stride
// and the base split into whole blocks and lanes: g = 4 * q + r.
struct Plan {
  int ndim;                                // merged dims, the last of stride 1
  unsigned long long len[kMaxDims];        // the region's length per merged dim
  unsigned long long stride_blk[kMaxDims]; // full stride >> 2
  unsigned int stride_lane[kMaxDims];      // full stride & 3
  unsigned long long base_blk;             // base >> 2
  unsigned int base_lane;                  // base & 3
  unsigned long long run_len;              // len[ndim - 1]
  unsigned long long slots_per_run;        // blocks given to each run
  unsigned long long slots;                // runs * slots_per_run
};

template <int DT> struct Out;
template <> struct Out<0> { using T = float; };
template <> struct Out<1> { using T = __nv_bfloat16; };
template <> struct Out<2> { using T = __half; };

template <int N>
__device__ __forceinline__ void philox(uint32_t (&c)[N][4], uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t lo0 = 0xD2511F53u * c[i][0];
      const uint32_t hi0 = __umulhi(0xD2511F53u, c[i][0]);
      const uint32_t lo1 = 0xCD9E8D57u * c[i][2];
      const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[i][2]);
      const uint32_t n0 = hi1 ^ c[i][1] ^ k0;
      const uint32_t n2 = hi0 ^ c[i][3] ^ k1;
      c[i][0] = n0;
      c[i][1] = lo1;
      c[i][2] = n2;
      c[i][3] = lo0;
    }
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// The f32 values of a block's four lanes.
template <int KIND>
__device__ __forceinline__ void lanes(const uint32_t (&c)[4], float a,
                                      float b, float (&v)[4]) {
  if (KIND == 0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float u = static_cast<float>(c[l] >> 8) * 5.9604644775390625e-08f;
      v[l] = __fadd_rn(a, __fmul_rn(b, u));  // b = hi - lo
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; p += 2) {
    const float u1 =
        static_cast<float>((c[p] >> 8) + 1u) * 5.9604644775390625e-08f;
    const float u2 =
        static_cast<float>(c[p + 1] >> 8) * 5.9604644775390625e-08f;
    const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float t = __fmul_rn(6.28318548202514648f, u2);
    float sn, cs;
    sincosf(t, &sn, &cs);
    v[p] = __fadd_rn(a, __fmul_rn(b, __fmul_rn(rad, cs)));
    v[p + 1] = __fadd_rn(a, __fmul_rn(b, __fmul_rn(rad, sn)));
  }
}

template <typename T>
__device__ __forceinline__ T to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ uint32_t bits16(T x) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  uint2 w;
  w.x = bits16(to_out<T>(v[0])) | (bits16(to_out<T>(v[1])) << 16);
  w.y = bits16(to_out<T>(v[2])) | (bits16(to_out<T>(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = w;
}
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Slot -> (the Philox block, the local index of the run's first element,
// the run-relative index j0 of the block's lane 0, which is "negative",
// wrapped, when the run starts past lane 0).  Every dim loop is unrolled,
// so the plan is read at static offsets.
template <typename I>
__device__ __forceinline__ void locate(const Plan& p, I slot, I& blk,
                                       I& row0, I& j0) {
  const int last = p.ndim - 1;
  I r = 0, s = slot;
  if (last > 0) {
    const I S = static_cast<I>(p.slots_per_run);
    r = slot / S;
    s = slot - r * S;
  }
  I b = static_cast<I>(p.base_blk);
  uint32_t low = p.base_lane;
  I q = r;
#pragma unroll
  for (int d = kMaxDims - 2; d >= 0; --d) {
    if (d >= last) continue;
    I idx = q;
    if (d > 0) {
      const I n = static_cast<I>(p.len[d]);
      const I qq = q / n;
      idx = q - qq * n;
      q = qq;
    }
    // idx * stride = 4 * (idx * q_d + (idx >> 2) * r_d) + (idx & 3) * r_d:
    // every term is at most the block index, so 32 bits hold them on the
    // narrow path.
    b += idx * static_cast<I>(p.stride_blk[d]) +
         (idx >> 2) * static_cast<I>(p.stride_lane[d]);
    low += static_cast<uint32_t>(idx & 3) * p.stride_lane[d];
  }
  blk = b + static_cast<I>(low >> 2) + s;
  row0 = r * static_cast<I>(p.run_len);
  j0 = static_cast<I>(4) * s - static_cast<I>(low & 3);
}

template <int DT, int KIND, int WIDE>
__global__ void __launch_bounds__(kThreads)
    keyed_rng_kernel(typename Out<DT>::T* __restrict__ out,
                     const __grid_constant__ Plan p, uint32_t k0,
                     uint32_t k1, float a, float b) {
  using T = typename Out<DT>::T;
  using I = typename std::conditional<WIDE != 0, unsigned long long,
                                      uint32_t>::type;
  constexpr int kIlp = ilp<KIND>();
  const I L = static_cast<I>(p.run_len);
  const I slots = static_cast<I>(p.slots);
  const I tile = static_cast<I>(kThreads * kIlp);
  const bool vec_ok =
      (reinterpret_cast<uintptr_t>(out) & (4 * sizeof(T) - 1)) == 0;
  for (I t0 = static_cast<I>(blockIdx.x) * tile; t0 < slots;
       t0 += static_cast<I>(gridDim.x) * tile) {
    uint32_t c[kIlp][4];
    I row0[kIlp], j0[kIlp];
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const I slot = t0 + static_cast<I>(i * kThreads + threadIdx.x);
      I blk;
      locate<I>(p, slot, blk, row0[i], j0[i]);
      if (slot >= slots) j0[i] = L;  // no lane lands in the run
      c[i][0] = static_cast<uint32_t>(blk);
      c[i][1] = WIDE ? static_cast<uint32_t>(
                           static_cast<unsigned long long>(blk) >> 32)
                     : 0u;
      c[i][2] = 0u;
      c[i][3] = 0u;
    }
    philox<kIlp>(c, k0, k1);
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      float v[4];
      lanes<KIND>(c[i], a, b, v);
      const I j = j0[i];
      const I o = row0[i] + j;
      if (j < L && L - j > 3 && vec_ok && (o & 3) == 0) {
        store4<T>(out + o, v);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (j + static_cast<I>(l) < L) {
            out[o + static_cast<I>(l)] = to_out<T>(v[l]);
          }
        }
      }
    }
  }
}

template <int DT, int KIND, int WIDE>
int occupancy() {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, keyed_rng_kernel<DT, KIND, WIDE>, kThreads, 0);
  return per_sm;
}

template <int DT, int KIND, int WIDE>
int launch(void* out, const Plan& p, uint32_t k0, uint32_t k1, float a,
           float b, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int per_sm = occupancy<DT, KIND, WIDE>();
  const unsigned long long tile = kThreads * ilp<KIND>();
  const unsigned long long tiles = (p.slots + tile - 1) / tile;
  const unsigned long long cap =
      static_cast<unsigned long long>(sms > 0 ? sms : 1) *
      static_cast<unsigned long long>(per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < cap ? tiles : cap);
  keyed_rng_kernel<DT, KIND, WIDE><<<blocks, kThreads, 0, s>>>(
      static_cast<typename Out<DT>::T*>(out), p, k0, k1, a, b);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_dt(void* out, int kind, int wide, const Plan& p, uint32_t k0,
              uint32_t k1, float a, float b, cudaStream_t s) {
  if (kind == 0) {
    return wide ? launch<DT, 0, 1>(out, p, k0, k1, a, b, s)
                : launch<DT, 0, 0>(out, p, k0, k1, a, b, s);
  }
  return wide ? launch<DT, 1, 1>(out, p, k0, k1, a, b, s)
              : launch<DT, 1, 0>(out, p, k0, k1, a, b, s);
}

// For every u2 = k * 2^-24 the kernel can form, t = f32(2pi) * u2: counts
// the t where sincosf's pair differs in any bit from sinf's and cosf's.
// `flip_s` and `flip_c` are 0; the compiler cannot know it, so it can
// neither fold the three arguments into one nor merge calls into one
// sincosf.
__global__ void __launch_bounds__(kThreads)
    sincos_check_kernel(unsigned int* __restrict__ count, uint32_t flip_s,
                        uint32_t flip_c) {
  const uint32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= (1u << 24)) return;
  const float t =
      __fmul_rn(6.28318548202514648f,
                static_cast<float>(k) * 5.9604644775390625e-08f);
  float sn, cs;
  sincosf(t, &sn, &cs);
  const float ts = __uint_as_float(__float_as_uint(t) ^ flip_s);
  const float tc = __uint_as_float(__float_as_uint(t) ^ flip_c);
  if (__float_as_uint(sn) != __float_as_uint(sinf(ts)) ||
      __float_as_uint(cs) != __float_as_uint(cosf(tc))) {
    atomicAdd(count, 1u);
  }
}

}  // namespace

extern "C" {

// Fill `out` (contiguous, `dtype`: 0 f32, 1 bf16, 2 f16) with the draws
// of `kind` (0 uniform with a = lo and b = hi - lo, 1 normal with a = mean
// and b = std) of the region given by its merged dims (`ndim` <= 8
// lengths and full strides, the last stride 1), its first element's
// global index `base`, and the launch plan's `slots_per_run` and `slots`
// (ops/keyed_rng.py::launch_plan); `wide` = 0 takes the 32-bit path,
// which the plan allows only below 2^34 full and 2^31 local elements.
// key = (k0, k1).  Returns cudaGetLastError() after the launch.
int tdx_keyed_rng(void* out, int dtype, int kind, int wide, int ndim,
                  const long long* len, const long long* fstride,
                  long long base, long long slots_per_run, long long slots,
                  unsigned int k0, unsigned int k1, float a, float b,
                  void* stream) {
  if (ndim < 1 || ndim > kMaxDims || dtype < 0 || dtype > 2 || kind < 0 ||
      kind > 1 || base < 0 || slots < 0 || slots_per_run < 1 ||
      (!wide && slots > kNarrowSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0) return 0;
  Plan p;
  p.ndim = ndim;
  for (int d = 0; d < kMaxDims; ++d) {
    const long long st = d < ndim ? fstride[d] : 0;
    p.len[d] = d < ndim ? static_cast<unsigned long long>(len[d]) : 1ull;
    p.stride_blk[d] = static_cast<unsigned long long>(st) >> 2;
    p.stride_lane[d] = static_cast<unsigned int>(st & 3);
  }
  p.base_blk = static_cast<unsigned long long>(base) >> 2;
  p.base_lane = static_cast<unsigned int>(base & 3);
  p.run_len = p.len[ndim - 1];
  p.slots_per_run = static_cast<unsigned long long>(slots_per_run);
  p.slots = static_cast<unsigned long long>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dt<0>(out, kind, wide, p, k0, k1, a, b, s);
    case 1: return launch_dt<1>(out, kind, wide, p, k0, k1, a, b, s);
    default: return launch_dt<2>(out, kind, wide, p, k0, k1, a, b, s);
  }
}

// CTAs per SM (the occupancy calculator's), threads per CTA and blocks
// per thread of the launch `tdx_keyed_rng` makes for (dtype, kind, wide),
// into shape[0..2].  Returns a CUDA error code.
int tdx_keyed_launch_shape(int dtype, int kind, int wide, int* shape) {
  if (dtype < 0 || dtype > 2 || kind < 0 || kind > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int (*const table[3][2][2])() = {
      {{occupancy<0, 0, 0>, occupancy<0, 0, 1>},
       {occupancy<0, 1, 0>, occupancy<0, 1, 1>}},
      {{occupancy<1, 0, 0>, occupancy<1, 0, 1>},
       {occupancy<1, 1, 0>, occupancy<1, 1, 1>}},
      {{occupancy<2, 0, 0>, occupancy<2, 0, 1>},
       {occupancy<2, 1, 0>, occupancy<2, 1, 1>}}};
  shape[0] = table[dtype][kind][wide ? 1 : 0]();
  shape[1] = kThreads;
  shape[2] = kind == 0 ? ilp<0>() : ilp<1>();
  return static_cast<int>(cudaGetLastError());
}

// Adds to the device word `count` the number of the 2^24 arguments t the
// normal draws form where sincosf does not give the bits of sinf and cosf
// (sincos_check_kernel).  Returns cudaGetLastError() after the launch.
int tdx_keyed_sincos_mismatches(unsigned int* count, unsigned int flip_s,
                                unsigned int flip_c, void* stream) {
  sincos_check_kernel<<<(1 << 24) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(count, flip_s,
                                                             flip_c);
  return static_cast<int>(cudaGetLastError());
}

const char* tdx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
