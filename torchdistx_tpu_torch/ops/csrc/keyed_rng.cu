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
// are bitwise equal to it.  logf, sinf, cosf and sqrtf are the precise
// library functions (no fast-math intrinsics).
//
// Bound: bytes written (each output element once) over the card's memory
// rate; Philox's 10 rounds are integer multiplies that the SMs hide
// behind the stores only when enough blocks are in flight.  Design: one
// thread per 4 consecutive elements of the region, a grid-stride loop,
// the Philox block cached across the 4 (consecutive elements of a row
// share a block), one 16-byte (f32) or 8-byte (16-bit) store where
// aligned.  Global indices come from the region's merged dims: the host
// merges every dim whose inner neighbours are whole, so a shard that is
// contiguous in the full tensor (an expert's slab) is one run and needs
// no division at all.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;

struct Region {
  int ndim;                     // merged dims, the last of stride 1
  long long len[kMaxDims];      // the region's length per merged dim
  long long fstride[kMaxDims];  // the full tensor's stride per merged dim
  long long base;               // the global index of the region's first element
};

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// The global index of local element i, and the length left in its run.
__device__ __forceinline__ long long global_index(const Region& r,
                                                  long long i,
                                                  long long* left) {
  const int last = r.ndim - 1;
  if (last == 0) {
    *left = r.len[0] - i;
    return r.base + i;
  }
  long long g = r.base;
  const long long L = r.len[last];
  long long q, c;
  if (i < 0xFFFFFFFFll && L < 0xFFFFFFFFll) {
    const uint32_t i32 = static_cast<uint32_t>(i);
    const uint32_t L32 = static_cast<uint32_t>(L);
    q = i32 / L32;
    c = i32 - static_cast<uint32_t>(q) * L32;
  } else {
    q = i / L;
    c = i - q * L;
  }
  *left = L - c;
  g += c;
  for (int d = last - 1; d > 0; --d) {
    const long long n = r.len[d];
    const long long qq = q / n;
    g += (q - qq * n) * r.fstride[d];
    q = qq;
  }
  return g + q * r.fstride[0];
}

template <int KIND>
__device__ __forceinline__ float draw(const uint32_t c[4], int lane, float a,
                                      float b) {
  if (KIND == 0) {
    const float u = static_cast<float>(c[lane] >> 8) * 5.9604644775390625e-08f;
    return __fadd_rn(a, __fmul_rn(b, u));  // b = hi - lo
  }
  const int p = lane & 2;
  const float u1 =
      static_cast<float>((c[p] >> 8) + 1u) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(c[p + 1] >> 8) * 5.9604644775390625e-08f;
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float t = __fmul_rn(6.28318548202514648f, u2);
  const float z = __fmul_rn(rad, (lane & 1) ? sinf(t) : cosf(t));
  return __fadd_rn(a, __fmul_rn(b, z));
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
__device__ __forceinline__ void store4(T* p, const T v[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const T v[4]) {
  uint2 w;
  w.x = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v[0])) |
        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v[1])) << 16);
  w.y = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v[2])) |
        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = w;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    keyed_rng_kernel(T* __restrict__ out, Region region, long long n,
                     uint32_t k0, uint32_t k1, float a, float b) {
  const long long n4 = (n + 3) / 4;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < n4; t += step) {
    const long long i0 = 4 * t;
    long long left = 0;
    long long g = global_index(region, i0, &left);
    long long cached = -1;
    uint32_t c[4] = {0, 0, 0, 0};
    T v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = i0 + k;
      if (i >= n) break;
      if (k > 0) {
        if (left > 1) {
          ++g;
          --left;
        } else {
          g = global_index(region, i, &left);
        }
      }
      const long long blk = g >> 2;
      if (blk != cached) {
        c[0] = static_cast<uint32_t>(blk);
        c[1] = static_cast<uint32_t>(static_cast<unsigned long long>(blk) >> 32);
        c[2] = 0;
        c[3] = 0;
        philox(c, k0, k1);
        cached = blk;
      }
      v[k] = to_out<T>(draw<KIND>(c, static_cast<int>(g & 3), a, b));
    }
    T* p = out + i0;
    if (i0 + 3 < n &&
        (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0) {
      store4<T>(p, v);
    } else {
      for (int k = 0; k < 4 && i0 + k < n; ++k) p[k] = v[k];
    }
  }
}

template <typename T>
void launch(void* out, int kind, const Region& r, long long n, uint32_t k0,
            uint32_t k1, float a, float b, int blocks, cudaStream_t s) {
  if (kind == 0) {
    keyed_rng_kernel<T, 0><<<blocks, kThreads, 0, s>>>(
        static_cast<T*>(out), r, n, k0, k1, a, b);
  } else {
    keyed_rng_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
        static_cast<T*>(out), r, n, k0, k1, a, b);
  }
}

}  // namespace

extern "C" {

// Fill `out` (n contiguous elements of `dtype`: 0 f32, 1 bf16, 2 f16) with
// the draws of `kind` (0 uniform with a = lo and b = hi - lo, 1 normal with
// a = mean and b = std) of the region given by its merged dims (`ndim` <= 8
// lengths and full strides, the last stride 1) and its first element's
// global index; key = (k0, k1).  Returns cudaGetLastError() after the
// launch.
int tdx_keyed_rng(void* out, int dtype, int kind, int ndim,
                  const long long* len, const long long* fstride,
                  long long base, long long n, unsigned int k0,
                  unsigned int k1, float a, float b, void* stream) {
  if (ndim < 1 || ndim > kMaxDims || n < 0 || dtype < 0 || dtype > 2 ||
      kind < 0 || kind > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Region r;
  r.ndim = ndim;
  for (int d = 0; d < kMaxDims; ++d) {
    r.len[d] = d < ndim ? len[d] : 1;
    r.fstride[d] = d < ndim ? fstride[d] : 0;
  }
  r.base = base;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long n4 = (n + 3) / 4;
  long long want = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(out, kind, r, n, k0, k1, a, b, blocks, s); break;
    case 1: launch<__nv_bfloat16>(out, kind, r, n, k0, k1, a, b, blocks, s); break;
    default: launch<__half>(out, kind, r, n, k0, k1, a, b, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tdx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
