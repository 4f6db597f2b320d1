// Plugin-lane kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the three elementwise Pallas TPU kernels of the plugin lanes:
//   combine_kernel  <- accl_tpu/ops/reduce_ops.py   _combine_kernel  (a ⊕ b)
//   cast_kernel     <- accl_tpu/ops/compression.py  _cast_kernel     (wire casts)
//   sr_kernel       <- accl_tpu/ops/compression.py  _sr_kernel       (f32 -> bf16,
//                                                                     stochastic round)
//
// The TPU kernels walk (W, rows, lanes) VMEM tiles; here there is no tile
// to fill, so each kernel is one grid-stride loop over the flat elements,
// launched with a thread per 16-byte vector (the loop then runs once):
// 16-byte vector accesses when every pointer is 16-byte aligned, a scalar
// loop for the tail (or for everything when a pointer is not aligned).
//
// Bound. Each kernel reads its inputs once and writes its output once with
// a few integer or float operations per element, so device memory bandwidth
// bounds it (3.35 TB/s on an H100 SXM): combine moves 3 n t bytes, a cast
// n (t_src + t_dst), stochastic rounding 6 n. The hash of the stochastic
// round costs about a dozen integer operations per element, far under the
// card's integer rate at that bandwidth.
//
// Numbers, as the JAX package computes them on the CPU:
//  * bf16 / f16 SUM add in f32 and round once (RNE); int32 SUM wraps.
//  * MAX is IEEE-754 maximum (jnp.maximum): a NaN operand propagates, +0 > -0.
//    It returns one operand unchanged, compared in f32 where widening is
//    exact.
//  * Narrowing casts round to nearest even, overflow to +-inf, keep
//    subnormals. A NaN becomes XLA's quiet NaN of the same sign: bf16
//    sign|0x7FC0; f16 sign|0x7E00|(f32 mantissa >> 13). Widening is exact;
//    a NaN widens as the Pallas lane widens it: f16 to
//    sign|0x7FC00000|(mantissa << 13), bf16 to sign|0x7FC00000. (The bare
//    cvt instructions return their own canonical NaN, so NaN is handled
//    here by bits.)
//  * Stochastic rounding, finite x: the top 16 bits of bits(x) + (h & 0xFFFF),
//    h a 32-bit counter-based hash of (seed, element index within its row);
//    +-inf is unchanged, NaN as in the cast. The TPU kernel draws its bits
//    from the core's PRNG seeded with (seed, grid position); the index plays
//    the grid position's part, so no two elements share a draw.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PLUGIN_THREADS 256

// dtype codes: the values of accl_tpu_torch.constants.dataType
enum { DT_F16 = 2, DT_F32 = 3, DT_I32 = 5, DT_BF16 = 7 };

// ---------------------------------------------------------------------------
// element conversions by bits (storage: float, int32, or uint16 for bf16/f16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  if ((h & 0x7F80u) == 0x7F80u && (h & 0x7Fu) != 0u)
    return __uint_as_float(((uint32_t)(h & 0x8000u) << 16) | 0x7FC00000u);
  return __uint_as_float((uint32_t)h << 16);
}

__device__ __forceinline__ float f16_to_f32(uint16_t h) {
  if ((h & 0x7C00u) == 0x7C00u && (h & 0x3FFu) != 0u)
    return __uint_as_float(((uint32_t)(h & 0x8000u) << 16) | 0x7FC00000u |
                           ((uint32_t)(h & 0x3FFu) << 13));
  return __half2float(__ushort_as_half(h));
}

__device__ __forceinline__ bool is_nan_bits(uint32_t u) {
  return (u & 0x7FFFFFFFu) > 0x7F800000u;
}

__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if (is_nan_bits(u)) return (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint16_t f32_to_f16(float f) {
  const uint32_t u = __float_as_uint(f);
  if (is_nan_bits(u))
    return (uint16_t)(((u >> 16) & 0x8000u) | 0x7E00u | ((u & 0x7FFFFFu) >> 13));
  return __half_as_ushort(__float2half_rn(f));
}

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

template <int DT> struct Elem;
template <> struct Elem<DT_F32> { using S = float; };
template <> struct Elem<DT_I32> { using S = int32_t; };
template <> struct Elem<DT_BF16> { using S = uint16_t; };
template <> struct Elem<DT_F16> { using S = uint16_t; };

template <int DT> __device__ __forceinline__ float widen(typename Elem<DT>::S v) {
  if constexpr (DT == DT_BF16) return bf16_to_f32(v);
  else if constexpr (DT == DT_F16) return f16_to_f32(v);
  else return v;
}

// IEEE-754 maximum, compared in f32: true when max(a, b) is b. When both
// are NaN, jnp.maximum on the CPU returns a if a's sign bit is set, else b.
__device__ __forceinline__ bool max_is_second(float a, float b) {
  if (a != a) return b != b && !(__float_as_uint(a) >> 31);
  if (b != b) return true;
  if (a == b) return (__float_as_uint(a) >> 31) && !(__float_as_uint(b) >> 31);
  return b > a;
}

template <int DT, int FUNC>
__device__ __forceinline__ typename Elem<DT>::S op(typename Elem<DT>::S a,
                                                   typename Elem<DT>::S b) {
  if constexpr (DT == DT_I32) {
    if constexpr (FUNC == 0) return (int32_t)((uint32_t)a + (uint32_t)b);
    else return b > a ? b : a;
  } else if constexpr (FUNC == 1) {
    return max_is_second(widen<DT>(a), widen<DT>(b)) ? b : a;
  } else if constexpr (DT == DT_F32) {
    return a + b;
  } else if constexpr (DT == DT_BF16) {
    return f32_to_bf16(bf16_to_f32(a) + bf16_to_f32(b));
  } else {
    return f32_to_f16(f16_to_f32(a) + f16_to_f32(b));
  }
}

template <typename S> union Vec16 {
  uint4 u;
  S s[16 / sizeof(S)];
};

template <int DT, int FUNC>
__global__ void __launch_bounds__(PLUGIN_THREADS)
combine_kernel(const typename Elem<DT>::S* a, const typename Elem<DT>::S* b,
               typename Elem<DT>::S* out, long long n, int vec_ok) {
  using S = typename Elem<DT>::S;
  constexpr int V = 16 / sizeof(S);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = 0;
  if (vec_ok) {
    const long long nv = n / V;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      Vec16<S> x, y, z;
      x.u = av[i];
      y.u = bv[i];
#pragma unroll
      for (int k = 0; k < V; ++k) z.s[k] = op<DT, FUNC>(x.s[k], y.s[k]);
      ov[i] = z.u;
    }
    start = nv * V;
  }
  for (long long i = start + tid; i < n; i += stride) out[i] = op<DT, FUNC>(a[i], b[i]);
}

// ---------------------------------------------------------------------------
// casts
// ---------------------------------------------------------------------------

template <int SRC, int DST> __device__ __forceinline__ typename Elem<DST>::S cvt(
    typename Elem<SRC>::S v) {
  if constexpr (SRC == DT_F32 && DST == DT_BF16) return f32_to_bf16(v);
  else if constexpr (SRC == DT_F32 && DST == DT_F16) return f32_to_f16(v);
  else if constexpr (SRC == DT_BF16) return bf16_to_f32(v);
  else return f16_to_f32(v);
}

// four elements per vector step: 16 bytes on the f32 side, 8 on the other
template <int SRC, int DST>
__global__ void __launch_bounds__(PLUGIN_THREADS)
cast_kernel(const typename Elem<SRC>::S* x, typename Elem<DST>::S* out, long long n,
            int vec_ok) {
  using Si = typename Elem<SRC>::S;
  using So = typename Elem<DST>::S;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = 0;
  if (vec_ok) {
    const long long nv = n / 4;
    for (long long i = tid; i < nv; i += stride) {
      Si in[4];
      So o[4];
      if constexpr (sizeof(Si) == 4) {
        const float4 f = reinterpret_cast<const float4*>(x)[i];
        in[0] = f.x; in[1] = f.y; in[2] = f.z; in[3] = f.w;
      } else {
        const uint2 h = reinterpret_cast<const uint2*>(x)[i];
        in[0] = (uint16_t)(h.x & 0xFFFFu); in[1] = (uint16_t)(h.x >> 16);
        in[2] = (uint16_t)(h.y & 0xFFFFu); in[3] = (uint16_t)(h.y >> 16);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = cvt<SRC, DST>(in[k]);
      if constexpr (sizeof(So) == 4) {
        reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        reinterpret_cast<uint2*>(out)[i] =
            make_uint2((uint32_t)o[0] | ((uint32_t)o[1] << 16),
                       (uint32_t)o[2] | ((uint32_t)o[3] << 16));
      }
    }
    start = nv * 4;
  }
  for (long long i = start + tid; i < n; i += stride) out[i] = cvt<SRC, DST>(x[i]);
}

// ---------------------------------------------------------------------------
// stochastic rounding f32 -> bf16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the draw of element `idx` of a row seeded with `key` = fmix32(seed)
__device__ __forceinline__ uint16_t sr_one(float f, uint32_t key, uint32_t idx) {
  const uint32_t u = __float_as_uint(f);
  if (is_nan_bits(u)) return (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
  const uint32_t h = fmix32((idx * 0x9E3779B9u) ^ key);
  return (uint16_t)((u + (h & 0xFFFFu)) >> 16);
}

// x: (rows, cols) f32; row blockIdx.y takes seeds[row] (or `seed` when
// seeds is null); the index is the column
__global__ void __launch_bounds__(PLUGIN_THREADS)
sr_kernel(const float* x, uint16_t* out, const int32_t* seeds, int seed, long long cols,
          int vec_ok) {
  const long long row = blockIdx.y;
  const uint32_t key = fmix32((uint32_t)(seeds ? seeds[row] : seed));
  const float* xr = x + row * cols;
  uint16_t* orow = out + row * cols;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = 0;
  if (vec_ok) {
    const long long nv = cols / 4;
    for (long long i = tid; i < nv; i += stride) {
      const float4 f = reinterpret_cast<const float4*>(xr)[i];
      const uint32_t c = (uint32_t)(i * 4);
      const uint32_t o0 = sr_one(f.x, key, c), o1 = sr_one(f.y, key, c + 1);
      const uint32_t o2 = sr_one(f.z, key, c + 2), o3 = sr_one(f.w, key, c + 3);
      reinterpret_cast<uint2*>(orow)[i] = make_uint2(o0 | (o1 << 16), o2 | (o3 << 16));
    }
    start = nv * 4;
  }
  for (long long i = start + tid; i < cols; i += stride)
    orow[i] = sr_one(xr[i], key, (uint32_t)i);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// blocks for `work` items per row: one item per thread. (The loops stride
// by the grid all the same, so a grid capped below this stays correct.)
static unsigned blocks_for(long long work) {
  long long b = (work + PLUGIN_THREADS - 1) / PLUGIN_THREADS;
  if (b > 0x7FFFFFFFll) b = 0x7FFFFFFFll;
  return (unsigned)(b < 1 ? 1 : b);
}

template <int DT, int FUNC>
static cudaError_t launch_combine(const void* a, const void* b, void* out, long long n,
                                  cudaStream_t stream) {
  using S = typename Elem<DT>::S;
  const int vec_ok = aligned16(a) && aligned16(b) && aligned16(out);
  const unsigned blocks = blocks_for(vec_ok ? n / (16 / (long long)sizeof(S)) + 1 : n);
  combine_kernel<DT, FUNC><<<blocks, PLUGIN_THREADS, 0, stream>>>(
      static_cast<const S*>(a), static_cast<const S*>(b), static_cast<S*>(out), n, vec_ok);
  return cudaGetLastError();
}

template <int DT>
static cudaError_t combine_dt(int func, const void* a, const void* b, void* out, long long n,
                              cudaStream_t s) {
  if (func == 0) return launch_combine<DT, 0>(a, b, out, n, s);
  if (func == 1) return launch_combine<DT, 1>(a, b, out, n, s);
  return cudaErrorInvalidValue;
}

template <int SRC, int DST>
static cudaError_t launch_cast(const void* x, void* out, long long n, cudaStream_t stream) {
  const int vec_ok = aligned16(x) && aligned16(out);
  const unsigned blocks = blocks_for(vec_ok ? n / 4 + 1 : n);
  cast_kernel<SRC, DST><<<blocks, PLUGIN_THREADS, 0, stream>>>(
      static_cast<const typename Elem<SRC>::S*>(x), static_cast<typename Elem<DST>::S*>(out),
      n, vec_ok);
  return cudaGetLastError();
}

extern "C" {

// out = a ⊕ b over n elements (func 0 = SUM, 1 = MAX); out may be a.
int accl_plugins_combine(int dtype, int func, const void* a, const void* b, void* out,
                        long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (dtype) {
    case DT_F32: return (int)combine_dt<DT_F32>(func, a, b, out, n, s);
    case DT_BF16: return (int)combine_dt<DT_BF16>(func, a, b, out, n, s);
    case DT_F16: return (int)combine_dt<DT_F16>(func, a, b, out, n, s);
    case DT_I32: return (int)combine_dt<DT_I32>(func, a, b, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out = x cast from `src` to `dst` (one of the four CAST_PAIRS).
int accl_plugins_cast(int src, int dst, const void* x, void* out, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (src == DT_F32 && dst == DT_BF16) return (int)launch_cast<DT_F32, DT_BF16>(x, out, n, s);
  if (src == DT_BF16 && dst == DT_F32) return (int)launch_cast<DT_BF16, DT_F32>(x, out, n, s);
  if (src == DT_F32 && dst == DT_F16) return (int)launch_cast<DT_F32, DT_F16>(x, out, n, s);
  if (src == DT_F16 && dst == DT_F32) return (int)launch_cast<DT_F16, DT_F32>(x, out, n, s);
  return (int)cudaErrorInvalidValue;
}

// out (rows, cols) bf16 = stochastic round of x (rows, cols) f32; row r
// seeded by seeds[r] (device int32), or by `seed` when seeds is null.
int accl_plugins_sr(const void* x, void* out, const void* seeds, int seed, long long rows,
                   long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (rows > 65535 || cols > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const int vec_ok = aligned16(x) && aligned16(out) && (cols % 4 == 0);
  const unsigned blocks = blocks_for(vec_ok ? cols / 4 + 1 : cols);
  sr_kernel<<<dim3(blocks, (unsigned)rows), PLUGIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(out),
      static_cast<const int32_t*>(seeds), seed, cols, vec_ok);
  return (int)cudaGetLastError();
}

const char* accl_plugins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
