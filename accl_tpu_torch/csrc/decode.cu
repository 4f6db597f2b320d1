// Paged flash-decode kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replace the two Pallas TPU kernels of the serving arm
// (accl_tpu/ops/flash.py, one call site in _flash_decode_paged, :1786):
//   flash_decode_kernel      <- _decode_kernel (:1590): one query row per
//                               GQA head, every decode step
//   flash_decode_span_kernel <- _decode_span_kernel (:1661): span query rows
//                               per head with per-row causal horizons, every
//                               chunk of a chunked prefill
// Both are one device template, decode_body; the two entry points exist so
// that each kernel's launches count on their own.
//
// Layout: q (B, H_kv, gp, 128) in TQ (f32 or bf16), the g * span query rows
// of a slot's KV head laid out (g, span) and padded to gp; the pools
// (H_kv, n_pages, page, 128) in TKV (f32, bf16 or int8); the block table
// (B, pages_max) and the lengths (B,) int32; out like q. Row r of a tile
// attends the slot's positions < len - span + 1 + r % span (span 1: < len).
// Scores are q.k scaled by c = scale log2(e) and exponentiated with exp2;
// the masked value is -1e30; the running max, normalizer and output
// accumulator follow the TPU kernels' online softmax (:1620-1650). int8
// pages are widened and multiplied by the inverse scale (the per-(head,
// page) one looked up through the same table entry as the page, else the
// fixed codec's); with a bf16 pool p is rounded to bf16 before P.V (the TPU
// kernel's p.astype(vb.dtype)) while l sums the unrounded p. A slot of
// length 0 folds nothing and writes exact zeros.
//
// Tiles. On a TPU a grid step is (slot, KV head, page) and the online-
// softmax state rides VMEM scratch across the sequential page axis. Here a
// block owns (slot, KV head, tile of R query rows: R = 16 for gp <= 16, the
// decode tile, else 64) and walks the slot's chain itself in ascending
// order through the block table, one page per online-softmax step as on the
// TPU (a page over 64 rows in parts of 64, each its own step), up to the
// tile's largest horizon: pages past it are dead and skipped, as dead pages
// are on the TPU (a dead page that a TPU row still visits is an exact no-op
// there). Each live page's K and V rows are staged in shared memory as f32
// (rows of 129 floats); 256 threads, thread (ty, tx)
// = (tid / 16, tid % 16) owns query rows ty + 16 i (i < R / 16) and
// positions tx + 16 j (j < 4) of the score tile and columns tx + 16 jj
// (jj < 8) of the output; the 16 threads of a row are half a warp, so row
// maxima and sums are shuffles. Products are fmaf loops in ascending index.
//
// Bound. Decode reads each live page of every slot's chain once: at a
// serving batch it moves bytes, not flops (about 2 g flops per byte of f32
// K/V), so the card's 3.35 TB/s bounds it. A prefill chunk does 4 d flops
// per (row, attended position) and is bound by the f32 rate of the CUDA
// cores (66.9 TFLOP/s). This is the simple correct kernel: split-K across
// pages for the decode's occupancy, TMA page loads and wgmma for the
// prefill tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define DC_THREADS 256
#define DC_D 128            // the head dim the kernels take
#define DC_BK 64            // the most positions of one step
#define DC_DPAD (DC_D + 1)  // row stride of a staged q, K or V row
#define DC_PST (DC_BK + 1)  // row stride of a staged score tile

// dtype codes: the values of accl_tpu_torch.constants.dataType
enum { DT_I8 = 1, DT_F32 = 3, DT_BF16 = 7 };

#define DC_NEG_INF (-1e30f)

struct DecodeArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* lens;
  const float* inv;  // per-(head, page) inverse scales, or null
  void* out;
  int B, hkv, gp, n_pages, page, pmax, span;
  float c, kv_inv;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename TQ, typename TKV, int NI, bool SPAN>
__device__ __forceinline__ void decode_body(const DecodeArgs& a) {
  extern __shared__ float smem[];
  constexpr int R = 16 * NI;
  constexpr bool INT8 = std::is_same<TKV, int8_t>::value;
  constexpr bool P_BF16 = std::is_same<TKV, __nv_bfloat16>::value;
  float* Qs = smem;                 // R x DC_DPAD
  float* Ks = Qs + R * DC_DPAD;     // DC_BK x DC_DPAD
  float* Vs = Ks + DC_BK * DC_DPAD;
  float* Ps = Vs + DC_BK * DC_DPAD;  // R x DC_PST
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int length = a.lens[b];
  const int cap = a.pmax * a.page;
  const int span = SPAN ? a.span : 1;

  // each row's horizon, capped at the chain's capacity (the TPU grid walks
  // pages_max pages and no further)
  int hz[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    hz[i] = min(length - span + 1 + (SPAN ? r % span : 0), cap);
  }
  // the tile's largest horizon, from the largest r % span over its rows
  const int r1 = min(r0 + R, a.gp);
  int top = 0;
  if (SPAN) {
    if (r1 - r0 >= span) {
      top = span - 1;
    } else {
      const int lo = r0 % span, hi = (r1 - 1) % span;
      top = lo <= hi ? hi : span - 1;
    }
  }
  const int ncols = min(length - span + 1 + top, cap);

  const long long qoff = ((long long)b * a.hkv + h) * a.gp * DC_D;
  const TQ* qb = static_cast<const TQ*>(a.q) + qoff;
  for (int t = threadIdx.x; t < R * DC_D; t += DC_THREADS) {
    const int r = t / DC_D, col = t % DC_D;
    Qs[r * DC_DPAD + col] = r0 + r < a.gp ? to_f32(qb[(long long)(r0 + r) * DC_D + col]) : 0.0f;
  }
  const long long hoff = (long long)h * a.n_pages * a.page * DC_D;
  const TKV* kh = static_cast<const TKV*>(a.kp) + hoff;
  const TKV* vh = static_cast<const TKV*>(a.vp) + hoff;
  const int* btb = a.bt + (long long)b * a.pmax;

  float acc[NI][DC_D / 16], m[NI], l[NI], alpha[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = DC_NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DC_D / 16; ++jj) acc[i][jj] = 0.0f;
  }
  // the walk: page j of the chain, in parts of up to 64 rows (one part for
  // a page of 64 rows or fewer, whose online-softmax step is then the TPU's)
  for (int c0 = 0, rows = 0; c0 < ncols; c0 += rows) {
    const int j = c0 / a.page, in_page = c0 % a.page;
    rows = min(DC_BK, a.page - in_page);  // this step's positions
    const int pg = btb[j];
    float inv = 1.0f;
    if (INT8) inv = a.inv ? a.inv[(long long)h * a.n_pages + pg] : a.kv_inv;
    const TKV* kpg = kh + ((long long)pg * a.page + in_page) * DC_D;
    const TKV* vpg = vh + ((long long)pg * a.page + in_page) * DC_D;
    __syncthreads();
    for (int t = threadIdx.x; t < DC_BK * DC_D; t += DC_THREADS) {
      const int r = t / DC_D, col = t % DC_D;
      float kv = 0.0f, vv = 0.0f;
      if (r < rows && c0 + r < ncols) {
        kv = to_f32(kpg[r * DC_D + col]);
        vv = to_f32(vpg[r * DC_D + col]);
        if (INT8) {
          kv = __fmul_rn(kv, inv);
          vv = __fmul_rn(vv, inv);
        }
      }
      Ks[r * DC_DPAD + col] = kv;
      Vs[r * DC_DPAD + col] = vv;
    }
    __syncthreads();
    float s[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int cc = 0; cc < DC_D; ++cc) {
      float qa[NI], kb[4];
#pragma unroll
      for (int i = 0; i < NI; ++i) qa[i] = Qs[(ty + 16 * i) * DC_DPAD + cc];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DC_DPAD + cc];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float mx = DC_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = __fmul_rn(s[i][j], a.c);
        const int col = tx + 16 * j;
        if (col >= rows || c0 + col >= hz[i]) x = DC_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, p);
        s[i][j] = P_BF16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      alpha[i] = exp2f(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum16(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * DC_PST + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    float pv[NI][DC_D / 16];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int jj = 0; jj < DC_D / 16; ++jj) pv[i][jj] = 0.0f;
#pragma unroll 4
    for (int rr = 0; rr < DC_BK; ++rr) {
      float pa[NI], vb[DC_D / 16];
#pragma unroll
      for (int i = 0; i < NI; ++i) pa[i] = Ps[(ty + 16 * i) * DC_PST + rr];
#pragma unroll
      for (int jj = 0; jj < DC_D / 16; ++jj) vb[jj] = Vs[rr * DC_DPAD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int jj = 0; jj < DC_D / 16; ++jj) pv[i][jj] = fmaf(pa[i], vb[jj], pv[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int jj = 0; jj < DC_D / 16; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], alpha[i]), pv[i][jj]);
  }
  TQ* ob = static_cast<TQ*>(a.out) + qoff;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= a.gp) continue;
    const float safe_l = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int jj = 0; jj < DC_D / 16; ++jj)
      ob[(long long)r * DC_D + tx + 16 * jj] = from_f32<TQ>(__fdiv_rn(acc[i][jj], safe_l));
  }
}

// Grid: x the query-row tiles, y the KV heads, z the slots.
template <typename TQ, typename TKV, int NI>
__global__ void __launch_bounds__(DC_THREADS) flash_decode_kernel(DecodeArgs a) {
  decode_body<TQ, TKV, NI, false>(a);
}

template <typename TQ, typename TKV, int NI>
__global__ void __launch_bounds__(DC_THREADS) flash_decode_span_kernel(DecodeArgs a) {
  decode_body<TQ, TKV, NI, true>(a);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <int NI>
static size_t smem_bytes() {
  return (size_t)(16 * NI * DC_DPAD + 2 * DC_BK * DC_DPAD + 16 * NI * DC_PST) * sizeof(float);
}

template <typename TQ, typename TKV, int NI>
static int go(bool span, const DecodeArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes<NI>();
  auto kernel = span ? flash_decode_span_kernel<TQ, TKV, NI> : flash_decode_kernel<TQ, TKV, NI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.gp + 16 * NI - 1) / (16 * NI), a.hkv, a.B);
  kernel<<<grid, DC_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
static int go_tile(bool span, const DecodeArgs& a, cudaStream_t st) {
  return a.gp <= 16 ? go<TQ, TKV, 1>(span, a, st) : go<TQ, TKV, 4>(span, a, st);
}

template <typename TQ>
static int go_kv(int kvdt, bool span, const DecodeArgs& a, cudaStream_t st) {
  switch (kvdt) {
    case DT_F32: return go_tile<TQ, float>(span, a, st);
    case DT_BF16: return go_tile<TQ, __nv_bfloat16>(span, a, st);
    case DT_I8: return go_tile<TQ, int8_t>(span, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

static int dispatch(int qdt, int kvdt, bool span, const void* q, const void* kp, const void* vp,
                    const void* bt, const void* lens, const void* inv, void* out, int B, int hkv,
                    int gp, int d, int n_pages, int page, int pmax, int sp, float c, float kv_inv,
                    void* stream) {
  if (B < 1 || B > 65535 || hkv < 1 || hkv > 65535 || gp < 1 || d != DC_D || n_pages < 1 ||
      page < 1 || pmax < 1 || sp < 1 || (!span && sp != 1))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a = {};
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.bt = static_cast<const int*>(bt);
  a.lens = static_cast<const int*>(lens);
  a.inv = static_cast<const float*>(inv);
  a.out = out;
  a.B = B;
  a.hkv = hkv;
  a.gp = gp;
  a.n_pages = n_pages;
  a.page = page;
  a.pmax = pmax;
  a.span = sp;
  a.c = c;
  a.kv_inv = kv_inv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qdt) {
    case DT_F32: return go_kv<float>(kvdt, span, a, st);
    case DT_BF16: return go_kv<__nv_bfloat16>(kvdt, span, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Kernel 29: one decode step, span 1. qdt / kvdt are dtype codes; inv is
// the (H_kv, n_pages) inverse-scale table of a per-page int8 pool or null;
// kv_inv the fixed int8 codec's inverse scale; c is scale log2(e).
int accl_decode_paged(int qdt, int kvdt, const void* q, const void* kp, const void* vp,
                      const void* bt, const void* lens, const void* inv, void* out, int B,
                      int hkv, int gp, int d, int n_pages, int page, int pmax, int span, float c,
                      float kv_inv, void* stream) {
  return dispatch(qdt, kvdt, false, q, kp, vp, bt, lens, inv, out, B, hkv, gp, d, n_pages, page,
                  pmax, span, c, kv_inv, stream);
}

// Kernel 30: span query rows per head, laid out (g, span) in gp rows.
int accl_decode_span(int qdt, int kvdt, const void* q, const void* kp, const void* vp,
                     const void* bt, const void* lens, const void* inv, void* out, int B,
                     int hkv, int gp, int d, int n_pages, int page, int pmax, int span, float c,
                     float kv_inv, void* stream) {
  return dispatch(qdt, kvdt, true, q, kp, vp, bt, lens, inv, out, B, hkv, gp, d, n_pages, page,
                  pmax, span, c, kv_inv, stream);
}

const char* accl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
