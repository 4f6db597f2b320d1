// Fused all-to-all x expert matmul kernels for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the three Pallas TPU kernels of the MoE datapath:
//   a2a_mm_kernel    <- accl_tpu/ops/collective_alltoall.py  _a2a_mm_kernel     (dispatch)
//   mm_a2a_kernel    <- accl_tpu/ops/collective_alltoall.py  _mm_a2a_kernel     (combine)
//   a2a_wgrad_kernel <- accl_tpu/ops/collective_alltoall.py  _a2a_wgrad_kernel  (their dw)
//
// Rank model, as in ring.cu: every rank's operand is reached through a
// per-rank pointer table (RankPtrs); on one card each entry is a rank's row
// of a (P, ...) tensor.
//
//   dispatch: x[s] (P, el, C, K) token blocks by destination rank, w[r]
//             (el, K, N) -> out[r] (el, P*C, N) f32 with
//             out[r][e][s*C + i] = sum_k x[s][r*el + e][i][k] * w[r][e][k]
//   combine:  h[s] (el, P*C, K) activations by destination rank, w[s]
//             (el, K, N) -> out[r] (P*el, C, N) in the wire type with
//             out[r][s*el + e][i] = round(sum_k h[s][e][r*C + i][k] * w[s][e][k])
//   wgrad:    t[s] (P*el, C, ct) blocks by destination, l[r] (el, P*C, cl)
//             by source -> out[r] (el, ct, cl) f32 with
//             out[r][e] = sum_s t[s][r*el + e]^T l[r][e][s*C ..], or the
//             mirror (el, cl, ct) = l[r][e]^T t[s][r*el + e] summed over s.
//
// On a TPU the exchange steps overlap the MXU work block by block. On one
// card there is no wire to hide: every (destination, source, expert) block
// is one independent product, read where its source rank keeps it, and the
// kernel computes them all at once. Each block of 256 threads computes a
// 64 x 64 output tile of one such product with a plain tiled matmul: the
// A and B tiles of depth 16 are staged in shared memory as f32 (each
// operand's value converted exactly), and every thread accumulates a 4 x 4
// sub-tile with f32 fused multiply-adds in ascending k, so integer-valued
// operands give exact results. Ragged tiles are masked; nothing is padded
// in device memory. The combine rounds each output once to the wire type
// (round to nearest even), the local block included.
//
// The wgrad. On a TPU the travelling blocks ride the flat exchange and each
// arrival's per-expert contraction over its token rows is added into the
// f32 dw panel: first the local block, then at step u channel 0's arrival
// from rank r - u and channel 1's (bidirectional) from rank r + u. On the
// card a block owns one 64 x 64 tile of one (rank, expert) dw panel and
// loops over the source ranks in that order, each partial computed fresh
// (fmaf over the C rows, ascending) and added to the tile's sum in
// registers. Both operands are staged as depth-16 row slabs read along
// their columns.
//
// Bound. A product of (M x K) by (K x N) does 2 M K N flops on 4 (M K + K N)
// + 4 M N bytes at most; at the MoE shapes (K and N in the hundreds to
// thousands) the f32 operations on the CUDA cores bound it (about 67
// TFLOP/s on an H100 SXM, not the tensor cores' 495 TF32 / 989 bf16). This
// kernel is the simple correct one: wgmma, TMA and a deeper pipeline are
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define A2A_MAX_RANKS 64
#define A2A_THREADS 256
#define TILE 64
#define BK 16

// dtype codes: the values of accl_tpu_torch.constants.dataType
enum { DT_F16 = 2, DT_F32 = 3, DT_BF16 = 7 };

struct RankPtrs {
  void* p[A2A_MAX_RANKS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// The staged depth-kn slabs' contribution to a thread's 4 x 4 share acc:
// thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of the tile, so a warp's shared-memory reads of Bs
// are consecutive; f32 fused multiply-adds in ascending k.
__device__ __forceinline__ void tile_fma(const float (&As)[BK][TILE + 4],
                                         const float (&Bs)[BK][TILE + 4], int kn,
                                         float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k = 0; k < kn; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// One 64 x 64 tile (rows m0.., columns n0..) of O = A B, A (M x K) and B
// (K x N) row-major, O (M x N) row-major; the stores to O coalesce.
template <typename TA, typename TB, typename TO>
__device__ void gemm_tile(const TA* __restrict__ A, const TB* __restrict__ B,
                          TO* __restrict__ O, int M, int N, int K, int m0, int n0) {
  __shared__ float As[BK][TILE + 4];  // As[k][m]
  __shared__ float Bs[BK][TILE + 4];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
  zero_tile(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int t = tid; t < TILE * BK; t += A2A_THREADS) {
      const int m = t / BK, k = t % BK, gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(A[(long long)gm * K + gk]) : 0.0f;
    }
    for (int t = tid; t < BK * TILE; t += A2A_THREADS) {
      const int k = t / TILE, n = t % TILE, gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, min(BK, K - k0), acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) O[(long long)gm * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

// A thread's 4 x 4 share of the 64 x 64 tile (rows m0.., columns n0..) of
// A^T B, A (K x M, lda) and B (K x N, ldb) row-major, into p: the
// contraction runs over the rows of both, so each depth-16 slab is read
// along its rows, neighbouring threads on neighbouring columns. Every thread
// of the block must call it (it synchronises).
template <typename TA, typename TB>
__device__ void tile_product_tn(const TA* __restrict__ A, long long lda,
                                const TB* __restrict__ B, long long ldb, int M, int N, int K,
                                int m0, int n0, float (&p)[4][4], float (&As)[BK][TILE + 4],
                                float (&Bs)[BK][TILE + 4]) {
  const int tid = threadIdx.x;
  zero_tile(p);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int t = tid; t < BK * TILE; t += A2A_THREADS) {
      const int k = t / TILE, m = t % TILE, gk = k0 + k, gm = m0 + m;
      As[k][m] = (gk < K && gm < M) ? to_f32(A[(long long)gk * lda + gm]) : 0.0f;
    }
    for (int t = tid; t < BK * TILE; t += A2A_THREADS) {
      const int k = t / TILE, n = t % TILE, gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * ldb + gn]) : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, min(BK, K - k0), p);
    __syncthreads();
  }
}

// Grid: x the column tiles of N, y (source rank, row tile of C), z
// (destination rank, local expert).
template <typename TA, typename TB>
__global__ void __launch_bounds__(A2A_THREADS)
a2a_mm_kernel(RankPtrs x, RankPtrs w, RankPtrs out, int P, int el, int C, int K, int N) {
  const int tiles = (C + TILE - 1) / TILE;
  const int s = blockIdx.y / tiles, m0 = (blockIdx.y % tiles) * TILE;
  const int r = blockIdx.z / el, e = blockIdx.z % el;
  const TA* A = static_cast<const TA*>(x.p[s]) + (long long)(r * el + e) * C * K;
  const TB* B = static_cast<const TB*>(w.p[r]) + (long long)e * K * N;
  float* O = static_cast<float*>(out.p[r]) + ((long long)e * P * C + (long long)s * C) * N;
  gemm_tile<TA, TB, float>(A, B, O, C, N, K, m0, blockIdx.x * TILE);
}

// Grid: x the column tiles of N, y (source rank, row tile of C), z
// (destination rank, local expert of the source).
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(A2A_THREADS)
mm_a2a_kernel(RankPtrs h, RankPtrs w, RankPtrs out, int P, int el, int C, int K, int N) {
  const int tiles = (C + TILE - 1) / TILE;
  const int s = blockIdx.y / tiles, m0 = (blockIdx.y % tiles) * TILE;
  const int r = blockIdx.z / el, e = blockIdx.z % el;
  const TA* A = static_cast<const TA*>(h.p[s]) + ((long long)e * P * C + (long long)r * C) * K;
  const TB* B = static_cast<const TB*>(w.p[s]) + (long long)e * K * N;
  TO* O = static_cast<TO*>(out.p[r]) + (long long)(s * el + e) * C * N;
  gemm_tile<TA, TB, TO>(A, B, O, C, N, K, m0, blockIdx.x * TILE);
}

// Grid: x the column tiles of the dw panel, y its row tiles, z (rank r,
// local expert e). LHS: out[r][e] (ct, cl); else (cl, ct). The sources in
// the exchange's order: r itself, then for u = 1.. channel 0's r - u (u <=
// T0) and channel 1's r + u (u <= T1).
template <typename TT, typename TL, bool LHS>
__global__ void __launch_bounds__(A2A_THREADS)
a2a_wgrad_kernel(RankPtrs trav, RankPtrs loc, RankPtrs out, int P, int el, int C, int ct, int cl,
                 int nchan) {
  __shared__ float As[BK][TILE + 4];
  __shared__ float Bs[BK][TILE + 4];
  const int r = blockIdx.z / el, e = blockIdx.z % el;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int M = LHS ? ct : cl, N = LHS ? cl : ct;
  const int T0 = nchan == 2 ? P / 2 : P - 1, T1 = nchan == 2 ? (P - 1) / 2 : 0;
  float acc[4][4], part[4][4];
  for (int u = 0; u <= T0; ++u) {
    for (int chan = 0; chan < 2; ++chan) {
      if (chan == 1 && (u == 0 || u > T1)) continue;
      const int s = chan == 0 ? (r - u + P) % P : (r + u) % P;
      const TT* T = static_cast<const TT*>(trav.p[s]) + (long long)(r * el + e) * C * ct;
      const TL* L = static_cast<const TL*>(loc.p[r]) + ((long long)e * P + s) * C * cl;
      if (LHS)
        tile_product_tn<TT, TL>(T, ct, L, cl, M, N, C, m0, n0, part, As, Bs);
      else
        tile_product_tn<TL, TT>(L, cl, T, ct, M, N, C, m0, n0, part, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = u == 0 ? part[i][j] : acc[i][j] + part[i][j];
    }
  }
  float* O = static_cast<float*>(out.p[r]) + (long long)e * ct * cl;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) O[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename TA, typename TB>
static const void* pick_out(int combine, int odt) {
  if (!combine) return odt == DT_F32 ? (const void*)a2a_mm_kernel<TA, TB> : nullptr;
  switch (odt) {
    case DT_F32: return (const void*)mm_a2a_kernel<TA, TB, float>;
    case DT_BF16: return (const void*)mm_a2a_kernel<TA, TB, __nv_bfloat16>;
    case DT_F16: return (const void*)mm_a2a_kernel<TA, TB, __half>;
  }
  return nullptr;
}

template <typename TA>
static const void* pick_b(int combine, int bdt, int odt) {
  switch (bdt) {
    case DT_F32: return pick_out<TA, float>(combine, odt);
    case DT_BF16: return pick_out<TA, __nv_bfloat16>(combine, odt);
    case DT_F16: return pick_out<TA, __half>(combine, odt);
  }
  return nullptr;
}

static const void* resolve(int combine, int adt, int bdt, int odt) {
  switch (adt) {
    case DT_F32: return pick_b<float>(combine, bdt, odt);
    case DT_BF16: return pick_b<__nv_bfloat16>(combine, bdt, odt);
    case DT_F16: return pick_b<__half>(combine, bdt, odt);
  }
  return nullptr;
}

template <typename TT, bool LHS>
static const void* pick_wgrad(int ldt) {
  switch (ldt) {
    case DT_F32: return (const void*)a2a_wgrad_kernel<TT, float, LHS>;
    case DT_BF16: return (const void*)a2a_wgrad_kernel<TT, __nv_bfloat16, LHS>;
    case DT_F16: return (const void*)a2a_wgrad_kernel<TT, __half, LHS>;
  }
  return nullptr;
}

template <bool LHS>
static const void* pick_wgrad_trav(int tdt, int ldt) {
  switch (tdt) {
    case DT_F32: return pick_wgrad<float, LHS>(ldt);
    case DT_BF16: return pick_wgrad<__nv_bfloat16, LHS>(ldt);
    case DT_F16: return pick_wgrad<__half, LHS>(ldt);
  }
  return nullptr;
}

static RankPtrs table(const uint64_t* ptrs, int P) {
  RankPtrs t;
  memset(&t, 0, sizeof(t));
  for (int i = 0; i < P; ++i) t.p[i] = reinterpret_cast<void*>(ptrs[i]);
  return t;
}

extern "C" {

// One launch of a2a_mm_kernel (combine = 0) or mm_a2a_kernel (combine = 1):
// a, b, o are the per-rank pointer tables of A (x or h), the expert weights
// and the output; adt, bdt, odt their dtype codes.
int accl_a2a_mm(int combine, int adt, int bdt, int odt, const uint64_t* a, const uint64_t* b,
                const uint64_t* o, int P, int el, int C, int K, int N, void* stream) {
  const void* fn = resolve(combine, adt, bdt, odt);
  if (fn == nullptr || P < 1 || P > A2A_MAX_RANKS || el < 1 || C < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const long long gy = (long long)P * ((C + TILE - 1) / TILE), gz = (long long)P * el;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  RankPtrs ta = table(a, P), tb = table(b, P), to = table(o, P);
  void* args[] = {&ta, &tb, &to, &P, &el, &C, &K, &N};
  const dim3 grid((N + TILE - 1) / TILE, (unsigned)gy, (unsigned)gz);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(A2A_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of a2a_wgrad_kernel: t, l, o are the per-rank pointer tables of
// the (P*el, C, ct) travelling blocks, the (el, P*C, cl) resident operands
// and the f32 dw panels, (el, ct, cl) when lhs is 1 and (el, cl, ct) when 0;
// tdt, ldt the operands' dtype codes; nchan the exchange's channels (1 or 2).
int accl_a2a_wgrad(int tdt, int ldt, int lhs, const uint64_t* t, const uint64_t* l,
                   const uint64_t* o, int P, int el, int C, int ct, int cl, int nchan,
                   void* stream) {
  const void* fn = lhs ? pick_wgrad_trav<true>(tdt, ldt) : pick_wgrad_trav<false>(tdt, ldt);
  if (fn == nullptr || P < 1 || P > A2A_MAX_RANKS || el < 1 || C < 1 || ct < 1 || cl < 1 ||
      nchan < 1 || nchan > 2)
    return (int)cudaErrorInvalidValue;
  const long long rows = ((lhs ? ct : cl) + TILE - 1) / TILE, gz = (long long)P * el;
  const long long cols = ((lhs ? cl : ct) + TILE - 1) / TILE;
  if (rows > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  RankPtrs tt = table(t, P), tl = table(l, P), to = table(o, P);
  void* args[] = {&tt, &tl, &to, &P, &el, &C, &ct, &cl, &nchan};
  const dim3 grid((unsigned)cols, (unsigned)rows, (unsigned)gz);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(A2A_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* accl_a2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
