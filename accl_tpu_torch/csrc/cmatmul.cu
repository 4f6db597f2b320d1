// Collective-matmul kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the five Pallas TPU kernels of the tensor-parallel collective
// matmuls and their backward (accl_tpu/ops/collective_matmul.py):
//   agmm_kernel  <- _agmm_kernel (:418, resident) and _agmm_stream_kernel (:676, k-blocked)
//   mmrs_kernel  <- _mmrs_kernel (:543, resident) and _mmrs_stream_kernel (:896, k-blocked)
//   wgrad_kernel <- _wgrad_kernel (:1050, the gathered wgrad of both backward passes)
//
// Rank model, as in ring.cu and a2a.cu: every rank's operand is reached
// through a per-rank pointer table (RankPtrs); on one card each entry is a
// rank's row of a (P, ...) tensor, and a later slice may point the entries
// at peer-mapped cards.
//
//   agmm: x[s] (m, k) row shard of rank s, w[r] (k, n) -> out[r] (P m, n) f32
//         out[r][s m + i] = sum_k x[s][i][k] w[r][k]        (all_gather(x) @ w)
//   mmrs: x[q] (P mc, k), w[q] (k, n) -> out[r] (mc, n) f32, chunk r of
//         reduce_scatter(x @ w): the partials x[q][r mc + i] @ w[q] folded in
//         the ring's order (below), the travelling sum rounded to the wire
//         type before each hop.
//   wgrad: trav[s] (ms, ct) shard of rank s, loc[r] (P ms, cl) ->
//         out[r] (ct, cl) f32 = sum_s trav[s]^T loc[r][s ms ..] (all_gather(trav)^T
//         @ loc), or the mirror (cl, ct) = loc[r]^T all_gather(trav).
//
// agmm. On a TPU each arriving shard is multiplied while the next hop is in
// flight; the resident body holds the whole shard in VMEM, the streaming
// body stages it in k-blocks and sums the blocks' products in an f32
// accumulator. Either way every output block is one product over the whole
// k, so on the card one kernel computes all of them: a block of 256 threads
// owns a 64 x 64 output tile of one (destination r, hop t) pair, stages
// depth-16 A and B tiles in shared memory as f32 (each operand's value
// converted exactly) and sums with fmaf in ascending k; integer-valued
// operands give exact results whatever the TPU's k-blocking. The shard of
// hop t is read from its source rank through the pointer table in the
// ring's order for the tile's channel: rows of the first half (channel 0)
// come from rank r - t, rows of the second half (channel 1, bidirectional
// rings only) from rank r + t. The accumulator-blocking arm (the TPU body
// runs one streaming kernel per mb row block) is one launch per row block
// [r0, r1), each with its own channel split `half`.
//
// mmrs. On a TPU the accumulator travels the ring: chunk c starts as rank
// c's partial and each hop adds the next rank's, rounding the traveller to
// the wire type before it is sent (acc = wire(acc) + partial, the add in
// f32, the final fold not rounded). Blocks on the card cannot carry a sum
// from one to the next, so a block owns one 64 x 64 output tile of one
// chunk r and keeps the travelling accumulator in registers across a loop
// over the P hops, which takes the place of the sequential ring: hop t's
// partial is computed fresh (fmaf over k, ascending) and folded in. Channel
// 0 folds ranks r, r+1, ..., r-1; channel 1 (rows from `split` on, the
// second half of the padded chunk) folds r, r-1, ..., r+1. No reduction
// crosses blocks. The TPU's realignment hop is the output indexing. The
// accumulator-blocking arm (one streaming kernel per nb column block) is one
// launch per column block [c0, c1).
//
// wgrad. On a TPU the traveller's shards ride the agmm ring and each
// arrival's dim-0-contracting partial is added into the dw panel while the
// next hop is in flight: o = c(local rows of channel 0) + c(local rows of
// channel 1), then hop t adds channel 0's arrival from rank r - t - 1 and
// channel 1's from rank r + t + 1. On the card a block owns one 64 x 64 dw
// tile of one rank and loops over those segments in that order, each
// partial computed fresh (fmaf over its rows, ascending) and added to the
// tile's sum in registers; no reduction crosses blocks. The contraction runs
// over rows, so both operands are staged as depth-16 row slabs, read along
// their columns (no transposed global reads). The streaming arm (the TPU
// body runs one kernel per ctb column block of the traveller) is one launch
// per block [c0, c1).
//
// Bound. Each product of (M x K) by (K x N) does 2 M K N flops; at the
// tensor-parallel shapes (K and N in the thousands) the f32 operations bound
// the three kernels on the CUDA cores (about 67 TFLOP/s on an H100 SXM; the TF32
// tensor cores' 495 TFLOP/s is a later redesign's target). This is the
// simple correct kernel; wgmma, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define CM_MAX_RANKS 64
#define CM_THREADS 256
#define TILE 64
#define BK 16

// dtype codes: the values of accl_tpu_torch.constants.dataType (0: no wire)
enum { DT_NONE = 0, DT_F16 = 2, DT_F32 = 3, DT_BF16 = 7 };

struct RankPtrs {
  void* p[CM_MAX_RANKS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// The value the wire carries: round to nearest even in TW, back to f32.
template <typename TW> __device__ __forceinline__ float wire_round(float v);
template <> __device__ __forceinline__ float wire_round<float>(float v) { return v; }
template <> __device__ __forceinline__ float wire_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float wire_round<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// The staged slabs' contribution, depth kn, to a thread's 4 x 4 share p:
// thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of the tile, so a warp's shared-memory reads of Bs
// are consecutive.
__device__ __forceinline__ void tile_fma(const float (&As)[BK][TILE + 4],
                                         const float (&Bs)[BK][TILE + 4], int kn,
                                         float (&p)[4][4]) {
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
      for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i], b[j], p[i][j]);
  }
}

__device__ __forceinline__ void zero_tile(float (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
}

// One thread's 4 x 4 share of the 64 x 64 tile (rows m0.., columns n0..) of
// A B, A (M x K, leading dimension lda) and B (K x N, ldb) row-major, into
// p, summed with fmaf in ascending k (tile_fma), so its output stores
// coalesce. Every thread of the block must call it (it synchronises).
template <typename TA, typename TB>
__device__ void tile_product(const TA* __restrict__ A, long long lda, const TB* __restrict__ B,
                             long long ldb, int M, int N, int K, int m0, int n0,
                             float (&p)[4][4], float (&As)[BK][TILE + 4],
                             float (&Bs)[BK][TILE + 4]) {
  const int tid = threadIdx.x;
  zero_tile(p);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int t = tid; t < TILE * BK; t += CM_THREADS) {
      const int m = t / BK, k = t % BK, gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(A[(long long)gm * lda + gk]) : 0.0f;
    }
    for (int t = tid; t < BK * TILE; t += CM_THREADS) {
      const int k = t / TILE, n = t % TILE, gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * ldb + gn]) : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, min(BK, K - k0), p);
    __syncthreads();
  }
}

// tile_product of A^T B with A (K x M, lda) and B (K x N, ldb) row-major:
// the contraction runs over the rows of both, so each depth-16 slab of A and
// of B is read along its rows, neighbouring threads on neighbouring columns.
template <typename TA, typename TB>
__device__ void tile_product_tn(const TA* __restrict__ A, long long lda,
                                const TB* __restrict__ B, long long ldb, int M, int N, int K,
                                int m0, int n0, float (&p)[4][4], float (&As)[BK][TILE + 4],
                                float (&Bs)[BK][TILE + 4]) {
  const int tid = threadIdx.x;
  zero_tile(p);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int t = tid; t < BK * TILE; t += CM_THREADS) {
      const int k = t / TILE, m = t % TILE, gk = k0 + k, gm = m0 + m;
      As[k][m] = (gk < K && gm < M) ? to_f32(A[(long long)gk * lda + gm]) : 0.0f;
    }
    for (int t = tid; t < BK * TILE; t += CM_THREADS) {
      const int k = t / TILE, n = t % TILE, gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * ldb + gn]) : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, min(BK, K - k0), p);
    __syncthreads();
  }
}

// Store a thread's 4 x 4 share into O (leading dimension ldo), masked to
// M rows and N columns.
__device__ __forceinline__ void store_tile(float* __restrict__ O, long long ldo, int M, int N,
                                           int m0, int n0, const float (&v)[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) O[(long long)gm * ldo + gn] = v[i][j];
    }
  }
}

// Rows [lo, hi) of tile y of a row range split in two channels: channel 0
// takes rows [a0, a1) in tiles0 tiles, channel 1 rows [a1, a2).
__device__ __forceinline__ int tile_rows(int y, int tiles0, int a0, int a1, int a2, int* lo,
                                         int* hi) {
  if (y < tiles0) {
    *lo = a0 + y * TILE;
    *hi = a1;
    return 0;
  }
  *lo = a1 + (y - tiles0) * TILE;
  *hi = a2;
  return 1;
}

// Grid: x the column tiles of n, y (channel, row tile of the block rows
// [r0, r1), channel 1 from `half`), z (destination rank r, hop t).
template <typename TA, typename TB>
__global__ void __launch_bounds__(CM_THREADS)
agmm_kernel(RankPtrs x, RankPtrs w, RankPtrs out, int P, int m, int k, int n, int r0, int r1,
            int half, int tiles0) {
  __shared__ float As[BK][TILE + 4];
  __shared__ float Bs[BK][TILE + 4];
  int lo, hi;
  const int chan = tile_rows(blockIdx.y, tiles0, r0, half, r1, &lo, &hi);
  const int r = blockIdx.z / P, t = blockIdx.z % P;
  const int s = chan == 0 ? (r - t + P) % P : (r + t) % P;
  const TA* A = static_cast<const TA*>(x.p[s]) + (long long)lo * k;
  const TB* B = static_cast<const TB*>(w.p[r]);
  float* O = static_cast<float*>(out.p[r]) + ((long long)s * m + lo) * n;
  float acc[4][4];
  const int n0 = blockIdx.x * TILE;
  tile_product<TA, TB>(A, k, B, n, hi - lo, n, k, 0, n0, acc, As, Bs);
  store_tile(O, n, hi - lo, n, 0, n0, acc);
}

// Grid: x the column tiles of [c0, c1), y (channel, row tile of the chunk's
// mc rows, channel 1 from `split`), z the chunk (destination rank) r.
template <typename TA, typename TB, typename TW>
__global__ void __launch_bounds__(CM_THREADS)
mmrs_kernel(RankPtrs x, RankPtrs w, RankPtrs out, int P, int mc, int k, int n, int c0, int c1,
            int split, int tiles0) {
  __shared__ float As[BK][TILE + 4];
  __shared__ float Bs[BK][TILE + 4];
  int lo, hi;
  const int chan = tile_rows(blockIdx.y, tiles0, 0, split, mc, &lo, &hi);
  const int r = blockIdx.z, n0 = blockIdx.x * TILE;
  const int N = c1 - c0;
  float acc[4][4], part[4][4];
  for (int t = 0; t < P; ++t) {
    const int q = chan == 0 ? (r + t) % P : (r - t + P) % P;
    const TA* A = static_cast<const TA*>(x.p[q]) + ((long long)r * mc + lo) * k;
    const TB* B = static_cast<const TB*>(w.p[q]) + c0;
    tile_product<TA, TB>(A, k, B, n, hi - lo, N, k, 0, n0, part, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = t == 0 ? part[i][j] : wire_round<TW>(acc[i][j]) + part[i][j];
  }
  float* O = static_cast<float*>(out.p[r]) + (long long)lo * n + c0;
  store_tile(O, n, hi - lo, N, 0, n0, acc);
}

// Grid: x the column tiles of the dw panel, y its row tiles, z the rank r.
// LHS: out[r] rows [c0, c1) of (ct, cl); else columns [c0, c1) of (cl, ct).
// Segments in the ring's order: hop t of channel 0 brings rank r - t's rows
// [0, split), of channel 1 (rows [split, ms), bidirectional rings only)
// rank r + t's; hop 0 is the local shard.
template <typename TT, typename TL, bool LHS>
__global__ void __launch_bounds__(CM_THREADS)
wgrad_kernel(RankPtrs trav, RankPtrs loc, RankPtrs out, int P, int ms, int ct, int cl, int c0,
             int c1, int split) {
  __shared__ float As[BK][TILE + 4];
  __shared__ float Bs[BK][TILE + 4];
  const int r = blockIdx.z, m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int M = LHS ? c1 - c0 : cl, N = LHS ? cl : c1 - c0;
  const int nchan = split < ms ? 2 : 1;
  float acc[4][4], part[4][4];
  for (int t = 0; t < P; ++t) {
    for (int chan = 0; chan < nchan; ++chan) {
      const int s = chan == 0 ? (r - t + P) % P : (r + t) % P;
      const int lo = chan == 0 ? 0 : split, hi = chan == 0 ? split : ms;
      const TT* T = static_cast<const TT*>(trav.p[s]) + (long long)lo * ct + c0;
      const TL* L = static_cast<const TL*>(loc.p[r]) + ((long long)s * ms + lo) * cl;
      if (LHS)
        tile_product_tn<TT, TL>(T, ct, L, cl, M, N, hi - lo, m0, n0, part, As, Bs);
      else
        tile_product_tn<TL, TT>(L, cl, T, ct, M, N, hi - lo, m0, n0, part, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = (t == 0 && chan == 0) ? part[i][j] : acc[i][j] + part[i][j];
    }
  }
  float* O = static_cast<float*>(out.p[r]) + (LHS ? (long long)c0 * cl : (long long)c0);
  store_tile(O, LHS ? cl : ct, M, N, m0, n0, acc);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename TA>
static const void* pick_agmm(int wdt) {
  switch (wdt) {
    case DT_F32: return (const void*)agmm_kernel<TA, float>;
    case DT_BF16: return (const void*)agmm_kernel<TA, __nv_bfloat16>;
    case DT_F16: return (const void*)agmm_kernel<TA, __half>;
  }
  return nullptr;
}

static const void* resolve_agmm(int xdt, int wdt) {
  switch (xdt) {
    case DT_F32: return pick_agmm<float>(wdt);
    case DT_BF16: return pick_agmm<__nv_bfloat16>(wdt);
    case DT_F16: return pick_agmm<__half>(wdt);
  }
  return nullptr;
}

template <typename TA, typename TB>
static const void* pick_wire(int wire) {
  switch (wire) {
    case DT_NONE: return (const void*)mmrs_kernel<TA, TB, float>;
    case DT_BF16: return (const void*)mmrs_kernel<TA, TB, __nv_bfloat16>;
    case DT_F16: return (const void*)mmrs_kernel<TA, TB, __half>;
  }
  return nullptr;
}

template <typename TA>
static const void* pick_mmrs(int wdt, int wire) {
  switch (wdt) {
    case DT_F32: return pick_wire<TA, float>(wire);
    case DT_BF16: return pick_wire<TA, __nv_bfloat16>(wire);
    case DT_F16: return pick_wire<TA, __half>(wire);
  }
  return nullptr;
}

static const void* resolve_mmrs(int xdt, int wdt, int wire) {
  switch (xdt) {
    case DT_F32: return pick_mmrs<float>(wdt, wire);
    case DT_BF16: return pick_mmrs<__nv_bfloat16>(wdt, wire);
    case DT_F16: return pick_mmrs<__half>(wdt, wire);
  }
  return nullptr;
}

template <typename TT, bool LHS>
static const void* pick_wgrad(int ldt) {
  switch (ldt) {
    case DT_F32: return (const void*)wgrad_kernel<TT, float, LHS>;
    case DT_BF16: return (const void*)wgrad_kernel<TT, __nv_bfloat16, LHS>;
    case DT_F16: return (const void*)wgrad_kernel<TT, __half, LHS>;
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

static const void* resolve_wgrad(int tdt, int ldt, int lhs) {
  return lhs ? pick_wgrad_trav<true>(tdt, ldt) : pick_wgrad_trav<false>(tdt, ldt);
}

static RankPtrs table(const uint64_t* ptrs, int P) {
  RankPtrs t;
  memset(&t, 0, sizeof(t));
  for (int i = 0; i < P; ++i) t.p[i] = reinterpret_cast<void*>(ptrs[i]);
  return t;
}

static int tiles(int rows) { return (rows + TILE - 1) / TILE; }

extern "C" {

// One launch of agmm_kernel over rows [r0, r1) of every shard, channel 1
// from row `half` (r1 for a one-channel ring): x, w, o are the per-rank
// pointer tables of the (m, k) shards, the (k, n) weights and the (P m, n)
// f32 outputs; xdt, wdt the operands' dtype codes.
int accl_cmatmul_agmm(int xdt, int wdt, const uint64_t* x, const uint64_t* w, const uint64_t* o,
                      int P, int m, int k, int n, int r0, int r1, int half, void* stream) {
  const void* fn = resolve_agmm(xdt, wdt);
  if (fn == nullptr || P < 1 || P > CM_MAX_RANKS || m < 1 || k < 1 || n < 1 || r0 < 0 ||
      r1 > m || r0 >= r1 || half < r0 || half > r1)
    return (int)cudaErrorInvalidValue;
  int tiles0 = tiles(half - r0);
  const long long gy = tiles0 + tiles(r1 - half), gz = (long long)P * P;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), tw = table(w, P), to = table(o, P);
  void* args[] = {&tx, &tw, &to, &P, &m, &k, &n, &r0, &r1, &half, &tiles0};
  const dim3 grid((n + TILE - 1) / TILE, (unsigned)gy, (unsigned)gz);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(CM_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of mmrs_kernel over columns [c0, c1), channel 1 from chunk row
// `split` (mc for a one-channel ring): x, w, o are the per-rank pointer
// tables of the (P mc, k) rows, the (k, n) weights and the (mc, n) f32
// outputs; wire the dtype code the traveller is rounded to (0: none).
int accl_cmatmul_mmrs(int xdt, int wdt, int wire, const uint64_t* x, const uint64_t* w,
                      const uint64_t* o, int P, int mc, int k, int n, int c0, int c1, int split,
                      void* stream) {
  const void* fn = resolve_mmrs(xdt, wdt, wire);
  if (fn == nullptr || P < 1 || P > CM_MAX_RANKS || mc < 1 || k < 1 || n < 1 || c0 < 0 ||
      c1 > n || c0 >= c1 || split < 0 || split > mc)
    return (int)cudaErrorInvalidValue;
  int tiles0 = tiles(split);
  const long long gy = tiles0 + tiles(mc - split);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), tw = table(w, P), to = table(o, P);
  void* args[] = {&tx, &tw, &to, &P, &mc, &k, &n, &c0, &c1, &split, &tiles0};
  const dim3 grid((c1 - c0 + TILE - 1) / TILE, (unsigned)gy, (unsigned)P);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(CM_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of wgrad_kernel over the traveller's columns [c0, c1), channel
// 1 from shard row `split` (ms for a one-channel ring): t, l, o are the
// per-rank pointer tables of the (ms, ct) shards, the (P ms, cl) resident
// operands and the f32 dw panels, (ct, cl) when lhs is 1 and (cl, ct) when
// 0; tdt, ldt the operands' dtype codes.
int accl_cmatmul_wgrad(int tdt, int ldt, int lhs, const uint64_t* t, const uint64_t* l,
                       const uint64_t* o, int P, int ms, int ct, int cl, int c0, int c1,
                       int split, void* stream) {
  const void* fn = resolve_wgrad(tdt, ldt, lhs);
  if (fn == nullptr || P < 1 || P > CM_MAX_RANKS || ms < 1 || ct < 1 || cl < 1 || c0 < 0 ||
      c1 > ct || c0 >= c1 || split < 1 || split > ms)
    return (int)cudaErrorInvalidValue;
  const int rows = lhs ? c1 - c0 : cl, cols = lhs ? cl : c1 - c0;
  if (tiles(rows) > 65535) return (int)cudaErrorInvalidValue;
  RankPtrs tt = table(t, P), tl = table(l, P), to = table(o, P);
  void* args[] = {&tt, &tl, &to, &P, &ms, &ct, &cl, &c0, &c1, &split};
  const dim3 grid((unsigned)tiles(cols), (unsigned)tiles(rows), (unsigned)P);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(CM_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* accl_cmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
