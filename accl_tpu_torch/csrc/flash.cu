// Flash attention kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replace the four Pallas TPU kernels of flash attention's training arm
// (accl_tpu/ops/flash.py):
//   flash_fwd_kernel       <- _kernel (:62, called by _flash_fwd_call :546)
//   flash_bwd_fused_kernel <- _bwd_fused_kernel (:724, call :780), with its
//                             fixed-order dQ pass flash_dq_reduce_kernel
//   flash_bwd_kv_kernel    <- _bwd_kv_kernel (:612, call :2327)
//   flash_bwd_q_kernel     <- _bwd_q_kernel (:658, call :2373)
// and the four of its head-packed d = 64 arm (flash_attention_packed, :1285;
// see "The head-packed arm" below):
//   flash_fwd_packed_kernel       <- _kernel_packed (:874, call :952)
//   flash_bwd_fused_packed_kernel <- _bwd_fused_kernel_packed (:1147, call
//                                    :1214), with flash_dq_reduce_kernel
//                                    over the packed slab
//   flash_bwd_kv_packed_kernel    <- _bwd_kv_kernel_packed (:982, call :1070)
//   flash_bwd_q_packed_kernel     <- _bwd_q_kernel_packed (:1024, call :1110)
//
// Layout: q (H, S, d), k and v (H_kv, S, d), row-major, of one type T (f32,
// bf16 or f16); q head h reads kv head h / g, g = H / H_kv, with no repeat.
// lse and the backward's row term dd (rowsum(dO o O) less dlse) are (H, S)
// f32 and every gradient is f32. Scores are q.k scaled by c = scale log2(e)
// and exponentiated with exp2; lse is stored as a natural log.
//
// Tiles. On a TPU a grid step holds a (block_q, block_k) tile and carries
// the online-softmax state (forward) or the dK/dV planes and the dQ scratch
// (backward) in VMEM from one sequential grid step to the next. Blocks on
// the card run in no order, so each block owns what it sums and loops over
// the other axis itself, as the TPU's sequential grid axis did: 256 threads,
// 64 x 64 tiles (BQ q rows by BK k rows), every operand tile staged in
// shared memory as f32 (each value converted exactly) with rows padded to
// D + 1 floats, D = 64, 96 or 128 the head dim rounded up (the padding
// columns are zero, which is exact). Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of a score tile and
// rows ty + 16 i, columns tx + 16 jj (jj < D / 16) of an output tile; the
// 16 threads of a row are one half of a warp, so row maxima and sums are
// shuffles. Every product is an fmaf loop in ascending contraction index.
//
//   forward: a block per (q tile, head) runs the online softmax over the k
//     tiles in order, skipping those wholly above the diagonal (causal): m,
//     l and the output accumulator stay in registers; p is rounded to T
//     before P.V and l sums the unrounded p, as the TPU kernel does.
//   dK/dV (two-pass and fused): a block per (k tile, kv head) keeps its K
//     and V tiles and its dK, dV accumulators and sweeps (q head of the
//     group, q tile) ascending, the TPU kernels' t order; per live tile it
//     recomputes p = exp2(s - lse log2(e)) and dS = p (dP - dd) scale once,
//     dV += P^T dO, dK += dS^T Q.
//   dQ (two-pass): a block per (q tile, head) sweeps the live k tiles in
//     order and adds each tile's dS K to its sum.
//   dQ (fused): dQ sums over k tiles that other blocks own. Atomics would
//     make the sum's order, and so its bits, depend on scheduling, so each
//     block writes its tile's dS K to an f32 slab (k tile, H, S, d), and
//     flash_dq_reduce_kernel adds the slab into dq in ascending k-tile order.
//     A long sweep runs as several launches over runs of k tiles [kt0, kt1),
//     each slab bounded by the wrapper's budget. The fused and the two-pass
//     backward thus sum the same tile products in the same order and give
//     the same bits; two runs of either give the same bits.
//
// Bound. A forward does 4 H S^2 d useful flops (half of that causal), a
// backward 2.5 times that; at the context-parallel shapes (S in the
// thousands) the f32 operations on the CUDA cores bound the kernels (about
// 67 TFLOP/s on an H100 SXM); bf16 operands go through the same f32 path.
// This is the simple correct kernel; wgmma on bf16 tiles, TMA and a
// pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FL_THREADS 256
#define BQ 64
#define BK 64
#define PST (BK + 1)  // row stride of a score tile in shared memory

// dtype codes: the values of accl_tpu_torch.constants.dataType
enum { DT_F16 = 2, DT_F32 = 3, DT_BF16 = 7 };

#define FL_NEG_INF (-1e30f)
#define FL_LOG2E 1.4426950408889634f
#define FL_LN2 0.6931471805599453f

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dd;
  void* out;
  float* lse_out;
  float* dq;
  float* dk;
  float* dv;
  float* slab;
  int H, hkv, S, d, causal, kt0, kt1;
  float c, sc;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
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

// Rows [r0, r0 + 64) of a (S, d) matrix X into Xs (rows of D + 1 floats) as
// f32, columns d .. D - 1 zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ Xs, const T* __restrict__ X, int r0,
                                          int d) {
  for (int t = threadIdx.x; t < 64 * D; t += FL_THREADS) {
    const int r = t / D, c = t % D;
    Xs[r * (D + 1) + c] = c < d ? to_f32(X[(long long)(r0 + r) * d + c]) : 0.0f;
  }
}

// s[i][j] = sum_c A[ty + 16 i][c] B[tx + 16 j][c] over the D columns.
template <int D>
__device__ __forceinline__ void tile_abt(const float* __restrict__ As,
                                         const float* __restrict__ Bs, float (&s)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// o[i][jj] += sum_r P[ty + 16 i][r] B[r][tx + 16 jj] over the tile's 64 r
// (P a score tile, B a staged operand tile): P.V and dS.K.
template <int D>
__device__ __forceinline__ void tile_pb(const float* __restrict__ Ps, const float* __restrict__ Bs,
                                        float (&o)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * PST + r];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) b[jj] = Bs[r * (D + 1) + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) o[i][jj] = fmaf(a[i], b[jj], o[i][jj]);
  }
}

// o[i][jj] += sum_r P[r][ty + 16 i] B[r][tx + 16 jj]: P^T dO and dS^T Q,
// accumulated over the q rows r of the tile in ascending order.
template <int D>
__device__ __forceinline__ void tile_ptb(const float* __restrict__ Ps, const float* __restrict__ Bs,
                                         float (&o)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Ps[r * PST + ty + 16 * i];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) b[jj] = Bs[r * (D + 1) + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) o[i][jj] = fmaf(a[i], b[jj], o[i][jj]);
  }
}

__device__ __forceinline__ void store_scores(float* __restrict__ Ps, const float (&x)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PST + tx + 16 * j] = x[i][j];
}

// Store rows [r0, r0 + 64) of an output tile o into the (S, d) f32 matrix O.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ O, int r0, int d,
                                           const float (&o)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d) O[(long long)(r0 + ty + 16 * i) * d + col] = o[i][jj];
    }
}

// p and dS of one (q tile at q0, k tile at k0), the TPU's _recompute_p_ds:
// s = (q.k) c, masked to -1e30 above the diagonal (causal); p = exp2(s - lse
// log2(e)); dP = dO.v; dS = p (dP - dd) scale. L2 and DD hold the q rows'
// lse log2(e) and dd.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* Ks, const float* dOs,
                                          const float* Vs, const float* L2, const float* DD,
                                          int q0, int k0, int causal, float c, float sc,
                                          float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4];
  tile_abt<D>(Qs, Ks, s);
  tile_abt<D>(dOs, Vs, ds);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = __fmul_rn(s[i][j], c);
      if (causal && q0 + r < k0 + tx + 16 * j) x = FL_NEG_INF;
      p[i][j] = exp2f(__fsub_rn(x, L2[r]));
      ds[i][j] = __fmul_rn(__fmul_rn(p[i][j], __fsub_rn(ds[i][j], DD[r])), sc);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_out(float (&o)[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) o[i][jj] = 0.0f;
}

// Grid: x the q tiles, y the heads.
template <typename T, int D>
__global__ void __launch_bounds__(FL_THREADS) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int NJ = D / 16;
  float* Qs = smem;
  float* Ks = Qs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* Ps = Vs + 64 * (D + 1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.y, hk = h / (a.H / a.hkv), q0 = blockIdx.x * BQ;
  const long long S = a.S, d = a.d;
  const T* kh = static_cast<const T*>(a.k) + hk * S * d;
  const T* vh = static_cast<const T*>(a.v) + hk * S * d;
  load_rows<T, D>(Qs, static_cast<const T*>(a.q) + h * S * d, q0, a.d);
  float acc[4][NJ], m[4], l[4], alpha[4];
  zero_out<D>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FL_NEG_INF;
    l[i] = 0.0f;
  }
  // causal: k tile kt is live iff kt BK < q0 + BQ
  const int nkt = a.causal ? (q0 + BQ - 1) / BK + 1 : a.S / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, D>(Ks, kh, k0, a.d);
    load_rows<T, D>(Vs, vh, k0, a.d);
    __syncthreads();
    float s[4][4];
    tile_abt<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = FL_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = __fmul_rn(s[i][j], a.c);
        if (a.causal && row < k0 + tx + 16 * j) x = FL_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, p);
        s[i][j] = to_f32(from_f32<T>(p));  // p in v's type for P.V
      }
      alpha[i] = exp2f(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum16(sum));
      m[i] = m_new;
    }
    store_scores(Ps, s);
    __syncthreads();
    float pv[4][NJ];
    zero_out<D>(pv);
    tile_pb<D>(Ps, Vs, pv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], alpha[i]), pv[i][jj]);
  }
  T* oh = static_cast<T*>(a.out) + h * S * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float safe_l = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < a.d) oh[row * d + col] = from_f32<T>(__fdiv_rn(acc[i][jj], safe_l));
    }
    if (tx == 0) a.lse_out[h * S + row] = __fadd_rn(__fmul_rn(m[i], FL_LN2), logf(safe_l));
  }
}

// The q tile at q0 of head h into Qs and dOs, its lse log2(e) into L2 and
// its dd into DD.
template <typename T, int D>
__device__ __forceinline__ void load_q_side(const FlashArgs& a, int h, int q0, float* Qs,
                                            float* dOs, float* L2, float* DD) {
  const long long off = (long long)h * a.S * a.d;
  load_rows<T, D>(Qs, static_cast<const T*>(a.q) + off, q0, a.d);
  load_rows<T, D>(dOs, static_cast<const T*>(a.dout) + off, q0, a.d);
  for (int t = threadIdx.x; t < BQ; t += FL_THREADS) {
    L2[t] = __fmul_rn(a.lse[(long long)h * a.S + q0 + t], FL_LOG2E);
    DD[t] = a.dd[(long long)h * a.S + q0 + t];
  }
}

// dK and dV of k tile kt of kv head blockIdx.y (FUSED: also each live
// tile's dQ partial into slab plane blockIdx.x). Grid: x the k tiles
// [kt0, kt1) (FUSED) or all of them, y the kv heads.
template <typename T, int D, bool FUSED>
__device__ __forceinline__ void bwd_kv_body(const FlashArgs& a) {
  extern __shared__ float smem[];
  constexpr int NJ = D / 16;
  float* Ks = smem;
  float* Vs = Ks + 64 * (D + 1);
  float* Qs = Vs + 64 * (D + 1);
  float* dOs = Qs + 64 * (D + 1);
  float* Ps = dOs + 64 * (D + 1);
  float* L2 = Ps + 64 * PST;
  float* DD = L2 + BQ;
  const int kt = (FUSED ? a.kt0 : 0) + blockIdx.x, hk = blockIdx.y;
  const int g = a.H / a.hkv, k0 = kt * BK;
  const long long S = a.S, d = a.d;
  load_rows<T, D>(Ks, static_cast<const T*>(a.k) + hk * S * d, k0, a.d);
  load_rows<T, D>(Vs, static_cast<const T*>(a.v) + hk * S * d, k0, a.d);
  float dk[4][NJ], dv[4][NJ];
  zero_out<D>(dk);
  zero_out<D>(dv);
  // causal: q tile it is live iff k0 < (it + 1) BQ
  const int it0 = a.causal ? k0 / BQ : 0;
  for (int gq = 0; gq < g; ++gq) {
    const int h = hk * g + gq;
    for (int it = it0; it < a.S / BQ; ++it) {
      const int q0 = it * BQ;
      __syncthreads();
      load_q_side<T, D>(a, h, q0, Qs, dOs, L2, DD);
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<D>(Qs, Ks, dOs, Vs, L2, DD, q0, k0, a.causal, a.c, a.sc, p, ds);
      store_scores(Ps, p);
      __syncthreads();
      tile_ptb<D>(Ps, dOs, dv);
      __syncthreads();
      store_scores(Ps, ds);
      __syncthreads();
      tile_ptb<D>(Ps, Qs, dk);
      if (FUSED) {
        float part[4][NJ];
        zero_out<D>(part);
        tile_pb<D>(Ps, Ks, part);
        store_rows<D>(a.slab + ((long long)blockIdx.x * a.H + h) * S * d, q0, a.d, part);
      }
    }
  }
  store_rows<D>(a.dk + hk * S * d, k0, a.d, dk);
  store_rows<D>(a.dv + hk * S * d, k0, a.d, dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(FL_THREADS) flash_bwd_fused_kernel(FlashArgs a) {
  bwd_kv_body<T, D, true>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(FL_THREADS) flash_bwd_kv_kernel(FlashArgs a) {
  bwd_kv_body<T, D, false>(a);
}

// dQ of q tile blockIdx.x of head blockIdx.y: the live k tiles' dS K in
// ascending order, each tile's product summed alone and then added.
template <typename T, int D>
__global__ void __launch_bounds__(FL_THREADS) flash_bwd_q_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int NJ = D / 16;
  float* Ks = smem;
  float* Vs = Ks + 64 * (D + 1);
  float* Qs = Vs + 64 * (D + 1);
  float* dOs = Qs + 64 * (D + 1);
  float* Ps = dOs + 64 * (D + 1);
  float* L2 = Ps + 64 * PST;
  float* DD = L2 + BQ;
  const int h = blockIdx.y, hk = h / (a.H / a.hkv), q0 = blockIdx.x * BQ;
  const long long S = a.S, d = a.d;
  load_q_side<T, D>(a, h, q0, Qs, dOs, L2, DD);
  float acc[4][NJ];
  zero_out<D>(acc);
  const int nkt = a.causal ? (q0 + BQ - 1) / BK + 1 : a.S / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, D>(Ks, static_cast<const T*>(a.k) + hk * S * d, k0, a.d);
    load_rows<T, D>(Vs, static_cast<const T*>(a.v) + hk * S * d, k0, a.d);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<D>(Qs, Ks, dOs, Vs, L2, DD, q0, k0, a.causal, a.c, a.sc, p, ds);
    store_scores(Ps, ds);
    __syncthreads();
    float part[4][NJ];
    zero_out<D>(part);
    tile_pb<D>(Ps, Ks, part);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = __fadd_rn(acc[i][jj], part[i][jj]);
  }
  store_rows<D>(a.dq + h * S * d, q0, a.d, acc);
}

// dq += the slab planes of k tiles [kt0, kt1) in ascending order, each
// element only over the k tiles live for its row's q tile.
__global__ void __launch_bounds__(FL_THREADS) flash_dq_reduce_kernel(FlashArgs a) {
  const long long n = (long long)a.H * a.S * a.d;
  for (long long e = (long long)blockIdx.x * FL_THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * FL_THREADS) {
    const int row = (int)((e / a.d) % a.S);
    const int last = a.causal ? min(a.kt1, row / BQ + 1) : a.kt1;
    float acc = a.dq[e];
    for (int kt = a.kt0; kt < last; ++kt) acc = __fadd_rn(acc, a.slab[(long long)(kt - a.kt0) * n + e]);
    a.dq[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// The head-packed arm (d = 64)
// ---------------------------------------------------------------------------
//
// q, k, v, out, dout and every gradient are (H2, S, 128): head 2p + h lies
// on lane half h (columns 64 h .. 64 h + 63) of pair p. lse and dd are
// (H2, 2, S) f32, which is the general arm's (H, S) with H = 2 H2. A block
// of 256 x 2 threads per (q tile, pair) (forward, dQ) or (k tile, pair)
// (dK/dV) carries both heads: all 512 threads stage the pair's 64 x 128
// tiles together, a row's 128 values by neighbouring threads, into one f32
// tile per lane half, and threadIdx.y = h then runs head 2p + h on its own
// tiles with the general kernels' D = 64 thread layout and helpers (the
// 16 threads of a row are still one half of a warp: a warp never spans
// two values of threadIdx.y). Each head keeps its own m, l and
// accumulators in its 256 threads' registers, as the TPU kernel keeps two
// scratch pairs. So every head sums the general kernels' products in their
// order: the packed kernels give the general kernels' bits at d = 64.
// Shared memory: 133,120 bytes (forward) and 167,424 bytes (backward), one
// block of 16 warps a multiprocessor.

#define PK_D 64                    // head dim of one lane half
#define PK_W (2 * PK_D)            // a packed row
#define PK_TILE (64 * (PK_D + 1))  // floats of one staged lane-half tile

// Rows [r0, r0 + 64) of both lane halves of a packed (S, 128) matrix X into
// Xs (half h at Xs + h PK_TILE, rows of PK_D + 1 floats) as f32.
template <typename T>
__device__ __forceinline__ void load_pair(float* __restrict__ Xs, const T* __restrict__ X,
                                          int r0) {
  const int tid = threadIdx.y * FL_THREADS + threadIdx.x;
  for (int t = tid; t < 64 * PK_W; t += 2 * FL_THREADS) {
    const int r = t / PK_W, c = t % PK_W;
    Xs[(c / PK_D) * PK_TILE + r * (PK_D + 1) + c % PK_D] =
        to_f32(X[(long long)(r0 + r) * PK_W + c]);
  }
}

// Rows [r0, r0 + 64) of lane half threadIdx.y of a packed (S, 128) f32
// matrix O from an output tile o.
__device__ __forceinline__ void store_half(float* __restrict__ O, int r0,
                                           const float (&o)[4][PK_D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, c0 = threadIdx.y * PK_D;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < PK_D / 16; ++jj)
      O[(long long)(r0 + ty + 16 * i) * PK_W + c0 + tx + 16 * jj] = o[i][jj];
}

// lse log2(e) and dd of both heads of pair pr at q tile q0 into L2 and DD
// (head h at offset h BQ).
__device__ __forceinline__ void load_pair_rows(const FlashArgs& a, int pr, int q0, float* L2,
                                               float* DD) {
  const int tid = threadIdx.y * FL_THREADS + threadIdx.x;
  for (int t = tid; t < 2 * BQ; t += 2 * FL_THREADS) {
    const long long i = ((long long)pr * 2 + t / BQ) * a.S + q0 + t % BQ;
    L2[t] = __fmul_rn(a.lse[i], FL_LOG2E);
    DD[t] = a.dd[i];
  }
}

// Grid: x the q tiles, y the pairs.
template <typename T>
__global__ void __launch_bounds__(2 * FL_THREADS) flash_fwd_packed_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int NJ = PK_D / 16;
  const int h = threadIdx.y, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pr = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long S = a.S, off = (long long)pr * S * PK_W;
  float* Qs = smem;
  float* Ks = Qs + 2 * PK_TILE;
  float* Vs = Ks + 2 * PK_TILE;
  float* Ps = Vs + 2 * PK_TILE + h * 64 * PST;
  const float* Qh = Qs + h * PK_TILE;
  const float* Kh = Ks + h * PK_TILE;
  const float* Vh = Vs + h * PK_TILE;
  const T* kp = static_cast<const T*>(a.k) + off;
  const T* vp = static_cast<const T*>(a.v) + off;
  load_pair<T>(Qs, static_cast<const T*>(a.q) + off, q0);
  float acc[4][NJ], m[4], l[4], alpha[4];
  zero_out<PK_D>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FL_NEG_INF;
    l[i] = 0.0f;
  }
  const int nkt = a.causal ? (q0 + BQ - 1) / BK + 1 : a.S / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_pair<T>(Ks, kp, k0);
    load_pair<T>(Vs, vp, k0);
    __syncthreads();
    float s[4][4];
    tile_abt<PK_D>(Qh, Kh, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = FL_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = __fmul_rn(s[i][j], a.c);
        if (a.causal && row < k0 + tx + 16 * j) x = FL_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, p);
        s[i][j] = to_f32(from_f32<T>(p));  // p in v's type for P.V
      }
      alpha[i] = exp2f(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum16(sum));
      m[i] = m_new;
    }
    store_scores(Ps, s);
    __syncthreads();
    float pv[4][NJ];
    zero_out<PK_D>(pv);
    tile_pb<PK_D>(Ps, Vh, pv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], alpha[i]), pv[i][jj]);
  }
  T* o = static_cast<T*>(a.out) + off;
  float* lse = a.lse_out + ((long long)pr * 2 + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float safe_l = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      o[row * PK_W + h * PK_D + tx + 16 * jj] = from_f32<T>(__fdiv_rn(acc[i][jj], safe_l));
    if (tx == 0) lse[row] = __fadd_rn(__fmul_rn(m[i], FL_LN2), logf(safe_l));
  }
}

// dK and dV of k tile kt of pair blockIdx.y, both heads (FUSED: also each
// live tile's dQ partial into slab plane blockIdx.x, a packed (H2, S, 128)
// plane). Grid: x the k tiles [kt0, kt1) (FUSED) or all of them, y the
// pairs. g = 1: the packed arm has no grouped-query sharing.
template <typename T, bool FUSED>
__device__ __forceinline__ void bwd_kv_packed_body(const FlashArgs& a) {
  extern __shared__ float smem[];
  constexpr int NJ = PK_D / 16;
  const int h = threadIdx.y;
  const int kt = (FUSED ? a.kt0 : 0) + blockIdx.x, pr = blockIdx.y, k0 = kt * BK;
  const long long S = a.S, off = (long long)pr * S * PK_W;
  float* Ks = smem;
  float* Vs = Ks + 2 * PK_TILE;
  float* Qs = Vs + 2 * PK_TILE;
  float* dOs = Qs + 2 * PK_TILE;
  float* Ps = dOs + 2 * PK_TILE + h * 64 * PST;
  float* L2 = dOs + 2 * PK_TILE + 2 * 64 * PST;
  float* DD = L2 + 2 * BQ;
  const float* Kh = Ks + h * PK_TILE;
  const float* Vh = Vs + h * PK_TILE;
  const float* Qh = Qs + h * PK_TILE;
  const float* dOh = dOs + h * PK_TILE;
  const T* qp = static_cast<const T*>(a.q) + off;
  const T* dop = static_cast<const T*>(a.dout) + off;
  load_pair<T>(Ks, static_cast<const T*>(a.k) + off, k0);
  load_pair<T>(Vs, static_cast<const T*>(a.v) + off, k0);
  float dk[4][NJ], dv[4][NJ];
  zero_out<PK_D>(dk);
  zero_out<PK_D>(dv);
  const int it0 = a.causal ? k0 / BQ : 0;
  for (int it = it0; it < a.S / BQ; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_pair<T>(Qs, qp, q0);
    load_pair<T>(dOs, dop, q0);
    load_pair_rows(a, pr, q0, L2, DD);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<PK_D>(Qh, Kh, dOh, Vh, L2 + h * BQ, DD + h * BQ, q0, k0, a.causal, a.c, a.sc, p,
                    ds);
    store_scores(Ps, p);
    __syncthreads();
    tile_ptb<PK_D>(Ps, dOh, dv);
    __syncthreads();
    store_scores(Ps, ds);
    __syncthreads();
    tile_ptb<PK_D>(Ps, Qh, dk);
    if (FUSED) {
      float part[4][NJ];
      zero_out<PK_D>(part);
      tile_pb<PK_D>(Ps, Kh, part);
      store_half(a.slab + ((long long)blockIdx.x * a.H + pr) * S * PK_W, q0, part);
    }
  }
  store_half(a.dk + off, k0, dk);
  store_half(a.dv + off, k0, dv);
}

template <typename T>
__global__ void __launch_bounds__(2 * FL_THREADS) flash_bwd_fused_packed_kernel(FlashArgs a) {
  bwd_kv_packed_body<T, true>(a);
}

template <typename T>
__global__ void __launch_bounds__(2 * FL_THREADS) flash_bwd_kv_packed_kernel(FlashArgs a) {
  bwd_kv_packed_body<T, false>(a);
}

// dQ of q tile blockIdx.x of pair blockIdx.y, both heads: the live k tiles'
// dS K in ascending order, each tile's product summed alone and then added.
template <typename T>
__global__ void __launch_bounds__(2 * FL_THREADS) flash_bwd_q_packed_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int NJ = PK_D / 16;
  const int h = threadIdx.y;
  const int pr = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long S = a.S, off = (long long)pr * S * PK_W;
  float* Ks = smem;
  float* Vs = Ks + 2 * PK_TILE;
  float* Qs = Vs + 2 * PK_TILE;
  float* dOs = Qs + 2 * PK_TILE;
  float* Ps = dOs + 2 * PK_TILE + h * 64 * PST;
  float* L2 = dOs + 2 * PK_TILE + 2 * 64 * PST;
  float* DD = L2 + 2 * BQ;
  const float* Kh = Ks + h * PK_TILE;
  const float* Vh = Vs + h * PK_TILE;
  const float* Qh = Qs + h * PK_TILE;
  const float* dOh = dOs + h * PK_TILE;
  const T* kp = static_cast<const T*>(a.k) + off;
  const T* vp = static_cast<const T*>(a.v) + off;
  load_pair<T>(Qs, static_cast<const T*>(a.q) + off, q0);
  load_pair<T>(dOs, static_cast<const T*>(a.dout) + off, q0);
  load_pair_rows(a, pr, q0, L2, DD);
  float acc[4][NJ];
  zero_out<PK_D>(acc);
  const int nkt = a.causal ? (q0 + BQ - 1) / BK + 1 : a.S / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_pair<T>(Ks, kp, k0);
    load_pair<T>(Vs, vp, k0);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<PK_D>(Qh, Kh, dOh, Vh, L2 + h * BQ, DD + h * BQ, q0, k0, a.causal, a.c, a.sc, p,
                    ds);
    store_scores(Ps, ds);
    __syncthreads();
    float part[4][NJ];
    zero_out<PK_D>(part);
    tile_pb<PK_D>(Ps, Kh, part);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = __fadd_rn(acc[i][jj], part[i][jj]);
  }
  store_half(a.dq + off, q0, acc);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

enum { K_FWD = 0, K_FUSED = 1, K_KV = 2, K_Q = 3 };

static size_t smem_bytes(int kind, int D) {
  if (kind == K_FWD) return (size_t)(3 * 64 * (D + 1) + 64 * PST) * sizeof(float);
  return (size_t)(4 * 64 * (D + 1) + 64 * PST + 2 * BQ) * sizeof(float);
}

template <typename K>
static int go(K kernel, dim3 grid, size_t smem, const FlashArgs& a, cudaStream_t st,
              dim3 block = dim3(FL_THREADS)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch(int kind, const FlashArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(kind, D);
  switch (kind) {
    case K_FWD: return go(flash_fwd_kernel<T, D>, dim3(a.S / BQ, a.H), smem, a, st);
    case K_FUSED:
      return go(flash_bwd_fused_kernel<T, D>, dim3(a.kt1 - a.kt0, a.hkv), smem, a, st);
    case K_KV: return go(flash_bwd_kv_kernel<T, D>, dim3(a.S / BK, a.hkv), smem, a, st);
    case K_Q: return go(flash_bwd_q_kernel<T, D>, dim3(a.S / BQ, a.H), smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_d(int dp, int kind, const FlashArgs& a, cudaStream_t st) {
  switch (dp) {
    case 64: return launch<T, 64>(kind, a, st);
    case 96: return launch<T, 96>(kind, a, st);
    case 128: return launch<T, 128>(kind, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

static int dispatch(int dt, int dp, int kind, const FlashArgs& a, void* stream) {
  if (a.H < 1 || a.hkv < 1 || a.H % a.hkv || a.H > 65535 || a.S < BQ || a.S % BQ || a.d < 1 ||
      a.d > dp)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32: return launch_d<float>(dp, kind, a, st);
    case DT_BF16: return launch_d<__nv_bfloat16>(dp, kind, a, st);
    case DT_F16: return launch_d<__half>(dp, kind, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The packed kernels: 256 x 2 threads, one stage of both lane halves'
// tiles (the forward: q, k, v and a score tile per head; the backward:
// also dO, and both heads' lse and dd rows).
static size_t smem_bytes_packed(int kind) {
  if (kind == K_FWD) return (size_t)(6 * PK_TILE + 2 * 64 * PST) * sizeof(float);
  return (size_t)(8 * PK_TILE + 2 * 64 * PST + 4 * BQ) * sizeof(float);
}

template <typename T>
static int launch_packed(int kind, const FlashArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes_packed(kind);
  const dim3 block(FL_THREADS, 2);
  switch (kind) {
    case K_FWD: return go(flash_fwd_packed_kernel<T>, dim3(a.S / BQ, a.H), smem, a, st, block);
    case K_FUSED:
      return go(flash_bwd_fused_packed_kernel<T>, dim3(a.kt1 - a.kt0, a.H), smem, a, st, block);
    case K_KV: return go(flash_bwd_kv_packed_kernel<T>, dim3(a.S / BK, a.H), smem, a, st, block);
    case K_Q: return go(flash_bwd_q_packed_kernel<T>, dim3(a.S / BQ, a.H), smem, a, st, block);
  }
  return (int)cudaErrorInvalidValue;
}

// a.H is the number of pairs H2 and a.d the packed row, 128.
static int dispatch_packed(int dt, int kind, const FlashArgs& a, void* stream) {
  if (a.H < 1 || a.H > 65535 || a.S < BQ || a.S % BQ) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32: return launch_packed<float>(kind, a, st);
    case DT_BF16: return launch_packed<__nv_bfloat16>(kind, a, st);
    case DT_F16: return launch_packed<__half>(kind, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

static FlashArgs args(const void* q, const void* k, const void* v, int H, int hkv, int S, int d,
                      int causal, float c) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.H = H;
  a.hkv = hkv;
  a.S = S;
  a.d = d;
  a.causal = causal;
  a.c = c;
  return a;
}

extern "C" {

// The forward: out (H, S, d) in the operands' type dt, lse (H, S) f32.
// dp is the head dim the kernel is built for (64, 96 or 128, >= d); c is
// scale log2(e).
int accl_flash_fwd(int dt, int dp, const void* q, const void* k, const void* v, void* out,
                   void* lse, int H, int hkv, int S, int d, int causal, float c, void* stream) {
  FlashArgs a = args(q, k, v, H, hkv, S, d, causal, c);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(dt, dp, K_FWD, a, stream);
}

// One launch of the fused backward over k tiles [kt0, kt1): dk and dv
// (H_kv, S, d) f32 of those tiles' rows, their dQ partials into slab
// (at least kt1 - kt0 planes of (H, S, d) f32).
int accl_flash_bwd_fused(int dt, int dp, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dd, void* dk, void* dv,
                         void* slab, int H, int hkv, int S, int d, int causal, float c, float sc,
                         int kt0, int kt1, void* stream) {
  if (kt0 < 0 || kt1 > S / BK || kt0 >= kt1) return (int)cudaErrorInvalidValue;
  FlashArgs a = args(q, k, v, H, hkv, S, d, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.slab = static_cast<float*>(slab);
  a.sc = sc;
  a.kt0 = kt0;
  a.kt1 = kt1;
  return dispatch(dt, dp, K_FUSED, a, stream);
}

// The two-pass backward's dK/dV: dk and dv (H_kv, S, d) f32.
int accl_flash_bwd_kv(int dt, int dp, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd, void* dk, void* dv, int H,
                      int hkv, int S, int d, int causal, float c, float sc, void* stream) {
  FlashArgs a = args(q, k, v, H, hkv, S, d, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sc = sc;
  return dispatch(dt, dp, K_KV, a, stream);
}

// The two-pass backward's dQ: dq (H, S, d) f32.
int accl_flash_bwd_q(int dt, int dp, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dd, void* dq, int H, int hkv,
                     int S, int d, int causal, float c, float sc, void* stream) {
  FlashArgs a = args(q, k, v, H, hkv, S, d, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dq = static_cast<float*>(dq);
  a.sc = sc;
  return dispatch(dt, dp, K_Q, a, stream);
}

// The packed forward: q, k, v and out (H2, S, 128) in type dt, head 2p + h
// on lane half h of pair p; lse (H2, 2, S) f32.
int accl_flash_fwd_packed(int dt, const void* q, const void* k, const void* v, void* out,
                          void* lse, int H2, int S, int causal, float c, void* stream) {
  FlashArgs a = args(q, k, v, H2, H2, S, PK_W, causal, c);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return dispatch_packed(dt, K_FWD, a, stream);
}

// One launch of the packed fused backward over k tiles [kt0, kt1): dk and
// dv (H2, S, 128) f32 of those tiles' rows, their dQ partials into slab
// (at least kt1 - kt0 planes of (H2, S, 128) f32); lse and dd (H2, 2, S).
int accl_flash_bwd_fused_packed(int dt, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dd, void* dk,
                                void* dv, void* slab, int H2, int S, int causal, float c, float sc,
                                int kt0, int kt1, void* stream) {
  if (kt0 < 0 || kt1 > S / BK || kt0 >= kt1) return (int)cudaErrorInvalidValue;
  FlashArgs a = args(q, k, v, H2, H2, S, PK_W, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.slab = static_cast<float*>(slab);
  a.sc = sc;
  a.kt0 = kt0;
  a.kt1 = kt1;
  return dispatch_packed(dt, K_FUSED, a, stream);
}

// The packed two-pass backward's dK/dV: dk and dv (H2, S, 128) f32.
int accl_flash_bwd_kv_packed(int dt, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* dd, void* dk, void* dv,
                             int H2, int S, int causal, float c, float sc, void* stream) {
  FlashArgs a = args(q, k, v, H2, H2, S, PK_W, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sc = sc;
  return dispatch_packed(dt, K_KV, a, stream);
}

// The packed two-pass backward's dQ: dq (H2, S, 128) f32.
int accl_flash_bwd_q_packed(int dt, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* dd, void* dq, int H2,
                            int S, int causal, float c, float sc, void* stream) {
  FlashArgs a = args(q, k, v, H2, H2, S, PK_W, causal, c);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dq = static_cast<float*>(dq);
  a.sc = sc;
  return dispatch_packed(dt, K_Q, a, stream);
}

// dq (H, S, d) f32 += the slab's planes of k tiles [kt0, kt1), in order.
int accl_flash_dq_reduce(void* dq, const void* slab, int H, int S, int d, int causal, int kt0,
                         int kt1, void* stream) {
  if (H < 1 || S < BQ || S % BQ || d < 1 || kt0 < 0 || kt1 > S / BK || kt0 >= kt1)
    return (int)cudaErrorInvalidValue;
  FlashArgs a = {};
  a.dq = static_cast<float*>(dq);
  a.slab = const_cast<float*>(static_cast<const float*>(slab));
  a.H = H;
  a.S = S;
  a.d = d;
  a.causal = causal;
  a.kt0 = kt0;
  a.kt1 = kt1;
  const long long n = (long long)H * S * d;
  const long long blocks = (n + FL_THREADS - 1) / FL_THREADS;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  flash_dq_reduce_kernel<<<grid, FL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* accl_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
