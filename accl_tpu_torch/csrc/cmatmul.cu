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
// [r0, r1), each with its own channel split `half`. Its bound: 2 M K N f32
// operations on the CUDA cores.
//
// mmrs. On a TPU the accumulator travels the ring: chunk c starts as rank
// c's partial and each hop adds the next rank's, rounding the traveller to
// the wire type before it is sent (acc = wire(acc) + partial, the add in
// f32, the final fold not rounded). Blocks on the card cannot carry a sum
// from one to the next, so a block owns one output tile of one chunk r and
// keeps the travelling accumulator in registers across a loop over the P
// hops, which takes the place of the sequential ring: hop t's partial is
// taken in its own accumulator and folded in. Channel 0 folds ranks r, r+1,
// ..., r-1; channel 1 (rows from `split` on, the second half of the padded
// chunk) folds r, r-1, ..., r+1. No reduction crosses blocks. The TPU's
// realignment hop is the output indexing. The accumulator-blocking arm (one
// streaming kernel per nb column block) is one launch per column block
// [c0, c1).
//
// wgrad. On a TPU the traveller's shards ride the agmm ring and each
// arrival's dim-0-contracting partial is added into the dw panel while the
// next hop is in flight: o = c(local rows of channel 0) + c(local rows of
// channel 1), then hop t adds channel 0's arrival from rank r - t and
// channel 1's from rank r + t. On the card a block owns one dw tile of one
// rank and runs over those segments in that order in one accumulator (no
// wire rounding lies between them); no reduction crosses blocks. The
// contraction runs over rows, so both operands are staged as row slabs.
// The streaming arm (the TPU body runs one kernel per ctb column block of
// the traveller) is one launch per block [c0, c1).
//
// Bound of mmrs and wgrad, and the design. Each product of (M x K) by
// (K x N) does 2 M K N flops; at the tensor-parallel shapes (K and N in the
// thousands) operations bound them. On the CUDA cores f32 runs at about
// 67 TFLOP/s; the TF32 tensor cores run at 495, but one TF32 product rounds
// each operand to 11 significant bits. The kernels keep f32 accuracy with
// split TF32: a = hi + lo, hi = tf32(a), lo = tf32(a - hi), and a b is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (the small cross products
// first), each product within about 2^-21 |a b|. That is three tensor-core
// products, so the bound is 3 x 2 M K N over 495 TFLOP/s. bf16 and f16
// values are exact in TF32 and are not split (a mixed f32 x bf16 pair takes
// two products); integer values below 2^11 have lo = 0, so integer operands
// whose sums stay below 2^24 give exact results.
//
// The tensor cores are fed by wgmma (m64nNk8, tf32 in, f32 out) from two
// warpgroups, each owning 64 rows of the block tile: 128 x 128 for wgrad,
// 128 x 64 for mmrs, two blocks of which share a multiprocessor. A comes from
// registers: each thread loads its fragments from the staged slab and
// splits them there. B comes from shared memory: once a slab, the threads
// split it into hi and lo tiles, K-major, as wgmma's TF32 form wants. The
// operands reach shared memory raw, in their own dtype, through a ring of
// TC_STAGES slabs filled by 16-byte cp.async copies, zero-filled at ragged
// edges by the copy's source size (rows that do not start on 16 bytes, as
// bf16 rows of odd length or odd column offsets, go element by element).
// While one slab's products run, the threads split the next slab and issue
// the copies of a later one, across hop and segment boundaries alike; one
// barrier a slab. The tensor cores' own f32 accumulation rounds toward
// zero, so over a long k its error would grow with k: each slab's products
// go into a fresh accumulator that is then added, rounding to nearest, to
// the f32 sum in registers. What bounds the kernels on the card is the
// CUDA cores' share: the split and the fragment loads of every element,
// the copies and the per-slab barrier, which run beside the products at
// 8 to 16 warps a multiprocessor.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#define CM_MAX_RANKS 64
#define CM_THREADS 256
#define TILE 64
#define BK 16
// split-TF32 kernels: cp.async ring depth, block rows, and each kernel's
// block columns, slab depth and resident blocks a multiprocessor
#define TC_STAGES 3
#define TC_BM 128
#define MMRS_BN 64
#define MMRS_BK 16
#define MMRS_BLOCKS 2
#define WGRAD_BN 128
#define WGRAD_BK 32
#define WGRAD_BLOCKS 1

// dtype codes: the values of accl_tpu_torch.constants.dataType (0: no wire)
enum { DT_NONE = 0, DT_F16 = 2, DT_F32 = 3, DT_BF16 = 7 };

struct RankPtrs {
  void* p[CM_MAX_RANKS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// The value the wire carries: round to nearest even in the wire type, back
// to f32.
__device__ __forceinline__ float wire_round(int wire, float v) {
  if (wire == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (wire == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}

// ---------------------------------------------------------------------------
// agmm: f32 products on the CUDA cores
// ---------------------------------------------------------------------------

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

// Rows [lo, hi) of tile y (of `tile` rows) of a row range split in two
// channels: channel 0 takes rows [a0, a1) in tiles0 tiles, channel 1 rows
// [a1, a2).
__device__ __forceinline__ int tile_rows(int y, int tiles0, int a0, int a1, int a2, int tile,
                                         int* lo, int* hi) {
  if (y < tiles0) {
    *lo = a0 + y * tile;
    *hi = a1;
    return 0;
  }
  *lo = a1 + (y - tiles0) * tile;
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
  const int chan = tile_rows(blockIdx.y, tiles0, r0, half, r1, TILE, &lo, &hi);
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

// ---------------------------------------------------------------------------
// mmrs, wgrad: split-TF32 products on the tensor cores
// ---------------------------------------------------------------------------

// An operand element as it is staged: its raw bits.
template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<__half> { using type = uint16_t; };

template <typename T> __device__ __forceinline__ float raw_f32(typename Raw<T>::type u);
template <> __device__ __forceinline__ float raw_f32<float>(uint32_t u) {
  return __uint_as_float(u);
}
template <> __device__ __forceinline__ float raw_f32<__nv_bfloat16>(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}
template <> __device__ __forceinline__ float raw_f32<__half>(uint16_t u) {
  return __half2float(__ushort_as_half(u));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v as hi (+ lo): an f32 value splits in two TF32 values (the tensor core
// drops the low 13 bits of what it is given, so both are rounded here; a
// non-finite v keeps lo 0, so inf and NaN reach the sum through hi alone);
// bf16 and f16 values are TF32 values already.
template <typename T>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  if (sizeof(T) == 4) {
    hi = tf32_rna(v);
    const float rest = v - __uint_as_float(hi);
    lo = tf32_rna(rest == rest ? rest : 0.0f);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// d = a b + (acc ? d : 0) over a 64 x N x 8 tile for one warpgroup (4
// warps): a from registers (warp w of the group holds rows 16 w .. 16 w +
// 15 as in mma.m16n8k8), b from shared memory through its descriptor, d
// N / 2 f32 registers a thread. Asynchronous: d and a stay untouched until
// wgmma_wait.
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed products are pending.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread become visible to the tensor cores'
// reads (the async proxy) once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pin an accumulator register after wgmma_wait: the compiler may not move
// its later uses above this point.
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// A wgmma shared-memory descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 contiguous bytes each, the two of one
// k8 step `lbo` bytes apart, neighbouring 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = ((unsigned)__cvta_generic_to_shared(p) >> 4) & 0x3FFF;
  return a | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage an R x C box of T (rows `ld` elements apart in g) raw into shared
// memory s (rows `ls` elements apart): rows from rv on and columns from cv
// on are zero. vec: 16-byte cp.async copies (g and every row start on 16
// bytes; the copy's source size zero-fills a ragged row end); else element
// by element.
template <typename T, int R, int C>
__device__ __forceinline__ void stage_box(typename Raw<T>::type* s, int ls, const T* g,
                                          long long ld, int rv, int cv, bool vec) {
  using U = typename Raw<T>::type;
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = C / E, N = R * CH;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N + CM_THREADS - 1) / CM_THREADS; ++it) {
      const int i = threadIdx.x + it * CM_THREADS, r = i / CH, c = (i % CH) * E;
      if (N % CM_THREADS != 0 && i >= N) break;
      const int nv = r < rv ? max(0, min(E, cv - c)) : 0;
      cp_async16(s + r * ls + c, nv > 0 ? g + (long long)r * ld + c : g, nv * (int)sizeof(T));
    }
  } else {
    const U* gu = reinterpret_cast<const U*>(g);
    for (int i = threadIdx.x; i < R * C; i += CM_THREADS) {
      const int r = i / C, c = i % C;
      s[r * ls + c] = (r < rv && c < cv) ? gu[(long long)r * ld + c] : U(0);
    }
  }
}

// The split-TF32 kernels' shared memory: a ring of TC_STAGES raw slabs and
// two buffers of the split B operand (mmrs adds its travelling sums).
extern __shared__ __align__(128) unsigned char tc_smem[];

// The block tile (TC_BM x BN) and its pipeline, slabs of depth KD. Two
// warpgroups, each owning 64 rows and all BN columns (one m64nBNk8 wgmma a
// k8 step and product). A is staged raw [m][k] (AK: k contiguous, mmrs's x) or [k][m]
// (wgrad's row slabs); its fragments are loaded from the raw slab and split
// in registers. B is staged raw [k][n]; once a slab, every thread splits a
// share of it into the hi and lo tiles the tensor cores read, K-major
// (core matrices of 8 n x 4 k). The raw row pads keep 16-byte row starts
// and put a warp's fragment loads on distinct banks.
template <typename TA, typename TB, int BN, bool AK, int KD>
struct Tc {
  using UA = typename Raw<TA>::type;
  using UB = typename Raw<TB>::type;
  static constexpr int BM = TC_BM, K8 = KD / 8, ND = BN / 2;
  static constexpr bool SPLIT_A = sizeof(TA) == 4, SPLIT_B = sizeof(TB) == 4;
  static constexpr int LSA = AK ? KD + 16 / (int)sizeof(TA) : BM + 8;
  static constexpr int LSB = BN + 8;
  static constexpr int RAW_A = (AK ? BM : KD) * LSA * (int)sizeof(TA);
  static constexpr int RAW_B = KD * LSB * (int)sizeof(TB);
  static constexpr int RAW = RAW_A + RAW_B;
  static constexpr int K8_BYTES = BN * 8 * 4;         // one k8 step of hi or lo
  static constexpr int SPLIT_BYTES = 2 * K8 * K8_BYTES;  // hi and lo of a slab
  static constexpr int SMEM = TC_STAGES * RAW + 2 * SPLIT_BYTES;
  static_assert(RAW_A % 16 == 0 && RAW % 128 == 0, "stages keep their alignment");

  __device__ static UA* raw_a(int st) { return reinterpret_cast<UA*>(tc_smem + st * RAW); }
  __device__ static UB* raw_b(int st) {
    return reinterpret_cast<UB*>(tc_smem + st * RAW + RAW_A);
  }
  // hi (h 0) or lo (h 1) of k8 step j in split buffer b
  __device__ static uint32_t* split_b(int b, int h, int j) {
    return reinterpret_cast<uint32_t*>(tc_smem + TC_STAGES * RAW + b * SPLIT_BYTES +
                                       (h * K8 + j) * K8_BYTES);
  }

  // Split the raw B slab of stage st into buffer b: thread chunk (n, c)
  // takes rows 4c .. 4c + 3 of column n and writes 16 bytes of hi and of lo
  // (a warp's reads on consecutive columns, its writes 128 contiguous bytes
  // a quarter).
  __device__ static void split_slab_b(int st, int b) {
    const UB* __restrict__ raw = raw_b(st);
#pragma unroll
    for (int it = 0; it < BN * (KD / 4) / CM_THREADS; ++it) {
      const int i = threadIdx.x + it * CM_THREADS, n = i % BN, c = i / BN;
      uint4 h, l;
      split_tf32<TB>(raw_f32<TB>(raw[(4 * c + 0) * LSB + n]), h.x, l.x);
      split_tf32<TB>(raw_f32<TB>(raw[(4 * c + 1) * LSB + n]), h.y, l.y);
      split_tf32<TB>(raw_f32<TB>(raw[(4 * c + 2) * LSB + n]), h.z, l.z);
      split_tf32<TB>(raw_f32<TB>(raw[(4 * c + 3) * LSB + n]), h.w, l.w);
      const int off = (n / 8) * 64 + (c % 2) * 32 + (n % 8) * 4;
      *reinterpret_cast<uint4*>(split_b(b, 0, c / 2) + off) = h;
      if (SPLIT_B) *reinterpret_cast<uint4*>(split_b(b, 1, c / 2) + off) = l;
    }
  }

  // This thread's A fragments of the raw slab of stage st, split: rows
  // 64 wg + 16 (warp % 4) + g (+ 8), columns 8 j + t (+ 4).
  __device__ static void load_a(int st, uint32_t (&ah)[K8][4], uint32_t (&al)[K8][4]) {
    const UA* __restrict__ A = raw_a(st);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
    for (int j = 0; j < K8; ++j) {
      UA v[4];
      if (AK) {
        v[0] = A[m * LSA + 8 * j + t];
        v[1] = A[(m + 8) * LSA + 8 * j + t];
        v[2] = A[m * LSA + 8 * j + t + 4];
        v[3] = A[(m + 8) * LSA + 8 * j + t + 4];
      } else {
        v[0] = A[(8 * j + t) * LSA + m];
        v[1] = A[(8 * j + t) * LSA + m + 8];
        v[2] = A[(8 * j + t + 4) * LSA + m];
        v[3] = A[(8 * j + t + 4) * LSA + m + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32<TA>(raw_f32<TA>(v[e]), ah[j][e], al[j][e]);
    }
  }

  // d = the slab's product, split buffer b: per k8 step the two cross
  // products of the split first, then hi hi. Asynchronous (wgmma_wait).
  __device__ static void product(float (&d)[ND], const uint32_t (&ah)[K8][4],
                                 const uint32_t (&al)[K8][4], int b) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < K8; ++j) {
      const uint64_t bh = kmajor_desc(split_b(b, 0, j), 128, 256);
      const int acc = j != 0;
      if (SPLIT_A) wgmma_tf32<BN>(d, al[j], bh, acc);
      if (SPLIT_B)
        wgmma_tf32<BN>(d, ah[j], kmajor_desc(split_b(b, 1, j), 128, 256),
                       SPLIT_A ? 1 : acc);
      wgmma_tf32<BN>(d, ah[j], bh, SPLIT_A || SPLIT_B ? 1 : acc);
    }
    wgmma_commit();
  }

  // Run `total` slabs: stage(s, st) issues slab s's copies into ring stage
  // st (called once a slab, in order). acc sums the slabs in runs of
  // `every`, and after(s) runs at a run's last slab (s % every == every -
  // 1). Each slab's products go to the tensor cores into a fresh
  // accumulator d, whose sum is then added to acc on the CUDA cores
  // (round to nearest): the tensor cores' own f32 accumulation rounds
  // toward zero, and over a long k that bias would grow with k. While slab
  // s's products run, the threads issue the copies of slab s + TC_STAGES
  // into slab s's ring stage (consumed by the previous step), split slab
  // s + 1's B into the other buffer and load its A fragments; one barrier a
  // slab.
  template <class Stage, class After>
  __device__ static void run(int total, int every, Stage stage, After after, float (&acc)[ND]) {
    uint32_t ah[K8][4], al[K8][4], nh[K8][4], nl[K8][4];
    float d[ND];
#pragma unroll
    for (int s = 0; s < TC_STAGES; ++s) {
      if (s < total) stage(s, s);
      cp_async_commit();
    }
    cp_async_wait<TC_STAGES - 1>();
    __syncthreads();
    split_slab_b(0, 0);
    load_a(0, ah, al);
    // slab s's products read one set of A registers while slab s + 1's are
    // loaded into the other; the sets alternate by name (the loop unrolled
    // by two), so that no register a product in flight reads is written
    // before wgmma_wait
    auto step = [&](int s, uint32_t (&ch)[K8][4], uint32_t (&cl)[K8][4],
                    uint32_t (&xh)[K8][4], uint32_t (&xl)[K8][4]) {
      cp_async_wait<TC_STAGES - 2>();
      fence_proxy_async();
      __syncthreads();
      product(d, ch, cl, s & 1);
      if (s + TC_STAGES < total) stage(s + TC_STAGES, s % TC_STAGES);
      cp_async_commit();
      if (s + 1 < total) {
        split_slab_b((s + 1) % TC_STAGES, (s + 1) & 1);
        load_a((s + 1) % TC_STAGES, xh, xl);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        pin(d[i]);
        acc[i] = s % every == 0 ? d[i] : acc[i] + d[i];
      }
      if (s % every == every - 1) after(s);
    };
    for (int s = 0; s < total; s += 2) {
      step(s, ah, al, nh, nl);
      if (s + 1 == total) break;
      step(s + 1, nh, nl, ah, al);
    }
    cp_async_wait<0>();
  }

  // Store d into O (leading dimension ldo, at the block tile's origin),
  // masked to `rows` rows and `cols` columns.
  __device__ static void store(float* __restrict__ O, long long ldo, int rows, int cols,
                               const float (&d)[ND]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2), n = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m + 8 * h;
      if (row >= rows) continue;
      float* o = O + (long long)row * ldo;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + n;
        if (col < cols) o[col] = d[4 * j + 2 * h];
        if (col + 1 < cols) o[col + 1] = d[4 * j + 2 * h + 1];
      }
    }
  }
};

// Grid: x the column tiles of [c0, c1), y (channel, row tile of the chunk's
// mc rows, channel 1 from `split`), z the chunk (destination rank) r. The
// slabs run hop by hop, each hop's k-slabs in ascending k; at a hop's last
// slab its partial folds into the traveller.
template <typename TA, typename TB>
__global__ void __launch_bounds__(CM_THREADS, MMRS_BLOCKS)
mmrs_kernel(RankPtrs x, RankPtrs w, RankPtrs out, int P, int mc, int k, int n, int c0, int c1,
            int split, int tiles0, int wire, int vec_x, int vec_w) {
  constexpr int BN = MMRS_BN;
  using G = Tc<TA, TB, BN, true, MMRS_BK>;
  int lo, hi;
  const int chan = tile_rows(blockIdx.y, tiles0, 0, split, mc, TC_BM, &lo, &hi);
  const int r = blockIdx.z, n0 = blockIdx.x * BN;
  const int M = hi - lo, N = c1 - c0 - n0;
  const int nk = (k + MMRS_BK - 1) / MMRS_BK;
  // the travelling sum, thread-private past the pipeline's shared memory
  // (element i of thread x at i * CM_THREADS + x: a warp's accesses on 32
  // banks)
  float* trav = reinterpret_cast<float*>(tc_smem + G::SMEM) + threadIdx.x;
  float part[G::ND];
  // the next slab to stage (stage() runs once a slab, in order): hop t's
  // source rank q, depth kk
  int q = r, kk = 0;
  const long long arow = ((long long)r * mc + lo) * k;
  auto stage = [&](int, int st) {
    stage_box<TA, TC_BM, MMRS_BK>(G::raw_a(st), G::LSA,
                                static_cast<const TA*>(x.p[q]) + arow + kk, k, M, k - kk,
                                vec_x);
    stage_box<TB, MMRS_BK, BN>(G::raw_b(st), G::LSB,
                             static_cast<const TB*>(w.p[q]) + (long long)kk * n + c0 + n0, n,
                             k - kk, N, vec_w);
    if ((kk += MMRS_BK) >= k) {
      kk = 0;
      q = chan == 0 ? (q + 1 == P ? 0 : q + 1) : (q == 0 ? P - 1 : q - 1);
    }
  };
  auto fold = [&](int s) {
    const bool first = s < nk;  // hop 0
#pragma unroll
    for (int i = 0; i < G::ND; ++i)
      trav[i * CM_THREADS] =
          first ? part[i] : wire_round(wire, trav[i * CM_THREADS]) + part[i];
  };
  G::run(P * nk, nk, stage, fold, part);
#pragma unroll
  for (int i = 0; i < G::ND; ++i) part[i] = trav[i * CM_THREADS];
  G::store(static_cast<float*>(out.p[r]) + (long long)lo * n + c0 + n0, n, M, N, part);
}

// Grid: x the column tiles of the dw panel, y its row tiles, z the rank r.
// lhs: out[r] rows [c0, c1) of (ct, cl), A the traveller and B the local
// rows; else columns [c0, c1) of (cl, ct), A the local rows and B the
// traveller (TA, TB are A's and B's types). Segments in the ring's order:
// hop t of channel 0 brings rank r - t's rows [0, split), of channel 1
// (rows [split, ms), bidirectional rings only) rank r + t's; hop 0 is the
// local shard. Each segment's rows run in depth-32 slabs, its last one
// zero-filled past the segment's end.
template <typename TA, typename TB>
__global__ void __launch_bounds__(CM_THREADS, WGRAD_BLOCKS)
wgrad_kernel(RankPtrs trav, RankPtrs loc, RankPtrs out, int P, int ms, int ct, int cl, int c0,
             int c1, int split, int lhs, int vec_t, int vec_l) {
  constexpr int BN = WGRAD_BN;
  using G = Tc<TA, TB, BN, false, WGRAD_BK>;
  const int r = blockIdx.z, m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * BN;
  const int M = (lhs ? c1 - c0 : cl) - m0, N = (lhs ? cl : c1 - c0) - n0;
  const int n0s = (split + WGRAD_BK - 1) / WGRAD_BK;
  const int per = n0s + (split < ms ? (ms - split + WGRAD_BK - 1) / WGRAD_BK : 0);
  float acc[G::ND];
  auto stage = [&](int s, int st) {
    const int t = s / per, u = s % per, chan = u >= n0s;
    const int src = chan == 0 ? (r - t + P) % P : (r + t) % P;
    const int row = (chan ? split - n0s * WGRAD_BK : 0) + u * WGRAD_BK;
    const int rv = (chan ? ms : split) - row;
    const long long toff = (long long)row * ct + c0;
    const long long loff = ((long long)src * ms + row) * cl;
    if (lhs) {
      stage_box<TA, WGRAD_BK, TC_BM>(G::raw_a(st), G::LSA,
                                  static_cast<const TA*>(trav.p[src]) + toff + m0, ct, rv, M,
                                  vec_t);
      stage_box<TB, WGRAD_BK, BN>(G::raw_b(st), G::LSB,
                               static_cast<const TB*>(loc.p[r]) + loff + n0, cl, rv, N, vec_l);
    } else {
      stage_box<TA, WGRAD_BK, TC_BM>(G::raw_a(st), G::LSA,
                                  static_cast<const TA*>(loc.p[r]) + loff + m0, cl, rv, M, vec_l);
      stage_box<TB, WGRAD_BK, BN>(G::raw_b(st), G::LSB,
                               static_cast<const TB*>(trav.p[src]) + toff + n0, ct, rv, N,
                               vec_t);
    }
  };
  G::run(P * per, P * per, stage, [](int) {}, acc);
  float* O = static_cast<float*>(out.p[r]) + (lhs ? (long long)c0 * cl : (long long)c0);
  const long long ldo = lhs ? cl : ct;
  G::store(O + (long long)m0 * ldo + n0, ldo, M, N, acc);
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

// A split-TF32 kernel instance, the dynamic shared memory it takes, and the
// devices (a bit each) on which its shared-memory limit has been raised.
struct TcFn {
  const void* fn;
  int smem;
  std::atomic<unsigned long long>* raised;
};

template <typename TA, typename TB>
static TcFn tc_instance(bool wgrad) {
  static std::atomic<unsigned long long> raised_w{0}, raised_m{0};
  if (wgrad)
    return TcFn{(const void*)wgrad_kernel<TA, TB>, Tc<TA, TB, WGRAD_BN, false, WGRAD_BK>::SMEM,
                &raised_w};
  using G = Tc<TA, TB, MMRS_BN, true, MMRS_BK>;  // and the travelling sums
  return TcFn{(const void*)mmrs_kernel<TA, TB>, G::SMEM + G::ND * CM_THREADS * (int)sizeof(float),
              &raised_m};
}

template <typename TA>
static TcFn pick_tc(int bdt, bool wgrad) {
  switch (bdt) {
    case DT_F32: return tc_instance<TA, float>(wgrad);
    case DT_BF16: return tc_instance<TA, __nv_bfloat16>(wgrad);
    case DT_F16: return tc_instance<TA, __half>(wgrad);
  }
  return TcFn{nullptr, 0, nullptr};
}

// The wgrad or mmrs instance for A's and B's dtype codes.
static TcFn resolve_tc(int adt, int bdt, bool wgrad) {
  switch (adt) {
    case DT_F32: return pick_tc<float>(bdt, wgrad);
    case DT_BF16: return pick_tc<__nv_bfloat16>(bdt, wgrad);
    case DT_F16: return pick_tc<__half>(bdt, wgrad);
  }
  return TcFn{nullptr, 0, nullptr};
}

static int dt_size(int dt) { return dt == DT_F32 ? 4 : 2; }

// Whether 16-byte copies reach an operand: every rank's base, moved by
// `off` bytes, and every row start (`ld` bytes apart) on 16 bytes.
static bool rows_on_16(const uint64_t* ptrs, int P, long long off, long long ld) {
  if (ld % 16) return false;
  for (int i = 0; i < P; ++i)
    if ((ptrs[i] + off) % 16) return false;
  return true;
}

// Launch k, first raising its shared-memory limit on the current device if
// no launch there has yet.
static cudaError_t launch_tc(TcFn k, dim3 grid, void** args, void* stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit == 0 || !(k.raised->load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
    if (e != cudaSuccess) return e;
    k.raised->fetch_or(bit, std::memory_order_release);
  }
  e = cudaLaunchKernel(k.fn, grid, dim3(CM_THREADS), args, k.smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

static RankPtrs table(const uint64_t* ptrs, int P) {
  RankPtrs t;
  memset(&t, 0, sizeof(t));
  for (int i = 0; i < P; ++i) t.p[i] = reinterpret_cast<void*>(ptrs[i]);
  return t;
}

static int tiles(int rows, int tile) { return (rows + tile - 1) / tile; }

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
  int tiles0 = tiles(half - r0, TILE);
  const long long gy = tiles0 + tiles(r1 - half, TILE), gz = (long long)P * P;
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
  if (P < 1 || P > CM_MAX_RANKS || mc < 1 || k < 1 || n < 1 || c0 < 0 || c1 > n ||
      c0 >= c1 || split < 0 || split > mc ||
      (wire != DT_NONE && wire != DT_BF16 && wire != DT_F16))
    return (int)cudaErrorInvalidValue;
  int tiles0 = tiles(split, TC_BM);
  const long long gy = tiles0 + tiles(mc - split, TC_BM);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const TcFn fn = resolve_tc(xdt, wdt, false);
  if (fn.fn == nullptr) return (int)cudaErrorInvalidValue;
  int vec_x = rows_on_16(x, P, 0, (long long)k * dt_size(xdt));
  int vec_w = rows_on_16(w, P, (long long)c0 * dt_size(wdt), (long long)n * dt_size(wdt));
  RankPtrs tx = table(x, P), tw = table(w, P), to = table(o, P);
  void* args[] = {&tx, &tw, &to, &P, &mc, &k, &n, &c0, &c1, &split, &tiles0, &wire,
                  &vec_x, &vec_w};
  const dim3 grid(tiles(c1 - c0, MMRS_BN), (unsigned)gy, (unsigned)P);
  return (int)launch_tc(fn, grid, args, stream);
}

// One launch of wgrad_kernel over the traveller's columns [c0, c1), channel
// 1 from shard row `split` (ms for a one-channel ring): t, l, o are the
// per-rank pointer tables of the (ms, ct) shards, the (P ms, cl) resident
// operands and the f32 dw panels, (ct, cl) when lhs is 1 and (cl, ct) when
// 0; tdt, ldt the operands' dtype codes.
int accl_cmatmul_wgrad(int tdt, int ldt, int lhs, const uint64_t* t, const uint64_t* l,
                       const uint64_t* o, int P, int ms, int ct, int cl, int c0, int c1,
                       int split, void* stream) {
  if (P < 1 || P > CM_MAX_RANKS || ms < 1 || ct < 1 || cl < 1 || c0 < 0 || c1 > ct ||
      c0 >= c1 || split < 1 || split > ms)
    return (int)cudaErrorInvalidValue;
  const int rows = lhs ? c1 - c0 : cl, cols = lhs ? cl : c1 - c0;
  if (tiles(rows, TC_BM) > 65535) return (int)cudaErrorInvalidValue;
  const TcFn fn = lhs ? resolve_tc(tdt, ldt, true) : resolve_tc(ldt, tdt, true);
  if (fn.fn == nullptr) return (int)cudaErrorInvalidValue;
  int vec_t = rows_on_16(t, P, (long long)c0 * dt_size(tdt), (long long)ct * dt_size(tdt));
  int vec_l = rows_on_16(l, P, 0, (long long)cl * dt_size(ldt));
  lhs = lhs ? 1 : 0;
  RankPtrs tt = table(t, P), tl = table(l, P), to = table(o, P);
  void* args[] = {&tt, &tl, &to, &P, &ms, &ct, &cl, &c0, &c1, &split, &lhs, &vec_t, &vec_l};
  const dim3 grid((unsigned)tiles(cols, WGRAD_BN), (unsigned)tiles(rows, TC_BM), (unsigned)P);
  return (int)launch_tc(fn, grid, args, stream);
}

const char* accl_cmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
