// Ring collective kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the four Pallas TPU kernels that carry ACCL.allreduce:
//   rs_fold_kernel     <- accl_tpu/parallel/pallas_ring.py     _rs_kernel
//   ring_ag_kernel     <- accl_tpu/parallel/pallas_ring.py     _ag_kernel
//   chunked_rs_kernel  <- accl_tpu/parallel/pallas_chunked.py  _chunked_rs_kernel
//   chunked_ag_kernel  <- accl_tpu/parallel/pallas_chunked.py  _chunked_ag_kernel
// the rooted collectives (reduce is chunked_rs_kernel then
// gather_copy_kernel):
//   bcast_relay_kernel    <- accl_tpu/parallel/pallas_chunked.py  _chunked_bcast_kernel
//   scatter_copy_kernel   <- accl_tpu/parallel/pallas_chunked.py  _chunked_scatter_kernel
//   gather_copy_kernel    <- accl_tpu/parallel/pallas_chunked.py  _chunked_gather_kernel
// and the all-to-all:
//   alltoall_copy_kernel  <- accl_tpu/parallel/pallas_chunked.py  _chunked_alltoall_kernel
//
// Rank model. A rank is a per-rank buffer reached through a pointer table
// (RankPtrs): on one card every rank's row of a (P, ...) tensor, on
// peer-mapped cards the peers' buffers.
//
// Two designs live here. The segmented rings (chunked_rs_kernel,
// chunked_ag_kernel), the VMEM-range all-gather ring (ring_ag_kernel) and
// the bcast relay (bcast_relay_kernel) keep the TPU's schedule: rank r's
// portion of a launch is the group of CTAs with blockIdx.z == r, blockIdx.y
// the ring channel, blockIdx.x a contiguous element range of the segment,
// and one launch runs one ring phase (all P-1 hops). A hop reads the
// upstream rank's staged partial (or output rows) and folds or copies it.
// The TPU kernel's two-deep receive slot becomes two staging slots per rank
// and channel in global memory. Readiness ("content k is in slot k%2") and
// capacity credits ("downstream has folded content k") are flag words per
// (rank, channel, CTA), stored with st.release.gpu and read with
// ld.acquire.gpu; staged data is read with ld.global.cg so no stale L1 line
// is ever folded. The all-gathers and the bcast relay forward straight out
// of the upstream rank's output rows, which are written once, so they need
// readiness flags only. These four are launched cooperatively, so the grid
// is co-resident or refused, and every spin is bounded by %globaltimer: a
// spin that times out writes the error word and returns, every other
// spinner sees the word and returns too, and the Python wrapper reads the
// word after the launch and raises.
//
// The others do not relay (sections "reduce-scatter fold" and "one-hop
// copies" below). On one HBM a ring only multiplies traffic: the VMEM-range
// reduce-scatter folds each output element in one pass over its P inputs,
// in the ring's hop order, and the scatter, gather and all-to-all copy each
// block once from where it lies to where it belongs. They wait on nothing:
// ordinary launches, no flags, no error word, 16-byte accesses.
//
// Bound. Every kernel here moves bytes and does at most one add per element
// read, so device memory bandwidth bounds it (3.35 TB/s on an H100 SXM). The
// rings use scalar coalesced accesses and a flag round trip per hop; the
// fold and the copies move 16 bytes per access.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define ACCL_MAX_RANKS 64
#define ACCL_THREADS 256

enum { ACCL_ERR_TIMEOUT = 1 };

// dtype codes: the values of accl_tpu_torch.constants.dataType
enum { DT_NONE = 0, DT_INT8 = 1, DT_F16 = 2, DT_F32 = 3, DT_F64 = 4,
       DT_I32 = 5, DT_I64 = 6, DT_BF16 = 7 };

struct RankPtrs {
  void* p[ACCL_MAX_RANKS];
};

// ---------------------------------------------------------------------------
// flag words
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= want. Returns false in every thread of the
// block when the spin timed out here or another block reported a failure.
// The bound is the global timer; the SM cycle counter backs it up (at most
// 2 cycles per ns below 2 GHz), so a timer that does not advance cannot
// turn a lost flag into a hang.
__device__ bool block_wait(const int* flag, int want, int* err,
                           unsigned long long timeout_ns) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int good = 1;
    if (ld_acquire(flag) < want) {
      const unsigned long long t0 = globaltimer();
      const long long c0 = clock64();
      while (ld_acquire(flag) < want) {
        if (*(volatile int*)err != 0) { good = 0; break; }
        if (globaltimer() - t0 > timeout_ns ||
            (unsigned long long)(clock64() - c0) > 2 * timeout_ns) {
          atomicExch(err, ACCL_ERR_TIMEOUT);
          good = 0;
          break;
        }
        __nanosleep(64);
      }
    }
    ok = good;
  }
  __syncthreads();
  const bool r = ok != 0;
  __syncthreads();
  return r;
}

// Every thread's stores are made visible at gpu scope before thread 0
// releases the flag(s).
__device__ __forceinline__ void block_fence() {
  __threadfence();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// element types: fold type, wire codecs, L2-only loads
// ---------------------------------------------------------------------------

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<int8_t> { using type = int32_t; };

__device__ __forceinline__ float up(__half v) { return __half2float(v); }
__device__ __forceinline__ float up(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ typename Acc<T>::type up(T v) { return v; }

template <typename T> __device__ __forceinline__ T down(typename Acc<T>::type v) { return (T)v; }
template <> __device__ __forceinline__ __half down<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 down<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// integer sums wrap (two's complement), as jnp and torch integer adds do
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }

__device__ __forceinline__ bool sign_set(float v) { return (__float_as_uint(v) >> 31) != 0; }
__device__ __forceinline__ bool sign_set(double v) { return __double_as_longlong(v) < 0; }

// IEEE-754 maximum, like jnp.maximum: NaN propagates from either side and
// +0 > -0; when both are NaN, jnp.maximum on the CPU returns a if a's sign
// bit is set, else b. True when max(a, b) is b.
template <typename A> __device__ __forceinline__ bool max_is_second(A a, A b) {
  if constexpr (std::is_floating_point<A>::value) {
    if (a != a) return b != b && !sign_set(a);
    if (b != b) return true;
    if (a == b) return sign_set(a) && !sign_set(b);
  }
  return b > a;
}

// func 0 = SUM, 1 = MAX; a is the received partial, b the local chunk. MAX
// returns one operand unchanged (a NaN keeps its bits), compared in the
// fold type, where the widening is exact.
template <typename T> __device__ __forceinline__ T fold(T a, T b, int func) {
  using A = typename Acc<T>::type;
  const A x = up(a), y = up(b);
  if (func == 0) return down<T>(add(x, y));
  return max_is_second(x, y) ? b : a;
}

// the wire: identity, or f32 staged as bf16 / f16, or int8 clip(round(x*s))
template <typename T, typename W> struct Wire;
template <typename T> struct Wire<T, T> {
  __device__ static T enc(T v, float) { return v; }
  __device__ static T dec(T w, float) { return w; }
};
template <> struct Wire<float, __nv_bfloat16> {
  __device__ static __nv_bfloat16 enc(float v, float) { return __float2bfloat16_rn(v); }
  __device__ static float dec(__nv_bfloat16 w, float) { return __bfloat162float(w); }
};
template <> struct Wire<float, __half> {
  __device__ static __half enc(float v, float) { return __float2half_rn(v); }
  __device__ static float dec(__half w, float) { return __half2float(w); }
};
template <> struct Wire<float, int8_t> {
  __device__ static int8_t enc(float v, float s) {
    const float q = fminf(fmaxf(rintf(v * s), -127.0f), 127.0f);
    return (int8_t)q;
  }
  // x / s as XLA compiles it: x times the correctly rounded reciprocal,
  // rounded apart from any add that follows (__fmul_rn is never contracted)
  __device__ static float dec(int8_t w, float s) { return __fmul_rn((float)w, __frcp_rn(s)); }
};

// Decompress a received value and fold it with the local one. With
// `contract`, an int8 SUM rounds once: XLA compiles the segmented TPU
// kernel's dequantize-and-add into a fused multiply-add (the VMEM-range
// kernel's rounds twice).
template <typename T, typename W>
__device__ __forceinline__ T fold_in(W w, T loc, int func, float scale, bool contract) {
  if constexpr (std::is_same<W, int8_t>::value && std::is_same<T, float>::value) {
    if (contract && func == 0) return fmaf((float)w, __frcp_rn(scale), loc);
  }
  return fold<T>(Wire<T, W>::dec(w, scale), loc, func);
}

template <typename W> __device__ __forceinline__ W ld_cg(const W* p) {
  W w;
  if constexpr (sizeof(W) == 1) {
    const unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(p));
    memcpy(&w, &v, 1);
  } else if constexpr (sizeof(W) == 2) {
    const unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&w, &v, 2);
  } else if constexpr (sizeof(W) == 4) {
    const unsigned int v = __ldcg(reinterpret_cast<const unsigned int*>(p));
    memcpy(&w, &v, 4);
  } else {
    const unsigned long long v = __ldcg(reinterpret_cast<const unsigned long long*>(p));
    memcpy(&w, &v, 8);
  }
  return w;
}

// ---------------------------------------------------------------------------
// reduce-scatter ring
// ---------------------------------------------------------------------------
//
// x[r]: (P, C, S) chunk grid of rank r; out[r]: (C, S); stage[r]: (2, 2, S)
// (channel, slot) in the wire type. Channel ch runs segments ch, ch+nchan,
// ...; with bidir channel 1 rotates left. Content k of a channel (the seed
// of a segment, then each folded partial) lives in slot k%2; flags:
// ready[r][ch][b][slot] = k+1 once content k is staged, cons[r][ch][b][slot]
// = k+1 once downstream folded it. Rank r ends owning chunk (r+1)%P
// (channel 1 with bidir: (r-1)%P), folded in ring order from that chunk's
// own rank: the TPU kernel's ownership and fold order.
template <typename T, typename W>
__device__ void rs_ring(const RankPtrs& x, const RankPtrs& out, const RankPtrs& stage,
                        int* flags, int P, int C, long long S, int nchan, int bidir,
                        int func, float scale, bool contract,
                        unsigned long long timeout_ns) {
  const int r = blockIdx.z, ch = blockIdx.y, b = blockIdx.x, B = gridDim.x;
  const int d = (bidir && ch == 1) ? -1 : 1;
  const int upr = (r - d + P) % P;
  const int nflag = P * 2 * B * 2;
  int* const err = flags + 2 * nflag;
  auto ready = [&](int rank, int slot) { return flags + (((rank * 2 + ch) * B + b) * 2 + slot); };
  auto cons = [&](int rank, int slot) { return flags + nflag + (((rank * 2 + ch) * B + b) * 2 + slot); };

  const long long per = (S + B - 1) / B;
  const long long lo = min(S, (long long)b * per), hi = min(S, lo + per);
  const T* xr = static_cast<const T*>(x.p[r]);
  W* mine = static_cast<W*>(stage.p[r]) + (long long)ch * 2 * S;
  const W* ups = static_cast<const W*>(stage.p[upr]) + (long long)ch * 2 * S;
  T* o = static_cast<T*>(out.p[r]);

  int k = 0;
  for (int c = ch; c < C; c += nchan) {
    // seed: my own chunk is the first partial I forward (content k)
    if (k >= 2 && !block_wait(cons(r, k & 1), k - 1, err, timeout_ns)) return;
    {
      const T* src = xr + ((long long)r * C + c) * S;
      W* dst = mine + (k & 1) * S;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        dst[i] = Wire<T, W>::enc(src[i], scale);
    }
    block_fence();
    if (threadIdx.x == 0) st_release(ready(r, k & 1), k + 1);

    for (int s = 0; s < P - 1; ++s, ++k) {
      const bool last = (s == P - 2);
      if (!block_wait(ready(upr, k & 1), k + 1, err, timeout_ns)) return;
      // credit: my slot (k+1)%2 held content k-1, which downstream must
      // have folded before I overwrite it
      if (!last && k >= 1 && !block_wait(cons(r, (k + 1) & 1), k, err, timeout_ns)) return;
      const int idx = ((r - d * (s + 1)) % P + P) % P;
      const T* loc = xr + ((long long)idx * C + c) * S;
      const W* rx = ups + (k & 1) * S;
      if (last) {
        T* oc = o + (long long)c * S;
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
          oc[i] = fold_in<T, W>(ld_cg(rx + i), loc[i], func, scale, contract);
      } else {
        W* nx = mine + ((k + 1) & 1) * S;
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
          nx[i] = Wire<T, W>::enc(fold_in<T, W>(ld_cg(rx + i), loc[i], func, scale, contract), scale);
      }
      block_fence();
      if (threadIdx.x == 0) {
        st_release(cons(upr, k & 1), k + 1);
        if (!last) st_release(ready(r, (k + 1) & 1), k + 2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// all-gather ring
// ---------------------------------------------------------------------------
//
// x[r]: (C, S); out[r]: (P, C, S). At hop s rank r copies block
// (r - d(s+1)) % P of segment c out of its upstream rank's output rows,
// which that rank wrote at its hop s-1 (or placed as its own block).
// prog[r][ch][b] counts the segments' seeds and hops done.
template <typename T>
__device__ void ag_ring(const RankPtrs& x, const RankPtrs& out, int* flags, int P, int C,
                        long long S, int nchan, int bidir, unsigned long long timeout_ns) {
  const int r = blockIdx.z, ch = blockIdx.y, b = blockIdx.x, B = gridDim.x;
  const int d = (bidir && ch == 1) ? -1 : 1;
  const int upr = (r - d + P) % P;
  int* const err = flags + P * 2 * B;
  auto prog = [&](int rank) { return flags + ((rank * 2 + ch) * B + b); };

  const long long per = (S + B - 1) / B;
  const long long lo = min(S, (long long)b * per), hi = min(S, lo + per);
  const T* xr = static_cast<const T*>(x.p[r]);
  T* o = static_cast<T*>(out.p[r]);
  const T* uo = static_cast<const T*>(out.p[upr]);

  int g = 0;
  for (int c = ch; c < C; c += nchan, ++g) {
    const int base = g * P;
    {
      T* dst = o + ((long long)r * C + c) * S;
      const T* src = xr + (long long)c * S;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = src[i];
    }
    block_fence();
    if (threadIdx.x == 0) st_release(prog(r), base + 1);
    for (int s = 0; s < P - 1; ++s) {
      if (!block_wait(prog(upr), base + s + 1, err, timeout_ns)) return;
      const int j = ((r - d * (s + 1)) % P + P) % P;
      const long long off = ((long long)j * C + c) * S;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) o[off + i] = ld_cg(uo + off + i);
      block_fence();
      if (threadIdx.x == 0) st_release(prog(r), base + s + 2);
    }
  }
}

// ---------------------------------------------------------------------------
// reduce-scatter fold: one pass per output element, in the ring's hop order
// ---------------------------------------------------------------------------
//
// _rs_kernel. x[q]: (P, L), rank q's chunks; out[r]: (L,). Rank r owns chunk
// c = (r+1)%P, as in the ring. The ring builds that chunk along a chain:
// rank c seeds it with Wire::enc(x[c][c]); rank c+1 folds its own chunk c
// into what it received (fold_in, received first) and re-encodes the sum
// for the next hop; ... rank c+P-1 = r folds last and stores in T. The TPU
// runs the chain over its links, one hop per step, because a partial has
// to travel to reach the next rank's chunk. On one HBM every rank's chunk
// is one load away, so a thread replays the whole chain for its elements:
// it reads x[c][c], x[c+1][c], ..., x[c+P-1][c] (mod P) and folds them in
// that order with the same functions, wire roundings included. The result
// is the ring's, bit for bit, in every dtype and wire; each input is read
// once and each output written once, with no staging, no flags and no
// cooperative launch.
//
// Bound: (P^2 + P) L elements of traffic over HBM bandwidth. The grid is
// (16-byte vectors of a chunk, rank r), one vector per thread. A thread
// issues its loads in groups of ACCL_FOLD_GROUP before it folds them, so a
// group's loads are in flight together. A chunk that is not 16-byte aligned
// on every rank, and the tail of an aligned chunk shorter than 16 bytes, go
// element by element (the builders pad chunks to whole 128-lane rows, so on
// the main path every chunk is aligned).

#define ACCL_FOLD_GROUP 8

// Step j (0..P-1) of one element's chain; v is that element of x[(c+j)%P][c].
template <typename T, typename W>
__device__ __forceinline__ void chain_step(W& carry, T& res, T v, int j, int P, int func,
                                           float scale) {
  if (j == 0) {
    carry = Wire<T, W>::enc(v, scale);
    return;
  }
  const T f = fold_in<T, W>(carry, v, func, scale, false);
  if (j == P - 1) {
    res = f;
  } else {
    carry = Wire<T, W>::enc(f, scale);
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(ACCL_THREADS)
rs_fold_kernel(RankPtrs x, RankPtrs out, int P, long long L, int func, float scale) {
  constexpr int V = 16 / sizeof(T);
  const int r = blockIdx.y, c = (r + 1) % P;
  const long long off = (long long)c * L;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  T* __restrict__ o = static_cast<T*>(out.p[r]);
  uintptr_t mis = reinterpret_cast<uintptr_t>(o);
  for (int q = 0; q < P; ++q) mis |= reinterpret_cast<uintptr_t>(static_cast<const T*>(x.p[q]) + off);
  long long done = 0;
  if ((mis & 15) == 0) {
    const long long nv = L / V;
    for (long long i = tid; i < nv; i += stride) {
      W carry[V];
      T res[V];
      for (int j0 = 0; j0 < P; j0 += ACCL_FOLD_GROUP) {
        uint4 buf[ACCL_FOLD_GROUP];
#pragma unroll
        for (int g = 0; g < ACCL_FOLD_GROUP; ++g) {
          if (j0 + g < P) {
            const T* src = static_cast<const T*>(x.p[(c + j0 + g) % P]) + off;
            buf[g] = reinterpret_cast<const uint4*>(src)[i];
          }
        }
#pragma unroll
        for (int g = 0; g < ACCL_FOLD_GROUP; ++g) {
          if (j0 + g < P) {
            T v[V];
            memcpy(v, &buf[g], 16);
#pragma unroll
            for (int k = 0; k < V; ++k) chain_step<T, W>(carry[k], res[k], v[k], j0 + g, P, func, scale);
          }
        }
      }
      uint4 w;
      memcpy(&w, res, 16);
      reinterpret_cast<uint4*>(o)[i] = w;
    }
    done = nv * V;
  }
  for (long long e = done + tid; e < L; e += stride) {
    W carry;
    T res;
    for (int j = 0; j < P; ++j)
      chain_step<T, W>(carry, res, static_cast<const T*>(x.p[(c + j) % P])[off + e], j, P, func,
                       scale);
    o[e] = res;
  }
}

// ---------------------------------------------------------------------------
// the ring kernels
// ---------------------------------------------------------------------------

// _chunked_rs_kernel: C segments over two channels, optionally counter-rotating
template <typename T, typename W>
__global__ void __launch_bounds__(ACCL_THREADS)
chunked_rs_kernel(RankPtrs x, RankPtrs out, RankPtrs stage, int* flags, int P, int C,
                  long long S, int bidir, int func, float scale,
                  unsigned long long timeout_ns) {
  rs_ring<T, W>(x, out, stage, flags, P, C, S, gridDim.y, bidir, func, scale, true, timeout_ns);
}

// _ag_kernel
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
ring_ag_kernel(RankPtrs x, RankPtrs out, int* flags, int P, long long L,
               unsigned long long timeout_ns) {
  ag_ring<T>(x, out, flags, P, 1, L, 1, 0, timeout_ns);
}

// _chunked_ag_kernel
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
chunked_ag_kernel(RankPtrs x, RankPtrs out, int* flags, int P, int C, long long S,
                  int bidir, unsigned long long timeout_ns) {
  ag_ring<T>(x, out, flags, P, C, S, gridDim.y, bidir, timeout_ns);
}

// ---------------------------------------------------------------------------
// rooted relay: bcast
// ---------------------------------------------------------------------------
//
// One channel: CTA b of every rank owns elements [lo, hi) of every segment,
// so it waits on CTA b of its neighbour only. pos = (r - root) % P is a
// rank's ring position; data moves one position per hop, from pos - 1 to
// pos, and every rank reads only its upstream neighbour's buffers. Each
// hop is one segment read and written once. The root's own row is never
// written: it is the source, which the body keeps exact.

template <typename T>
__device__ __forceinline__ void copy_slice(T* dst, const T* src, long long lo, long long hi,
                                           bool cg) {
  if (cg) {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = ld_cg(src + i);
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = src[i];
  }
}

// _chunked_bcast_kernel. x[r]: (C, S), read at the root only; out[r]: (C, S).
// Position 1 copies the root's segments where they lie; position p > 1
// copies segment c from its upstream neighbour's output once that rank's
// progress word says it holds c. Output rows are written once, so readiness
// is the only flag (the TPU kernel's slot credits have nothing to guard):
// the segments pipeline down the ring, ~(C + P - 2) segment copies deep.
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
bcast_relay_kernel(RankPtrs x, RankPtrs out, int* flags, int P, int C, long long S, int root,
                   unsigned long long timeout_ns) {
  const int r = blockIdx.z, b = blockIdx.x, B = gridDim.x;
  const int pos = (r - root + P) % P;
  if (pos == 0) return;
  const int up = (r - 1 + P) % P;
  int* const err = flags + P * B;
  auto prog = [&](int rank) { return flags + rank * B + b; };
  const long long per = (S + B - 1) / B;
  const long long lo = min(S, (long long)b * per), hi = min(S, lo + per);
  const T* src = static_cast<const T*>(pos == 1 ? x.p[root] : out.p[up]);
  T* o = static_cast<T*>(out.p[r]);
  for (int c = 0; c < C; ++c) {
    if (pos > 1 && !block_wait(prog(up), c + 1, err, timeout_ns)) return;
    const long long off = (long long)c * S;
    copy_slice(o + off, src + off, lo, hi, pos > 1);
    block_fence();
    if (threadIdx.x == 0) st_release(prog(r), c + 1);
  }
}

// ---------------------------------------------------------------------------
// one-hop copies: scatter, gather and all-to-all
// ---------------------------------------------------------------------------
//
// What the TPU kernels compute: a scatter sets out[r] = x[root][r], a gather
// sets slot s of the root's output to x[s], for every rank but the root; an
// all-to-all sets out[r][s] = x[s][r] for every pair s != r. They relay
// because ICI is a torus of neighbour links: a block moves one ring
// position per hop and is read and written at each, P (P-1) / 2 block
// copies in all where a scatter or gather needs P - 1 (the all-to-all
// moves each rank's chunk for rank r+s over s hops, 4x the function's bytes
// at P = 8). On one card every rank is a row in the same HBM, so here each
// block goes straight from where it lies to where it belongs, read once and
// written once: no ring positions, no staging slots, no flags, nothing
// waits on another CTA. Through peer-mapped cards on NVSwitch the root's
// NVLink port would bound a scatter or gather either way, and every pair of
// cards has its own link for the all-to-all, so one hop is right there too.
//
// Bound: 2 (P-1) n elements of traffic over HBM bandwidth for a scatter or
// gather, 2 P (P-1) n for an all-to-all (n a block's elements). The design spends
// the whole card on it: blockIdx.y (and for the all-to-all blockIdx.z)
// picks the block, and blockIdx.x covers it in one pass, one 16-byte access per thread, so the grid's CTAs sweep
// HBM in address order and the resident ones (eight of 256 threads per SM)
// keep some 2048 loads in flight per SM. On an H100 80GB HBM3 at 700 W
// (tools/copy_variants.py, P 8, 128 MiB blocks) that beats a persistent
// grid-stride loop with four loads in flight per thread by 6% and
// streaming cache hints by 1%, and matches cudaMemcpy. A block whose
// source or destination is not 16-byte aligned (S 777 in int8 or bf16 puts
// blocks at odd offsets), and the tail of an aligned block shorter than 16
// bytes, go element by element.

// dst[0, n) = src[0, n), over the CTAs of this blockIdx.y
template <typename T>
__device__ __forceinline__ void copy_block(T* __restrict__ dst, const T* __restrict__ src,
                                           long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long nv = n * (long long)sizeof(T) / 16;
    const uint4* __restrict__ s = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nv; i += stride) d[i] = s[i];
    done = nv * 16 / (long long)sizeof(T);
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
}

// _chunked_scatter_kernel. x: the root's (P, n) blocks by destination rank;
// out[r]: (n,). blockIdx.y = j covers rank j + (j >= root): every rank but
// the root, whose row the body fills with its own block.
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
scatter_copy_kernel(const T* __restrict__ x, RankPtrs out, long long n, int root) {
  const int r = blockIdx.y + (blockIdx.y >= root);
  copy_block(static_cast<T*>(out.p[r]), x + (long long)r * n, n);
}

// _chunked_gather_kernel. x[s]: (n,), rank s's block; out: the root's (P, n)
// slots by source rank. blockIdx.y = j covers source j + (j >= root); the
// root's own slot is left to the body.
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
gather_copy_kernel(RankPtrs x, T* __restrict__ out, long long n, int root) {
  const int s = blockIdx.y + (blockIdx.y >= root);
  copy_block(out + (long long)s * n, static_cast<const T*>(x.p[s]), n);
}

// _chunked_alltoall_kernel. x[s]: (P, n), rank s's chunks by destination
// rank; out[r]: (P, n), rank r's chunks by source rank. blockIdx.z = r is the
// destination, blockIdx.y = j covers source j + (j >= r): each rank's own
// slot out[r][r] is left to the body, which inserts it exactly. out must not
// alias x: an in-place all-to-all is a transposition, and would read blocks
// that other CTAs have already overwritten.
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
alltoall_copy_kernel(RankPtrs x, RankPtrs out, long long n) {
  const int r = blockIdx.z, s = blockIdx.y + (blockIdx.y >= r);
  copy_block(static_cast<T*>(out.p[r]) + (long long)s * n,
             static_cast<const T*>(x.p[s]) + (long long)r * n, n);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename T, typename W>
static const void* rs_fn(int chunked) {
  return chunked ? (const void*)chunked_rs_kernel<T, W> : (const void*)rs_fold_kernel<T, W>;
}

// chunked=0: rs_fold_kernel, else chunked_rs_kernel
static const void* rs_resolve(int chunked, int dtype, int wire) {
  if (wire == DT_NONE || wire == dtype) {
    switch (dtype) {
      case DT_INT8: return rs_fn<int8_t, int8_t>(chunked);
      case DT_F16: return rs_fn<__half, __half>(chunked);
      case DT_F32: return rs_fn<float, float>(chunked);
      case DT_F64: return rs_fn<double, double>(chunked);
      case DT_I32: return rs_fn<int32_t, int32_t>(chunked);
      case DT_I64: return rs_fn<int64_t, int64_t>(chunked);
      case DT_BF16: return rs_fn<__nv_bfloat16, __nv_bfloat16>(chunked);
    }
    return nullptr;
  }
  if (dtype != DT_F32) return nullptr;
  switch (wire) {
    case DT_BF16: return rs_fn<float, __nv_bfloat16>(chunked);
    case DT_F16: return rs_fn<float, __half>(chunked);
    case DT_INT8: return rs_fn<float, int8_t>(chunked);
  }
  return nullptr;
}

static int dt_size(int dtype) {
  switch (dtype) {
    case DT_INT8: return 1;
    case DT_F16: case DT_BF16: return 2;
    case DT_F32: case DT_I32: return 4;
    case DT_F64: case DT_I64: return 8;
  }
  return 0;
}

static const void* ag_resolve(int chunked, int itemsize) {
  switch (itemsize) {
    case 1: return chunked ? (const void*)chunked_ag_kernel<uint8_t> : (const void*)ring_ag_kernel<uint8_t>;
    case 2: return chunked ? (const void*)chunked_ag_kernel<uint16_t> : (const void*)ring_ag_kernel<uint16_t>;
    case 4: return chunked ? (const void*)chunked_ag_kernel<uint32_t> : (const void*)ring_ag_kernel<uint32_t>;
    case 8: return chunked ? (const void*)chunked_ag_kernel<uint64_t> : (const void*)ring_ag_kernel<uint64_t>;
  }
  return nullptr;
}

// the kernels that wait on flags: the reduce-scatter and all-gather rings
// and the bcast relay
enum { KIND_RS = 0, KIND_AG = 1, KIND_BCAST = 2 };

static const void* bcast_resolve(int itemsize) {
  switch (itemsize) {
    case 1: return (const void*)bcast_relay_kernel<uint8_t>;
    case 2: return (const void*)bcast_relay_kernel<uint16_t>;
    case 4: return (const void*)bcast_relay_kernel<uint32_t>;
    case 8: return (const void*)bcast_relay_kernel<uint64_t>;
  }
  return nullptr;
}

static cudaError_t capacity(const void* fn, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, ACCL_THREADS, 0);
  if (e != cudaSuccess) return e;
  *ctas = per_sm * sms;
  return cudaSuccess;
}

static RankPtrs table(const uint64_t* ptrs, int P) {
  RankPtrs t;
  memset(&t, 0, sizeof(t));
  for (int i = 0; i < P; ++i) t.p[i] = reinterpret_cast<void*>(ptrs[i]);
  return t;
}

static cudaError_t launch(const void* fn, int B, int nchan, int P, void** args,
                          cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = capacity(fn, &cap);
  if (e != cudaSuccess) return e;
  if ((long long)B * nchan * P > cap) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(B, nchan, P), dim3(ACCL_THREADS), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

enum { COPY_SCATTER = 0, COPY_GATHER = 1, COPY_ALLTOALL = 2 };

template <typename T>
static const void* copy_fn(int kind) {
  switch (kind) {
    case COPY_SCATTER: return (const void*)scatter_copy_kernel<T>;
    case COPY_GATHER: return (const void*)gather_copy_kernel<T>;
    case COPY_ALLTOALL: return (const void*)alltoall_copy_kernel<T>;
  }
  return nullptr;
}

static const void* copy_resolve(int kind, int itemsize) {
  switch (itemsize) {
    case 1: return copy_fn<uint8_t>(kind);
    case 2: return copy_fn<uint16_t>(kind);
    case 4: return copy_fn<uint32_t>(kind);
    case 8: return copy_fn<uint64_t>(kind);
  }
  return nullptr;
}

// An ordinary launch of (bx, gy, gz) CTAs, bx covering n elements' 16-byte
// vectors once.
static cudaError_t launch_copy(const void* fn, int gy, int gz, long long n, int itemsize,
                               void** args, cudaStream_t stream) {
  const long long vec = ((long long)itemsize * n + 15) / 16;
  const long long bx = (vec + ACCL_THREADS - 1) / ACCL_THREADS;
  if (bx > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)bx, (unsigned)gy, (unsigned)gz),
                                   dim3(ACCL_THREADS), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" {

// Co-resident CTAs of one kernel on the current device (-1: no such kernel).
// kind: KIND_*; dtype is the element size for every kind but KIND_RS.
int accl_ring_capacity(int kind, int chunked, int dtype, int wire, int* ctas) {
  const void* fn = kind == KIND_RS   ? rs_resolve(chunked, dtype, wire)
                   : kind == KIND_AG ? ag_resolve(chunked, dtype)
                                     : bcast_resolve(dtype);
  if (fn == nullptr) return -1;
  return (int)capacity(fn, ctas);
}

int accl_ring_threads() { return ACCL_THREADS; }

// rs_fold_kernel: x the per-rank (P, L) chunk rows, out the per-rank (L,)
// rows; an ordinary launch of (vectors of L, P) CTAs.
int accl_ring_rs_fold(int dtype, int wire, const uint64_t* x, const uint64_t* out, int P,
                      long long L, int func, float scale, void* stream) {
  const void* fn = rs_resolve(0, dtype, wire);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || L < 1) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P);
  void* args[] = {&tx, &to, &P, &L, &func, &scale};
  return (int)launch_copy(fn, P, 1, L, dt_size(dtype), args, static_cast<cudaStream_t>(stream));
}

// chunked_rs_kernel: one reduce-scatter ring phase over C segments.
int accl_ring_rs(int dtype, int wire, const uint64_t* x, const uint64_t* out,
                 const uint64_t* stage, void* flags, int P, int C, long long S, int B,
                 int nchan, int bidir, int func, float scale, double timeout_s,
                 void* stream) {
  const void* fn = rs_resolve(1, dtype, wire);
  if (fn == nullptr || P < 1 || P > ACCL_MAX_RANKS) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P), ts = table(stage, P);
  int* f = static_cast<int*>(flags);
  unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  void* args[] = {&tx, &to, &ts, &f, &P, &C, &S, &bidir, &func, &scale, &tns};
  return (int)launch(fn, B, nchan, P, args, static_cast<cudaStream_t>(stream));
}

// All-gather ring phase over elements of `itemsize` bytes.
int accl_ring_ag(int chunked, int itemsize, const uint64_t* x, const uint64_t* out,
                 void* flags, int P, int C, long long S, int B, int nchan, int bidir,
                 double timeout_s, void* stream) {
  const void* fn = ag_resolve(chunked, itemsize);
  if (fn == nullptr || P < 1 || P > ACCL_MAX_RANKS) return (int)cudaErrorInvalidValue;
  if (!chunked && (C != 1 || nchan != 1)) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P);
  int* f = static_cast<int*>(flags);
  unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  long long L = S;
  if (chunked) {
    void* args[] = {&tx, &to, &f, &P, &C, &S, &bidir, &tns};
    return (int)launch(fn, B, nchan, P, args, static_cast<cudaStream_t>(stream));
  }
  void* args[] = {&tx, &to, &f, &P, &L, &tns};
  return (int)launch(fn, B, 1, P, args, static_cast<cudaStream_t>(stream));
}

// The bcast relay over elements of `itemsize` bytes.
int accl_ring_relay(int itemsize, const uint64_t* x, const uint64_t* out, void* flags, int P,
                    int C, long long S, int B, int root, double timeout_s, void* stream) {
  const void* fn = bcast_resolve(itemsize);
  if (fn == nullptr || P < 1 || P > ACCL_MAX_RANKS || root < 0 || root >= P)
    return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P);
  int* f = static_cast<int*>(flags);
  unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  void* args[] = {&tx, &to, &f, &P, &C, &S, &root, &tns};
  return (int)launch(fn, B, 1, P, args, static_cast<cudaStream_t>(stream));
}

// scatter_copy_kernel: x is the root's (P, n) blocks, out the per-rank rows.
int accl_ring_scatter(int itemsize, const void* x, const uint64_t* out, int P, long long n,
                      int root, void* stream) {
  const void* fn = copy_resolve(COPY_SCATTER, itemsize);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || root < 0 || root >= P || n < 1)
    return (int)cudaErrorInvalidValue;
  RankPtrs to = table(out, P);
  void* args[] = {&x, &to, &n, &root};
  return (int)launch_copy(fn, P - 1, 1, n, itemsize, args, static_cast<cudaStream_t>(stream));
}

// gather_copy_kernel: x the per-rank blocks, out the root's (P, n) slots.
int accl_ring_gather(int itemsize, const uint64_t* x, void* out, int P, long long n, int root,
                     void* stream) {
  const void* fn = copy_resolve(COPY_GATHER, itemsize);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || root < 0 || root >= P || n < 1)
    return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P);
  void* args[] = {&tx, &out, &n, &root};
  return (int)launch_copy(fn, P - 1, 1, n, itemsize, args, static_cast<cudaStream_t>(stream));
}

// alltoall_copy_kernel: x and out the per-rank (P, n) rows, by destination
// and by source rank; out must not alias x.
int accl_ring_alltoall(int itemsize, const uint64_t* x, const uint64_t* out, int P, long long n,
                       void* stream) {
  const void* fn = copy_resolve(COPY_ALLTOALL, itemsize);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || n < 1) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P);
  void* args[] = {&tx, &to, &n};
  return (int)launch_copy(fn, P - 1, P, n, itemsize, args, static_cast<cudaStream_t>(stream));
}

const char* accl_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
