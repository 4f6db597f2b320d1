// Ring collective kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the four Pallas TPU kernels that carry ACCL.allreduce:
//   ring_rs_kernel     <- accl_tpu/parallel/pallas_ring.py     _rs_kernel
//   ring_ag_kernel     <- accl_tpu/parallel/pallas_ring.py     _ag_kernel
//   chunked_rs_kernel  <- accl_tpu/parallel/pallas_chunked.py  _chunked_rs_kernel
//   chunked_ag_kernel  <- accl_tpu/parallel/pallas_chunked.py  _chunked_ag_kernel
// and the rooted collectives (reduce is chunked_rs_kernel then
// gather_copy_kernel):
//   bcast_relay_kernel    <- accl_tpu/parallel/pallas_chunked.py  _chunked_bcast_kernel
//   scatter_copy_kernel   <- accl_tpu/parallel/pallas_chunked.py  _chunked_scatter_kernel
//   gather_copy_kernel    <- accl_tpu/parallel/pallas_chunked.py  _chunked_gather_kernel
// and the phased ring-rotation all-to-all:
//   alltoall_phase_kernel <- accl_tpu/parallel/pallas_chunked.py  _chunked_alltoall_kernel
//
// Rank model. A rank is a per-rank buffer reached through a pointer table
// (RankPtrs): on one card every rank's row of a (P, ...) tensor, on
// peer-mapped cards the peers' buffers. Rank r's portion of a launch is the
// group of CTAs with blockIdx.z == r; blockIdx.y is the ring channel and
// blockIdx.x cuts the segment into contiguous element ranges. One launch
// runs one ring phase (all P-1 hops).
//
// A hop is a read of the upstream rank's staged partial plus a fold with the
// local chunk. The TPU kernel's two-deep receive slot becomes two staging
// slots per rank and channel in global memory. Readiness ("content k is in
// slot k%2") and capacity credits ("downstream has folded content k") are
// flag words per (rank, channel, CTA), stored with st.release.gpu and read
// with ld.acquire.gpu; staged data is read with ld.global.cg so no stale L1
// line is ever folded. The all-gathers forward straight out of the
// upstream rank's output rows, which are written once, so they need
// readiness flags only.
//
// The bcast relay moves a root's payload one neighbour at a time along the
// ring (section "rooted relays" below); the all-to-all rotates every rank's
// chunks round the ring, phase by phase. The scatter and gather do not
// relay: each block goes straight from where it lies to where it belongs
// (section "rooted one-hop copies"). All four are pure transport, templated
// on the element's size, not its type: the TPU kernels run them in the wire
// dtype.
//
// No hang: the rings, the bcast relay and the all-to-all are launched
// cooperatively, so the grid is co-resident or refused, and every spin is
// bounded by %globaltimer. A spin that times out writes the error word and
// returns; every other spinner sees the word and returns too; the Python
// wrapper reads the word after the launch and raises. The one-hop copies
// wait on nothing and launch as ordinary grids.
//
// Bound. Every kernel here moves bytes and does at most one add per element
// read, so device memory bandwidth bounds it (3.35 TB/s on an H100 SXM). The
// ring kernels are simple on purpose: scalar coalesced accesses and a flag
// round trip per hop; TMA, 16-byte vector accesses and fewer flags are later
// work. The one-hop copies move 16 bytes per access (section below).

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
// the four kernels
// ---------------------------------------------------------------------------

// _rs_kernel: whole chunk as one segment, one channel
template <typename T, typename W>
__global__ void __launch_bounds__(ACCL_THREADS)
ring_rs_kernel(RankPtrs x, RankPtrs out, RankPtrs stage, int* flags, int P, long long L,
               int func, float scale, unsigned long long timeout_ns) {
  rs_ring<T, W>(x, out, stage, flags, P, 1, L, 1, 0, func, scale, false, timeout_ns);
}

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
// rooted one-hop copies: scatter and gather
// ---------------------------------------------------------------------------
//
// What the TPU kernels compute: a scatter sets out[r] = x[root][r], a gather
// sets slot s of the root's output to x[s], for every rank but the root.
// They relay because ICI is a torus of neighbour links: a block moves one
// ring position per hop and is read and written at each, P (P-1) / 2 block
// copies in all where the function needs P - 1. On one card every rank is
// a row in the same HBM, so here each block goes straight from where it
// lies to where it belongs, read once and written once: no ring positions,
// no staging slots, no flags, nothing waits on another CTA. Through
// peer-mapped cards on NVSwitch the root's NVLink port would bound a
// scatter or gather either way, so one hop is right there too.
//
// Bound: 2 (P-1) n elements of traffic over HBM bandwidth. The design spends
// the whole card on it: blockIdx.y picks the block, and blockIdx.x covers
// it in one pass, one 16-byte access per thread, so the grid's CTAs sweep
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

// ---------------------------------------------------------------------------
// phased ring-rotation all-to-all
// ---------------------------------------------------------------------------
//
// _chunked_alltoall_kernel. x[r]: (P, C, S), rank r's chunks by destination
// rank; out[r]: (P, C, S) by source rank, row r never written (the body
// inserts the rank's own chunk exactly); bounce[r]: (2, C, S). Phase s
// (1..P-1) moves every rank's chunk for rank r+s s hops right, segment by
// segment. Every rank runs the same global steps g = C s(s-1)/2 + h C + c
// (hop h of phase s, segment c): at step g rank r takes the segment its left
// neighbour sends at that step, read where it lies (the left's input chunk
// at hop 0, the left's bounce slot h%2 after it), and stores it in its
// output row r-s at the phase's last hop, else in its own bounce slot
// (h+1)%2, which its right neighbour reads at step g+C. So per hop a segment
// is read once and written once, as the TPU kernel's HBM traffic is; its
// send slot and remote copy become the direct read.
//
// One progress word per (rank, CTA): prog = g+1 once step g is done. To the
// right neighbour it is readiness (the bounce segment stored at step g is
// there); to the left it is the credit (the left's segment of step g has
// been read). A bounce slot's previous content was stored at least 2C steps
// earlier and read by the right neighbour C steps after that, so before
// overwriting a slot at step g a rank waits for its right neighbour to have
// finished step g-C; before reading the left's bounce it waits for the left
// to have finished step g-C. One chain over global steps spans all hops and
// phases, so a fast rank never overwrites a slot that still holds the
// previous hop's tail segments. Every wait is on a neighbour's step g-C < g,
// so the schedule cannot deadlock.
template <typename T>
__global__ void __launch_bounds__(ACCL_THREADS)
alltoall_phase_kernel(RankPtrs x, RankPtrs out, RankPtrs bounce, int* flags, int P, int C,
                      long long S, unsigned long long timeout_ns) {
  const int r = blockIdx.z, b = blockIdx.x, B = gridDim.x;
  const int left = (r - 1 + P) % P, right = (r + 1) % P;
  int* const err = flags + P * B;
  auto prog = [&](int rank) { return flags + rank * B + b; };
  const long long per = (S + B - 1) / B;
  const long long lo = min(S, (long long)b * per), hi = min(S, lo + per);
  const long long slot = (long long)C * S;
  const T* lx = static_cast<const T*>(x.p[left]);
  const T* lb = static_cast<const T*>(bounce.p[left]);
  T* mb = static_cast<T*>(bounce.p[r]);
  T* o = static_cast<T*>(out.p[r]);
  int g = 0;
  for (int s = 1; s < P; ++s) {
    for (int h = 0; h < s; ++h) {
      const bool last = (h == s - 1);
      for (int c = 0; c < C; ++c, ++g) {
        const T* src;
        if (h == 0) {
          src = lx + ((long long)((left + s) % P) * C + c) * S;
        } else {
          if (!block_wait(prog(left), g - C + 1, err, timeout_ns)) return;
          src = lb + (h & 1) * slot + (long long)c * S;
        }
        T* dst;
        if (last) {
          dst = o + ((long long)((r - s + P) % P) * C + c) * S;
        } else {
          if (!block_wait(prog(right), g - C + 1, err, timeout_ns)) return;
          dst = mb + ((h + 1) & 1) * slot + (long long)c * S;
        }
        copy_slice(dst, src, lo, hi, h > 0);
        block_fence();
        if (threadIdx.x == 0) st_release(prog(r), g + 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename T, typename W>
static const void* rs_fn(int chunked) {
  return chunked ? (const void*)chunked_rs_kernel<T, W> : (const void*)ring_rs_kernel<T, W>;
}

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

static const void* ag_resolve(int chunked, int itemsize) {
  switch (itemsize) {
    case 1: return chunked ? (const void*)chunked_ag_kernel<uint8_t> : (const void*)ring_ag_kernel<uint8_t>;
    case 2: return chunked ? (const void*)chunked_ag_kernel<uint16_t> : (const void*)ring_ag_kernel<uint16_t>;
    case 4: return chunked ? (const void*)chunked_ag_kernel<uint32_t> : (const void*)ring_ag_kernel<uint32_t>;
    case 8: return chunked ? (const void*)chunked_ag_kernel<uint64_t> : (const void*)ring_ag_kernel<uint64_t>;
  }
  return nullptr;
}

enum { KIND_RS = 0, KIND_AG = 1, KIND_BCAST = 2, KIND_ALLTOALL = 5 };

template <typename T>
static const void* relay_fn(int kind) {
  switch (kind) {
    case KIND_BCAST: return (const void*)bcast_relay_kernel<T>;
    case KIND_ALLTOALL: return (const void*)alltoall_phase_kernel<T>;
  }
  return nullptr;
}

static const void* relay_resolve(int kind, int itemsize) {
  switch (itemsize) {
    case 1: return relay_fn<uint8_t>(kind);
    case 2: return relay_fn<uint16_t>(kind);
    case 4: return relay_fn<uint32_t>(kind);
    case 8: return relay_fn<uint64_t>(kind);
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

template <typename T>
static const void* copy_fn(bool gather) {
  return gather ? (const void*)gather_copy_kernel<T> : (const void*)scatter_copy_kernel<T>;
}

static const void* copy_resolve(bool gather, int itemsize) {
  switch (itemsize) {
    case 1: return copy_fn<uint8_t>(gather);
    case 2: return copy_fn<uint16_t>(gather);
    case 4: return copy_fn<uint32_t>(gather);
    case 8: return copy_fn<uint64_t>(gather);
  }
  return nullptr;
}

// An ordinary launch of (bx, P - 1) CTAs, bx covering a block's 16-byte
// vectors once.
static cudaError_t launch_copy(const void* fn, int P, long long n, int itemsize,
                               void** args, cudaStream_t stream) {
  const long long vec = ((long long)itemsize * n + 15) / 16;
  const long long bx = (vec + ACCL_THREADS - 1) / ACCL_THREADS;
  if (bx > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)bx, (unsigned)(P - 1)),
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
                                     : relay_resolve(kind, dtype);
  if (fn == nullptr) return -1;
  return (int)capacity(fn, ctas);
}

int accl_ring_threads() { return ACCL_THREADS; }

// Reduce-scatter ring phase. chunked=0: ring_rs_kernel (C must be 1).
int accl_ring_rs(int chunked, int dtype, int wire, const uint64_t* x, const uint64_t* out,
                 const uint64_t* stage, void* flags, int P, int C, long long S, int B,
                 int nchan, int bidir, int func, float scale, double timeout_s,
                 void* stream) {
  const void* fn = rs_resolve(chunked, dtype, wire);
  if (fn == nullptr || P < 1 || P > ACCL_MAX_RANKS) return (int)cudaErrorInvalidValue;
  if (!chunked && (C != 1 || nchan != 1)) return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P), ts = table(stage, P);
  int* f = static_cast<int*>(flags);
  unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  long long L = S;
  if (chunked) {
    void* args[] = {&tx, &to, &ts, &f, &P, &C, &S, &bidir, &func, &scale, &tns};
    return (int)launch(fn, B, nchan, P, args, static_cast<cudaStream_t>(stream));
  }
  void* args[] = {&tx, &to, &ts, &f, &P, &L, &func, &scale, &tns};
  return (int)launch(fn, B, 1, P, args, static_cast<cudaStream_t>(stream));
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

// The bcast relay (KIND_BCAST) or the all-to-all (KIND_ALLTOALL, root
// unused), over elements of `itemsize` bytes; stage is the all-to-all's
// bounce, unused by the bcast.
int accl_ring_relay(int kind, int itemsize, const uint64_t* x, const uint64_t* out,
                    const uint64_t* stage, void* flags, int P, int C, long long S, int B,
                    int root, double timeout_s, void* stream) {
  const void* fn = relay_resolve(kind, itemsize);
  if (fn == nullptr || P < 1 || P > ACCL_MAX_RANKS || root < 0 || root >= P)
    return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P), to = table(out, P);
  int* f = static_cast<int*>(flags);
  unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_ALLTOALL) {
    RankPtrs tb = table(stage, P);
    void* args[] = {&tx, &to, &tb, &f, &P, &C, &S, &tns};
    return (int)launch(fn, B, 1, P, args, st);
  }
  void* args[] = {&tx, &to, &f, &P, &C, &S, &root, &tns};
  return (int)launch(fn, B, 1, P, args, st);
}

// scatter_copy_kernel: x is the root's (P, n) blocks, out the per-rank rows.
int accl_ring_scatter(int itemsize, const void* x, const uint64_t* out, int P, long long n,
                      int root, void* stream) {
  const void* fn = copy_resolve(false, itemsize);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || root < 0 || root >= P || n < 1)
    return (int)cudaErrorInvalidValue;
  RankPtrs to = table(out, P);
  void* args[] = {&x, &to, &n, &root};
  return (int)launch_copy(fn, P, n, itemsize, args, static_cast<cudaStream_t>(stream));
}

// gather_copy_kernel: x the per-rank blocks, out the root's (P, n) slots.
int accl_ring_gather(int itemsize, const uint64_t* x, void* out, int P, long long n, int root,
                     void* stream) {
  const void* fn = copy_resolve(true, itemsize);
  if (fn == nullptr || P < 2 || P > ACCL_MAX_RANKS || root < 0 || root >= P || n < 1)
    return (int)cudaErrorInvalidValue;
  RankPtrs tx = table(x, P);
  void* args[] = {&tx, &out, &n, &root};
  return (int)launch_copy(fn, P, n, itemsize, args, static_cast<cudaStream_t>(stream));
}

const char* accl_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
