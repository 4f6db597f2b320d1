// Pipeline-tick activation relay for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas TPU kernel of the 1F1B relay:
//   pp_relay_kernel <- accl_tpu/ops/pipeline_relay.py:_relay_kernel (:155,
//                      called from _relay_call, :252): one pipeline tick's
//                      two hops, the forward activation one stage ahead and
//                      the gradient one stage back
//
// Layout: four per-rank pointer tables, f, b (inputs) and fo, bo (outputs),
// each entry a stage row of L lanes of lane_bytes bytes. Channel 0 writes
// fo[r] = f[r-1] and channel 1 writes bo[r] = b[r+1], ranks modulo P, every
// lane apart. The rows are reached through the tables only, so the same
// kernel can later read peer-mapped rows on other cards.
//
// Design. On a TPU the hop is a remote DMA between chips: each channel
// stages 1 MiB segments through two VMEM send slots, lands them in two
// receive slots gated by credits, and a barrier pairs the neighbours first.
// On one card every input row is complete when the kernel starts and each
// output byte is written exactly once, so slots, credits and the barrier
// have nothing to order and are not carried over; nor is the TPU's padding
// of the payload into the (C, sr, 128) segment grid and the copy back. The
// JAX plan's C segments stay the unit of work: a block copies one tile of
// PP_TILE bytes of one segment of one lane of one destination row on one
// channel (grid x: (lane, segment, tile); y: destination rank; z: channel),
// both channels in the one launch of a tick. The copy works on bytes, any
// element type: 16-byte vector loads and stores where source and
// destination are both 16-byte aligned (else the widest common alignment),
// four loads in flight per thread before their stores, and a ragged tail.
//
// Bound. The kernel reads each channel's payload once and writes it once,
// so the card's 3.35 TB/s bounds it: at (8, 512, 3072) f32 per channel that
// is 201.3 MB moved, 0.060 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#define PP_MAX_RANKS 64
#define PP_THREADS 256
#define PP_TILE (64 * 1024)  // bytes one block copies

struct RankPtrs {
  void* p[PP_MAX_RANKS];
};

// Copies n bytes from s to d in words of type T (both pointers aligned to
// sizeof(T)), then the bytes of the tail.
template <typename T>
__device__ __forceinline__ void copy_words(const char* __restrict__ s, char* __restrict__ d,
                                           long long n) {
  const T* __restrict__ sw = reinterpret_cast<const T*>(s);
  T* __restrict__ dw = reinterpret_cast<T*>(d);
  const long long nw = n / (long long)sizeof(T);
  long long i = threadIdx.x;
  for (; i + 3 * PP_THREADS < nw; i += 4 * PP_THREADS) {
    T a0 = sw[i];
    T a1 = sw[i + PP_THREADS];
    T a2 = sw[i + 2 * PP_THREADS];
    T a3 = sw[i + 3 * PP_THREADS];
    dw[i] = a0;
    dw[i + PP_THREADS] = a1;
    dw[i + 2 * PP_THREADS] = a2;
    dw[i + 3 * PP_THREADS] = a3;
  }
  for (; i < nw; i += PP_THREADS) dw[i] = sw[i];
  for (long long j = nw * (long long)sizeof(T) + threadIdx.x; j < n; j += PP_THREADS) d[j] = s[j];
}

__global__ void __launch_bounds__(PP_THREADS)
pp_relay_kernel(RankPtrs f, RankPtrs b, RankPtrs fo, RankPtrs bo, int P, int C,
                long long lane_bytes, long long seg_bytes, int tiles) {
  const int chan = blockIdx.z;
  const int r = blockIdx.y;
  long long x = blockIdx.x;
  const long long tile = x % tiles;
  x /= tiles;
  const long long c = x % C;
  const long long lane = x / C;
  const int src = chan == 0 ? (r + P - 1) % P : (r + 1) % P;
  const long long seg_hi = min((c + 1) * seg_bytes, lane_bytes);
  const long long lo = c * seg_bytes + tile * PP_TILE;
  if (lo >= seg_hi) return;
  const long long n = min((long long)PP_TILE, seg_hi - lo);
  const long long base = lane * lane_bytes + lo;
  const char* s = static_cast<const char*>(chan == 0 ? f.p[src] : b.p[src]) + base;
  char* d = static_cast<char*>(chan == 0 ? fo.p[r] : bo.p[r]) + base;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d);
  if ((mis & 15) == 0)
    copy_words<uint4>(s, d, n);
  else if ((mis & 7) == 0)
    copy_words<uint2>(s, d, n);
  else if ((mis & 3) == 0)
    copy_words<uint32_t>(s, d, n);
  else if ((mis & 1) == 0)
    copy_words<uint16_t>(s, d, n);
  else
    copy_words<uint8_t>(s, d, n);
}

static RankPtrs table(const uint64_t* ptrs, int P) {
  RankPtrs t = {};
  for (int i = 0; i < P; ++i) t.p[i] = reinterpret_cast<void*>(ptrs[i]);
  return t;
}

extern "C" {

// One tick's relay over P stage rows of L lanes of lane_bytes bytes each,
// lanes cut in C segments of seg_bytes (the last ragged).
int accl_pipeline_relay(const uint64_t* f, const uint64_t* b, const uint64_t* fo,
                        const uint64_t* bo, int P, int L, long long lane_bytes,
                        long long seg_bytes, int C, void* stream) {
  if (P < 1 || P > PP_MAX_RANKS || L < 1 || C < 1 || seg_bytes < 1 || lane_bytes < 1 ||
      (long long)C * seg_bytes < lane_bytes)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (seg_bytes + PP_TILE - 1) / PP_TILE;
  const long long nx = (long long)L * C * tiles;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  RankPtrs tf = table(f, P), tb = table(b, P), tfo = table(fo, P), tbo = table(bo, P);
  dim3 grid((unsigned)nx, (unsigned)P, 2);
  pp_relay_kernel<<<grid, PP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tf, tb, tfo, tbo, P, C, lane_bytes, seg_bytes, (int)tiles);
  return (int)cudaGetLastError();
}

const char* accl_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
