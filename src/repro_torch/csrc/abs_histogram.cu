// K4d — the 128-bin |x| magnitude histogram of hist-k on Hopper.
//
// Replaces the TPU kernel repro/kernels/histk/hist.py:abs_histogram
// (pallas_call at line 62).  Until this kernel K4d was K1's Triton
// statistics kernel with the histogram switched on (tl.histogram into one
// 512-byte int32 row per 4096-element block, rows summed by torch); that
// design stays for K1's own histogram (kernels/ef_fused/fused_moments.py).
//
// What it computes: the int64 counts of the d elements of x in the bins
//   b = 4*(E - 111) + q, clamped to [0, 127],
// E the biased f32 exponent of |x| and q the number of the edge mantissas
// of 2^(1/4), 2^(1/2), 2^(3/4) at or below its mantissa
// (kernels/histk/hist.py:bin_of) — the exact position of |x| among the
// f32 bin edges.  Zero and subnormals land in bin 0; inf, NaN and
// everything at or above edge[127] in bin 127.  Integer counts do not
// depend on the order they are taken in, so the result is bitwise the
// plain version's at any block and grid.
//
// What bounds it on the card: bytes.  One read of x, 4 bytes an element
// (2 in bf16): 0.321 ms (0.160) for the 268,435,456-element leaf at 3.35
// TB/s.  The binning is
// ~10 integer operations an element, far below the compute roof.  The
// Triton design reached 36% of that bound (0.886 ms on an NVIDIA H100
// 80GB HBM3 at 700 W): tl.histogram's per-element votes and the 33-67 MB
// of per-block rows it wrote and folded, not the reading of x, set its
// time (K4a reads the same bytes in 0.420 ms).
//
// What the design does about it:
//   * a persistent grid, at most one CTA of 12 warps per SM, walks x with
//     a grid stride in 16-byte loads (4 f32 or 8 bf16; 8 per lane in
//     flight, 48 KB per SM), with a scalar head and tail for a view that
//     does not start on a 16-byte boundary or whose length is not a
//     multiple of the load's elements; a bf16 element is binned by its
//     f32 value, the top half of the word (exact);
//   * every lane counts into its own 128 uint32 counters in shared memory
//     (192 KB a CTA), counter b of lane l at word b*32 + l: no two lanes
//     share a counter and lane l's counters all sit in bank l, so the
//     updates meet no address conflict and no bank conflict, however
//     crowded the bins (gradient magnitudes crowd into a handful);
//   * at the end each CTA folds its 384 sub-histograms, bin by bin, with
//     a warp reduction, and adds the 128 sums into the int64 output with
//     integer atomicAdd (exact and order-free; no float atomics): 1 KB of
//     atomic adds per CTA, no per-block rows and no fold launch.  The
//     wrapper zeroes the output first.
//
// Measured by chip_smoke.py at the 268M leaf on an NVIDIA H100 80GB HBM3
// at 700 W: 0.380 ms against the bound's 0.321 (the Triton design 0.879 in
// the same run).  launch/tune_kernels.py times the alternatives: plain
// increments of the per-lane counters 0.445 ms (the atomics issue
// without waiting on a load), one histogram per warp with
// __match_any_sync and a leader's atomicAdd 1.26 ms, 4 or 16 float4 a
// lane in flight within 2%.
//
// Counter widths: a lane's counter counts at most the elements that lane
// visits, about d / (CTAs * 384); it overflows 32 bits only for d above
// 2^32 * 384 elements, far beyond any tensor this port makes.  The fold
// sums in 64 bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BINS 128
#define HIST_WARPS 12
#define HIST_THREADS (HIST_WARPS * 32)
#define HIST_U 8  // float4 loads per lane in flight
#define HIST_SMEM (HIST_WARPS * BINS * 32 * 4)  // 196,608 bytes

__device__ __forceinline__ int bin_of(float v) {
  const unsigned bits = __float_as_uint(v) & 0x7fffffffu;
  const unsigned man = bits & 0x7fffffu;
  const int q = (man >= 0x1837F0u) + (man >= 0x3504F3u) + (man >= 0x5744FDu);
  const int b = (int)(bits >> 23) * 4 - 444 + q;
  return b < 0 ? 0 : (b > BINS - 1 ? BINS - 1 : b);
}

// this lane's counter of v's bin (h points at the lane's first counter)
__device__ __forceinline__ void count(unsigned* h, float v) {
  atomicAdd(h + bin_of(v) * 32, 1u);
}

__device__ __forceinline__ void count(unsigned* h, __nv_bfloat16 v) {
  count(h, __bfloat162float(v));
}

// the elements of one 16-byte load: 4 f32, or 8 bf16 (the lower address
// in each word's low half; a bf16 is the top half of its f32: exact)
__device__ __forceinline__ void count16(unsigned* h, uint4 v, float) {
  count(h, __uint_as_float(v.x));
  count(h, __uint_as_float(v.y));
  count(h, __uint_as_float(v.z));
  count(h, __uint_as_float(v.w));
}

__device__ __forceinline__ void count16(unsigned* h, uint4 v,
                                        __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    count(h, __uint_as_float(w[i] << 16));
    count(h, __uint_as_float(w[i] & 0xffff0000u));
  }
}

template <typename T>
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_kernel(const T* __restrict__ x, long long d, long long head,
            unsigned long long* __restrict__ out) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte load
  extern __shared__ uint4 smem4[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < HIST_SMEM / 16; i += HIST_THREADS)
    smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  unsigned* h = sh + warp * (BINS * 32) + lane;

  // head elements before the first 16-byte boundary, tail after the last
  // whole 16-byte load: at most V - 1 each, counted by the first CTA's
  // threads
  const long long n4 = (d - head) / V;
  const long long tail = head + V * n4;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) count(h, x[threadIdx.x]);
    if (threadIdx.x < d - tail) count(h, x[tail + threadIdx.x]);
  }

  const uint4* x4 = reinterpret_cast<const uint4*>(x + head);
  const long long stride = (long long)gridDim.x * HIST_THREADS;
  long long i = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
  for (; i + (HIST_U - 1) * stride < n4; i += HIST_U * stride) {
    uint4 v[HIST_U];
#pragma unroll
    for (int u = 0; u < HIST_U; ++u) v[u] = __ldcs(x4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < HIST_U; ++u) count16(h, v[u], T());
  }
  for (; i < n4; i += stride) count16(h, __ldcs(x4 + i), T());
  __syncthreads();

  // fold: warp w sums bins w, w + 12, ...; lane l adds up the counters of
  // lane l of every warp, then the warp reduces its 32 partial sums
  for (int b = warp; b < BINS; b += HIST_WARPS) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) s += sh[(w * BINS + b) * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0 && s != 0) atomicAdd(out + b, s);
  }
}

// The SM count and the shared-memory opt-in, once per device.
static int g_sms[64];

static cudaError_t prepare(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && g_sms[dev] > 0) {
    *sms = g_sms[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hist_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HIST_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hist_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HIST_SMEM);
  if (err == cudaSuccess && dev < 64) g_sms[dev] = *sms;
  return err;
}

template <typename T>
static int launch(const void* x, long long d, void* out, void* stream,
                  int sms) {
  const int size = (int)sizeof(T);
  long long head = (long long)((16 - (uintptr_t)x % 16) % 16 / size);
  if (head > d) head = d;
  const long long n4 = (d - head) / (16 / size);
  const long long per_cta = (long long)HIST_THREADS * HIST_U;
  long long ctas = (n4 + per_cta - 1) / per_cta;
  if (ctas > sms) ctas = sms;
  if (ctas < 1) ctas = 1;
  hist_kernel<T><<<(unsigned)ctas, HIST_THREADS, HIST_SMEM,
                   (cudaStream_t)stream>>>((const T*)x, d, head,
                                           (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// x: d elements, f32 (x_bf16 = 0; any 4-byte aligned address) or bf16
// (x_bf16 = 1; any 2-byte aligned address), binned by their exact f32
// value; out: 128 int64 counts, zeroed by the caller, to which the kernel
// adds.
extern "C" int abs_histogram(const void* x, int x_bf16, long long d,
                             void* out, void* stream) {
  int sms = 0;
  const cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return (int)err;
  return x_bf16 ? launch<__nv_bfloat16>(x, d, out, stream, sms)
                : launch<float>(x, d, out, stream, sms);
}
