// The 128-bin |u| magnitude histogram of hist-k on Hopper, in two kernels
// of one template: K4d, the histogram of a materialised u, and K1 with its
// histogram, the histogram and the moments (s, sq, absmax) of u = g + e
// formed in registers from one read of g and e.
//
// Replaces the TPU kernels repro/kernels/histk/hist.py:abs_histogram
// (pallas_call at line 62) and repro/kernels/ef_fused/fused_moments.py:
// fused_moments with with_hist=True (pallas_call at line 144; K1 without
// the histogram stays K1's Triton kernel, kernels/ef_fused/
// fused_moments.py).  Both were first K1's Triton statistics kernel with
// the histogram switched on: tl.histogram into one 512-byte int32 row per
// stats block, the rows summed by torch and the padding zeros taken back
// out of bin 0.
//
// What it computes: the int64 counts of the d elements of u in the bins
//   b = 4*(E - 111) + q, clamped to [0, 127],
// E the biased f32 exponent of |u| and q the number of the edge mantissas
// of 2^(1/4), 2^(1/2), 2^(3/4) at or below its mantissa
// (kernels/histk/hist.py:bin_of) — the exact position of |u| among the
// f32 bin edges.  Zero and subnormals land in bin 0; inf, NaN and
// everything at or above edge[127] in bin 127.  Integer counts do not
// depend on the order they are taken in, so the histogram is bitwise the
// plain version's at any block and grid.  K1 also returns sum(u),
// sum(u*u) and max|u| (a NaN in u makes max|u| NaN, as torch's amax).
//
// What bounds it on the card: bytes.  One read of the operands: K4d 4
// bytes an element (2 in bf16), 0.321 ms (0.160) for the 268,435,456-
// element leaf at 3.35 TB/s; K1 8 bytes (4 with both operands bf16),
// 0.641 ms (0.321).  The binning is ~10 integer operations an element and
// the moments ~4 more, far below the compute roof.  The Triton design
// reached 36% of K4d's bound and 32% of K1's at bf16 (0.886 and 1.009 ms
// on an NVIDIA H100 80GB HBM3 at 700 W; K1's time hardly fell when its
// bytes halved): tl.histogram's per-element votes and the 17-67 MB of
// per-block rows it wrote and folded, not the reading of the operands,
// set its time.
//
// What the design does about it:
//   * a persistent grid, at most one CTA of 12 warps per SM, walks g with
//     a grid stride in 16-byte loads (4 f32 or 8 bf16; HIST_U per lane in
//     flight, 48 KB per SM) and e's elements of the same loads beside them
//     (8, 16 or 32 bytes a load), with a scalar head and tail for a view
//     that does not start on a 16-byte boundary or whose length is not a
//     multiple of the load's elements; a view of e that is not aligned
//     like g is read element by element.  u is formed in f32 in registers
//     (a bf16 is the top half of its f32: exact) and never written;
//   * every lane counts into its own 128 uint32 counters in shared memory
//     (192 KB a CTA), counter b of lane l at word b*32 + l: no two lanes
//     share a counter and lane l's counters all sit in bank l, so the
//     updates meet no address conflict and no bank conflict, however
//     crowded the bins (gradient magnitudes crowd into a handful);
//   * at the end each CTA folds its 384 sub-histograms, bin by bin, with
//     a warp reduction, and adds the 128 sums into the int64 output with
//     integer atomicAdd (exact and order-free): 1 KB of atomic adds per
//     CTA, no per-block rows and no fold launch.  The wrapper zeroes the
//     output first;
//   * K1's moments stay in registers: each lane sums the elements of one
//     round of loads in f32 and adds that into f64 sums (so a lane's
//     thousands of elements cost no f32 drift), keeps max|u| as the
//     largest |u| bit pattern (the order of non-negative floats, NaN above
//     inf), and the CTA reduces them by warp shuffles and one pass over
//     its 12 warps in a fixed order into ONE (s, sq, mx) row of f64.  No
//     float atomics: the wrapper folds the rows (at most one per SM) with
//     torch's reductions, so a rerun on the same card gives the same bits.
//
// Measured by chip_smoke.py at the 268M leaf on an NVIDIA H100 80GB HBM3
// at 700 W: K4d 0.380 ms against the bound's 0.321 (the Triton design
// 0.879 in the same run); K1 with its histogram in PERF.md's kernel
// table.  launch/tune_kernels.py times K4d's alternatives: plain increments
// of the per-lane counters 0.445 ms (the atomics issue without waiting
// on a load), one histogram per warp with __match_any_sync and a leader's
// atomicAdd 1.26 ms, 4 or 16 float4 a lane in flight within 2%.
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
#define HIST_U 8  // 16-byte loads of g per lane in flight
#define HIST_SMEM (HIST_WARPS * BINS * 32 * 4)  // 196,608 bytes

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// N elements of T as raw 32-bit words, loaded with streaming loads of 8
// or 16 bytes (p aligned to the bytes of one load); element c as f32 (two
// bf16 a word, the lower address in the low half: the top half of an f32)
template <typename T, int N>
struct Pack {
  static constexpr int W = N * (int)sizeof(T) / 4;
  unsigned w[W];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (W == 2) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < W; k += 4) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + k / 4);
        w[k] = v.x;
        w[k + 1] = v.y;
        w[k + 2] = v.z;
        w[k + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ float get(int c) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[c]);
    return __uint_as_float(c & 1 ? w[c >> 1] & 0xffff0000u : w[c >> 1] << 16);
  }
};

// K1's moments of one lane: the round's f32 sums, the lane's f64 sums and
// the largest |u| bit pattern
struct Moments {
  float ps = 0.0f, psq = 0.0f;
  double s = 0.0, sq = 0.0;
  unsigned mx = 0u;
  __device__ __forceinline__ void add(float v) {
    ps += v;
    psq += v * v;
    mx = max(mx, __float_as_uint(v) & 0x7fffffffu);
  }
  __device__ __forceinline__ void flush() {
    s += (double)ps;
    sq += (double)psq;
    ps = psq = 0.0f;
  }
};

template <bool MOMENTS>
__device__ __forceinline__ void take(unsigned* h, Moments& m, float v) {
  count(h, v);
  if (MOMENTS) m.add(v);
}

template <typename TG, typename TE, bool HAS_E>
__device__ __forceinline__ float elem(const TG* __restrict__ g,
                                      const TE* __restrict__ e, long long i) {
  if constexpr (HAS_E) return to_f32(g[i]) + to_f32(e[i]);
  return to_f32(g[i]);
}

// The histogram of u = g (+ e) into out (and, with MOMENTS, CTA b's
// (s, sq, mx) into rows[3b..3b+2]; CTA 0 writes zeros into the rows of
// the nrows - gridDim.x CTAs that were not launched).  Elements [head,
// head + V*n4) are read in 16-byte loads of g (g + head and e + head
// aligned to them), the rest one by one.
template <typename TG, typename TE, bool HAS_E, bool MOMENTS>
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_kernel(const TG* __restrict__ g, const TE* __restrict__ e, long long d,
            long long head, long long n4, unsigned long long* __restrict__ out,
            double* __restrict__ rows, int nrows) {
  constexpr int V = 16 / (int)sizeof(TG);  // elements a 16-byte load of g
  extern __shared__ uint4 smem4[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < HIST_SMEM / 16; i += HIST_THREADS)
    smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  unsigned* h = sh + warp * (BINS * 32) + lane;
  Moments m;

  const long long stride = (long long)gridDim.x * HIST_THREADS;
  const long long t0 = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
  // the elements before the first 16-byte boundary and after the last
  // whole load (at most V - 1 each on an aligned view)
  for (long long i = t0; i < head; i += stride) {
    take<MOMENTS>(h, m, elem<TG, TE, HAS_E>(g, e, i));
    if (MOMENTS) m.flush();
  }
  for (long long i = head + V * n4 + t0; i < d; i += stride) {
    take<MOMENTS>(h, m, elem<TG, TE, HAS_E>(g, e, i));
    if (MOMENTS) m.flush();
  }

  const TG* gv = g + head;
  const TE* ev = HAS_E ? e + head : nullptr;
  long long i = t0;
  for (; i + (HIST_U - 1) * stride < n4; i += HIST_U * stride) {
    Pack<TG, V> a[HIST_U];
#pragma unroll
    for (int u = 0; u < HIST_U; ++u) a[u].load(gv + (i + u * stride) * V);
    if constexpr (HAS_E) {
      Pack<TE, V> b[HIST_U];
#pragma unroll
      for (int u = 0; u < HIST_U; ++u) b[u].load(ev + (i + u * stride) * V);
#pragma unroll
      for (int u = 0; u < HIST_U; ++u)
#pragma unroll
        for (int c = 0; c < V; ++c)
          take<MOMENTS>(h, m, a[u].get(c) + b[u].get(c));
    } else {
#pragma unroll
      for (int u = 0; u < HIST_U; ++u)
#pragma unroll
        for (int c = 0; c < V; ++c) take<MOMENTS>(h, m, a[u].get(c));
    }
    if (MOMENTS) m.flush();
  }
  for (; i < n4; i += stride) {
    Pack<TG, V> a;
    a.load(gv + i * V);
    if constexpr (HAS_E) {
      Pack<TE, V> b;
      b.load(ev + i * V);
#pragma unroll
      for (int c = 0; c < V; ++c) take<MOMENTS>(h, m, a.get(c) + b.get(c));
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) take<MOMENTS>(h, m, a.get(c));
    }
    if (MOMENTS) m.flush();
  }
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

  if constexpr (MOMENTS) {
    __shared__ double wsum[HIST_WARPS][2];
    __shared__ unsigned wmax[HIST_WARPS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m.s += __shfl_xor_sync(0xffffffffu, m.s, o);
      m.sq += __shfl_xor_sync(0xffffffffu, m.sq, o);
      m.mx = max(m.mx, __shfl_xor_sync(0xffffffffu, m.mx, o));
    }
    if (lane == 0) {
      wsum[warp][0] = m.s;
      wsum[warp][1] = m.sq;
      wmax[warp] = m.mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0, sq = 0.0;
      unsigned mx = 0u;
      for (int w = 0; w < HIST_WARPS; ++w) {
        s += wsum[w][0];
        sq += wsum[w][1];
        mx = max(mx, wmax[w]);
      }
      double* row = rows + 3 * (long long)blockIdx.x;
      row[0] = s;
      row[1] = sq;
      row[2] = (double)__uint_as_float(mx);
    }
    if (blockIdx.x == 0)
      for (int r = gridDim.x + threadIdx.x; r < nrows; r += HIST_THREADS) {
        rows[3 * r] = 0.0;
        rows[3 * r + 1] = 0.0;
        rows[3 * r + 2] = 0.0;
      }
  }
}

// Launch one instantiation: the shared-memory opt-in once per device, the
// vector region (g + head on a 16-byte boundary and e + head on its loads'
// bytes, else every element one by one) and at most one CTA per SM (and
// per row of K1's moments).
template <typename TG, typename TE, bool HAS_E, bool MOMENTS>
static int launch(const void* g, const void* e, long long d, void* out,
                  void* rows, int nrows, void* stream) {
  static int sms[64];  // per device, set at its first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hist_kernel<TG, TE, HAS_E, MOMENTS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 HIST_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    sms[dev] = n;
  }
  constexpr int V = 16 / (int)sizeof(TG);
  constexpr uintptr_t EALIGN =
      V * sizeof(TE) < 16 ? V * sizeof(TE) : 16;  // bytes of one load of e
  long long head = (long long)((16 - (uintptr_t)g % 16) % 16 / sizeof(TG));
  if (head > d) head = d;
  if (HAS_E && ((uintptr_t)e + head * sizeof(TE)) % EALIGN != 0) head = d;
  const long long n4 = (d - head) / V;
  const long long per_cta = (long long)HIST_THREADS * HIST_U * V;
  long long ctas = (d + per_cta - 1) / per_cta;
  if (ctas > sms[dev]) ctas = sms[dev];
  if (MOMENTS && ctas > nrows) ctas = nrows;
  if (ctas < 1) ctas = 1;
  hist_kernel<TG, TE, HAS_E, MOMENTS>
      <<<(unsigned)ctas, HIST_THREADS, HIST_SMEM, (cudaStream_t)stream>>>(
          (const TG*)g, (const TE*)e, d, head, n4, (unsigned long long*)out,
          (double*)rows, nrows);
  return (int)cudaGetLastError();
}

// K4d.  x: d elements, f32 (x_bf16 = 0; any 4-byte aligned address) or
// bf16 (x_bf16 = 1; any 2-byte aligned address), binned by their exact
// f32 value; out: 128 int64 counts, zeroed by the caller, to which the
// kernel adds.
extern "C" int abs_histogram(const void* x, int x_bf16, long long d,
                             void* out, void* stream) {
  return x_bf16
             ? launch<bf16, bf16, false, false>(x, nullptr, d, out, nullptr,
                                                0, stream)
             : launch<float, float, false, false>(x, nullptr, d, out,
                                                  nullptr, 0, stream);
}

// K1 with its histogram.  g: d elements, f32 or bf16 (g_bf16); e: d
// elements, f32 or bf16 (e_bf16), or null (u = g); hist: 128 int64
// counts, zeroed by the caller; rows: nrows >= 1 rows of three f64 (s,
// sq, max|u|), every one written (one per CTA, zeros past the grid).
extern "C" int fused_moments_hist(const void* g, const void* e, int g_bf16,
                                  int e_bf16, long long d, void* hist,
                                  void* rows, int nrows, void* stream) {
  if (nrows < 1) return (int)cudaErrorInvalidValue;
  if (e == nullptr)
    return g_bf16 ? launch<bf16, bf16, false, true>(g, e, d, hist, rows,
                                                    nrows, stream)
                  : launch<float, float, false, true>(g, e, d, hist, rows,
                                                      nrows, stream);
  if (g_bf16)
    return e_bf16 ? launch<bf16, bf16, true, true>(g, e, d, hist, rows,
                                                   nrows, stream)
                  : launch<bf16, float, true, true>(g, e, d, hist, rows,
                                                    nrows, stream);
  return e_bf16 ? launch<float, bf16, true, true>(g, e, d, hist, rows, nrows,
                                                  stream)
                : launch<float, float, true, true>(g, e, d, hist, rows,
                                                   nrows, stream);
}
