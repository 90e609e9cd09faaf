// K2 — the refinement loop of Algorithm 1 in one pass on Hopper: int32
// counts of |f32(g) + f32(e)| > t_j for 1..128 thresholds.  The same
// kernel with one threshold and no e is K4b, the unfused pipeline's
// count_gt.
//
// Replaces the TPU kernels repro/kernels/ef_fused/tree_count.py:
// tree_count (pallas_call at line 93) and repro/kernels/gaussian_topk/
// count_gt.py:count_gt (pallas_call at line 34).
//
// What it computes: counts[j] = #{i < d : |u_i| > t_j}, u = f32(g) +
// f32(e) (e may be absent: u = f32(g)), as the reference's _load_u forms
// it (tree_count.py:36-38).  Elements past d are never counted.  A count
// is an exact integer whatever the order of its sums, so the grid is the
// kernel's own: it does not follow the stats block.
//
// What bounds it on the card: bytes, barely.  Each element is read once
// (8 B at f32 g and e, 4 B at bf16): at the 268,435,456-element leaf
// 0.641 ms at f32 and 0.321 ms at bf16 at 3.35 TB/s.  At the SM's issue
// limit (128 lane-operations a clock an SM, 132 SMs at 1.98 GHz) the bf16
// bound leaves about 40 operations an element, and the refinement tree
// asks 15 compare-and-adds of each.
//
// What the design does about it:
//   * the thresholds are sorted and their duplicates removed on the host
//     (the heap of the refinement tree holds equal values: 0.5·1.5·t0 ==
//     1.5·0.5·t0 in f32, so its 15 thresholds are 10 distinct ones);
//     they travel in the kernel's parameters, and each CTA maps its
//     distinct counts back to heap order, duplicates included, in its
//     final atomics;
//   * a compare-and-add is two instructions (FSETP with the |.| modifier
//     of the operand, free, and a predicated IADD), and the counters live
//     in registers, NT of them, NT a template parameter in {1, 2, 4, 8,
//     10, 16}: the tree's 10 distinct thresholds take 20 instructions an
//     element, and widening, adding and unpacking bf16 pairs 1-3 more;
//   * every lane issues 16-byte loads, 4 f32 or 8 bf16 of g and the
//     matching elements of e (8, 16 or 32 bytes), UNROLL groups of them
//     before the first compare, over a persistent grid that fills the
//     SMs (the occupancy API's CTAs an SM) with a grid-stride loop;
//   * one warp reduction (__reduce_add_sync) a counter at the end, one
//     shared-memory add a warp and one global atomicAdd a CTA and
//     threshold into the zeroed output;
//   * the elements before the first 16-byte boundary of g and after the
//     last whole group, and every element of a view whose e does not
//     share g's alignment, take a scalar loop of the same kernel;
//   * more than 16 distinct thresholds (at most 128, not the main path)
//     take a y-dimension of the grid, 16 thresholds a slice, each slice
//     reading the operands again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TC_THREADS 256
#define TC_UNROLL 4          // 16-byte groups of g a lane loads before it counts
#define TC_SLICE 16          // distinct thresholds a slice of the grid
#define TC_MAX 128

typedef __nv_bfloat16 bf16;

struct Thresholds {
  float t[TC_MAX];      // distinct, ascending, padded with +inf to a slice
  int slot[TC_MAX];     // heap position j -> its distinct threshold
  int n;                // heap positions (the output's length)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// two bf16 in one 32-bit word (the lower address in the low half), as f32
__device__ __forceinline__ void bf16x2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T>
struct Group {
  static constexpr int n = 16 / (int)sizeof(T);
};

// N consecutive elements at p as f32, p aligned to the bytes it loads
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const bf16* __restrict__ p,
                                         float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    if (N - i >= 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
      bf16x2(v.x, x + i);
      bf16x2(v.y, x + i + 2);
      bf16x2(v.z, x + i + 4);
      bf16x2(v.w, x + i + 6);
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i));
      bf16x2(v.x, x + i);
      bf16x2(v.y, x + i + 2);
    }
  }
}

template <int NT>
__device__ __forceinline__ void count(float x, const float (&t)[NT],
                                      int (&c)[NT]) {
  const float a = fabsf(x);
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j] += a > t[j] ? 1 : 0;
}

// The vector part covers groups [0, ng) of GS elements from element
// `head` (g + head is 16-byte aligned, e + head aligned to its group's
// bytes); the scalar part covers [0, head) and [head + ng·GS, d).  A view
// without a common alignment passes head = 0, ng = 0: all scalar.
template <typename TG, typename TE, bool HAS_E, int NT>
__global__ void __launch_bounds__(TC_THREADS)
count_kernel(const TG* __restrict__ g, const TE* __restrict__ e, long long d,
             long long head, long long ng, const Thresholds P,
             int* __restrict__ out) {
  constexpr int GS = Group<TG>::n;
  __shared__ int tot[NT];
  const int s0 = blockIdx.y * TC_SLICE;
  float t[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) t[j] = P.t[s0 + j];
  int c[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j] = 0;
  if (threadIdx.x < NT) tot[threadIdx.x] = 0;

  const long long tid = (long long)blockIdx.x * TC_THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * TC_THREADS;
  const TG* gv = g + head;
  const TE* ev = HAS_E ? e + head : nullptr;
  // whole rounds: every lane has UNROLL groups, all loads before counting
  const long long full = ng / (nthreads * TC_UNROLL) * (nthreads * TC_UNROLL);
  for (long long q0 = tid; q0 < full; q0 += nthreads * TC_UNROLL) {
    float x[TC_UNROLL][GS];
#pragma unroll
    for (int r = 0; r < TC_UNROLL; ++r)
      load_vec<GS>(gv + (q0 + r * nthreads) * GS, x[r]);
    if (HAS_E) {
      float y[TC_UNROLL][GS];
#pragma unroll
      for (int r = 0; r < TC_UNROLL; ++r)
        load_vec<GS>(ev + (q0 + r * nthreads) * GS, y[r]);
#pragma unroll
      for (int r = 0; r < TC_UNROLL; ++r)
#pragma unroll
        for (int i = 0; i < GS; ++i) x[r][i] += y[r][i];
    }
#pragma unroll
    for (int r = 0; r < TC_UNROLL; ++r)
#pragma unroll
      for (int i = 0; i < GS; ++i) count<NT>(x[r][i], t, c);
  }
  // the groups of the last partial round, one at a time
  for (long long q = full + tid; q < ng; q += nthreads) {
    float x[GS];
    load_vec<GS>(gv + q * GS, x);
    if (HAS_E) {
      float y[GS];
      load_vec<GS>(ev + q * GS, y);
#pragma unroll
      for (int i = 0; i < GS; ++i) x[i] += y[i];
    }
#pragma unroll
    for (int i = 0; i < GS; ++i) count<NT>(x[i], t, c);
  }
  // the scalar elements: the head, then the tail past the last group
  const long long tail = head + ng * GS;
  const long long ns = head + (d - tail);
  for (long long s = tid; s < ns; s += nthreads) {
    const long long i = s < head ? s : tail + (s - head);
    float x = to_f32(g[i]);
    if (HAS_E) x += to_f32(e[i]);
    count<NT>(x, t, c);
  }

  __syncthreads();  // tot is zeroed
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned w = __reduce_add_sync(0xffffffffu, (unsigned)c[j]);
    if (lane == 0 && w) atomicAdd(&tot[j], (int)w);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < P.n; h += TC_THREADS) {
    const int s = P.slot[h] - s0;
    if (s >= 0 && s < NT && s < TC_SLICE && tot[s]) atomicAdd(out + h, tot[s]);
  }
}

static int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename TG, typename TE, bool HAS_E, int NT>
static int launch(const void* g, const void* e, long long d,
                  const Thresholds& P, int slices, void* out,
                  cudaStream_t stream) {
  constexpr int GS = Group<TG>::n;
  constexpr uintptr_t EALIGN = GS * sizeof(TE) < 16 ? GS * sizeof(TE) : 16;
  const uintptr_t ga = (uintptr_t)g;
  long long head = (long long)((16 - ga % 16) % 16 / sizeof(TG));
  if (head > d) head = d;
  long long ng = (d - head) / GS;
  if ((ga + head * sizeof(TG)) % 16 != 0 ||
      (HAS_E && ((uintptr_t)e + head * sizeof(TE)) % EALIGN != 0)) {
    head = 0;  // no common alignment: every element scalar
    ng = 0;
  }
  auto kern = count_kernel<TG, TE, HAS_E, NT>;
  static int per_sm = 0;  // resident CTAs an SM, asked once a kernel
  if (per_sm < 1) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS,
                                                  0);
    if (per_sm < 1) per_sm = 1;
  }
  const long long work = ng > 0 ? ng : d;
  long long ctas = (work + TC_THREADS * TC_UNROLL - 1) /
                   (TC_THREADS * TC_UNROLL);
  const long long cap = (long long)sm_count() * per_sm;
  if (ctas > cap) ctas = cap;
  if (ctas < 1) ctas = 1;
  kern<<<dim3((unsigned)ctas, (unsigned)slices), TC_THREADS, 0, stream>>>(
      (const TG*)g, (const TE*)e, d, head, ng, P, (int*)out);
  return (int)cudaGetLastError();
}

template <typename TG, typename TE, bool HAS_E>
static int by_width(const void* g, const void* e, long long d,
                    const Thresholds& P, int n_distinct, void* out,
                    cudaStream_t stream) {
  const int slices = (n_distinct + TC_SLICE - 1) / TC_SLICE;
  if (n_distinct <= 1)
    return launch<TG, TE, HAS_E, 1>(g, e, d, P, 1, out, stream);
  if (n_distinct <= 2)
    return launch<TG, TE, HAS_E, 2>(g, e, d, P, 1, out, stream);
  if (n_distinct <= 4)
    return launch<TG, TE, HAS_E, 4>(g, e, d, P, 1, out, stream);
  if (n_distinct <= 8)
    return launch<TG, TE, HAS_E, 8>(g, e, d, P, 1, out, stream);
  if (n_distinct <= 10)
    return launch<TG, TE, HAS_E, 10>(g, e, d, P, 1, out, stream);
  return launch<TG, TE, HAS_E, 16>(g, e, d, P, slices, out, stream);
}

// thr: the n_distinct distinct thresholds, ascending (host memory);
// slot: for each of the n heap positions its index in thr (host memory);
// out: n int32 on the device, zeroed here and then counted into.  g_bf16 /
// e_bf16: 1 when the operand is bf16, 0 when f32; e may be null.
extern "C" int tree_count(const void* g, const void* e, int g_bf16,
                          int e_bf16, long long d, const float* thr,
                          int n_distinct, const int* slot, int n, void* out,
                          void* stream) {
  if (n_distinct < 1 || n_distinct > TC_MAX || n < 1 || n > TC_MAX)
    return (int)cudaErrorInvalidValue;
  Thresholds P;
  const int padded = (n_distinct + TC_SLICE - 1) / TC_SLICE * TC_SLICE;
  for (int j = 0; j < TC_MAX; ++j)
    P.t[j] = j < n_distinct ? thr[j] : HUGE_VALF;
  for (int j = 0; j < TC_MAX; ++j) P.slot[j] = j < n ? slot[j] : padded;
  P.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)n * sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  if (e == nullptr)
    return g_bf16 ? by_width<bf16, bf16, false>(g, e, d, P, n_distinct, out, s)
                  : by_width<float, float, false>(g, e, d, P, n_distinct, out,
                                                  s);
  if (g_bf16)
    return e_bf16 ? by_width<bf16, bf16, true>(g, e, d, P, n_distinct, out, s)
                  : by_width<bf16, float, true>(g, e, d, P, n_distinct, out,
                                                s);
  return e_bf16 ? by_width<float, bf16, true>(g, e, d, P, n_distinct, out, s)
                : by_width<float, float, true>(g, e, d, P, n_distinct, out, s);
}
