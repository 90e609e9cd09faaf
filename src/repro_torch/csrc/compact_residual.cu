// K3 — pass B of the fused EF pipeline on Hopper: threshold compaction
// into per-block staging rows, then the residual write.  The stage
// kernel with HAS_E = false is also K4c, the unfused pipeline's
// threshold compaction of a materialised u.
//
// Replaces the TPU kernels repro/kernels/ef_fused/compact_residual.py:
// compact_residual (pallas_call sites at lines 191 (stage), 208
// (residual) and 237 (sequential one-sweep: _kernel)) and
// repro/kernels/gaussian_topk/threshold_compact.py:threshold_compact
// (pallas_call at line 54: the stage rows with no e; the TPU built them
// with a one-hot MXU matmul, here they come from the ballot scan below,
// whose offsets are exact integers).
//
// What it computes, per block of `block` elements of u = g + e:
//   mask = |u| > thres, pos = in-block exclusive prefix count of mask,
//   keep = mask & pos < bcap;
//   stage:    vals[pos] = u, offs[pos] = in-block offset for kept
//             elements (index order), slots >= min(cnt, bcap) padded with
//             0 / SENTINEL; cnt = the uncapped count;
//   residual: e' = 0 where keep & enc_before + pos < k_cap, else u, with
//             enc_before the exclusive cumsum of min(cnt, bcap) over the
//             preceding blocks (computed between the two launches).
//
// What bounds it on the card: bytes.  Stage reads g and e (8 B/element)
// and writes only the staging rows; residual reads them again and writes
// e' (12 B/element in all).  The work per element is a compare, a ballot
// and a popcount, far below the compute roof.  At the 268,435,456-element
// leaf (block 1024, bcap 64) the stage launch's bound is 0.681 ms and
// K4c's (no e) 0.361 ms at 3.35 TB/s; with bf16 operands (block 2048)
// 0.341 and 0.180 ms, and the residual's 0.481 ms.
//
// What the design does about it:
//   * stage (redesigned for Hopper): one WARP per block, 8 blocks per CTA
//     of 256 threads.  The first design (one CTA of 256 threads per block,
//     a ballot scan with two __syncthreads per chunk) reached only 42% of
//     K4c's bound (0.852 ms on an NVIDIA H100 80GB HBM3 at 700 W): halving
//     the bytes read made it only 15% faster, so short CTAs, barriers and
//     too few bytes in flight bound it, not the bytes.  Now each lane
//     issues 8 float4 loads (16 bytes each; 4 KB a warp, 8 KB with e; a
//     bf16 g: 4 loads of 8 elements) before it scans, the in-order
//     position comes from one warp ballot an element of a load and
//     popcounts under the lane's mask, and the warp writes
//     its own padding and count — no shared memory, no barrier.  Views
//     that are not 16-byte aligned (a storage offset of 1-3 elements, a
//     block not a multiple of 4) take the scalar-load instantiation of the
//     same kernel.  Measured by chip_smoke.py at that leaf on an NVIDIA
//     H100 80GB HBM3 at 700 W: K3 stage 0.773 ms (bound 0.681), K4c 0.441
//     ms (bound 0.361) and 0.404 ms at block 2048 (bound 0.341), against
//     0.984 and 0.840 ms for the first design in the same run.  Of the
//     variants that launch/tune_kernels.py times, 4 or 16 blocks a CTA
//     and 4 float4 a lane are within 3%; 16 float4 a lane is 46% slower
//     at block 1024, where its 2048-element chunk is never full and every
//     load takes the guarded scalar path;
//   * residual: one CTA of 256 threads per block; neighbouring threads
//     read neighbouring elements (coalesced 128-byte warp transactions);
//     the prefix count is a warp __ballot_sync + __popc of the lanes
//     below, plus the totals of the warps before it (in shared memory);
//   * the staging write is a scatter of the kept elements into a row that
//     stays in L2;
//   * the two launches are the race-free shape of the reference's GPU
//     lowering (compact_residual.py:180-218): blocks run in parallel in
//     no order, so enc_before cannot be carried from block to block.  The
//     in-block position is an exact integer, so the residual launch's
//     scan and the stage launch's give every element the same position;
//   * nothing goes through a tensor-core dot: offsets up to 8191 are not
//     exact in TF32 (compact_residual.py:30-33); integers stay integers;
//   * the residual may be written in place over e: each thread reads its
//     own element before it writes it, and no other thread reads it.
//
// Operand types: g f32 or bf16, e f32, bf16 or none.  Each kernel widens
// both to f32 (a bf16 is the top half of an f32: exact) and forms
// u = f32(g) + f32(e) and its comparison in f32, as the reference's
// _load_u does (compact_residual.py:81-85); the staging rows hold those
// f32 values; e' is stored in the promoted type (bf16 only when both
// operands are bf16, or g is bf16 and there is no e), rounded once to
// nearest even (__float2bfloat16_rn: torch's and XLA's cast).  The
// vector path loads 16 bytes of g a group: 4 f32 or 8 bf16 elements,
// and e's elements of the same group in 8-, 16- or 32-byte loads.  A
// chunk stays 1024 elements (STAGE_VPL * 128) whatever the type, so at
// bf16 a lane has half the bytes in flight and the same registers.
//
// Bit-exactness: u = g + e is one f32 add, as in the reference; the
// staged values are copies of u; pos, offs and counts are integer; so
// the staging rows and e' are bitwise those of the reference at the same
// threshold and geometry.  Where a block selects more than bcap, its row
// keeps the lowest in-block indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define SENTINEL (-1)
// stage: blocks per CTA (one warp each) and 4-element f32 groups per lane
// per chunk (STAGE_VPL * 128 = 1024 elements, a whole block on the main
// path at f32; a bf16 g takes half as many groups of 8)
#define STAGE_WARPS 8
#define STAGE_VPL 8
// tiles of THREADS elements each residual thread loads before it scans:
// measured on an H100 at the 268M-element leaf, ~5% faster with 1 than 4
#define RESID_TILES 1

typedef __nv_bfloat16 bf16;

// ---- the operand types ---------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// e' is bf16 only when both operands are (HAS_E = false passes TE = TG)
template <typename A, typename B>
struct Promote {
  typedef float type;
};
template <>
struct Promote<bf16, bf16> {
  typedef bf16 type;
};

// elements of g in one 16-byte load: a lane's group
template <typename T>
struct Group {
  static constexpr int n = 16 / (int)sizeof(T);
};

// two bf16 in one 32-bit word (the lower address in the low half), as f32
__device__ __forceinline__ void bf16x2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive elements at p as f32: 16-byte loads (8-byte for four
// bf16); p aligned to the bytes it loads
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
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
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      bf16x2(v.x, x + i);
      bf16x2(v.y, x + i + 2);
      bf16x2(v.z, x + i + 4);
      bf16x2(v.w, x + i + 6);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      bf16x2(v.x, x + i);
      bf16x2(v.y, x + i + 2);
    }
  }
}

// ---- stage: one warp per selection block -------------------------------
//
// A lane's group is GS = Group<TG>::n consecutive elements (one 16-byte
// load of g); lane l owns the groups c0 + j*32*GS + GS*l (j < VPL =
// STAGE_VPL * 4 / GS) of each chunk of STAGE_VPL*128 elements; all of a
// chunk's loads are issued before its scan.  Elements in index order are
// chunk by chunk, j by j, lane by lane, then the GS elements of a group,
// so an element's in-block position is
//   run (the chunks and groups before)
//   + the masked elements of lanes below in the same j (GS ballots,
//     popcounts under the lane's lanemask_lt)
//   + the masked elements before it in its own group.
// No shared memory and no barrier: the warp owns its block.

template <typename TG>
struct Stage {
  static constexpr int GS = Group<TG>::n;
  static constexpr int VPL = STAGE_VPL * 4 / GS;
  static constexpr int CHUNK = STAGE_VPL * 128;
};

// The chunk's groups of this lane, u = g (+ e) in f32, with the elements
// at or past the block's real end (min(block, d - base)) read as 0 — the
// reference's zero padding.  VEC: g is 16-byte aligned, e aligned to its
// group's bytes (at most 16) and block % GS == 0, so every group of a
// full chunk is whole loads.
template <typename TG, typename TE, bool HAS_E, bool VEC>
__device__ __forceinline__ void stage_load(
    const TG* __restrict__ g, const TE* __restrict__ e, long long lim, int c0,
    float (&x)[Stage<TG>::VPL][Stage<TG>::GS]) {
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const int lg = GS * (threadIdx.x & 31);
  if (c0 + Stage<TG>::CHUNK <= lim) {  // a full chunk: no guards
    if (VEC) {
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        load_vec<GS>(g + c0 + j * 32 * GS + lg, x[j]);
      if (HAS_E) {
        float y[VPL][GS];
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          load_vec<GS>(e + c0 + j * 32 * GS + lg, y[j]);
#pragma unroll
        for (int j = 0; j < VPL; ++j)
#pragma unroll
          for (int c = 0; c < GS; ++c) x[j][c] += y[j][c];
      }
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int c = 0; c < GS; ++c) {
          const int i = c0 + j * 32 * GS + lg + c;
          x[j][c] = HAS_E ? to_f32(g[i]) + to_f32(e[i]) : to_f32(g[i]);
        }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int c = 0; c < GS; ++c) {
      const int i = c0 + j * 32 * GS + lg + c;
      x[j][c] = i < lim ? (HAS_E ? to_f32(g[i]) + to_f32(e[i]) : to_f32(g[i]))
                        : 0.0f;
    }
}

template <typename TG, typename TE, bool HAS_E, bool VEC>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
stage_kernel(const TG* __restrict__ g, const TE* __restrict__ e, long long d,
             float thres, int block, int bcap, long long nblocks,
             float* __restrict__ vals, int* __restrict__ offs,
             int* __restrict__ cnt) {
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * STAGE_WARPS + (threadIdx.x >> 5);
  if (b >= nblocks) return;  // the whole warp: b is uniform across it
  const long long base = b * (long long)block;
  const long long lim = d - base < block ? d - base : block;
  const TG* gb = g + base;
  const TE* eb = HAS_E ? e + base : nullptr;
  float* vrow = vals + b * bcap;
  int* orow = offs + b * bcap;
  const unsigned below = (1u << lane) - 1u;
  int run = 0;  // masked elements before the current group, in the block
  for (int c0 = 0; c0 < block; c0 += Stage<TG>::CHUNK) {
    float x[VPL][GS];
    stage_load<TG, TE, HAS_E, VEC>(gb, eb, lim, c0, x);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      bool m[GS];
      int p = run, tot = 0;
#pragma unroll
      for (int c = 0; c < GS; ++c) {
        m[c] = fabsf(x[j][c]) > thres;
        const unsigned bal = __ballot_sync(0xffffffffu, m[c]);
        p += __popc(bal & below);
        tot += __popc(bal);
      }
      const int off = c0 + j * 32 * GS + GS * lane;
#pragma unroll
      for (int c = 0; c < GS; ++c) {
        if (m[c]) {
          if (p < bcap) {
            vrow[p] = x[j][c];
            orow[p] = off + c;
          }
          ++p;
        }
      }
      run += tot;
    }
  }
  const int enc = run < bcap ? run : bcap;
  for (int s = enc + lane; s < bcap; s += 32) {
    vrow[s] = 0.0f;
    orow[s] = SENTINEL;
  }
  if (lane == 0) cnt[b] = run;
}

// ---- residual: one CTA of THREADS per block ------------------------------

// e is __restrict__ here though the residual may be written over it:
// each thread reads its own element before it writes it and no thread
// reads another's, so e's loads may take the read-only path (without
// it the f32 launch ran ~12% longer on an H100 at the 268M leaf,
// chip_smoke.py phase 2).
template <typename TG, typename TE, bool HAS_E>
__device__ __forceinline__ float load_u(const TG* __restrict__ g,
                                        const TE* __restrict__ e,
                                        long long i, long long d) {
  if (i >= d) return 0.0f;  // the reference's zero padding
  float x = to_f32(g[i]);
  if (HAS_E) x = x + to_f32(e[i]);
  return x;
}

// One chunk is TILES tiles of THREADS consecutive elements; thread t
// owns element c0 + i*THREADS + t of tile i.  All TILES loads of a chunk
// are issued before the first scan, so each thread keeps TILES loads of
// g and e in flight (the bytes in flight, not the arithmetic, bound
// these kernels).  chunk_scan gives each element its position among the
// chunk's masked elements in index order — tiles in order, warps in
// order inside a tile, lanes in order inside a warp — and the chunk's
// total.  All threads of the block call it (it synchronises twice).
template <int TILES>
__device__ __forceinline__ void chunk_scan(const bool (&m)[TILES],
                                           int (*warp_tot)[WARPS],
                                           int (&pos)[TILES], int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  unsigned bal[TILES];
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    bal[i] = __ballot_sync(0xffffffffu, m[i]);
    if (lane == 0) warp_tot[i][warp] = __popc(bal[i]);
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_tot[i][w];
      before += (w < warp) ? c : 0;
      tile += c;
    }
    pos[i] = run + before + __popc(bal[i] & below);
    run += tile;
  }
  __syncthreads();  // warp_tot is rewritten by the next chunk
  *total = run;
}

// The chunk's TILES elements of this thread: u and its mask.
template <int TILES, typename TG, typename TE, bool HAS_E>
__device__ __forceinline__ void load_chunk(const TG* __restrict__ g,
                                           const TE* e, long long base,
                                           long long d, int c0, int block,
                                           float thres, float (&x)[TILES],
                                           bool (&m)[TILES]) {
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int j = c0 + i * THREADS + threadIdx.x;
    x[i] = j < block ? load_u<TG, TE, HAS_E>(g, e, base + j, d) : 0.0f;
    m[i] = j < block && fabsf(x[i]) > thres;
  }
}

template <int TILES, typename TG, typename TE, bool HAS_E>
__global__ void __launch_bounds__(THREADS)
resid_kernel(const TG* __restrict__ g, const TE* e, long long d, float thres,
             int block, int bcap, long long k_cap,
             const long long* __restrict__ enc_before,
             typename Promote<TG, TE>::type* out) {
  __shared__ int warp_tot[TILES][WARPS];
  const long long b = blockIdx.x;
  const long long base = b * (long long)block;
  const long long eb = enc_before[b];
  int run = 0;
  for (int c0 = 0; c0 < block; c0 += THREADS * TILES) {
    float x[TILES];
    bool m[TILES];
    int pos[TILES], total;
    load_chunk<TILES, TG, TE, HAS_E>(g, e, base, d, c0, block, thres, x, m);
    chunk_scan(m, warp_tot, pos, &total);
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const int j = c0 + i * THREADS + threadIdx.x;
      const int p = run + pos[i];
      const bool on_wire = m[i] && p < bcap && eb + p < k_cap;
      if (j < block && base + j < d)
        store(out + base + j, on_wire ? 0.0f : x[i]);
    }
    run += total;
  }
}

template <typename TG, typename TE, bool HAS_E, bool VEC>
static int launch_stage(const void* g, const void* e, long long d,
                        float thres, int block, int bcap, long long nblocks,
                        void* vals, void* offs, void* cnt, void* stream) {
  const long long ctas = (nblocks + STAGE_WARPS - 1) / STAGE_WARPS;
  stage_kernel<TG, TE, HAS_E, VEC>
      <<<(unsigned)ctas, STAGE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const TG*)g, (const TE*)e, d, thres, block, bcap, nblocks,
      (float*)vals, (int*)offs, (int*)cnt);
  return (int)cudaGetLastError();
}

// The vector instantiation needs every block to start on a 16-byte
// boundary of g and on its group's bytes (at most 16) of e; any other
// view (a storage offset that breaks that, a block not a multiple of the
// group) takes the scalar-load instantiation of the same kernel: the
// same rows.
template <typename TG, typename TE, bool HAS_E>
static int stage_typed(const void* g, const void* e, long long d, float thres,
                       int block, int bcap, long long nblocks, void* vals,
                       void* offs, void* cnt, void* stream) {
  constexpr int GS = Group<TG>::n;
  constexpr uintptr_t EALIGN =
      GS * sizeof(TE) < 16 ? GS * sizeof(TE) : 16;
  const bool vec = block % GS == 0 && (uintptr_t)g % 16 == 0 &&
                   (!HAS_E || (uintptr_t)e % EALIGN == 0);
  return vec ? launch_stage<TG, TE, HAS_E, true>(g, e, d, thres, block, bcap,
                                                 nblocks, vals, offs, cnt,
                                                 stream)
             : launch_stage<TG, TE, HAS_E, false>(g, e, d, thres, block, bcap,
                                                  nblocks, vals, offs, cnt,
                                                  stream);
}

template <typename TG, typename TE, bool HAS_E>
static int resid_typed(const void* g, const void* e, long long d, float thres,
                       int block, int bcap, long long k_cap,
                       long long nblocks, const void* enc_before, void* out,
                       void* stream) {
  resid_kernel<RESID_TILES, TG, TE, HAS_E>
      <<<(unsigned)nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const TG*)g, (const TE*)e, d, thres, block, bcap, k_cap,
      (const long long*)enc_before,
      (typename Promote<TG, TE>::type*)out);
  return (int)cudaGetLastError();
}

// g_bf16 / e_bf16: 1 when the operand is bf16, 0 when f32 (e_bf16 is
// ignored without e).  e may be null (u = g).
#define DISPATCH(fn, ...)                                                  \
  (e == nullptr ? (g_bf16 ? fn<bf16, bf16, false>(__VA_ARGS__)            \
                          : fn<float, float, false>(__VA_ARGS__))         \
   : g_bf16     ? (e_bf16 ? fn<bf16, bf16, true>(__VA_ARGS__)             \
                          : fn<bf16, float, true>(__VA_ARGS__))           \
                : (e_bf16 ? fn<float, bf16, true>(__VA_ARGS__)            \
                          : fn<float, float, true>(__VA_ARGS__)))

extern "C" int compact_stage(const void* g, const void* e, int g_bf16,
                             int e_bf16, long long d, float thres, int block,
                             int bcap, long long nblocks, void* vals,
                             void* offs, void* cnt, void* stream) {
  return DISPATCH(stage_typed, g, e, d, thres, block, bcap, nblocks, vals,
                  offs, cnt, stream);
}

// out: d elements of the promoted type (bf16 when both operands are bf16,
// or g is bf16 without e; else f32); may be e itself when e has that type.
extern "C" int compact_resid(const void* g, const void* e, int g_bf16,
                             int e_bf16, long long d, float thres, int block,
                             int bcap, long long k_cap, long long nblocks,
                             const void* enc_before, void* out,
                             void* stream) {
  return DISPATCH(resid_typed, g, e, d, thres, block, bcap, k_cap, nblocks,
                  enc_before, out, stream);
}
