// K3 — pass B of the fused EF pipeline on Hopper: threshold compaction
// into per-block staging rows, the residual write and the codec pair.
// The fused pipeline runs the one sweep (sweep_kernel: rows, e' and the
// pair in one launch, the TPU kernel's sequential sweep); the stage and
// residual launches are the reference's GPU lowering, kept as the
// sweep's cross-check.  The stage kernel with HAS_E = false is also K4c,
// the unfused pipeline's threshold compaction of a materialised u.
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
//             preceding blocks (computed between the two launches);
//   sweep:    both, and the pair: slot enc_before + pos < k_cap of the
//             (k_cap,) values and indices holds the kept element (its
//             value in e''s type, its global index), every other slot
//             0 / SENTINEL — bitwise assemble_staging of the rows.
//
// The one sweep (sweep_kernel) and what bounds it: bytes, g and e read
// once and e' written once (12 B/element at f32, 6 at bf16), plus the
// rows, the pair and one status word a group of blocks: at the
// 268,435,456-element leaf 1.003 ms at f32, 0.503 ms at bf16.  Blocks
// run in no order, so enc_before cannot be carried from block to block
// as on the TPU.  The design:
//   * one warp takes SWEEP_BLOCKS consecutive selection blocks (a group)
//     from an atomic ticket, so the groups before it are always running;
//     it streams each block as the stage kernel does (the same loads,
//     ballots and rows) and writes e' = u for every element while it
//     streams, vectorised 16 bytes a lane;
//   * then it publishes its group's sum of min(cnt, bcap) in the group's
//     64-bit status word (flag and count in one word) and finds the
//     group's enc_before by decoupled look-back over its predecessors'
//     words, 32 at a time, stopping at the nearest inclusive prefix
//     (Merrill and Garland, "Single-pass Parallel Prefix Scan with
//     Decoupled Look-back", 2016), and publishes its inclusive prefix;
//   * only the kept elements (at most bcap a block) depend on
//     enc_before: after a __syncwarp the warp rereads its rows, zeroes
//     e' at the elements that reach the wire and writes their pair
//     slots; the streaming never waits on the look-back;
//   * the entry point zeroes the ticket and the status words and
//     pre-fills the pair with 0 / SENTINEL (three cudaMemsetAsync);
//   * e' may be written over e (or over g without e): each element is
//     read by the warp that owns its block before that warp writes it.
//
// What bounds it on the card: bytes.  Stage reads g and e (8 B/element)
// and writes only the staging rows; residual reads them again and writes
// e' (12 B/element in all).  The work per element is a compare, a ballot
// and a popcount, far below the compute roof.  At the 268,435,456-element
// leaf (block 1024, bcap 64) the stage launch's bound is 0.681 ms and
// K4c's (no e) 0.361 ms at 3.35 TB/s; with bf16 operands (block 2048)
// 0.341 and 0.180 ms, and the residual's 0.962 and 0.481 ms.
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
//   * residual (redesigned the same way): the stage kernel's warp a block,
//     its loads and its ballot positions, then e' written 16 bytes a lane
//     (as the sweep writes it) with the elements on the wire zeroed.  The
//     first design (one CTA of 256 threads a block, one element a thread
//     a tile in scalar loads, a __syncthreads pair every 256 elements to
//     add up its warps' counts) ran at 1.109 ms at f32 and 1.003 ms at
//     bf16 (87% and 48% of its bound, NVIDIA H100 80GB HBM3 at 700 W): at
//     bf16 every load was 2 bytes wide.  It takes enc_before from the
//     wrapper's exact cumsum of the stage's counts, never from the sweep's
//     look-back, so it stays the sweep's independent cross-check;
//   * the staging write is a scatter of the kept elements into a row that
//     stays in L2;
//   * the two launches are the race-free shape of the reference's GPU
//     lowering (compact_residual.py:180-218): blocks run in parallel in
//     no order, so enc_before cannot be carried from block to block.  The
//     in-block position is an exact integer, so the residual launch's
//     scan and the stage launch's give every element the same position;
//   * nothing goes through a tensor-core dot: offsets up to 8191 are not
//     exact in TF32 (compact_residual.py:30-33); integers stay integers;
//   * the residual and the sweep may write e' in place over e (or over g
//     without e): each element is read by the lane that writes it, before
//     it writes it, and by no other lane.
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

#define SENTINEL (-1)
// stage: blocks per CTA (one warp each) and 4-element f32 groups per lane
// per chunk (STAGE_VPL * 128 = 1024 elements, a whole block on the main
// path at f32; a bf16 g takes half as many groups of 8)
#define STAGE_WARPS 8
#define STAGE_VPL 8
// sweep: selection blocks a warp takes with one ticket (one status word
// and one look-back for all of them).  Measured on an H100 at the
// 268,435,456-element leaf (launch/compare_kernels.py --sweep-blocks):
// 1, 2, 4 and 8 took 1.51, 1.37, 1.30 and 1.29 ms at f32 and 0.83,
// 0.73, 0.70 and 0.69 ms at bf16: the look-back's latency, paid once a
// group, bounds the small groups
#define SWEEP_BLOCKS 8

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

// The chunk's masked elements in index order: each one's in-block
// position from the ballots, the kept ones (position < bcap) written to
// the block's staging row; `run` counts the block's masked elements.
template <typename TG>
__device__ __forceinline__ void stage_scan(
    const float (&x)[Stage<TG>::VPL][Stage<TG>::GS], int c0, float thres,
    int bcap, float* __restrict__ vrow, int* __restrict__ orow, int& run) {
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
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

// The row's slots past min(run, bcap): 0 / SENTINEL.
__device__ __forceinline__ void stage_pad(int run, int bcap, float* vrow,
                                          int* orow) {
  const int enc = run < bcap ? run : bcap;
  for (int s = enc + (threadIdx.x & 31); s < bcap; s += 32) {
    vrow[s] = 0.0f;
    orow[s] = SENTINEL;
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
  int run = 0;  // masked elements before the current chunk, in the block
  for (int c0 = 0; c0 < block; c0 += Stage<TG>::CHUNK) {
    float x[VPL][GS];
    stage_load<TG, TE, HAS_E, VEC>(gb, eb, lim, c0, x);
    stage_scan<TG>(x, c0, thres, bcap, vrow, orow, run);
  }
  stage_pad(run, bcap, vrow, orow);
  if (lane == 0) cnt[b] = run;
}

// ---- e' stores ------------------------------------------------------------

// N consecutive values at p (aligned to their bytes, at most 16 a store)
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    if (N - i >= 8) {
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(bf16x2_bits(x[i], x[i + 1]), bf16x2_bits(x[i + 2], x[i + 3]),
                     bf16x2_bits(x[i + 4], x[i + 5]),
                     bf16x2_bits(x[i + 6], x[i + 7]));
    } else {
      *reinterpret_cast<uint2*>(p + i) = make_uint2(
          bf16x2_bits(x[i], x[i + 1]), bf16x2_bits(x[i + 2], x[i + 3]));
    }
  }
}

// e' = u for the chunk's elements of this lane, in stage_load's layout
// (the elements at or past lim are not written).  VEC: o is aligned to a
// group's bytes of TO (at most 16).
template <typename TG, typename TO, bool VEC>
__device__ __forceinline__ void store_chunk(
    TO* o, long long lim, int c0,
    const float (&x)[Stage<TG>::VPL][Stage<TG>::GS]) {
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const int lg = GS * (threadIdx.x & 31);
  if (VEC && c0 + Stage<TG>::CHUNK <= lim) {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      store_vec<GS>(o + c0 + j * 32 * GS + lg, x[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int c = 0; c < GS; ++c) {
      const int i = c0 + j * 32 * GS + lg + c;
      if (i < lim) store(o + i, x[j][c]);
    }
}

// ---- residual: one warp per selection block -----------------------------
//
// The stage kernel's structure (a warp a block, STAGE_WARPS blocks a CTA,
// the same loads and ballot positions; no shared memory, no barrier);
// each chunk is loaded, its on-wire elements zeroed and written back as
// e' by the lane that loaded it.

// The chunk's masked elements in index order: the ones at an in-block
// position below cut (min(bcap, k_cap - enc_before), at least 0) go on
// the wire and become 0; `run` counts the block's masked elements.
template <typename TG>
__device__ __forceinline__ void resid_scan(
    float (&x)[Stage<TG>::VPL][Stage<TG>::GS], float thres, int cut,
    int& run) {
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
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
#pragma unroll
    for (int c = 0; c < GS; ++c) {
      if (m[c]) {
        if (p < cut) x[j][c] = 0.0f;
        ++p;
      }
    }
    run += tot;
  }
}

template <typename TG, typename TE, bool HAS_E, bool VEC>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
resid_kernel(const TG* __restrict__ g, const TE* __restrict__ e, long long d,
             float thres, int block, int bcap, long long k_cap,
             long long nblocks, const long long* __restrict__ enc_before,
             typename Promote<TG, TE>::type* out) {
  typedef typename Promote<TG, TE>::type TO;
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const long long b = (long long)blockIdx.x * STAGE_WARPS + (threadIdx.x >> 5);
  if (b >= nblocks) return;  // the whole warp: b is uniform across it
  const long long base = b * (long long)block;
  const long long lim = d - base < block ? d - base : block;
  const long long room = k_cap - enc_before[b];
  const int cut = room <= 0 ? 0 : (room < bcap ? (int)room : bcap);
  const TG* gb = g + base;
  const TE* eb = HAS_E ? e + base : nullptr;
  TO* ob = out + base;
  int run = 0;  // masked elements before the current chunk, in the block
  for (int c0 = 0; c0 < block; c0 += Stage<TG>::CHUNK) {
    float x[VPL][GS];
    stage_load<TG, TE, HAS_E, VEC>(gb, eb, lim, c0, x);
    resid_scan<TG>(x, thres, cut, run);
    store_chunk<TG, TO, VEC>(ob, lim, c0, x);
  }
}

// ---- sweep: the TPU kernel's one sweep, one warp a selection block -------
//
// A block's status word: its flag in the top two bits (0 not published
// yet; ST_AGG: the block's own min(cnt, bcap); ST_INC: the inclusive
// prefix of min(cnt, bcap) over the blocks up to it) and the count below.
// The word carries its own value, so relaxed loads and stores suffice.
#define ST_AGG (1ull << 62)
#define ST_INC (2ull << 62)
#define ST_VAL ((1ull << 62) - 1)

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The exclusive prefix of min(cnt, bcap) over the blocks before b: the
// warp reads 32 predecessors' status words at once (lane l block
// top - l), waits until each is published, adds the aggregates up to the
// nearest inclusive prefix and stops there, else moves 32 blocks back.
__device__ long long look_back(const unsigned long long* status, long long b) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (long long top = b - 1;; top -= 32) {
    const long long j = top - lane;
    unsigned long long w = ST_INC;  // before block 0: an inclusive 0
    if (j >= 0) {
      do {
        w = ld_status(status + j);
      } while ((w >> 62) == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    long long v = lane <= stop ? (long long)(w & ST_VAL) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    sum += v;
    if (inc) return sum;
  }
}

// The stage kernel's selection and rows, e', and the codec pair in one
// launch.  A warp takes SWEEP_BLOCKS consecutive selection blocks (a
// group) from the ticket, so every group before it has a running warp:
// the look-back always ends.  g and e are read once, by the warp that
// owns the block, before it writes e' over them (out may be e, or g
// without e).
template <typename TG, typename TE, bool HAS_E, bool VEC>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
sweep_kernel(const TG* __restrict__ g, const TE* __restrict__ e, long long d,
             float thres, int block, int bcap, long long k_cap,
             long long nblocks, float* __restrict__ vals,
             int* __restrict__ offs, int* __restrict__ cnt,
             typename Promote<TG, TE>::type* out,
             typename Promote<TG, TE>::type* __restrict__ wv,
             int* __restrict__ wi, unsigned long long* status,
             unsigned long long* ticket) {
  typedef typename Promote<TG, TE>::type TO;
  constexpr int GS = Stage<TG>::GS, VPL = Stage<TG>::VPL;
  const int lane = threadIdx.x & 31;
  unsigned long long tk = 0;
  if (lane == 0) tk = atomicAdd(ticket, 1ull);
  const long long grp = (long long)__shfl_sync(0xffffffffu, tk, 0);
  const long long b0 = grp * SWEEP_BLOCKS;
  if (b0 >= nblocks) return;  // the whole warp
  const int nb = nblocks - b0 < SWEEP_BLOCKS ? (int)(nblocks - b0)
                                             : SWEEP_BLOCKS;
  int agg = 0;  // the group's min(cnt, bcap), summed
#pragma unroll 1
  for (int q = 0; q < nb; ++q) {
    const long long b = b0 + q;
    const long long base = b * (long long)block;
    const long long lim = d - base < block ? d - base : block;
    const TG* gb = g + base;
    const TE* eb = HAS_E ? e + base : nullptr;
    TO* ob = out + base;
    float* vrow = vals + b * bcap;
    int* orow = offs + b * bcap;
    int run = 0;
    for (int c0 = 0; c0 < block; c0 += Stage<TG>::CHUNK) {
      float x[VPL][GS];
      stage_load<TG, TE, HAS_E, VEC>(gb, eb, lim, c0, x);
      // e' = u everywhere while streaming; after the look-back the
      // kept elements that go on the wire, and those alone, are zeroed
      store_chunk<TG, TO, VEC>(ob, lim, c0, x);
      stage_scan<TG>(x, c0, thres, bcap, vrow, orow, run);
    }
    stage_pad(run, bcap, vrow, orow);
    if (lane == 0) cnt[b] = run;
    agg += run < bcap ? run : bcap;
  }
  if (lane == 0)
    st_status(status + grp,
              (grp == 0 ? ST_INC : ST_AGG) | (unsigned long long)agg);
  long long before = 0;  // the group's enc_before
  if (grp > 0) {
    before = look_back(status, grp);
    if (lane == 0)
      st_status(status + grp, ST_INC | (unsigned long long)(before + agg));
  }
  // every lane's row, count and e' stores ordered before the reads and
  // the zeroing stores below, which other lanes of the warp make
  __syncwarp();
#pragma unroll 1
  for (int q = 0; q < nb && before < k_cap; ++q) {
    const long long b = b0 + q;
    const int c = cnt[b];
    const int enc = c < bcap ? c : bcap;
    const long long room = k_cap - before;
    const int wire = room < enc ? (int)room : enc;
    const float* vrow = vals + b * bcap;
    const int* orow = offs + b * bcap;
    TO* ob = out + b * (long long)block;
    for (int s = lane; s < wire; s += 32) {
      const int off = orow[s];
      store(ob + off, 0.0f);
      store(wv + before + s, vrow[s]);
      wi[before + s] = (int)(b * (long long)block + off);
    }
    before += enc;
  }
}

// The vector instantiation needs every block to start on a 16-byte
// boundary of g and on its group's bytes (at most 16) of e, and of out
// where the kernel writes e'; any other view (a storage offset that
// breaks that, a block not a multiple of the group) takes the scalar-load
// instantiation of the same kernel: the same rows and the same e'.
template <typename TG, typename TE, bool HAS_E>
static bool vec_ok(const void* g, const void* e, int block, const void* out) {
  typedef typename Promote<TG, TE>::type TO;
  constexpr int GS = Group<TG>::n;
  constexpr uintptr_t EALIGN = GS * sizeof(TE) < 16 ? GS * sizeof(TE) : 16;
  constexpr uintptr_t OALIGN = GS * sizeof(TO) < 16 ? GS * sizeof(TO) : 16;
  return block % GS == 0 && (uintptr_t)g % 16 == 0 &&
         (!HAS_E || (uintptr_t)e % EALIGN == 0) &&
         (uintptr_t)out % OALIGN == 0;
}

// a CTA of STAGE_WARPS warps for every STAGE_WARPS selection blocks
static unsigned warp_ctas(long long warps) {
  return (unsigned)((warps + STAGE_WARPS - 1) / STAGE_WARPS);
}

template <typename TG, typename TE, bool HAS_E>
static int stage_typed(const void* g, const void* e, long long d, float thres,
                       int block, int bcap, long long nblocks, void* vals,
                       void* offs, void* cnt, void* stream) {
  auto kern = vec_ok<TG, TE, HAS_E>(g, e, block, nullptr)
                  ? stage_kernel<TG, TE, HAS_E, true>
                  : stage_kernel<TG, TE, HAS_E, false>;
  kern<<<warp_ctas(nblocks), STAGE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const TG*)g, (const TE*)e, d, thres, block, bcap, nblocks,
      (float*)vals, (int*)offs, (int*)cnt);
  return (int)cudaGetLastError();
}

template <typename TG, typename TE, bool HAS_E>
static int resid_typed(const void* g, const void* e, long long d, float thres,
                       int block, int bcap, long long k_cap,
                       long long nblocks, const void* enc_before, void* out,
                       void* stream) {
  typedef typename Promote<TG, TE>::type TO;
  auto kern = vec_ok<TG, TE, HAS_E>(g, e, block, out)
                  ? resid_kernel<TG, TE, HAS_E, true>
                  : resid_kernel<TG, TE, HAS_E, false>;
  kern<<<warp_ctas(nblocks), STAGE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const TG*)g, (const TE*)e, d, thres, block, bcap, k_cap, nblocks,
      (const long long*)enc_before, (TO*)out);
  return (int)cudaGetLastError();
}

// The pair is pre-filled with 0 / SENTINEL (slots at or past the number
// of staged elements keep it), the ticket and the status words zeroed;
// then one launch.
template <typename TG, typename TE, bool HAS_E>
static int sweep_typed(const void* g, const void* e, long long d, float thres,
                       int block, int bcap, long long k_cap,
                       long long nblocks, void* vals, void* offs, void* cnt,
                       void* out, void* wv, void* wi, void* scratch,
                       void* stream) {
  typedef typename Promote<TG, TE>::type TO;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(wv, 0, (size_t)k_cap * sizeof(TO), s);
  if (rc == cudaSuccess)
    rc = cudaMemsetAsync(wi, 0xff, (size_t)k_cap * sizeof(int), s);
  if (rc == cudaSuccess)
    rc = cudaMemsetAsync(scratch, 0,
                         (size_t)(nblocks + 1) * sizeof(unsigned long long),
                         s);  // at least the ticket and a word a group
  if (rc != cudaSuccess) return (int)rc;
  unsigned long long* ticket = (unsigned long long*)scratch;
  auto kern = vec_ok<TG, TE, HAS_E>(g, e, block, out)
                  ? sweep_kernel<TG, TE, HAS_E, true>
                  : sweep_kernel<TG, TE, HAS_E, false>;
  const long long groups = (nblocks + SWEEP_BLOCKS - 1) / SWEEP_BLOCKS;
  kern<<<warp_ctas(groups), STAGE_WARPS * 32, 0, s>>>(
      (const TG*)g, (const TE*)e, d, thres, block, bcap, k_cap, nblocks,
      (float*)vals, (int*)offs, (int*)cnt, (TO*)out, (TO*)wv, (int*)wi,
      ticket + 1, ticket);
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

// The one sweep: the staging rows (vals, offs, cnt), e' into out (of the
// promoted type; may be e itself, or g without e) and the codec pair
// (wv: k_cap values of the promoted type, wi: k_cap int32 indices).
// scratch: nblocks + 1 64-bit words, zeroed here (the ticket, then one
// status word a group of SWEEP_BLOCKS blocks).
extern "C" int compact_sweep(const void* g, const void* e, int g_bf16,
                             int e_bf16, long long d, float thres, int block,
                             int bcap, long long k_cap, long long nblocks,
                             void* vals, void* offs, void* cnt, void* out,
                             void* wv, void* wi, void* scratch,
                             void* stream) {
  return DISPATCH(sweep_typed, g, e, d, thres, block, bcap, k_cap, nblocks,
                  vals, offs, cnt, out, wv, wi, scratch, stream);
}
