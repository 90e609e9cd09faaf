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
// and a popcount, far below the compute roof.
//
// What the design does about it:
//   * one CTA of 256 threads per block; neighbouring threads read
//     neighbouring elements (coalesced 128-byte warp transactions); the
//     stage launch issues the loads of 4 tiles (1024 elements, the whole
//     block on the main path) before it scans any, to keep more bytes
//     in flight;
//   * the prefix count is a warp __ballot_sync + __popc of the lanes
//     below, plus the totals of the tiles and warps before it (in
//     shared memory) — no block-wide scan tree, two __syncthreads per
//     chunk;
//   * the staging write is a scatter of the few kept elements (~1 in
//     1000 at the paper's density) into a row that stays in L2;
//   * the two launches are the race-free shape of the reference's GPU
//     lowering (compact_residual.py:180-218): blocks run in parallel in
//     no order, so enc_before cannot be carried from block to block;
//   * nothing goes through a tensor-core dot: offsets up to 8191 are not
//     exact in TF32 (compact_residual.py:30-33); integers stay integers;
//   * the residual may be written in place over e: each thread reads its
//     own element before it writes it, and no other thread reads it.
//
// Bit-exactness: u = g + e is one f32 add, as in the reference; the
// staged values are copies of u; pos, offs and counts are integer; so
// the staging rows and e' are bitwise those of the reference at the same
// threshold and geometry.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define SENTINEL (-1)
// tiles of THREADS elements each thread loads before it scans: measured
// on an H100 at the 268M-element leaf, the stage launch is ~10% faster
// with 4 than with 1, the residual launch ~5% faster with 1 than with 4
#define STAGE_TILES 4
#define RESID_TILES 1

template <bool HAS_E>
__device__ __forceinline__ float load_u(const float* __restrict__ g,
                                        const float* __restrict__ e,
                                        long long i, long long d) {
  if (i >= d) return 0.0f;  // the reference's zero padding
  float x = g[i];
  if (HAS_E) x = x + e[i];
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
template <int TILES, bool HAS_E>
__device__ __forceinline__ void load_chunk(const float* __restrict__ g,
                                           const float* e, long long base,
                                           long long d, int c0, int block,
                                           float thres, float (&x)[TILES],
                                           bool (&m)[TILES]) {
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int j = c0 + i * THREADS + threadIdx.x;
    x[i] = j < block ? load_u<HAS_E>(g, e, base + j, d) : 0.0f;
    m[i] = j < block && fabsf(x[i]) > thres;
  }
}

template <int TILES, bool HAS_E>
__global__ void __launch_bounds__(THREADS)
stage_kernel(const float* __restrict__ g, const float* __restrict__ e,
             long long d, float thres, int block, int bcap,
             float* __restrict__ vals, int* __restrict__ offs,
             int* __restrict__ cnt) {
  __shared__ int warp_tot[TILES][WARPS];
  const long long b = blockIdx.x;
  const long long base = b * (long long)block;
  float* vrow = vals + b * bcap;
  int* orow = offs + b * bcap;
  int run = 0;  // masked elements in the chunks before this one
  for (int c0 = 0; c0 < block; c0 += THREADS * TILES) {
    float x[TILES];
    bool m[TILES];
    int pos[TILES], total;
    load_chunk<TILES, HAS_E>(g, e, base, d, c0, block, thres, x, m);
    chunk_scan(m, warp_tot, pos, &total);
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const int p = run + pos[i];
      if (m[i] && p < bcap) {
        vrow[p] = x[i];
        orow[p] = c0 + i * THREADS + threadIdx.x;
      }
    }
    run += total;
  }
  const int enc = run < bcap ? run : bcap;
  for (int s = enc + threadIdx.x; s < bcap; s += THREADS) {
    vrow[s] = 0.0f;
    orow[s] = SENTINEL;
  }
  if (threadIdx.x == 0) cnt[b] = run;
}

template <int TILES, bool HAS_E>
__global__ void __launch_bounds__(THREADS)
resid_kernel(const float* __restrict__ g, const float* e, long long d,
             float thres, int block, int bcap, long long k_cap,
             const long long* __restrict__ enc_before, float* out) {
  __shared__ int warp_tot[TILES][WARPS];
  const long long b = blockIdx.x;
  const long long base = b * (long long)block;
  const long long eb = enc_before[b];
  int run = 0;
  for (int c0 = 0; c0 < block; c0 += THREADS * TILES) {
    float x[TILES];
    bool m[TILES];
    int pos[TILES], total;
    load_chunk<TILES, HAS_E>(g, e, base, d, c0, block, thres, x, m);
    chunk_scan(m, warp_tot, pos, &total);
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const int j = c0 + i * THREADS + threadIdx.x;
      const int p = run + pos[i];
      const bool on_wire = m[i] && p < bcap && eb + p < k_cap;
      if (j < block && base + j < d) out[base + j] = on_wire ? 0.0f : x[i];
    }
    run += total;
  }
}

template <bool HAS_E>
static int launch_stage(const void* g, const void* e, long long d,
                        float thres, int block, int bcap, long long nblocks,
                        void* vals, void* offs, void* cnt, void* stream) {
  stage_kernel<STAGE_TILES, HAS_E>
      <<<(unsigned)nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)e, d, thres, block, bcap,
      (float*)vals, (int*)offs, (int*)cnt);
  return (int)cudaGetLastError();
}

// e may be null (u = g)
extern "C" int compact_stage_f32(const void* g, const void* e, long long d,
                                 float thres, int block, int bcap,
                                 long long nblocks, void* vals, void* offs,
                                 void* cnt, void* stream) {
  return e != nullptr
             ? launch_stage<true>(g, e, d, thres, block, bcap, nblocks, vals,
                                  offs, cnt, stream)
             : launch_stage<false>(g, e, d, thres, block, bcap, nblocks,
                                   vals, offs, cnt, stream);
}

extern "C" int compact_resid_f32(const void* g, const void* e, long long d,
                                 float thres, int block, int bcap,
                                 long long k_cap, long long nblocks,
                                 const void* enc_before, void* out,
                                 void* stream) {
  if (e != nullptr)
    resid_kernel<RESID_TILES, true>
        <<<(unsigned)nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)e, d, thres, block, bcap, k_cap,
        (const long long*)enc_before, (float*)out);
  else
    resid_kernel<RESID_TILES, false>
        <<<(unsigned)nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)e, d, thres, block, bcap, k_cap,
        (const long long*)enc_before, (float*)out);
  return (int)cudaGetLastError();
}
