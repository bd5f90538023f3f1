// 16x16 alpha-compositing backward for Hopper (sm_90a), with per-warp
// conservative culling and asynchronous staging.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py
//   ::make_backward_kernel16 (reached through _bwd_impl16, pallas_call at
//   :622)
// with the per-pair output of the 32x32 backward on the 16-px pair plan:
// for every pair row of feat (B_al x 16 f32 [mean2d, conic, opa, rgb,
// depth, rect16, pad]) walked by its 16x16 tile, the row
//   [d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_r, d_g, d_b, d_depth, 0 x 6]
// summed over the tile's pixels, from the forward's color/depth sums
// (before background) and final T, and their cotangents dC(3), dD, dT.
// Per pixel the forward walk is recomputed with the forward's exact
// operation order, and each included cell contributes the one-pass
// gradient (subtile_bwd.cuh's bwd_cell, shared with the 32x32 backward;
// the reference's form is tile_kernel16.py:383-391), built with
// -fmad=false.
//
// What bounds it on the H100: the FP32 operations of the cells a pixel
// evaluates, and the per-pair reduction. The design it replaced (one
// thread per pixel, a warp two pixel rows) evaluated the tests at
// every cell of the tile-walk, reduced every pair any lane of a warp
// included with ten butterflies (50 shuffles), staged 32 rows at a time
// with plain loads and met three CTA barriers per 32 rows.
// What the design does about it (subtile_cull.cuh, subtile_bwd.cuh):
// - one CTA of 256 threads per 16x16 tile (blockIdx.x is the tile of the
//   2 n_gx x 2 n_gy grid); the tile is exactly one rect16 cell, so the
//   rect test runs once per staged pair (warp 0, ballot + prefix
//   compaction into shared memory). The compaction stays: the plan bins
//   a Gaussian by its radius scaled and padded (mapping: x 1.1 + 6 px),
//   the row's rect16 by its own radius, so a run holds rows that fail its
//   tile's rect test (my CPU count on the room map at 300x170: 55% of the
//   rows of the mapping plan, 24% of the tracker's pad-2 plan, 2.4% of a
//   fresh one). The plan's dead pad slots (each run starts at a multiple
//   of K16 = 128; pair_gather zeroes the slots between runs) lie outside
//   every [ranges[t, 0], ranges[t, 1]) and are never staged;
// - each warp owns an 8x4 block of pixels; before walking a chunk its
//   lanes test the compacted pairs against the block, one pair a lane,
//   from terms (1/ca, 1/cc, log opa) prepared once per staged row
//   (block_keep: drops a pair only where alpha < 1/255 at every pixel of
//   the block as the f32 arithmetic computes it), and the warp walks the
//   survivors in pair order; a warp whose pixels are all done skips the
//   chunk;
// - chunks of 64 pair rows (4 KB) staged by one bulk asynchronous copy
//   (TMA, cp.async.bulk, completion on an mbarrier) into a double buffer:
//   chunk c + 1 is in flight while chunk c is walked;
// - rows reduced without atomics and in a fixed order: inside a warp the
//   reduce-scatter of the ten values (12 shuffles, warp_sum10) only for a
//   surviving pair some lane includes, its ten sums stored by ten lanes in
//   an [8 warps][64][10] table with a bit per written row; then one
//   thread per (pair, column) sums the warps' partials in warp order and
//   stores the value once, while the next chunk is compacted (two CTA
//   barriers a chunk, not three). A pair of the 16-px plan belongs to one
//   tile, so there is no cluster and no distributed shared memory. The
//   rows are bit for bit the same from launch to launch.
// - the early exit is per CTA (__syncthreads_count); rows never reached
//   keep the zero the wrapper allocated.

#include <cuda_runtime.h>
#include <stdint.h>

#include "subtile_cull.cuh"
#include "subtile_bwd.cuh"

namespace {

using namespace subtile;

constexpr int kFeat = 16;  // floats per pair row

// The n rows of the chunk at ``base`` from the warps' partials: one
// thread per (pair, column) adds them in warp order and stores each row
// that some warp wrote, once.
__device__ __forceinline__ void store_rows(
    const float (*part)[kChunk][kRows], const unsigned (*wrote)[kChunk / 32],
    float* __restrict__ dfeat, int base, int n) {
  for (int i = threadIdx.x; i < n * kRows; i += kThreads) {
    const int r = i / kRows;
    const int col = i - r * kRows;
    float s = 0.0f;
    bool any = false;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if ((wrote[w][r >> 5] >> (r & 31)) & 1u) {
        s += part[w][r][col];
        any = true;
      }
    }
    if (any) dfeat[static_cast<size_t>(base + r) * kFeat + col] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
composite16_bwd_subtile(const float4* __restrict__ feat,   // (B_al, 4) x float4
                        const int2* __restrict__ ranges,   // (n_tiles,)
                        const float* __restrict__ color,   // (3, H, W)
                        const float* __restrict__ depth,   // (H, W)
                        const float* __restrict__ final_T, // (H, W)
                        const float* __restrict__ d_color, // (3, H, W)
                        const float* __restrict__ d_depth, // (H, W)
                        const float* __restrict__ d_T,     // (H, W)
                        float* __restrict__ dfeat,         // (B_al, 16) zeroed
                        int W, int H, int n_tx) {
  __shared__ __align__(128) float4 s_rows[2][kChunk][4];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ unsigned char s_idx[kChunk];
  __shared__ int s_m;
  __shared__ float4 s_pre[kChunk][2];  // the block test's row terms
  __shared__ float s_part[kWarps][kChunk][kRows];
  __shared__ unsigned s_wrote[kWarps][kChunk / 32];

  const Geometry g = geometry16(n_tx);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool inside = (g.x < W) && (g.y < H);
  const float px = static_cast<float>(g.x);
  const float py = static_cast<float>(g.y);
  const float xb = static_cast<float>(g.xb);
  const float yb = static_cast<float>(g.yb);

  // this pixel's forward sums and cotangents (zero outside the image)
  const PixelCot cot = pixel_cot(inside, g.x, g.y, W, H, color, depth,
                                 final_T, d_color, d_depth, d_T);

  const int2 rg = ranges[g.tile];
  const int n_chunks = (rg.y - rg.x + kChunk - 1) / kChunk;
  float T = 1.0f;
  float pA = 0.0f;
  bool done = !inside;

  if (tid == 0) {
    bar_init(&s_bar[0]);
    bar_init(&s_bar[1]);
    bar_fence_init();
  }
  // a tile wholly outside the image (the grid's spare column or row) has
  // nothing to add
  if (__syncthreads_count(!done) == 0) return;
  if (tid == 0 && n_chunks > 0) {
    stage(s_rows[0], feat + static_cast<size_t>(rg.x) * 4,
          min(kChunk, rg.y - rg.x) * 64, &s_bar[0]);
  }

  int last = -1;  // the last chunk walked
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int base = rg.x + c * kChunk;
    const int n = min(kChunk, rg.y - base);
    bar_wait(&s_bar[buf], (c >> 1) & 1);
    // the other buffer's rows were consumed in the previous step
    if (tid == 0 && c + 1 < n_chunks) {
      stage(s_rows[buf ^ 1], feat + static_cast<size_t>(base + kChunk) * 4,
            min(kChunk, rg.y - base - kChunk) * 64, &s_bar[buf ^ 1]);
    }
    const float4(*rows)[4] = s_rows[buf];
    compact_rect(rows, n, g.t16x, g.t16y, s_idx, &s_m, s_pre);
    // the previous chunk's rows (complete since its walk's barrier), before
    // this chunk's walk writes the partials again
    if (c > 0) store_rows(s_part, s_wrote, dfeat, base - kChunk, kChunk);
    __syncthreads();

    unsigned wrote0 = 0u, wrote1 = 0u;  // the rows this warp stored
    if (__any_sync(kFull, !done)) {
      unsigned keep[kChunk / 32];
      cull(s_pre, s_idx, s_m, xb, yb, keep);
#pragma unroll
      for (int h = 0; h < kChunk / 32; ++h) {
        unsigned bits = keep[h];
        while (bits) {
          const int r = s_idx[h * 32 + __ffs(bits) - 1];
          bits &= bits - 1u;
          float v[kRows];
          const bool inc = bwd_cell(rows[r], px, py, cot, &T, &pA, &done, v);
          if (__any_sync(kFull, inc)) {            int col;
            const float sum = warp_sum10(v, lane, &col);
            if (!(lane & 1) && col >= 0) s_part[warp][r][col] = sum;
            if (r < 32) {
              wrote0 |= 1u << r;
            } else {
              wrote1 |= 1u << (r - 32);
            }
          }
        }
      }
    }
    if (lane == 0) {
      s_wrote[warp][0] = wrote0;
      s_wrote[warp][1] = wrote1;
    }
    last = c;
    if (__syncthreads_count(!done) == 0) break;  // every pixel is done
  }
  if (last >= 0) {
    const int base = rg.x + last * kChunk;
    store_rows(s_part, s_wrote, dfeat, base, min(kChunk, rg.y - base));
  }
  // a copy still in flight must land before the CTA's shared memory goes
  if (tid == 0 && last + 1 < n_chunks) bar_wait(&s_bar[(last + 1) & 1],
                                                ((last + 1) >> 1) & 1);
}

}  // namespace

// C entry, loaded with ctypes: composite16_bwd (B4), the signature of
// composite32_bwd. feat: (B_al, 16) f32, 16-byte aligned; ranges:
// (n_tiles, 2) int32 over the n_tx-wide 16-px grid; color, d_color: (3,
// H, W) f32; depth, final_T, d_depth, d_T: (H, W) f32; dfeat: (B_al, 16)
// f32, zero-filled by the caller (rows a tile never reaches must read 0).
// Launch on ``stream`` and return cudaGetLastError().
extern "C" int composite16_bwd(const void* feat, const void* ranges,
                               const void* color, const void* depth,
                               const void* final_T, const void* d_color,
                               const void* d_depth, const void* d_T,
                               void* dfeat, int n_tiles, int n_tx, int W,
                               int H, void* stream) {
  if (n_tiles <= 0) return 0;
  composite16_bwd_subtile<<<n_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
      static_cast<const float*>(color), static_cast<const float*>(depth),
      static_cast<const float*>(final_T), static_cast<const float*>(d_color),
      static_cast<const float*>(d_depth), static_cast<const float*>(d_T),
      static_cast<float*>(dfeat), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}
