// 32x32 alpha-compositing backward for Hopper (sm_90a), on 16x16
// sub-tile CTAs joined in clusters of four, with per-warp conservative
// culling and asynchronous staging.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_backward_kernel (reached through _bwd_impl, pallas_call at :699)
// in its f32 body, with the per-pair output of tile_kernel2_bwd.cu
// (reference backward.cu:648-872): for every pair row of feat walked by
// its 32x32 tile, the row
//   [d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_r, d_g, d_b, d_depth, 0 x 6]
// summed over the tile's pixels, from the forward's color/depth sums
// (before background) and final T, and their cotangents dC(3), dD, dT.
// Per pixel the forward walk is recomputed with the forward's exact
// operation order, so the inclusion decisions are the forward's, and an
// included cell contributes, with A = rgb.dC + depth.dD, pA the running
// inclusive prefix of w A and Stot = C.dC + D.dD,
//   dL/dalpha = A T_excl - (dT T_final + Stot - pA) / max(1 - alpha, 1e-6)
// (the one-pass form, tile_kernel2.py:456-467) through G = a_un / opa to
// the five quadratic-form terms, d_opa, d_rgb and d_depth. The per-cell
// arithmetic and its order are tile_kernel2_bwd.cu's, built with
// -fmad=false.
//
// What bounds it on the H100: the FP32 operations of the cells a pixel
// evaluates, and the per-pair reduction. PR 5's design (one CTA of 1024
// threads per tile, kept in tile_kernel2_bwd.cu as the yardstick C entry
// composite32_bwd_tile1024) recomputed the tests at every cell of the
// 32x32 tile-walk (7.9% included on the s=1 polish plan), reduced every
// pair any lane of a warp included with ten butterflies, and put all
// 1024 threads through a barrier every 32 pairs for a 40 KB table.
// What the design does about it (subtile_cull.cuh, subtile_bwd.cuh):
// - one CTA of 256 threads per 16x16 quarter (one rect16 cell: the rect
//   test runs once per staged pair, ballot + prefix compaction), each
//   warp an 8x4 block of pixels that walks, in pair order, only the pairs
//   the conservative block test keeps; a warp whose pixels are all done
//   skips the chunk;
// - chunks of 64 pair rows staged by a bulk asynchronous copy (TMA,
//   mbarrier completion) into a double buffer, the next in flight while
//   the current one is walked;
// - rows reduced without atomics and in a fixed order: inside a warp a
//   reduce-scatter of the ten values (12 shuffles, warp_sum10) only for a
//   surviving pair some lane includes, its ten sums stored by ten lanes
//   in an [8 warps][64][10] table with a bit per written row;
//   inside the CTA one thread per (pair, column) sums the warps' partials
//   in warp order; across the tile's four quarters, a thread block
//   cluster of four (__cluster_dims__): after a cluster barrier, rank 0
//   adds the other three CTAs' sums from distributed shared memory in
//   rank order and stores each row once. The sums are double-buffered
//   and the cluster barrier is split (arrive after a chunk's sums, wait
//   one chunk later, before rank 0 reads them), so a quarter may walk one
//   chunk ahead of the others instead of all four meeting every chunk.
//   The result is bit for bit the same from launch to launch.
// - the early exit is per cluster: a quarter whose pixels are all done
//   keeps joining the cluster barriers with zero sums until all four are
//   done (read from each CTA's flag over distributed shared memory, one
//   chunk late) or the tile's run ends. Rows never reached keep the zero
//   the wrapper allocated.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "subtile_cull.cuh"
#include "subtile_bwd.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace subtile;

constexpr int kFeat = 16;  // floats per pair row
constexpr int kQuarters = 4;

// the cluster barrier in two halves (cluster.sync() is both)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rank 0: the four quarters' sums of n rows (``sum``: this CTA's [kChunk]
// [kRows] table, the peers' at the same offset) added in rank order, each
// row stored once
__device__ __forceinline__ void store_rows(cg::cluster_group cluster,
                                           float (*sum)[kRows],
                                           float* __restrict__ dfeat,
                                           int base, int n) {
  const float* q0 = &sum[0][0];
  const float* q1 = cluster.map_shared_rank(&sum[0][0], 1);
  const float* q2 = cluster.map_shared_rank(&sum[0][0], 2);
  const float* q3 = cluster.map_shared_rank(&sum[0][0], 3);
  for (int i = threadIdx.x; i < n * kRows; i += kThreads) {
    const int r = i / kRows;
    const int col = i - r * kRows;
    dfeat[static_cast<size_t>(base + r) * kFeat + col] =
        ((q0[i] + q1[i]) + q2[i]) + q3[i];
  }
}

__global__ void __cluster_dims__(kQuarters, 1, 1)
__launch_bounds__(kThreads, 4)
composite32_bwd_subtile(const float4* __restrict__ feat,   // (B_al, 4) x float4
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
  // this quarter's row sums and whether any of its pixels is not done,
  // double-buffered: read by the cluster's rank 0 (sums) and every rank
  // (flags) after the chunk's cluster barrier
  __shared__ float s_sum[2][kChunk][kRows];
  __shared__ int s_alive[2];

  cg::cluster_group cluster = cg::this_cluster();
  const Geometry g = geometry(n_tx);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool inside = (g.x < W) && (g.y < H);
  const float px = static_cast<float>(g.x);
  const float py = static_cast<float>(g.y);
  const float xb = static_cast<float>(g.xb);
  const float yb = static_cast<float>(g.yb);
  const unsigned rank = cluster.block_rank();

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
  __syncthreads();
  if (tid == 0 && n_chunks > 0) {
    stage(s_rows[0], feat + static_cast<size_t>(rg.x) * 4,
          min(kChunk, rg.y - rg.x) * 64, &s_bar[0]);
  }

  int last = -1;  // the last chunk whose sums are not stored yet
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
    __syncthreads();

    // the previous chunk's sums are complete in every quarter once the
    // cluster barrier's previous phase is: rank 0 stores them, and every
    // rank reads whether any quarter had a pixel left after that chunk
    int any = 1;
    if (c > 0) {
      cluster_wait();
      if (rank == 0) {
        store_rows(cluster, s_sum[(c - 1) & 1], dfeat, base - kChunk,
                   kChunk);
      }
      any = 0;
#pragma unroll
      for (int q = 0; q < kQuarters; ++q) {
        any |= *cluster.map_shared_rank(&s_alive[(c - 1) & 1], q);
      }
    }
    // this chunk's sums, warp partials added in warp order
    for (int i = tid; i < n * kRows; i += kThreads) {
      const int r = i / kRows;
      const int col = i - r * kRows;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((s_wrote[w][r >> 5] >> (r & 31)) & 1u) s += s_part[w][r][col];
      }
      s_sum[buf][r][col] = s;
    }
    const int alive = __syncthreads_count(!done);
    if (tid == 0) s_alive[buf] = alive;
    cluster_arrive();
    last = c;
    // every pixel of the tile was done before this chunk: its sums are 0
    if (!any) break;
  }
  // a copy still in flight must land before the CTA's shared memory goes
  if (tid == 0 && last + 1 < n_chunks) {
    bar_wait(&s_bar[(last + 1) & 1], ((last + 1) >> 1) & 1);
  }
  if (last >= 0) {
    cluster_wait();
    if (rank == 0) {
      const int base = rg.x + last * kChunk;
      store_rows(cluster, s_sum[last & 1], dfeat, base,
                 min(kChunk, rg.y - base));
    }
    // the peers' shared memory stays until rank 0 has read it
    cluster.sync();
  }
}

}  // namespace

// C entry, loaded with ctypes: composite32_bwd (f32). feat: (B_al, 16)
// f32, 16-byte aligned; ranges: (n_tiles, 2) int32; color, d_color: (3,
// H, W) f32; depth, final_T, d_depth, d_T: (H, W) f32; dfeat: (B_al, 16)
// f32, zero-filled by the caller (rows a tile never reaches must read
// 0). Launch on ``stream`` and return cudaGetLastError().
extern "C" int composite32_bwd(const void* feat, const void* ranges,
                               const void* color, const void* depth,
                               const void* final_T, const void* d_color,
                               const void* d_depth, const void* d_T,
                               void* dfeat, int n_tiles, int n_tx, int W,
                               int H, void* stream) {
  if (n_tiles <= 0) return 0;
  composite32_bwd_subtile<<<kQuarters * n_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
      static_cast<const float*>(color), static_cast<const float*>(depth),
      static_cast<const float*>(final_T), static_cast<const float*>(d_color),
      static_cast<const float*>(d_depth), static_cast<const float*>(d_T),
      static_cast<float*>(dfeat), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}
