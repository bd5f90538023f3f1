// 32x32 alpha-compositing backward for Hopper (sm_90a), on 16x16
// sub-tile CTAs joined in clusters of four, with per-warp conservative
// culling and asynchronous staging: one body, four falloffs (B2, B2-bf16,
// B2-mxu, B2-bf16-mxu).
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_backward_kernel (reached through _bwd_impl, pallas_call at :699)
// in its f32 body (C entry composite32_bwd), its bf16 body (bf16=True,
// :488-508, the falloff of _chunk_terms :160-175; C entry
// composite32_bwd_bf16), its MXU body (mxu=True, :387-398; C entry
// composite32_bwd_mxu) and the two together (mxu=True, bf16=True: the MXU
// falloff, which takes precedence over bf16's (:157-159), with the bf16
// gradient products; C entry composite32_bwd_bf16_mxu), with the per-pair
// output of tile_kernel2_bwd.cu
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
// arithmetic and its order are tile_kernel2_bwd.cu's, in
// subtile_bwd.cuh's bwd_cell with its falloff axis (kBF16, kMXU), built
// with -fmad=false:
// - f32: the direct power, f32 products;
// - bf16: bf16_falloff.cuh's power and a_un, and its quad_grads for the
//   five products (G, dx, dy, dL/dG and the conic rounded to bfloat16,
//   every product rounded, each widened before its sum);
// - mxu: the tensor cores' power (mxu_falloff.cuh: G8 . P8 about the
//   32x32 tile's centre, three TF32 passes, clamped to <= 0), a_un = opa
//   expf(power) in f32; the transmittance stays the linear T (1 - alpha)
//   as the reference's backward scans it (_scan_mul, :447-449), not the
//   forward's log space, and dx, dy of the products the direct mx - x,
//   my - y (:386-390);
// - bf16 and mxu: the mxu body with bf16's quad_grads for the five
//   products.
//
// What bounds it on the H100: the FP32 operations of the cells a pixel
// evaluates (under bf16 also the conversions and the bfloat16 roundings,
// scalar, one instruction each; under mxu also the tensor cores' three
// passes a power block), and the per-pair reduction. The designs it
// replaced (one CTA of 1024 threads per tile, kept in tile_kernel2_bwd.cu
// as the yardstick C entries composite32_bwd_tile1024 (f32),
// composite32_bwd_bf16_tile1024, composite32_bwd_mxu_tile1024 and
// composite32_bwd_bf16_mxu_tile1024)
// recomputed the tests at every cell of the 32x32 tile-walk (7.9%
// included on the s=1 polish plan; under mxu a power block for every 16
// consecutive pairs), reduced every pair any lane of a warp included with
// ten butterflies, and put all 1024 threads through a barrier every 32
// pairs for a 40 KB table.
// What the design does about it (subtile_cull.cuh, subtile_bwd.cuh):
// - one CTA of 256 threads per 16x16 quarter (one rect16 cell: the rect
//   test runs once per staged pair, ballot + prefix compaction), each
//   warp an 8x4 block of pixels that walks, in pair order, only the pairs
//   the conservative block test keeps, with the margin of its falloff
//   (f32: kCullRel / kCullAbs; bf16: block_keep<true>, kCullBf16Rel /
//   kCullBf16Abs; mxu, alone or with bf16: prepare_mxu's kCullMxu Mmag for
//   the 32x32 tile's centre, since the falloff is the mxu one and bf16
//   rounds only the products). The backward recomputes exactly the
//   falloff, the tests and the transmittance step those margins were
//   derived for, so a culled (pair, block) has alpha < 1/255 at every
//   pixel there: its cells contribute exact zeros and leave T and pA as
//   they were. A warp whose pixels are all done skips the chunk;
// - under mxu the warp walks its survivors as the mxu forward does
//   (tile32_fwd_subtile_mxu.cu): a survivor list in pair order, an A
//   operand of the next 16 survivors' G8 rows copied from the chunk's G8
//   table (formed once per staged row by warps 2 and 3 while warps 0 and
//   1 compact), power_block into the warp's 16 x 32 power block, then
//   clamp_power. The P8 operand is in the basis of the 32x32 tile's
//   centre, not the quarter's. Every lane walks every survivor of the
//   block (done only masks the cell), since each cell some lane includes
//   goes through warp_sum10, which the whole warp must join; the warp
//   leaves the walk only once all its lanes are done;
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
//   chunk late) or the tile's run ends. A pixel's done flag is final: the
//   linear T only falls, under every falloff. Rows never reached keep the
//   zero the wrapper allocated.
// Shared memory and occupancy (ptxas on sm_90a; 228 KB an SM, 1 KB of it
// reserved a CTA): the f32 and bf16 bodies take 36,008 bytes of static
// shared memory (rows 8 KB, block-test terms 2 KB, warp partials 20 KB,
// cluster sums 5 KB), so their registers (__launch_bounds__(256, 4): at
// most 64 a thread) allow 4 CTAs an SM. The mxu bodies (mxu alone and
// with bf16) add 31,264 bytes of dynamic shared memory, opted into at the
// first launch (mxu_falloff::opt_in_smem): the chunk's G8 table 2 KB and
// per warp its A operand 0.5 KB, P8 1 KB, power block 2 KB and survivor
// list 64 bytes, and 32 bytes to align them. 67,272 bytes a CTA leave
// room for 3
// CTAs an SM (24 warps against the f32 body's 32), so their launch bounds
// ask for 3 (at most 85 registers a thread). A cluster of four such CTAs
// spans at most four SMs of one GPC.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_falloff.cuh"
#include "subtile_cull.cuh"
#include "subtile_bwd.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace subtile;
namespace mf = mxu_falloff;

constexpr int kFeat = 16;  // floats per pair row
constexpr int kQuarters = 4;
constexpr int kG = mf::kG;            // G8 columns
constexpr int kPowRows = mf::kBlock;  // survivors a power block
constexpr int kPix = mf::kPix;        // a warp's pixels: the block's 32

// The mxu body's tables, in dynamic shared memory (WMMA loads and stores
// need 32-byte aligned rows: every member starts at a multiple of 32
// bytes): the chunk's G8 rows, and per warp its A operand, P8, power block
// and survivor list.
struct MxuSmem {
  float g8[kChunk][kG];
  float a[kWarps][kPowRows][kG];
  float p8[kWarps][kG][kPix];
  float pow[kWarps][kPowRows][kPix];
  unsigned char surv[kWarps][kChunk];
};
// the dynamic shared memory the mxu body asks for: the tables and the
// room to align their base to 32 bytes
constexpr size_t kMxuSmemBytes = sizeof(MxuSmem) + 32;

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

template <bool kBF16, bool kMXU>
__global__ void __cluster_dims__(kQuarters, 1, 1)
__launch_bounds__(kThreads, kMXU ? 3 : 4)
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
  // kMXU only. Declared 8-byte aligned, so that the static tables (36,008
  // bytes) need no padding in any instantiation; the mxu body aligns its
  // base to 32 bytes itself (kMxuSmemBytes has the room).
  extern __shared__ __align__(8) unsigned char s_dyn[];

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

  // mxu: the 32x32 tile's centre, the basis of the expansion, and this
  // warp's P8 (its 32 pixels in lane order)
  MxuSmem& mx = *reinterpret_cast<MxuSmem*>(
      s_dyn + ((32u - (smem_u32(s_dyn) & 31u)) & 31u));
  float cx_t = 0.0f, cy_t = 0.0f;
  if constexpr (kMXU) {
    cx_t = mf::tile_centre(g.tx);
    cy_t = mf::tile_centre(g.ty);
    mf::p8_column(px - cx_t, py - cy_t, &mx.p8[warp][0][0], lane);
  }

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
    compact_rect<kMXU>(rows, n, g.t16x, g.t16y, s_idx, &s_m, s_pre, cx_t,
                       cy_t);
    if constexpr (kMXU) {
      if (tid >= kChunk && tid < kChunk + n) {  // warps 2 and 3
        const int r = tid - kChunk;
        const float4 f0 = rows[r][0];
        mf::g8_row(f0.x, f0.y, f0.z, f0.w, rows[r][1].x, cx_t, cy_t,
                   mx.g8[r]);
      }
    }
    __syncthreads();

    unsigned wrote0 = 0u, wrote1 = 0u;  // the rows this warp stored
    if (__any_sync(kFull, !done)) {
      unsigned keep[kChunk / 32];
      cull<kBF16 && !kMXU>(s_pre, s_idx, s_m, xb, yb, keep);
      if constexpr (kMXU) {
        // this warp's survivors, in pair order
        unsigned char* const surv = mx.surv[warp];
        float* const a8 = &mx.a[warp][0][0];
        float* const pw = &mx.pow[warp][0][0];
        int m = 0;
#pragma unroll
        for (int h = 0; h < kChunk / 32; ++h) {
          if ((keep[h] >> lane) & 1u) {
            surv[m + __popc(keep[h] & ((1u << lane) - 1u))] =
                s_idx[h * 32 + lane];
          }
          m += __popc(keep[h]);
        }
        __syncwarp();
        for (int i0 = 0; i0 < m; i0 += kPowRows) {
          if (!__any_sync(kFull, !done)) break;  // every pixel is done
          // the A operand: survivors i0 .. i0 + 15's G8 rows, lane l half
          // (l & 1) of row l >> 1, zero past the m-th
          const int i = i0 + (lane >> 1);
          float4 g8 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (i < m) {
            g8 = reinterpret_cast<const float4*>(mx.g8[surv[i]])[lane & 1];
          }
          reinterpret_cast<float4*>(a8 + (lane >> 1) * kG)[lane & 1] = g8;
          __syncwarp();  // and the previous block's powers are read
          mf::power_block(a8, &mx.p8[warp][0][0], pw);
          __syncwarp();
          const int i1 = min(i0 + kPowRows, m);
          for (int k = i0; k < i1; ++k) {
            const int r = surv[k];
            float v[kRows];
            const bool inc = bwd_cell<kBF16, true>(
                rows[r], px, py, cot, &T, &pA, &done, v,
                mf::clamp_power(pw[(k - i0) * kPix + lane]));
            if (__any_sync(kFull, inc)) {
              int col;
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
      } else {
#pragma unroll
        for (int h = 0; h < kChunk / 32; ++h) {
          unsigned bits = keep[h];
          while (bits) {
            const int r = s_idx[h * 32 + __ffs(bits) - 1];
            bits &= bits - 1u;
            float v[kRows];
            const bool inc =
                bwd_cell<kBF16, false>(rows[r], px, py, cot, &T, &pA, &done,
                                       v);
            if (__any_sync(kFull, inc)) {
              int col;
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

template <bool kBF16, bool kMXU>
int launch(const void* feat, const void* ranges, const void* color,
           const void* depth, const void* final_T, const void* d_color,
           const void* d_depth, const void* d_T, void* dfeat, int n_tiles,
           int n_tx, int W, int H, void* stream) {
  if (n_tiles <= 0) return 0;
  size_t smem = 0;
  if constexpr (kMXU) {
    smem = kMxuSmemBytes;
    const cudaError_t e =
        mf::opt_in_smem<composite32_bwd_subtile<kBF16, kMXU>>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite32_bwd_subtile<kBF16, kMXU>
      <<<kQuarters * n_tiles, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
          static_cast<const float*>(color), static_cast<const float*>(depth),
          static_cast<const float*>(final_T),
          static_cast<const float*>(d_color),
          static_cast<const float*>(d_depth), static_cast<const float*>(d_T),
          static_cast<float*>(dfeat), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, loaded with ctypes: composite32_bwd (f32, B2),
// composite32_bwd_bf16 (B2-bf16), composite32_bwd_mxu (B2-mxu) and
// composite32_bwd_bf16_mxu (B2-bf16-mxu). feat:
// (B_al, 16) f32, 16-byte aligned; ranges: (n_tiles, 2) int32; color,
// d_color: (3, H, W) f32; depth, final_T, d_depth, d_T: (H, W) f32;
// dfeat: (B_al, 16) f32, zero-filled by the caller (rows a tile never
// reaches must read 0). Launch on ``stream`` and return
// cudaGetLastError().
#define BWD_ENTRY(NAME, BF16, MXU)                                          \
  extern "C" int NAME(const void* feat, const void* ranges,                 \
                      const void* color, const void* depth,                 \
                      const void* final_T, const void* d_color,             \
                      const void* d_depth, const void* d_T, void* dfeat,    \
                      int n_tiles, int n_tx, int W, int H, void* stream) {  \
    return launch<BF16, MXU>(feat, ranges, color, depth, final_T, d_color,  \
                             d_depth, d_T, dfeat, n_tiles, n_tx, W, H,      \
                             stream);                                       \
  }

BWD_ENTRY(composite32_bwd, false, false)
BWD_ENTRY(composite32_bwd_bf16, true, false)
BWD_ENTRY(composite32_bwd_mxu, false, true)
BWD_ENTRY(composite32_bwd_bf16_mxu, true, true)
