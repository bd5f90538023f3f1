// 32x32 alpha-compositing backward for Hopper (sm_90a): the one-CTA-per-
// tile design.
//
// None of its C entries runs on a path. All four are yardsticks, launched
// by no path and timed by chip_smoke.py in turns beside the sub-tile
// kernels that replaced them (tile32_bwd_subtile.cu, one body with a
// falloff axis): composite32_bwd_tile1024 (the f32 body, replaced by
// composite32_bwd), composite32_bwd_bf16_tile1024 and
// composite32_bwd_mxu_tile1024 (the bf16 and mxu bodies, replaced by
// composite32_bwd_bf16 and composite32_bwd_mxu) and
// composite32_bwd_bf16_mxu_tile1024 (the mxu falloff with the bfloat16
// products, replaced by composite32_bwd_bf16_mxu).
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_backward_kernel (reached through _bwd_impl, pallas_call at :699)
// with the same per-pair output (reference backward.cu:648-872): for every
// pair row of feat (B_al x 16 f32 [mean2d, conic, opa, rgb, depth, rect16,
// pad]) walked by its 32x32 tile, the row
//   [d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_r, d_g, d_b, d_depth, 0 x 6]
// summed over the tile's pixels, from the forward's color/depth sums
// (before background) and final T, and their cotangents dC(3), dD, dT.
//
// Per pixel the forward walk is recomputed with the forward kernel's exact
// operation order (T_incl = T (1 - alpha), w = alpha T, the T_incl < 1e-4
// termination dropping that pair, the rect16 / power > 0 / alpha < 1/255
// skips), so the inclusion decisions are the forward's. For an included
// (pair, pixel) cell, with A = rgb.dC + depth.dD, pA the running inclusive
// prefix of w A and Stot = C.dC + D.dD:
//   dL/dalpha = A T_excl - (dT T_final + Stot - pA) / max(1 - alpha, 1e-6)
// (the TPU kernel's one-pass form, tile_kernel2.py:456-467); gradients flow
// through the unclamped falloff G = a_un / opa: d_opa = G dL/dalpha,
// dL/dG = opa dL/dalpha, then the five quadratic-form terms, and
// d_rgb, d_depth = w dC, w dD. Skipped cells contribute exactly 0.
//
// What bounds it on the H100: arithmetic and the per-pair reduction. Each
// walked (pair, pixel) cell recomputes the forward's tests (~25 FP32
// operations); an included one steps T, evaluates the gradient (~50) and
// contributes ten values to its pair's
// row; the bytes (64-byte pair rows in and out, ten image planes) are a
// small fraction of the 3.35 TB/s budget. What the design does about it:
// one CTA per tile and one thread per pixel as in the forward, so the
// per-cell work is straight-line FP32 code; pair rows are staged per chunk
// of 32 in shared memory and read as broadcasts; each pixel carries T, its
// done flag and pA in registers. A pair's ten sums are formed without
// atomics: a butterfly shuffle reduction inside each warp (skipped, with
// zeros stored, when no lane of the warp includes the pair), a
// [32 warps][32 pairs][10] shared-memory table (40 KB), then one thread
// per (pair, column) sums its 32 warp partials in a fixed order and
// stores the value once (each pair belongs to exactly one tile). The CTA
// leaves when every pixel is done (__syncthreads_count), as the forward
// does; rows it never reaches keep the zero the wrapper allocated. The
// reduction, not the cell arithmetic, is the first lever for a faster
// version. Built with -fmad=false, like the forward, so the recomputed
// walk rounds exactly as the plain PyTorch version's.
//
// The bf16 variant (C entry composite32_bwd_bf16) replaces the same call
// site with bf16=True (tile_kernel2.py:488-508): the walk recomputes the
// bfloat16 falloff of the forward's bf16 variant, and the five
// quadratic-form products are formed in bfloat16 from G, dx, dy and dL/dG
// rounded to bfloat16 (bf16_falloff.cuh), each widened to f32 before its
// pixel sum; d_opa, d_rgb and d_depth stay f32. Its bound is counted as
// the f32 kernel's (no bf16x2 packing; the conversions add operations).
//
// The mxu variants (C entries composite32_bwd_mxu_tile1024 and
// composite32_bwd_bf16_mxu_tile1024) replace the same call site with
// mxu=True (make_backward_kernel :387-398): only the falloff changes.
// Per chunk of 32 pair rows, 32 threads write the G8 rows to shared memory
// and each warp takes its pixels' powers from the tensor cores, 16 pairs at
// a time (mxu_falloff.cuh, three TF32 WMMA passes, clamped to <= 0; 2 KB of
// power block and 1 KB of P8 a warp, 97 KB of dynamic shared memory a CTA
// with the G8 rows). Everything else is B2's walk: the recomputed
// transmittance stays the linear product T (1 - alpha), as the reference's
// backward scans it (_scan_mul, :447-449), not the forward's log space;
// T_final and the other forward planes come from the mxu forward; dx, dy of
// the gradient products stay the direct mx - x, my - y (:386-390); a_un =
// opa expf(power) in f32. Under bf16 as well
// (composite32_bwd_bf16_mxu_tile1024) the quadratic-form products are
// bf16_falloff.cuh's rounded ones: the reference's _chunk_terms gives
// mxu_ctx precedence over bf16 for the falloff (:157-159) while the
// products' bf16 branch (:488-508) still runs. Bound: as B2, plus the
// tensor-core term (3 x 2 x 8 FLOP a walked cell) at the TF32 peak.

#include <cuda_runtime.h>

#include "bf16_falloff.cuh"
#include "mxu_falloff.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // one warp per pixel row
constexpr int kChunk = 32;               // pair rows staged per step
constexpr int kRows = 10;                // gradient columns per pair
constexpr int kFeat = 16;                // floats per pair row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// the dynamic shared memory of the mxu variants
using MxuSmem = mxu_falloff::Smem<kChunk, kWarps>;

template <bool kBF16, bool kMXU>
__global__ void __launch_bounds__(kThreads)
composite32_bwd_kernel(const float4* __restrict__ feat,   // (B_al, 4) x float4
                       const int2* __restrict__ ranges,   // (n_tiles,)
                       const float* __restrict__ color,   // (3, H, W)
                       const float* __restrict__ depth,   // (H, W)
                       const float* __restrict__ final_T, // (H, W)
                       const float* __restrict__ d_color, // (3, H, W)
                       const float* __restrict__ d_depth, // (H, W)
                       const float* __restrict__ d_T,     // (H, W)
                       float* __restrict__ dfeat,         // (B_al, 16) zeroed
                       int W, int H, int n_tx) {
  __shared__ float4 s_feat[kChunk][4];
  __shared__ float s_part[kWarps][kChunk][kRows];
  extern __shared__ __align__(128) float s_mxu[];  // kMXU only

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = tx * kTile + lane;
  const int y = ty * kTile + warp;
  const bool inside = (x < W) && (y < H);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const float t16x = static_cast<float>(x >> 4);
  const float t16y = static_cast<float>(y >> 4);

  // this pixel's forward sums and cotangents (zero outside the image)
  float dCr = 0.0f, dCg = 0.0f, dCb = 0.0f, dD = 0.0f, c0 = 0.0f;
  if (inside) {
    const size_t hw = static_cast<size_t>(H) * W;
    const size_t p = static_cast<size_t>(y) * W + x;
    dCr = d_color[p];
    dCg = d_color[hw + p];
    dCb = d_color[2 * hw + p];
    dD = d_depth[p];
    const float stot = ((dCr * color[p] + dCg * color[hw + p])
                        + dCb * color[2 * hw + p]) + dD * depth[p];
    c0 = d_T[p] * final_T[p] + stot;
  }

  const int2 rg = ranges[tile];
  float T = 1.0f;
  float pA = 0.0f;
  bool done = !inside;

  // mxu: the chunk's G8 rows, this warp's P8 and power block
  const MxuSmem mxu(s_mxu, warp);
  const float cx_t = mxu_falloff::tile_centre(tx);
  const float cy_t = mxu_falloff::tile_centre(ty);
  if constexpr (kMXU) {
    mxu_falloff::p8_column(px - cx_t, py - cy_t, mxu.p8, lane);
    __syncwarp();
  }

  for (int base = rg.x; base < rg.y; base += kChunk) {
    const int n = min(kChunk, rg.y - base);
    __syncthreads();  // the previous chunk's rows and partials are consumed
    if (tid < n * 4) {
      s_feat[tid >> 2][tid & 3] =
          feat[static_cast<size_t>(base + (tid >> 2)) * 4 + (tid & 3)];
    }
    __syncthreads();
    if constexpr (kMXU) {
      mxu_falloff::fill_g8<kChunk>(mxu.g8, &s_feat[0][0], n, tid, cx_t, cy_t);
      __syncthreads();
    }

    for (int k = 0; k < n; ++k) {
      if constexpr (kMXU) {
        mxu_falloff::block_step(k, !done, mxu.g8, mxu.p8, mxu.pow);
      }
      float v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) v[j] = 0.0f;
      bool inc = false;
      if (!done) {
        const float4 f0 = s_feat[k][0];  // mx, my, ca, cb
        const float4 f1 = s_feat[k][1];  // cc, opa, r, g
        const float4 f2 = s_feat[k][2];  // b, depth, rect x0, rect y0
        const float4 f3 = s_feat[k][3];  // rect x1, rect y1, pad, pad
        const float dx = f0.x - px;
        const float dy = f0.y - py;
        float power;
        if constexpr (kMXU) {
          power = mxu_falloff::power_at(mxu.pow, k, lane);
        } else if constexpr (kBF16) {
          power = bf16_falloff::power(dx, dy, f0.z, f0.w, f1.x);
        } else {
          power = -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
        }
        const bool rect_ok = (t16x >= f2.z) && (t16x < f3.x) &&
                             (t16y >= f2.w) && (t16y < f3.y);
        if (rect_ok && power <= 0.0f) {
          const float a_un = (kBF16 && !kMXU) ? bf16_falloff::a_un(f1.y, power)
                                              : f1.y * expf(power);
          const float alpha = fminf(kAlphaMax, a_un);
          if (alpha >= kAlphaMin) {
            const float T_incl = T * (1.0f - alpha);
            if (T_incl < kTEps) {
              done = true;  // the triggering pair is dropped
            } else {
              inc = true;
              const float w = alpha * T;
              const float A =
                  ((f1.z * dCr + f1.w * dCg) + f2.x * dCb) + f2.y * dD;
              pA = pA + w * A;
              const float inv_om = 1.0f / fmaxf(1.0f - alpha, 1e-6f);
              const float dLda = A * T - inv_om * (c0 - pA);
              const float G = a_un / fmaxf(f1.y, 1e-12f);
              const float dLdG = f1.y * dLda;
              if constexpr (kBF16) {
                bf16_falloff::quad_grads(G, dx, dy, dLdG, f0.z, f0.w, f1.x,
                                         v);
              } else {
                const float gdx = G * dx;
                const float gdy = G * dy;
                const float dG_ddx = -gdx * f0.z - gdy * f0.w;
                const float dG_ddy = -gdy * f1.x - gdx * f0.w;
                v[0] = dLdG * dG_ddx;
                v[1] = dLdG * dG_ddy;
                v[2] = dLdG * (-0.5f * gdx * dx);
                v[3] = dLdG * (-gdx * dy);
                v[4] = dLdG * (-0.5f * gdy * dy);
              }
              v[5] = G * dLda;
              v[6] = w * dCr;
              v[7] = w * dCg;
              v[8] = w * dCb;
              v[9] = w * dD;
              T = T_incl;
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, inc)) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) v[j] = warp_sum(v[j]);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) s_part[warp][k][j] = v[j];
      }
    }

    __syncthreads();
    if (tid < n * kRows) {
      const int pair = tid / kRows;
      const int col = tid - pair * kRows;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[w][pair][col];
      dfeat[static_cast<size_t>(base + pair) * kFeat + col] = s;
    }
    if (__syncthreads_count(!done) == 0) break;  // every pixel is done
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
    smem = MxuSmem::kBytes;
    const cudaError_t e =
        mxu_falloff::opt_in_smem<composite32_bwd_kernel<kBF16, kMXU>>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite32_bwd_kernel<kBF16, kMXU><<<n_tiles, kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
      static_cast<const float*>(color), static_cast<const float*>(depth),
      static_cast<const float*>(final_T), static_cast<const float*>(d_color),
      static_cast<const float*>(d_depth), static_cast<const float*>(d_T),
      static_cast<float*>(dfeat), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, loaded with ctypes: the yardsticks composite32_bwd_tile1024
// (this design's f32 body), composite32_bwd_bf16_tile1024 (its bfloat16
// body), composite32_bwd_mxu_tile1024 (its tensor-core falloff) and
// composite32_bwd_bf16_mxu_tile1024 (the tensor-core falloff with the
// bfloat16 gradient products), which only chip_smoke.py and
// tests/test_torch_cuda.py launch, on the same plans as the sub-tile
// kernels that replaced them. feat: (B_al, 16) f32, 16-byte
// aligned; ranges: (n_tiles, 2) int32; color, d_color: (3, H, W) f32;
// depth, final_T, d_depth, d_T: (H, W) f32; dfeat: (B_al, 16) f32,
// zero-filled by the caller (rows a tile never reaches must read 0).
// Launch on ``stream`` and return cudaGetLastError().
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

BWD_ENTRY(composite32_bwd_tile1024, false, false)
BWD_ENTRY(composite32_bwd_bf16_tile1024, true, false)
BWD_ENTRY(composite32_bwd_mxu_tile1024, false, true)
BWD_ENTRY(composite32_bwd_bf16_mxu_tile1024, true, true)
