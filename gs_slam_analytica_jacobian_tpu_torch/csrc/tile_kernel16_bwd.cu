// 16x16 alpha-compositing backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py
//   ::make_backward_kernel16 (reached through _bwd_impl16, pallas_call at
//   :622)
// with the per-pair output of the 32x32 backward (tile_kernel2_bwd.cu,
// reference backward.cu:648-872) on the 16-px pair plan: for every pair
// row of feat (B_al x 16 f32 [mean2d, conic, opa, rgb, depth, rect16,
// pad]) walked by its 16x16 tile, the row
//   [d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_r, d_g, d_b, d_depth, 0 x 6]
// summed over the tile's pixels, from the forward's color/depth sums
// (before background) and final T, and their cotangents dC(3), dD, dT.
//
// Per pixel the forward walk is recomputed with the forward kernel's exact
// operation order, so the inclusion decisions are the forward's. For an
// included (pair, pixel) cell, with A = rgb.dC + depth.dD, pA the running
// inclusive prefix of w A and Stot = C.dC + D.dD:
//   dL/dalpha = A T_excl - (dT T_final + Stot - pA) / max(1 - alpha, 1e-6)
// (the TPU kernel's one-pass form, tile_kernel16.py:383-391); gradients
// flow through the unclamped falloff G = a_un / opa: d_opa = G dL/dalpha,
// dL/dG = opa dL/dalpha, then the five quadratic-form terms, and
// d_rgb, d_depth = w dC, w dD. Skipped cells contribute exactly 0.
//
// What bounds it on the H100: arithmetic and the per-pair reduction, as
// for the 32x32 backward: each walked cell recomputes the forward's tests
// (~25 FP32 operations), each included cell evaluates the gradient and adds ten
// values into its pair's row. What the design does about it: one CTA of
// 256 threads per 16x16 tile, one thread per pixel (a warp holds two
// pixel rows), per-cell straight-line FP32 code; pair rows staged per
// chunk of 32 in shared memory and read as broadcasts; each pixel carries
// T, its done flag and pA in registers. A pair's ten sums are formed
// without atomics: a butterfly shuffle reduction inside each warp (skipped,
// with zeros stored, when no lane of the warp includes the pair), an
// [8 warps][32 pairs][10] shared-memory table (10 KB), then one thread per
// (pair, column) sums its 8 warp partials in a fixed order and stores the
// value once (each pair belongs to exactly one tile). Against the 32x32
// backward a pair's row is reduced over 8 warp partials instead of 32,
// and the grid has 4x the CTAs. The CTA leaves when every pixel is done
// (__syncthreads_count); rows it never reaches keep the zero the wrapper
// allocated. Built with -fmad=false, like the forward.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // each warp: two pixel rows
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

__global__ void __launch_bounds__(kThreads)
composite16_bwd_kernel(const float4* __restrict__ feat,   // (B_al, 4) x float4
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

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = tx * kTile + (tid & (kTile - 1));
  const int y = ty * kTile + tid / kTile;
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

  for (int base = rg.x; base < rg.y; base += kChunk) {
    const int n = min(kChunk, rg.y - base);
    __syncthreads();  // the previous chunk's rows and partials are consumed
    if (tid < n * 4) {
      s_feat[tid >> 2][tid & 3] =
          feat[static_cast<size_t>(base + (tid >> 2)) * 4 + (tid & 3)];
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
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
        const float power =
            -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
        const bool rect_ok = (t16x >= f2.z) && (t16x < f3.x) &&
                             (t16y >= f2.w) && (t16y < f3.y);
        if (rect_ok && power <= 0.0f) {
          const float a_un = f1.y * expf(power);
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
              const float gdx = G * dx;
              const float gdy = G * dy;
              const float dG_ddx = -gdx * f0.z - gdy * f0.w;
              const float dG_ddy = -gdy * f1.x - gdx * f0.w;
              v[0] = dLdG * dG_ddx;
              v[1] = dLdG * dG_ddy;
              v[2] = dLdG * (-0.5f * gdx * dx);
              v[3] = dLdG * (-gdx * dy);
              v[4] = dLdG * (-0.5f * gdy * dy);
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
    for (int i = tid; i < n * kRows; i += kThreads) {
      const int pair = i / kRows;
      const int col = i - pair * kRows;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[w][pair][col];
      dfeat[static_cast<size_t>(base + pair) * kFeat + col] = s;
    }
    if (__syncthreads_count(!done) == 0) break;  // every pixel is done
  }
}

}  // namespace

// C entry, loaded with ctypes; the signature of composite32_bwd. feat:
// (B_al, 16) f32, 16-byte aligned; ranges: (n_tiles, 2) int32 over the
// n_tx-wide 16-px grid; color, d_color: (3, H, W) f32; depth, final_T,
// d_depth, d_T: (H, W) f32; dfeat: (B_al, 16) f32, zero-filled by the
// caller. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int composite16_bwd(const void* feat, const void* ranges,
                               const void* color, const void* depth,
                               const void* final_T, const void* d_color,
                               const void* d_depth, const void* d_T,
                               void* dfeat, int n_tiles, int n_tx, int W,
                               int H, void* stream) {
  if (n_tiles <= 0) return 0;
  composite16_bwd_kernel<<<n_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
      static_cast<const float*>(color), static_cast<const float*>(depth),
      static_cast<const float*>(final_T), static_cast<const float*>(d_color),
      static_cast<const float*>(d_depth), static_cast<const float*>(d_T),
      static_cast<float*>(dfeat), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}
