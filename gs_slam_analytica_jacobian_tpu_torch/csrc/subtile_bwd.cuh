// What the sub-tile backward kernels (tile32_bwd_subtile.cu's B2, B2-bf16
// and B2-mxu, tile16_bwd_subtile.cu's B4) share: a pixel's forward sums
// and cotangents, the backward walk's step at one (pair, pixel) cell, and
// a warp's sums of a pair's ten gradient values over its 32 pixels.
//
// The cell (reference backward.cu:648-872, the one-pass form of
// tile_kernel2.py:456-467 and tile_kernel16.py:383-391): the forward's
// falloff, tests and transmittance step with the forward's exact
// operation order, so the inclusion decisions are the forward's; an
// included cell contributes, with A = rgb.dC + depth.dD, pA the running
// inclusive prefix of w A and Stot = C.dC + D.dD,
//   dL/dalpha = A T_excl - (dT T_final + Stot - pA) / max(1 - alpha, 1e-6)
// through G = a_un / opa to the five quadratic-form terms, d_opa, d_rgb
// and d_depth. Built with -fmad=false, so it rounds as the plain version
// (ops/tile_kernel2.py::plain_bwd_walk) does.
//
// The cell's falloff axis (kBF16, kMXU), as the one-CTA-per-tile bodies of
// tile_kernel2_bwd.cu have it: f32, the direct f32 power and f32
// products; kBF16, the bfloat16 falloff (bf16_falloff::power and ::a_un)
// and the five quadratic-form products formed in bfloat16
// (bf16_falloff::quad_grads), each widened; kMXU, the power comes in from
// the caller's tensor-core power block (clamped to <= 0) and a_un = opa
// expf(power) in f32, while the transmittance stays the linear
// T (1 - alpha) and dx, dy of the products the direct mx - x, my - y
// (under kBF16 as well, the products are the bfloat16 ones). d_opa, d_rgb
// and d_depth stay f32 under every flag.

#pragma once

#include <cuda_runtime.h>

#include "bf16_falloff.cuh"
#include "subtile_cull.cuh"

namespace subtile {

constexpr int kRows = 10;  // gradient columns per pair

// A pixel's cotangents of color (dC) and depth (dD) and c0 = dT T_final +
// Stot, all zero outside the image.
struct PixelCot {
  float dCr = 0.0f, dCg = 0.0f, dCb = 0.0f, dD = 0.0f, c0 = 0.0f;
};

__device__ __forceinline__ PixelCot pixel_cot(
    bool inside, int x, int y, int W, int H, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_T,
    const float* __restrict__ d_color, const float* __restrict__ d_depth,
    const float* __restrict__ d_T) {
  PixelCot k;
  if (inside) {
    const size_t hw = static_cast<size_t>(H) * W;
    const size_t p = static_cast<size_t>(y) * W + x;
    k.dCr = d_color[p];
    k.dCg = d_color[hw + p];
    k.dCb = d_color[2 * hw + p];
    k.dD = d_depth[p];
    const float stot = ((k.dCr * color[p] + k.dCg * color[hw + p])
                        + k.dCb * color[2 * hw + p]) + k.dD * depth[p];
    k.c0 = d_T[p] * final_T[p] + stot;
  }
  return k;
}

// The walk's step at the cell of pair row ``row`` (four float4: mx, my,
// ca, cb | cc, opa, r, g | b, depth, rect) and pixel (px, py) whose
// transmittance, prefix and done flag are *T, *pA, *done: v gets the
// cell's ten gradient values (zero unless included), and the return
// value says whether the pixel included the pair. Under kMXU
// ``power_mxu`` is the cell's clamped tensor-core power (read only where
// the pixel is not done).
template <bool kBF16 = false, bool kMXU = false>
__device__ __forceinline__ bool bwd_cell(const float4* row, float px,
                                         float py, const PixelCot& k,
                                         float* T, float* pA, bool* done,
                                         float v[kRows],
                                         float power_mxu = 0.0f) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = 0.0f;
  if (*done) return false;
  const float4 f0 = row[0];  // mx, my, ca, cb
  const float4 f1 = row[1];  // cc, opa, r, g
  const float4 f2 = row[2];  // b, depth, rect x0, rect y0
  const float dx = f0.x - px;
  const float dy = f0.y - py;
  float power;
  if constexpr (kMXU) {
    power = power_mxu;
  } else if constexpr (kBF16) {
    power = bf16_falloff::power(dx, dy, f0.z, f0.w, f1.x);
  } else {
    power = -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
  }
  if (!(power <= 0.0f)) return false;
  float a_un;
  if constexpr (kBF16 && !kMXU) {
    a_un = bf16_falloff::a_un(f1.y, power);
  } else {
    a_un = f1.y * expf(power);
  }
  const float alpha = fminf(kAlphaMax, a_un);
  if (!(alpha >= kAlphaMin)) return false;
  const float T_incl = *T * (1.0f - alpha);
  if (T_incl < kTEps) {
    *done = true;  // the triggering pair is dropped
    return false;
  }
  const float w = alpha * *T;
  const float A = ((f1.z * k.dCr + f1.w * k.dCg) + f2.x * k.dCb) + f2.y * k.dD;
  *pA = *pA + w * A;
  const float inv_om = 1.0f / fmaxf(1.0f - alpha, 1e-6f);
  const float dLda = A * *T - inv_om * (k.c0 - *pA);
  const float G = a_un / fmaxf(f1.y, 1e-12f);
  const float dLdG = f1.y * dLda;
  if constexpr (kBF16) {
    bf16_falloff::quad_grads(G, dx, dy, dLdG, f0.z, f0.w, f1.x, v);
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
  v[6] = w * k.dCr;
  v[7] = w * k.dCg;
  v[8] = w * k.dCb;
  v[9] = w * k.dD;
  *T = T_incl;
  return true;
}

// The warp sums of the ten values v[0..9] in 12 shuffles instead of ten
// butterflies' 50: at each of the five levels a lane keeps half of its
// values and adds its partner's copies of them (the halves 5/5, 3/3 with
// one zero slot, 2/2 with one, 1/1, then the last value whole). Returns
// the sum this lane ends with and sets *col to its column, or -1 where
// the lane holds a zero slot; lanes l and l ^ 1 hold the same column.
// The order of the additions is fixed: the result is deterministic.
__device__ __forceinline__ float warp_sum10(const float v[kRows], int lane,
                                            int* col) {
  const bool h1 = lane & 16, h2 = lane & 8, h3 = lane & 4, h4 = lane & 2;
  float k[5];  // columns (h1 ? 5 : 0) + j
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float send = h1 ? v[j] : v[j + 5];
    k[j] = (h1 ? v[j + 5] : v[j]) + __shfl_xor_sync(kFull, send, 16);
  }
  float m[3];  // k slots (h2 ? 3 : 0) + j, slot 5 zero
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float hi = j + 3 < 5 ? k[j + 3] : 0.0f;
    const float send = h2 ? k[j] : hi;
    m[j] = (h2 ? hi : k[j]) + __shfl_xor_sync(kFull, send, 8);
  }
  float n[2];  // m slots (h3 ? 2 : 0) + j, slot 3 zero
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float hi = j + 2 < 3 ? m[j + 2] : 0.0f;
    const float send = h3 ? m[j] : hi;
    n[j] = (h3 ? hi : m[j]) + __shfl_xor_sync(kFull, send, 4);
  }
  // n slot h4
  float p = (h4 ? n[1] : n[0]) +
            __shfl_xor_sync(kFull, h4 ? n[0] : n[1], 2);
  p += __shfl_xor_sync(kFull, p, 1);
  const int m_slot = (h3 ? 2 : 0) + (h4 ? 1 : 0);
  const int k_slot = (h2 ? 3 : 0) + m_slot;
  *col = (m_slot < 3 && k_slot < 5) ? (h1 ? 5 : 0) + k_slot : -1;
  return p;
}

}  // namespace subtile
