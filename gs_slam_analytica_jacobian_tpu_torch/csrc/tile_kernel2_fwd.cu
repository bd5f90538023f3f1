// 32x32 forward alpha compositing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_forward_kernel (pallas_call at :642 with n_touched, :662 without)
// with the same per-pixel semantics (reference forward.cu:406-535):
//   for each 32x32 tile t = ty*n_tx + tx, walk the pairs [ranges[t,0],
//   ranges[t,1]) of feat (B_al x 16 f32 rows [mean2d, conic, opa, rgb,
//   depth, rect16, pad]) front to back for every pixel (x, y) (integer
//   coordinates, no +0.5):
//     power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  dx = mx - x, dy = my - y
//     alpha = min(0.99, opa exp(power))
//   skip the pair if power > 0, alpha < 1/255, or the pixel's 16-px cell
//   lies outside the pair's rect16; if T (1 - alpha) < 1e-4 the pixel is
//   done and this pair is dropped; else accumulate rgb/depth with weight
//   alpha T and set T = T (1 - alpha). Pixels outside the image start done.
//   n_touched[pair] counts in-image pixels where the pair was included and
//   T_incl > 0.5 (or, under nt_weight, alpha T >= 1/255).
//
// What bounds it on the H100: arithmetic. Each (pair, pixel) cell costs
// ~30 FP32 operations (quadratic form, expf, tests, four multiply-adds)
// against one 64-byte pair row shared by all 1024 pixels of the tile, so the bytes
// moved (pair rows + the 5-plane image) are a small fraction of the
// 3.35 TB/s budget and the FP32 pipes are the limit.
// What the design does about it: one CTA per tile and one thread per
// pixel, so the per-cell work is straight-line FP32 code with no
// cross-thread traffic; a chunk of 128 pair rows is staged once in shared
// memory (8 KB) and read by all 32 warps as broadcasts; a block-wide
// early exit (__syncthreads_count) stops the walk once every pixel is
// done; per-pair n_touched is a warp ballot/popc plus one shared-memory
// sum over the 32 warps and one plain store per pair (each pair belongs
// to exactly one tile, so no global atomics). The output is written
// directly in (C, H, W) planes. Built with -fmad=false: every multiply
// and add rounds as in the plain PyTorch version, so the alpha and
// transmittance thresholds decide alike in both.
//
// The bf16 variant (C entry composite32_fwd_bf16) replaces the same two
// call sites with bf16=True: the falloff of _chunk_terms' bf16 branch
// (tile_kernel2.py:160-175), power and opa exp(power) in bfloat16 from f32
// deltas (bf16_falloff.cuh), widened to f32 before the 0.99 cap and the
// skip tests; transmittance, the 1e-4 stop and the sums stay f32. Its
// bound is the f32 kernel's: scalar bfloat16 arithmetic runs at no more
// than the FP32 rate on the CUDA cores (nothing here packs bf16x2), and
// the conversions add operations, so it is not expected to be faster.

#include <cuda_runtime.h>

#include "bf16_falloff.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // one warp per pixel row
constexpr int kChunk = 128;              // pair rows staged per step
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

template <bool kNTouch, bool kNtWeight, bool kBF16>
__global__ void __launch_bounds__(kThreads)
composite32_fwd_kernel(const float4* __restrict__ feat,   // (B_al, 4) x float4
                       const int2* __restrict__ ranges,   // (n_tiles,)
                       float* __restrict__ out,           // (5, H, W)
                       float* __restrict__ ntouch,        // (B_al,) zeroed
                       int W, int H, int n_tx) {
  __shared__ float4 s_feat[kChunk][4];
  __shared__ int s_cnt[kNTouch ? kWarps : 1][kChunk];

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

  const int2 rg = ranges[tile];
  float T = 1.0f;
  bool done = !inside;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int base = rg.x; base < rg.y; base += kChunk) {
    const int n = min(kChunk, rg.y - base);
    __syncthreads();  // the previous chunk's rows and counts are consumed
    if (tid < n * 4) {
      s_feat[tid >> 2][tid & 3] =
          feat[static_cast<size_t>(base + (tid >> 2)) * 4 + (tid & 3)];
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      bool counted = false;
      if (!done) {
        const float4 f0 = s_feat[k][0];  // mx, my, ca, cb
        const float4 f1 = s_feat[k][1];  // cc, opa, r, g
        const float4 f2 = s_feat[k][2];  // b, depth, rect x0, rect y0
        const float4 f3 = s_feat[k][3];  // rect x1, rect y1, pad, pad
        const float dx = f0.x - px;
        const float dy = f0.y - py;
        float power;
        if constexpr (kBF16) {
          power = bf16_falloff::power(dx, dy, f0.z, f0.w, f1.x);
        } else {
          power = -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
        }
        const bool rect_ok = (t16x >= f2.z) && (t16x < f3.x) &&
                             (t16y >= f2.w) && (t16y < f3.y);
        if (rect_ok && power <= 0.0f) {
          const float a_un = kBF16 ? bf16_falloff::a_un(f1.y, power)
                                   : f1.y * expf(power);
          const float alpha = fminf(kAlphaMax, a_un);
          if (alpha >= kAlphaMin) {
            const float T_incl = T * (1.0f - alpha);
            if (T_incl < kTEps) {
              done = true;  // the triggering pair is dropped
            } else {
              const float w = alpha * T;
              acc_r += f1.z * w;
              acc_g += f1.w * w;
              acc_b += f2.x * w;
              acc_d += f2.y * w;
              if (kNTouch) {
                counted = kNtWeight ? (w >= kAlphaMin) : (T_incl > 0.5f);
              }
              T = T_incl;
            }
          }
        }
      }
      if (kNTouch) {
        const unsigned ballot = __ballot_sync(0xffffffffu, counted);
        if (lane == 0) s_cnt[warp][k] = __popc(ballot);
      }
    }

    if (kNTouch) {
      __syncthreads();
      if (tid < n) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_cnt[w][tid];
        ntouch[base + tid] = static_cast<float>(s);
      }
    }
    if (__syncthreads_count(!done) == 0) break;  // every pixel is done
  }

  if (inside) {
    const size_t hw = static_cast<size_t>(H) * W;
    const size_t p = static_cast<size_t>(y) * W + x;
    out[p] = acc_r;
    out[hw + p] = acc_g;
    out[2 * hw + p] = acc_b;
    out[3 * hw + p] = acc_d;
    out[4 * hw + p] = T;
  }
}

template <bool kBF16>
int launch(const void* feat, const void* ranges, void* out, void* ntouch,
           int n_tiles, int n_tx, int W, int H, int with_ntouch,
           int nt_weight, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* f4 = static_cast<const float4*>(feat);
  const int2* r2 = static_cast<const int2*>(ranges);
  float* o = static_cast<float*>(out);
  float* nt = static_cast<float*>(ntouch);
  const dim3 grid(n_tiles);
  const dim3 block(kThreads);
  if (!with_ntouch) {
    composite32_fwd_kernel<false, false, kBF16><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  } else if (nt_weight) {
    composite32_fwd_kernel<true, true, kBF16><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  } else {
    composite32_fwd_kernel<true, false, kBF16><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, loaded with ctypes: composite32_fwd (f32) and
// composite32_fwd_bf16 (the bfloat16 falloff). feat: (B_al, 16) f32,
// 16-byte aligned; ranges: (n_tiles, 2) int32; out: (5, H, W) f32;
// ntouch: (B_al,) f32, zero-filled by the caller (pairs a tile never
// reaches must read 0). Launch on ``stream`` and return
// cudaGetLastError().
extern "C" int composite32_fwd(const void* feat, const void* ranges,
                               void* out, void* ntouch, int n_tiles,
                               int n_tx, int W, int H, int with_ntouch,
                               int nt_weight, void* stream) {
  return launch<false>(feat, ranges, out, ntouch, n_tiles, n_tx, W, H,
                       with_ntouch, nt_weight, stream);
}

extern "C" int composite32_fwd_bf16(const void* feat, const void* ranges,
                                    void* out, void* ntouch, int n_tiles,
                                    int n_tx, int W, int H, int with_ntouch,
                                    int nt_weight, void* stream) {
  return launch<true>(feat, ranges, out, ntouch, n_tiles, n_tx, W, H,
                      with_ntouch, nt_weight, stream);
}
