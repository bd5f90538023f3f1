// 16x16 forward alpha compositing for Hopper (sm_90a): the
// one-thread-per-pixel design that tile16_fwd_subtile.cu replaced, kept
// under the C entry composite16_fwd_walk as a yardstick that only
// chip_smoke.py times on the same plans.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py
//   ::make_forward_kernel16 (pallas_call at :562 with n_touched, :582
//   without)
// with the per-pixel semantics of the 32x32 kernel (tile_kernel2_fwd.cu,
// reference forward.cu:406-535) on the 16-px pair plan: for each 16x16
// tile t = ty*n_tx + tx of the (2*ceil(W/32)) x (2*ceil(H/32)) grid, walk
// the pairs [ranges[t,0], ranges[t,1]) of feat (B_al x 16 f32 rows
// [mean2d, conic, opa, rgb, depth, rect16, pad]) front to back for every
// pixel (x, y) (integer coordinates):
//     power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  dx = mx - x, dy = my - y
//     alpha = min(0.99, opa exp(power))
//   skip the pair if power > 0, alpha < 1/255, or the pixel's 16-px cell
//   lies outside the pair's rect16; if T (1 - alpha) < 1e-4 the pixel is
//   done and this pair is dropped; else accumulate rgb/depth with weight
//   alpha T and set T = T (1 - alpha). Pixels outside the image start done.
//   n_touched[pair] counts in-image pixels where the pair was included and
//   T_incl > 0.5 (or, under nt_weight, alpha T >= 1/255).
// The TPU kernel's 2x2 subtile groups, DMA ring, Hillis-Steele scans,
// block-permuted image and chunk-counter channel have no counterpart here.
//
// What bounds it on the H100: arithmetic, as for the 32x32 kernel (~25
// FP32 operations per walked (pair, pixel) cell, ~13 more per cell that
// passes the skip tests, against one 64-byte pair
// row shared by the tile's 256 pixels). A 16-px plan holds more pairs than
// a 32-px one but each pair walks 256 cells instead of 1024, so the cells
// per frame fall. What the design does about it: one CTA of 256 threads
// per tile, one thread per pixel (a warp holds two pixel rows), so the
// per-cell work is straight-line FP32 code; a chunk of 128 pair rows is
// staged once in shared memory (8 KB) and read by all 8 warps as
// broadcasts; the grid has 4x the CTAs of the 32x32 kernel, which fills
// the 132 SMs at the coarse resolutions where that kernel starves; a
// block-wide early exit (__syncthreads_count) stops the walk once every
// pixel is done; per-pair n_touched is a warp ballot/popc plus one
// shared-memory sum over the 8 warps and one plain store per pair (each
// pair belongs to exactly one tile, so no global atomics). Built with
// -fmad=false: every multiply and add rounds as in the plain PyTorch
// version, so the thresholds decide alike in both.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // each warp: two pixel rows
constexpr int kChunk = 128;              // pair rows staged per step
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

template <bool kNTouch, bool kNtWeight>
__global__ void __launch_bounds__(kThreads)
composite16_fwd_kernel(const float4* __restrict__ feat,   // (B_al, 4) x float4
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
  const int x = tx * kTile + (tid & (kTile - 1));
  const int y = ty * kTile + tid / kTile;
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
    for (int i = tid; i < n * 4; i += kThreads) {
      s_feat[i >> 2][i & 3] = feat[static_cast<size_t>(base) * 4 + i];
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
        const float power =
            -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
        const bool rect_ok = (t16x >= f2.z) && (t16x < f3.x) &&
                             (t16y >= f2.w) && (t16y < f3.y);
        if (rect_ok && power <= 0.0f) {
          const float alpha = fminf(kAlphaMax, f1.y * expf(power));
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

}  // namespace

// C entry, loaded with ctypes: composite16_fwd_walk (the yardstick), the
// signature of composite32_fwd. feat:
// (B_al, 16) f32, 16-byte aligned; ranges: (n_tiles, 2) int32 over the
// n_tx-wide 16-px grid; out: (5, H, W) f32; ntouch: (B_al,) f32,
// zero-filled by the caller. Launches on ``stream`` and returns
// cudaGetLastError().
extern "C" int composite16_fwd_walk(const void* feat, const void* ranges,
                                    void* out, void* ntouch, int n_tiles,
                                    int n_tx, int W, int H,
                                    int with_ntouch, int nt_weight,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* f4 = static_cast<const float4*>(feat);
  const int2* r2 = static_cast<const int2*>(ranges);
  float* o = static_cast<float*>(out);
  float* nt = static_cast<float*>(ntouch);
  const dim3 grid(n_tiles);
  const dim3 block(kThreads);
  if (!with_ntouch) {
    composite16_fwd_kernel<false, false><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  } else if (nt_weight) {
    composite16_fwd_kernel<true, true><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  } else {
    composite16_fwd_kernel<true, false><<<grid, block, 0, s>>>(
        f4, r2, o, nt, W, H, n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}
