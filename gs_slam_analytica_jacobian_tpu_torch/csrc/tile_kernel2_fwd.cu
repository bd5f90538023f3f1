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
// What bounds it on the H100: arithmetic. Each walked (pair, pixel) cell
// costs ~25 FP32 operations (quadratic form, expf, tests) and one that
// passes the skip tests ~13 more (transmittance, four multiply-adds),
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
//
// The mxu variant (C entry composite32_fwd_mxu, with or without n_touched)
// replaces the same two call sites with mxu=True (make_forward_kernel
// :225-237, :279-289). The falloff comes from the tensor cores
// (mxu_falloff.cuh): per 128-pair chunk, 128 threads write the chunk's G8
// rows (4 KB) to shared memory; each warp multiplies them, 16 pairs at a
// time, with its row's P8 in three TF32 WMMA passes and stores the 16 x 32
// power block in its own shared buffer (2 KB a warp, 64 KB a CTA: dynamic
// shared memory, opted in once per device; the layout, the G8 fill and
// the block step are mxu_falloff.cuh's, shared with the backward),
// from which each lane walks its pixel's 16 powers in pair order. The
// power is clamped to <= 0, so the power > 0 skip never fires (the
// reference's ok tests the clamped value, :181). Transmittance is the
// reference's log-space prefix: per pixel a running f32 sum
// cum += log1pf(-alpha) that restarts at every 128-pair chunk (the plan
// aligns each tile's run to 128), T_incl = T_chunk expf(cum) with T_chunk
// the pixel's T at the chunk's start, T_excl = T_incl / (1 - alpha) (a
// division, as :288-289), and at the chunk's end T = min(T, T_incl over
// the included pairs) (:305-308). On the TPU a lower-triangular (K, K) @
// (K, P) matmul is how that prefix reaches the MXU; here every thread
// already walks its pixel's pairs in order, so a running sum is the same
// function at 1/128 of the arithmetic. Bound: the tensor-core term (three
// TF32 m16n16k8 products, 3 x 2 x 8 FLOP a walked cell) at the TF32 peak,
// beside the CUDA-core operations that remain: ~15 a walked cell (the f32
// kernel's 25 less the deltas and the quadratic form, 11, plus the clamp)
// and ~30 a cell that passes the skip tests, the only cells that reach the
// log-space prefix (the f32 kernel's 13 less its linear T step, 2, plus
// log1pf ~8, the second expf ~4, the division ~4, the sum and product 2,
// the T min 1). The CUDA cores' share dominates the tensor cores'.

#include <cuda_runtime.h>

#include "bf16_falloff.cuh"
#include "mxu_falloff.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // one warp per pixel row
constexpr int kChunk = 128;              // pair rows staged per step
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// the dynamic shared memory of the mxu variants
using MxuSmem = mxu_falloff::Smem<kChunk, kWarps>;

template <bool kNTouch, bool kNtWeight, bool kBF16, bool kMXU>
__global__ void __launch_bounds__(kThreads)
composite32_fwd_kernel(const float4* __restrict__ feat,   // (B_al, 4) x float4
                       const int2* __restrict__ ranges,   // (n_tiles,)
                       float* __restrict__ out,           // (5, H, W)
                       float* __restrict__ ntouch,        // (B_al,) zeroed
                       int W, int H, int n_tx) {
  __shared__ float4 s_feat[kChunk][4];
  __shared__ int s_cnt[kNTouch ? kWarps : 1][kChunk];
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

  const int2 rg = ranges[tile];
  float T = 1.0f;
  bool done = !inside;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

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
    __syncthreads();  // the previous chunk's rows and counts are consumed
    if (tid < n * 4) {
      s_feat[tid >> 2][tid & 3] =
          feat[static_cast<size_t>(base + (tid >> 2)) * 4 + (tid & 3)];
    }
    __syncthreads();
    if constexpr (kMXU) {
      mxu_falloff::fill_g8<kChunk>(mxu.g8, &s_feat[0][0], n, tid, cx_t, cy_t);
      __syncthreads();
    }
    const float T_chunk = T;  // mxu: T at the chunk's start
    float cum = 0.0f;         // mxu: the chunk's running log-space prefix

    for (int k = 0; k < n; ++k) {
      if constexpr (kMXU) {
        mxu_falloff::block_step(k, !done, mxu.g8, mxu.p8, mxu.pow);
      }
      bool counted = false;
      if (!done) {
        const float4 f0 = s_feat[k][0];  // mx, my, ca, cb
        const float4 f1 = s_feat[k][1];  // cc, opa, r, g
        const float4 f2 = s_feat[k][2];  // b, depth, rect x0, rect y0
        const float4 f3 = s_feat[k][3];  // rect x1, rect y1, pad, pad
        float power;
        if constexpr (kMXU) {
          power = mxu_falloff::power_at(mxu.pow, k, lane);
        } else if constexpr (kBF16) {
          power = bf16_falloff::power(f0.x - px, f0.y - py, f0.z, f0.w,
                                      f1.x);
        } else {
          const float dx = f0.x - px;
          const float dy = f0.y - py;
          power = -0.5f * (f0.z * dx * dx + f1.x * dy * dy) - f0.w * dx * dy;
        }
        const bool rect_ok = (t16x >= f2.z) && (t16x < f3.x) &&
                             (t16y >= f2.w) && (t16y < f3.y);
        if (rect_ok && power <= 0.0f) {
          const float a_un = (kBF16 && !kMXU) ? bf16_falloff::a_un(f1.y, power)
                                              : f1.y * expf(power);
          const float alpha = fminf(kAlphaMax, a_un);
          if (alpha >= kAlphaMin) {
            float T_incl, T_excl;
            if constexpr (kMXU) {
              cum += log1pf(-alpha);
              T_incl = T_chunk * expf(cum);
              T_excl = T_incl / (1.0f - alpha);
            } else {
              T_incl = T * (1.0f - alpha);
              T_excl = T;
            }
            if (T_incl < kTEps) {
              done = true;  // the triggering pair is dropped
            } else {
              const float w = alpha * T_excl;
              acc_r += f1.z * w;
              acc_g += f1.w * w;
              acc_b += f2.x * w;
              acc_d += f2.y * w;
              if (kNTouch) {
                counted = kNtWeight ? (w >= kAlphaMin) : (T_incl > 0.5f);
              }
              T = kMXU ? fminf(T, T_incl) : T_incl;
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

template <bool kNTouch, bool kNtWeight, bool kBF16, bool kMXU>
int launch_one(const void* feat, const void* ranges, void* out, void* ntouch,
               int n_tiles, int n_tx, int W, int H, void* stream) {
  size_t smem = 0;
  if constexpr (kMXU) {
    smem = MxuSmem::kBytes;
    const cudaError_t e = mxu_falloff::opt_in_smem<
        composite32_fwd_kernel<kNTouch, kNtWeight, kBF16, kMXU>>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite32_fwd_kernel<kNTouch, kNtWeight, kBF16, kMXU>
      <<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
          static_cast<float*>(out), static_cast<float*>(ntouch), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBF16, bool kMXU>
int launch(const void* feat, const void* ranges, void* out, void* ntouch,
           int n_tiles, int n_tx, int W, int H, int with_ntouch,
           int nt_weight, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!with_ntouch) {
    return launch_one<false, false, kBF16, kMXU>(feat, ranges, out, ntouch,
                                                 n_tiles, n_tx, W, H, stream);
  }
  if (nt_weight) {
    return launch_one<true, true, kBF16, kMXU>(feat, ranges, out, ntouch,
                                               n_tiles, n_tx, W, H, stream);
  }
  return launch_one<true, false, kBF16, kMXU>(feat, ranges, out, ntouch,
                                              n_tiles, n_tx, W, H, stream);
}

// One chunk's power block through mxu_falloff.cuh, unclamped: the check of
// the tensor-core falloff itself (chip_smoke.py holds it against the f32
// G6 @ P6). One CTA of 1024 threads; pixel q = y * 32 + x of tile (tx, ty).
__global__ void __launch_bounds__(kThreads)
mxu_power_tile_kernel(const float4* __restrict__ feat,  // (n, 4) x float4
                      int n, int tx, int ty,
                      float* __restrict__ out) {         // (128, 1024)
  extern __shared__ __align__(128) float s_mxu[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const MxuSmem mxu(s_mxu, warp);
  const float cx_t = mxu_falloff::tile_centre(tx);
  const float cy_t = mxu_falloff::tile_centre(ty);
  mxu_falloff::p8_column(static_cast<float>(tx * kTile + lane) - cx_t,
                         static_cast<float>(ty * kTile + warp) - cy_t, mxu.p8,
                         lane);
  mxu_falloff::fill_g8<kChunk>(mxu.g8, feat, n, tid, cx_t, cy_t);
  __syncthreads();
  for (int b = 0; b < kChunk; b += mxu_falloff::kBlock) {
    mxu_falloff::block_step(b, true, mxu.g8, mxu.p8, mxu.pow);
    for (int i = 0; i < mxu_falloff::kBlock; ++i) {
      out[static_cast<size_t>(b + i) * kThreads + tid] =
          mxu.pow[i * mxu_falloff::kPix + lane];
    }
  }
}

}  // namespace

// C entries, loaded with ctypes: composite32_fwd (f32),
// composite32_fwd_bf16 (the bfloat16 falloff) and composite32_fwd_mxu (the
// tensor-core falloff and the log-space transmittance; under mxu the
// reference's bf16 flag has no effect on the forward). feat: (B_al, 16)
// f32, 16-byte aligned; ranges: (n_tiles, 2) int32; out: (5, H, W) f32;
// ntouch: (B_al,) f32, zero-filled by the caller (pairs a tile never
// reaches must read 0). Launch on ``stream`` and return
// cudaGetLastError().
extern "C" int composite32_fwd(const void* feat, const void* ranges,
                               void* out, void* ntouch, int n_tiles,
                               int n_tx, int W, int H, int with_ntouch,
                               int nt_weight, void* stream) {
  return launch<false, false>(feat, ranges, out, ntouch, n_tiles, n_tx, W, H,
                              with_ntouch, nt_weight, stream);
}

extern "C" int composite32_fwd_bf16(const void* feat, const void* ranges,
                                    void* out, void* ntouch, int n_tiles,
                                    int n_tx, int W, int H, int with_ntouch,
                                    int nt_weight, void* stream) {
  return launch<true, false>(feat, ranges, out, ntouch, n_tiles, n_tx, W, H,
                             with_ntouch, nt_weight, stream);
}

extern "C" int composite32_fwd_mxu(const void* feat, const void* ranges,
                                   void* out, void* ntouch, int n_tiles,
                                   int n_tx, int W, int H, int with_ntouch,
                                   int nt_weight, void* stream) {
  return launch<false, true>(feat, ranges, out, ntouch, n_tiles, n_tx, W, H,
                             with_ntouch, nt_weight, stream);
}

// The power block of one chunk of n <= 128 pair rows (feat, 16-byte
// aligned) at tile (tx, ty): out (128, 1024) f32, rows >= n zero.
extern "C" int mxu_power_tile(const void* feat, int n, int tx, int ty,
                              void* out, void* stream) {
  const cudaError_t e =
      mxu_falloff::opt_in_smem<mxu_power_tile_kernel>(MxuSmem::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  mxu_power_tile_kernel<<<1, kThreads, MxuSmem::kBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), n, tx, ty, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
