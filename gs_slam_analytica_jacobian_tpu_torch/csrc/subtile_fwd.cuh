// The sub-tile forward compositing kernel, shared by tile32_fwd_subtile.cu
// (B1' / B1 and B1'-bf16 / B1-bf16 on the 32-px plan) and
// tile16_fwd_subtile.cu (B3' / B3 on the 16-px plan): one body, two
// template axes beside kNTouch and kNtWeight.
//
// The function (reference forward.cu:406-535): for each tile, walk the
// pairs [ranges[t,0], ranges[t,1]) front to back for every pixel (integer
// coordinates), power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, alpha =
// min(0.99, opa exp(power)); skip the pair if power > 0, alpha < 1/255 or
// the pixel's 16-px cell lies outside its rect16; if T (1 - alpha) < 1e-4
// the pixel is done and the pair dropped; else accumulate rgb/depth with
// weight alpha T and step T. n_touched[pair] counts in-image pixels
// where the pair was included and T_incl > 0.5 (or, under nt_weight,
// alpha T >= 1/255).
//
// kBF16, the falloff: f32, the direct f32 power; bf16, the reference's
// bfloat16 body (bf16_falloff.cuh: power from the f32 deltas with every
// product and sum rounded to bfloat16, clamped to <= 0, and opa
// exp(power) rounded once more, both widened). Either way
// the 0.99 cap, the 1/255 and 1e-4 tests, the transmittance and the sums
// are f32, in the same order, and the block test carries the margin of
// its falloff (subtile_cull.cuh: kCullRel / kCullAbs, or kCullBf16Rel /
// kCullBf16Abs).
//
// kTile16, the grid: false, a 32x32 tile's four 16x16 quarters are four
// CTAs (geometry, grid 4 x n_tiles), all reading the tile's range, and
// n_touched is a fixed-order sum over the 8 warps, then one float
// atomicAdd per pair and quarter (whole numbers below 2^24: exact in any
// order, so deterministic); true, a 16x16 tile of the 16-px plan is one
// CTA (geometry16, grid n_tiles, which can hold one column or row of
// tiles past the image), a pair belongs to that one tile, and n_touched
// is the fixed-order warp sum and one plain store. Either way rows that
// the rect16 compaction drops, or that a CTA never reaches, keep the
// wrapper's zero.
//
// The design (subtile_cull.cuh), against the one-thread-per-pixel walks
// it replaced, which evaluated the falloff and tests at every (pair,
// pixel) cell of a tile's run:
// - the CTA's 16x16 pixels are one rect16 cell, so the rect test runs
//   once per staged pair (warp 0, ballot + prefix compaction into shared
//   memory) instead of once per pixel, and the early exit
//   (__syncthreads_count) is per CTA; a CTA wholly outside the image
//   returns at once, and an empty run still writes its pixels (T = 1,
//   zero sums);
// - each warp owns an 8x4 block of pixels; before walking a chunk its
//   lanes test the compacted pairs against the block, one pair a lane,
//   from terms (1/ca, 1/cc, log opa) prepared once per staged row
//   (block_keep: drops a pair only where alpha < 1/255 at every pixel of
//   the block as the kernel's arithmetic computes it), and the warp walks
//   the survivors in pair order; a warp whose pixels are all done skips
//   the chunk;
// - chunks of 64 pair rows (4 KB, one contiguous block) are staged by one
//   bulk asynchronous copy (TMA, cp.async.bulk, completion on an
//   mbarrier) into a double buffer: chunk c + 1 is in flight while chunk
//   c is walked. Staging stays inside [ranges[t,0], ranges[t,1]): on the
//   16-px plan, whose runs start at multiples of K16 = 128, the dead pad
//   slots between runs are never staged or walked.
// A skipped pair changes neither T nor the done flag, so the walk over
// the kept pairs gives the images and n_touched of the walk over all of
// them, bit for bit (built with -fmad=false, as the plain version
// ops/tile_kernel2.py::plain_walk rounds).
//
// Resources, -Xptxas -v on sm_90a: noted in the two sources' headers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_falloff.cuh"
#include "subtile_cull.cuh"

namespace subtile {

template <bool kNTouch, bool kNtWeight, bool kBF16, bool kTile16>
__global__ void __launch_bounds__(kThreads, 4)
composite_fwd_subtile(const float4* __restrict__ feat,  // (B_al, 4) x float4
                      const int2* __restrict__ ranges,  // (n_tiles,)
                      float* __restrict__ out,          // (5, H, W)
                      float* __restrict__ ntouch,       // (B_al,) zeroed
                      int W, int H, int n_tx) {
  __shared__ __align__(128) float4 s_rows[2][kChunk][4];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ unsigned char s_idx[kChunk];
  __shared__ int s_m;
  __shared__ float4 s_pre[kChunk][2];  // the block test's row terms
  __shared__ int s_cnt[kNTouch ? kWarps : 1][kChunk];

  const Geometry g = kTile16 ? geometry16(n_tx) : geometry(n_tx);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool inside = (g.x < W) && (g.y < H);
  const float px = static_cast<float>(g.x);
  const float py = static_cast<float>(g.y);
  const float xb = static_cast<float>(g.xb);
  const float yb = static_cast<float>(g.yb);

  const int2 rg = ranges[g.tile];
  const int n_chunks = (rg.y - rg.x + kChunk - 1) / kChunk;
  float T = 1.0f;
  bool done = !inside;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  if (tid == 0) {
    bar_init(&s_bar[0]);
    bar_init(&s_bar[1]);
    bar_fence_init();
  }
  // a CTA wholly outside the image has nothing to do; an empty run still
  // writes its pixels (T = 1, zero sums)
  if (__syncthreads_count(!done) == 0) return;
  if (tid == 0 && n_chunks > 0) {
    stage(s_rows[0], feat + static_cast<size_t>(rg.x) * 4,
          min(kChunk, rg.y - rg.x) * 64, &s_bar[0]);
  }

  int c = 0;
  for (; c < n_chunks; ++c) {
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
    if (kNTouch) {
      for (int r = lane; r < kChunk; r += 32) s_cnt[warp][r] = 0;
    }
    __syncthreads();

    if (__any_sync(kFull, !done)) {
      unsigned keep[kChunk / 32];
      cull<kBF16>(s_pre, s_idx, s_m, xb, yb, keep);
#pragma unroll
      for (int h = 0; h < kChunk / 32; ++h) {
        unsigned bits = keep[h];
        while (bits) {
          const int r = s_idx[h * 32 + __ffs(bits) - 1];
          bits &= bits - 1u;
          bool counted = false;
          if (!done) {
            const float4 f0 = rows[r][0];  // mx, my, ca, cb
            const float4 f1 = rows[r][1];  // cc, opa, r, g
            const float4 f2 = rows[r][2];  // b, depth, rect x0, rect y0
            const float dx = f0.x - px;
            const float dy = f0.y - py;
            float power;
            if constexpr (kBF16) {
              power = bf16_falloff::power(dx, dy, f0.z, f0.w, f1.x);
            } else {
              power = -0.5f * (f0.z * dx * dx + f1.x * dy * dy) -
                      f0.w * dx * dy;
            }
            if (power <= 0.0f) {
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
            const unsigned ballot = __ballot_sync(kFull, counted);
            if (lane == 0) s_cnt[warp][r] = __popc(ballot);
          }
        }
      }
    }

    if (kNTouch) {
      __syncthreads();
      if (tid < n) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_cnt[w][tid];
        if (s) {
          if constexpr (kTile16) {
            ntouch[base + tid] = static_cast<float>(s);
          } else {
            atomicAdd(&ntouch[base + tid], static_cast<float>(s));
          }
        }
      }
    }
    if (__syncthreads_count(!done) == 0) break;  // the CTA is done
  }
  // a copy still in flight must land before the CTA's shared memory goes
  if (tid == 0 && c + 1 < n_chunks) bar_wait(&s_bar[(c + 1) & 1],
                                             ((c + 1) >> 1) & 1);

  if (inside) {
    const size_t hw = static_cast<size_t>(H) * W;
    const size_t p = static_cast<size_t>(g.y) * W + g.x;
    out[p] = acc_r;
    out[hw + p] = acc_g;
    out[2 * hw + p] = acc_b;
    out[3 * hw + p] = acc_d;
    out[4 * hw + p] = T;
  }
}

template <bool kNTouch, bool kNtWeight, bool kBF16, bool kTile16>
int launch_fwd_one(const void* feat, const void* ranges, void* out,
                   void* ntouch, int n_tiles, int n_tx, int W, int H,
                   void* stream) {
  composite_fwd_subtile<kNTouch, kNtWeight, kBF16, kTile16>
      <<<kTile16 ? n_tiles : 4 * n_tiles, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
          static_cast<float*>(out), static_cast<float*>(ntouch), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' body: feat (B_al, 16) f32, 16-byte aligned; ranges
// (n_tiles, 2) int32 over the n_tx-wide grid; out (5, H, W) f32; ntouch
// (B_al,) f32, zero-filled by the caller (pairs a tile never reaches must
// read 0). Launches on ``stream`` and returns cudaGetLastError().
template <bool kBF16, bool kTile16>
int launch_fwd(const void* feat, const void* ranges, void* out, void* ntouch,
               int n_tiles, int n_tx, int W, int H, int with_ntouch,
               int nt_weight, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!with_ntouch) {
    return launch_fwd_one<false, false, kBF16, kTile16>(
        feat, ranges, out, ntouch, n_tiles, n_tx, W, H, stream);
  }
  if (nt_weight) {
    return launch_fwd_one<true, true, kBF16, kTile16>(
        feat, ranges, out, ntouch, n_tiles, n_tx, W, H, stream);
  }
  return launch_fwd_one<true, false, kBF16, kTile16>(
      feat, ranges, out, ntouch, n_tiles, n_tx, W, H, stream);
}

}  // namespace subtile
