// 32x32 forward alpha compositing on the tensor-core falloff for Hopper
// (sm_90a), on 16x16 sub-tile CTAs with per-warp conservative culling and
// asynchronous staging.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_forward_kernel (pallas_call at :642 with n_touched, :662
//   without) in its MXU body (mxu=True: _mxu_power :96-128, the log-space
//   transmittance :279-289), with the per-pixel semantics of the f32
//   forward (tile32_fwd_subtile.cu) but two differences: the power is the
//   tile-local expansion G8 . P8 on the tensor cores (mxu_falloff.cuh:
//   three TF32 WMMA passes of the exactly split G8 operand, clamped to
//   <= 0), and the transmittance is the reference's log-space prefix: per
//   pixel a running f32 sum cum += log1pf(-alpha) that restarts at every
//   128-row block of the plan (each tile's run starts at a multiple of
//   128), T_incl = T_blk expf(cum) with T_blk the pixel's T at the block's
//   start, T_excl = T_incl / (1 - alpha), the pixel done where T_incl <
//   1e-4 (that pair dropped), else the sums take alpha T_excl and T =
//   min(T, T_incl). n_touched counts in-image pixels where the pair was
//   included and T_incl > 0.5 (or, under nt_weight, alpha T_excl >=
//   1/255).
//
// What bounds it on the H100: the CUDA cores' operations on the cells a
// pixel evaluates (log1pf, a second expf and a division on every cell
// that passes the skip tests), beside the tensor cores' three passes.
// The design it replaced (one CTA of 1024 threads per tile, a warp per
// tile row) evaluated every cell of the 32x32
// tile-walk, 16 consecutive pairs a power block, and 1024 threads met at
// every 128-row chunk. What the design does about it (subtile_cull.cuh):
// - one CTA of 256 threads per 16x16 quarter of a tile (the quarter is
//   one rect16 cell: the rect test runs once per staged pair, ballot +
//   prefix compaction), each warp an 8x4 block of pixels;
// - the block test with the margin of the tensor-core falloff
//   (prepare_mxu, subtile_cull.cuh's note derives it): before walking a
//   chunk the warp's lanes test the compacted pairs against the block
//   and the warp lists its survivors in pair order in shared memory;
// - the power block is per warp. The P8 operand is 8 x 32 as before, its
//   columns the block's 32 pixels in lane order, in the basis of the
//   32x32 tile's centre (tx 32 + 15.5, ty 32 + 15.5), not the quarter's:
//   the expansion, and so its rounding, is the reference's. The A
//   operand is the G8 rows of the warp's next 16 survivors, copied from
//   the chunk's G8 table (a row per staged pair, formed once, by warps 2
//   and 3 while warps 0 and 1 compact) into the warp's own 16 x 8 buffer,
//   zero-padded (the padded rows' powers are never read). power_block and
//   split3_tf32 are mxu_falloff.cuh's, unchanged;
// - chunks of 64 pair rows (4 KB) staged by one bulk asynchronous copy
//   (TMA, mbarrier completion) into a double buffer, chunk c + 1 in
//   flight while chunk c is walked; the log-space prefix still restarts
//   only at the plan's 128-row boundaries (every second chunk). A culled
//   pair adds exactly 0 to cum in the reference (alpha_eff 0, log1p(0) =
//   0), so skipping it leaves every sum bit for bit as it was. A pixel's
//   done flag is final where it is set: T_incl only falls along a block
//   (cum only falls), so every later live pair of the block terminates
//   too, which is the reference's chunk-end rule; a warp whose pixels are
//   all done may therefore stop anywhere, and the quarter leaves after
//   any chunk once all its pixels are;
// - n_touched: per surviving pair a ballot + popc, a fixed-order sum over
//   the 8 warps in shared memory, and one float atomicAdd per pair and
//   quarter into the zero-filled output. The addends are whole numbers
//   below 2^24, so their f32 sum is exact in any order: deterministic.
// The shared memory is static (43.6 KB: the rows' double buffer 8 KB,
// the G8 table 2 KB, per warp its A 0.5 KB, P8 1 KB and power block 2 KB),
// below the 48 KB that needs no opt-in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_falloff.cuh"
#include "subtile_cull.cuh"

namespace {

using namespace subtile;
namespace mf = mxu_falloff;

constexpr int kG = mf::kG;          // G8 columns
constexpr int kPowRows = mf::kBlock;  // pairs a power block
constexpr int kPix = mf::kPix;      // a warp's pixels: the block's 32
constexpr int kLogBlock = 128 / kChunk;  // chunks a log-space block

template <bool kNTouch, bool kNtWeight>
__global__ void __launch_bounds__(kThreads, 4)
composite32_fwd_subtile_mxu(const float4* __restrict__ feat,  // (B_al, 4) x float4
                            const int2* __restrict__ ranges,  // (n_tiles,)
                            float* __restrict__ out,          // (5, H, W)
                            float* __restrict__ ntouch,       // (B_al,) zeroed
                            int W, int H, int n_tx) {
  __shared__ __align__(128) float4 s_rows[2][kChunk][4];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ unsigned char s_idx[kChunk];
  __shared__ int s_m;
  __shared__ float4 s_pre[kChunk][2];  // the block test's row terms
  // the chunk's G8 rows; per warp its A operand, P8 and power block
  // (WMMA loads and stores need 32-byte aligned rows)
  __shared__ __align__(32) float s_g8[kChunk][kG];
  __shared__ __align__(32) float s_a[kWarps][kPowRows][kG];
  __shared__ __align__(32) float s_p8[kWarps][kG][kPix];
  __shared__ __align__(32) float s_pow[kWarps][kPowRows][kPix];
  __shared__ unsigned char s_surv[kWarps][kChunk];  // survivors' rows
  __shared__ int s_cnt[kNTouch ? kWarps : 1][kChunk];

  const Geometry g = geometry(n_tx);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool inside = (g.x < W) && (g.y < H);
  const float px = static_cast<float>(g.x);
  const float py = static_cast<float>(g.y);
  const float xb = static_cast<float>(g.xb);
  const float yb = static_cast<float>(g.yb);
  // the 32x32 tile's centre: the basis of the expansion
  const float cx_t = mf::tile_centre(g.tx);
  const float cy_t = mf::tile_centre(g.ty);
  float* const a8 = &s_a[warp][0][0];
  float* const p8 = &s_p8[warp][0][0];
  float* const pw = &s_pow[warp][0][0];
  mf::p8_column(px - cx_t, py - cy_t, p8, lane);

  const int2 rg = ranges[g.tile];
  const int n_chunks = (rg.y - rg.x + kChunk - 1) / kChunk;
  float T = 1.0f;
  float T_blk = 1.0f;  // T at the start of the 128-row block
  float cum = 0.0f;    // the block's running log-space prefix
  bool done = !inside;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  if (tid == 0) {
    bar_init(&s_bar[0]);
    bar_init(&s_bar[1]);
    bar_fence_init();
  }
  // a quarter wholly outside the image has nothing to do; an empty run
  // still writes its pixels (T = 1, zero sums)
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
    compact_rect<true>(rows, n, g.t16x, g.t16y, s_idx, &s_m, s_pre, cx_t,
                       cy_t);
    if (tid >= kChunk && tid < kChunk + n) {  // warps 2 and 3
      const int r = tid - kChunk;
      const float4 f0 = rows[r][0];
      mf::g8_row(f0.x, f0.y, f0.z, f0.w, rows[r][1].x, cx_t, cy_t,
                 s_g8[r]);
    }
    if (kNTouch) {
      for (int r = lane; r < kChunk; r += 32) s_cnt[warp][r] = 0;
    }
    if (c % kLogBlock == 0) {  // a 128-row block of the plan starts
      T_blk = T;
      cum = 0.0f;
    }
    __syncthreads();

    if (__any_sync(kFull, !done)) {
      unsigned keep[kChunk / 32];
      cull(s_pre, s_idx, s_m, xb, yb, keep);
      // this warp's survivors, in pair order
      int m = 0;
#pragma unroll
      for (int h = 0; h < kChunk / 32; ++h) {
        if ((keep[h] >> lane) & 1u) {
          s_surv[warp][m + __popc(keep[h] & ((1u << lane) - 1u))] =
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
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < m) {
          v = reinterpret_cast<const float4*>(s_g8[s_surv[warp][i]])[lane & 1];
        }
        reinterpret_cast<float4*>(a8 + (lane >> 1) * kG)[lane & 1] = v;
        __syncwarp();  // and the previous block's powers are read
        mf::power_block(a8, p8, pw);
        __syncwarp();
        const int i1 = min(i0 + kPowRows, m);
        for (int k = i0; k < i1; ++k) {
          const int r = s_surv[warp][k];
          bool counted = false;
          if (!done) {
            const float power = mf::clamp_power(pw[(k - i0) * kPix + lane]);
            const float4 f1 = rows[r][1];  // cc, opa, r, g
            const float4 f2 = rows[r][2];  // b, depth, rect x0, rect y0
            if (power <= 0.0f) {
              const float a_un = f1.y * expf(power);
              const float alpha = fminf(kAlphaMax, a_un);
              if (alpha >= kAlphaMin) {
                cum += log1pf(-alpha);
                const float T_incl = T_blk * expf(cum);
                const float T_excl = T_incl / (1.0f - alpha);
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
                  T = fminf(T, T_incl);
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
        if (s) atomicAdd(&ntouch[base + tid], static_cast<float>(s));
      }
    }
    if (__syncthreads_count(!done) == 0) break;  // the quarter is done
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

template <bool kNTouch, bool kNtWeight>
int launch_one(const void* feat, const void* ranges, void* out, void* ntouch,
               int n_tiles, int n_tx, int W, int H, void* stream) {
  composite32_fwd_subtile_mxu<kNTouch, kNtWeight>
      <<<4 * n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(feat), static_cast<const int2*>(ranges),
          static_cast<float*>(out), static_cast<float*>(ntouch), W, H, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The check of the tensor-core falloff alone, in the layout it was written
// for: one CTA of 1024 threads over a 32x32 tile, a warp per tile row, a
// chunk of 128 pair rows, its G8 rows and each warp's P8 and power block in
// dynamic shared memory (mxu_falloff::Smem, opted in above the 48 KB
// default).
namespace {
namespace power_tile {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kThreads / 32;    // one warp per pixel row
constexpr int kChunk = 128;              // pair rows of the chunk

using MxuSmem = mxu_falloff::Smem<kChunk, kWarps>;

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

}  // namespace power_tile
}  // namespace

// C entry, loaded with ctypes: composite32_fwd_mxu (B1-mxu with n_touched,
// B1'-mxu without; under mxu the reference's bf16 flag has no effect on
// the forward), the signature of composite32_fwd. feat: (B_al, 16) f32,
// 16-byte aligned; ranges: (n_tiles, 2) int32; out: (5, H, W) f32;
// ntouch: (B_al,) f32, zero-filled by the caller (pairs a tile never
// reaches must read 0). Launch on ``stream`` and return
// cudaGetLastError().
extern "C" int composite32_fwd_mxu(const void* feat, const void* ranges,
                                   void* out, void* ntouch, int n_tiles,
                                   int n_tx, int W, int H, int with_ntouch,
                                   int nt_weight, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!with_ntouch) {
    return launch_one<false, false>(feat, ranges, out, ntouch, n_tiles, n_tx,
                                    W, H, stream);
  }
  if (nt_weight) {
    return launch_one<true, true>(feat, ranges, out, ntouch, n_tiles, n_tx,
                                  W, H, stream);
  }
  return launch_one<true, false>(feat, ranges, out, ntouch, n_tiles, n_tx, W,
                                 H, stream);
}

// The power block of one chunk of n <= 128 pair rows (feat, 16-byte
// aligned) at tile (tx, ty): out (128, 1024) f32, rows >= n zero. Only the
// card checks call it (ops/tile_kernel2.py::mxu_power_tile).
extern "C" int mxu_power_tile(const void* feat, int n, int tx, int ty,
                              void* out, void* stream) {
  namespace pt = power_tile;
  const cudaError_t e = mxu_falloff::opt_in_smem<pt::mxu_power_tile_kernel>(
      pt::MxuSmem::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  pt::mxu_power_tile_kernel<<<1, pt::kThreads, pt::MxuSmem::kBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), n, tx, ty, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
