// What the sub-tile compositing kernels (subtile_fwd.cuh's forward in
// tile32_fwd_subtile.cu and tile16_fwd_subtile.cu, tile32_fwd_subtile_mxu.cu,
// tile32_bwd_subtile.cu, tile16_bwd_subtile.cu) share: the CTA and warp
// layout, the conservative per-warp block test (with its margins for the
// bfloat16 and the tensor-core falloffs), the rect16 compaction of
// a staged chunk, and the asynchronous staging of a chunk of pair rows
// (one bulk copy, completion on an mbarrier).
//
// Layout. A 32x32 tile's four 16x16 quarters are four CTAs of 256
// threads (geometry: blockIdx.x = 4 * tile + quarter, quarter = qy * 2 +
// qx); a 16x16 tile of the 16-px plan is one CTA (geometry16: blockIdx.x
// = tile). Either way the CTA's 16x16 pixels are exactly one 16-px cell
// of the plan's rect16 boxes, so the rect test is uniform over the CTA.
// Warp w owns the 8x4 pixel block at (8 (w & 1), 4 (w >> 1)) of its cell;
// lane l is the pixel (l & 7, l >> 3) of that block.
//
// The block test, block_keep. A (pair, block) is dropped only where, at
// every pixel of the 8x4 block, opa * expf(power) < 1/255 as the kernel's
// f32 arithmetic computes it; such a pair is skipped at each of those
// pixels, and a skipped pair changes neither T nor the done flag, so the
// walk over the kept pairs gives the same images, n_touched and rows.
// With L = log(opa) - log(1/255) the per-pixel test keeps a pixel only if
// q / 2 <= L up to rounding, q = ca dx^2 + 2 cb dx dy + cc dy^2 (power =
// -q / 2). For a positive-definite conic q is convex, so its minimum over
// the block's rectangle of deltas [mx - x1, mx - x0] x [my - y1, my - y0]
// (integer pixel coordinates, no +0.5, as the kernels use) is 0 when the
// mean lies inside, else the least of the four edges' minima, each a 1-D
// quadratic minimised at a clamped stationary point (from the
// reciprocals 1/ca and 1/cc, prepared once per staged row with L). The
// pair is dropped when
//   qmin / 2 > L + kCullRel * Smax + kCullAbs,
//   Smax = 2 (ca max(dx^2) + cc max(dy^2)) over the rectangle's corners.
// The margin's argument: under positive definiteness |cb dx dy| <=
// (ca dx^2 + cc dy^2) / 2, so every term of q, at any pixel of the block
// and at the points this test evaluates, is at most Smax in magnitude.
// The kernel's power rounds each delta (one ulp u = 2^-24 relative), each
// of its products and sums (-fmad=false: one rounding each): at most ~7u
// Smax off the exact power. This test's own f32 evaluation of the
// rectangle, the stationary points and the edge values is at most ~12u
// Smax off, in power units. kCullRel = 2^-18 = 64u covers their sum more
// than three times. expf (2 ulp), the product with opa (one rounding),
// logf here (1 ulp of |L| <= ~90) and the f32 constant 1/255 move the
// log of alpha by less than 1e-5 together: kCullAbs = 2^-16. Rows with a
// non-finite mean, conic or opacity, and conics that are not clearly
// positive definite (ca <= 0, cc <= 0 or det <= 2^-16 ca cc, where the
// bound on |cb| above could fail by rounding), get L = +inf and are never
// dropped; an opacity of 0 gives L = -inf and the pair is dropped, as
// alpha < 1/255 at every pixel (a negative one gives NaN: kept). The plain PyTorch version is
// ops/tile_kernel2.py::block_keep_plain, with the same operations in the
// same order.
//
// The margin under bf16 (block_keep<true>: B1-bf16 / B1'-bf16 of
// tile32_fwd_subtile.cu). There the kernel's alpha comes from
// bf16_falloff.cuh: with bf() a rounding to bfloat16 (8 significant bits,
// unit roundoff u_b = 2^-8) and dx, dy the f32 deltas,
//   power_b = min(0, bf(bf(-0.5) bf(qa + qc) - qb)),
//   qa = bf(bf(bf(ca) bf(dx)) bf(dx)), qc = bf(bf(bf(cc) bf(dy)) bf(dy)),
//   qb = bf(bf(bf(cb) bf(dx)) bf(dy)),
//   a_un = bf(bf(opa) bf(expf(power_b))).
// The error is measured against the exact q at the f32 deltas (they lie
// in the f32 rectangle [xlo, xhi] x [ylo, yhi] this test forms, since
// rounding is monotone), and against the f32 conic, not its bfloat16
// rounding (which can make it indefinite: no harm, the bound below holds
// relative to the f32 terms).
// - Power. qa, qc and qb each carry five roundings relative to their
//   exact terms (the conic entry, two deltas, two products): |qa -
//   ca dx^2| <= ((1 + u_b)^5 - 1) ca dx^2, and so on. bf(-0.5) is exact
//   and the product with it too; the sum and the difference round once
//   each. So |power_b - power| <= ((1 + u_b)^7 - 1) (0.5 (|qa| + |qc|) +
//   |qb|) <= 7.1 u_b (0.5 (ca dx^2 + cc dy^2) + |cb dx dy|). Positive
//   definiteness of the f32 conic, which prepare requires, gives
//   |cb dx dy| <= (ca dx^2 + cc dy^2) / 2, so the error is at most
//   7.1 u_b (ca dx^2 + cc dy^2) <= 3.55 u_b Smax at any pixel of the
//   block. The clamp to <= 0 only moves power_b toward the exact power,
//   which is <= 0. A product that overflows to inf gives a power of -inf
//   or NaN, both skipped, as the exact power is then far below any L;
//   subnormal products are off by less than 2^-133, inside the absolute
//   term.
// - Alpha. a_un carries three bfloat16 roundings (opa, the exp, the
//   product) and expf's 2 f32 ulps: log a_un <= log opa + power_b +
//   3.05 u_b. The widening is exact, and the 0.99 cap does not move the
//   1/255 test.
// So a pixel of the block passes only where qmin / 2 <= L + 3.55 u_b Smax
// + 3.05 u_b up to this test's own rounding (the ~12u Smax and 1e-5 of
// the f32 note, orders below). Under bf16 the pair is dropped only where
//   qmin / 2 > L + kCullBf16Rel * Smax + kCullBf16Abs,
// kCullBf16Rel = 2^-5 = 8 u_b (2.25 times the 3.55 u_b) and kCullBf16Abs
// = 2^-5 (2.6 times the 3.05 u_b), in place of kCullRel and kCullAbs,
// which they exceed by 2^13 and 2^11. The plain PyTorch version is
// block_keep_plain(..., bf16=True), the same operations in the same
// order; tests/test_torch_cull_bf16.py checks the power bound against
// float64 and the test against _falloff(bf16=True).
//
// The margin under mxu (tile32_fwd_subtile_mxu.cu). There the kernel's
// power is not the direct f32 form but G8 . P8 (mxu_falloff.cuh): the
// tile-local expansion about the 32x32 tile's centre (cx, cy), with
// mxl = mx - cx, myl = my - cy and |pxl|, |pyl| <= 15.5 at every pixel of
// the tile, accumulated by the tensor cores; its plain version
// (ops/tile_kernel2.py::_mxu_form) is an f32 torch.matmul of the same G6
// and P6. Both round relative to the expansion's terms, which can exceed
// the block's Smax by orders of magnitude where the mean lies inside the
// tile and far from its centre. Every term, and every intermediate of
// g8_row, is at most
//   Mmag = 240.25 (0.5|ca| + |cb| + 0.5|cc|)
//        + 15.5 (|ca mxl| + |cb myl| + |cb mxl| + |cc myl|)
//        + 0.5 (|ca| mxl^2 + 2 |cb mxl myl| + |cc| myl^2)
// in magnitude (>= M = 240.25 (0.5|ca| + |cb| + 0.5|cc|) + 15.5 (|g3| +
// |g4|) + |g5|: Mmag bounds g3, g4 and g5 by the sums of their products'
// magnitudes, since the rounding of g8_row is relative to those). The
// distance from the exact power -q(mx - x, my - y) / 2:
// - the rounding of mxl and myl (one subtraction each, u relative) moves
//   the expansion's deltas by u |mxl|, u |myl|: at most 2u Mmag;
// - g8_row's products and sums (-fmad=false, one rounding each; the
//   factors -0.5 and 2 are exact): g3 and g4 2u of their products, g5 4u
//   of its three: at most 4u Mmag (P8 is exact);
// - the kernel: split3_tf32 keeps each g exactly and every TF32 product
//   is exact in f32; the tensor core adds them in an order and with a
//   rounding of its own. Modelled as steps that align at most five terms
//   (four products and the running sum) to the largest and truncate,
//   each step is off by at most 12u of the sum of its terms' magnitudes,
//   and a power takes at most six steps (three m16n16k8 products, k = 8
//   in two steps of four): at most 72u Mmag;
// - the plain version: an f32 matmul of depth 6 in any order, with or
//   without fused multiply-adds: at most 6u Mmag.
// So the kernel's power lies within 78u Mmag of the exact power and the
// plain version's within 12u Mmag. Under mxu a row's L carries
// kCullMxu * Mmag more, kCullMxu = 2^-16 = 256u (3.3 times the kernel's
// bound; Mmag's own f32 evaluation is a few u off, which that room
// covers), formed once per staged row (prepare_mxu) beside its G8 row.
// The block test's own rounding stays covered by kCullRel * Smax, expf
// and logf by kCullAbs. A culled pair has alpha < 1/255 at every pixel of
// the block, so its alpha_eff is 0 and log1p(0) = 0: skipping it leaves
// the log-space prefix, T and the done flag bit for bit as they were. The
// plain PyTorch version is block_keep_plain(..., centre=(cx, cy)), the
// same operations in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace subtile {

constexpr int kCell = 16;      // a quarter: one rect16 cell
constexpr int kThreads = kCell * kCell;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockW = 8;     // a warp's pixel block, 8 x 4
constexpr int kBlockH = 4;
constexpr int kChunk = 64;     // pair rows staged per step (4 KB)
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kCullRel = 3.814697265625e-06f;  // 2^-18
constexpr float kCullAbs = 1.52587890625e-05f;   // 2^-16
constexpr float kPdRel = 1.52587890625e-05f;     // 2^-16
constexpr float kCullMxu = 1.52587890625e-05f;   // 2^-16
constexpr float kCullBf16Rel = 0.03125f;         // 2^-5
constexpr float kCullBf16Abs = 0.03125f;         // 2^-5
constexpr float kHalfTile = 15.5f;     // |pxl|, |pyl| in a 32x32 tile
constexpr float kHalfTileSq = 240.25f;
constexpr unsigned kFull = 0xffffffffu;

// The geometry of this CTA and thread.
struct Geometry {
  int tile, tx, ty;  // the tile and its column and row on the plan's grid
  float t16x, t16y;  // the CTA's 16-px cell
  int xb, yb;        // the warp's block origin
  int x, y;          // this thread's pixel
};

// the cell (cx, cy) of 16-px cells, its warp blocks and pixels
__device__ __forceinline__ void place(Geometry* g, int cx, int cy) {
  g->t16x = static_cast<float>(cx);
  g->t16y = static_cast<float>(cy);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  g->xb = cx * kCell + (warp & 1) * kBlockW;
  g->yb = cy * kCell + (warp >> 1) * kBlockH;
  g->x = g->xb + (lane & (kBlockW - 1));
  g->y = g->yb + (lane >> 3);
}

// a quarter of a 32x32 tile (n_tx tiles a row): blockIdx.x = 4 tile + q
__device__ __forceinline__ Geometry geometry(int n_tx) {
  Geometry g;
  g.tile = blockIdx.x >> 2;
  const int quarter = blockIdx.x & 3;
  g.tx = g.tile % n_tx;
  g.ty = g.tile / n_tx;
  place(&g, 2 * g.tx + (quarter & 1), 2 * g.ty + (quarter >> 1));
  return g;
}

// a 16x16 tile of the 16-px plan (n_tx tiles a row): blockIdx.x = tile
__device__ __forceinline__ Geometry geometry16(int n_tx) {
  Geometry g;
  g.tile = blockIdx.x;
  g.tx = g.tile % n_tx;
  g.ty = g.tile / n_tx;
  place(&g, g.tx, g.ty);
  return g;
}

// rect16 covers the CTA's cell (the per-pixel test of the one-thread-per-
// pixel kernels, uniform here)
__device__ __forceinline__ bool rect_ok(const float4 f2, const float4 f3,
                                        float t16x, float t16y) {
  return (t16x >= f2.z) && (t16x < f3.x) && (t16y >= f2.w) &&
         (t16y < f3.y);
}

// A pair row's block-test terms, computed once per staged row: p0 = (mx,
// my, ca, cb), p1 = (cc, 1 / ca, 1 / cc, L) with L = log(opa) -
// log(1/255), or +inf for a row that is never dropped (a non-finite
// mean, conic or opacity, or a conic that is not clearly positive
// definite).
__device__ __forceinline__ void prepare(const float4 f0, const float4 f1,
                                        float4* p0, float4* p1) {
  const float mx = f0.x, my = f0.y, ca = f0.z, cb = f0.w, cc = f1.x;
  const float opa = f1.y;
  const bool finite = isfinite(mx) && isfinite(my) && isfinite(ca) &&
                      isfinite(cb) && isfinite(cc) && isfinite(opa);
  const float det = ca * cc - cb * cb;
  const bool pd = ca > 0.0f && cc > 0.0f && det > kPdRel * (ca * cc);
  const float L = (finite && pd) ? logf(opa) - logf(kAlphaMin) : INFINITY;
  *p0 = f0;
  *p1 = make_float4(cc, 1.0f / ca, 1.0f / cc, L);
}

// prepare under mxu: L also carries kCullMxu * Mmag for the 32x32 tile
// centred at (cx, cy) (see the note above), in this order
__device__ __forceinline__ void prepare_mxu(const float4 f0, const float4 f1,
                                            float cx, float cy, float4* p0,
                                            float4* p1) {
  prepare(f0, f1, p0, p1);
  const float mxl = fabsf(f0.x - cx);
  const float myl = fabsf(f0.y - cy);
  const float ca = fabsf(f0.z), cb = fabsf(f0.w), cc = fabsf(f1.x);
  const float quad = kHalfTileSq * ((0.5f * ca + cb) + 0.5f * cc);
  const float lin =
      kHalfTile * (((ca * mxl + cb * myl) + cb * mxl) + cc * myl);
  const float cst =
      0.5f * ((ca * mxl * mxl + 2.0f * cb * mxl * myl) + cc * myl * myl);
  p1->w = p1->w + kCullMxu * ((quad + lin) + cst);
}

// the minimum of q over the edge dx = a, dy in [lo, hi] (inv_c = 1 / cc)
__device__ __forceinline__ float edge_min(float a, float lo, float hi,
                                          float ca, float cb, float cc,
                                          float inv_c) {
  const float d = fminf(fmaxf(-(cb * a) * inv_c, lo), hi);
  return (ca * a * a + 2.0f * cb * a * d) + cc * d * d;
}

// false only where the pair prepared in (p0, p1) is skipped at every
// pixel of the 8x4 block at (xb, yb) (under kBF16 by the bfloat16
// falloff, with its margin); see the note above
template <bool kBF16 = false>
__device__ __forceinline__ bool block_keep(const float4 p0, const float4 p1,
                                           float xb, float yb) {
  constexpr float rel = kBF16 ? kCullBf16Rel : kCullRel;
  constexpr float abs_ = kBF16 ? kCullBf16Abs : kCullAbs;
  const float mx = p0.x, my = p0.y, ca = p0.z, cb = p0.w, cc = p1.x;
  const float L = p1.w;
  const float xlo = mx - (xb + static_cast<float>(kBlockW - 1));
  const float xhi = mx - xb;
  const float ylo = my - (yb + static_cast<float>(kBlockH - 1));
  const float yhi = my - yb;
  float qmin = 0.0f;
  if (!(xlo <= 0.0f && xhi >= 0.0f && ylo <= 0.0f && yhi >= 0.0f)) {
    qmin = fminf(fminf(edge_min(xlo, ylo, yhi, ca, cb, cc, p1.z),
                       edge_min(xhi, ylo, yhi, ca, cb, cc, p1.z)),
                 fminf(edge_min(ylo, xlo, xhi, cc, cb, ca, p1.y),
                       edge_min(yhi, xlo, xhi, cc, cb, ca, p1.y)));
  }
  const float smax = 2.0f * (ca * fmaxf(xlo * xlo, xhi * xhi) +
                             cc * fmaxf(ylo * ylo, yhi * yhi));
  return !(0.5f * qmin > L + rel * smax + abs_);
}

// Staging: one bulk copy (TMA, cp.async.bulk) of a chunk's contiguous
// 64-byte rows into shared memory, completion on an mbarrier.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: expect ``bytes`` on ``bar`` and start the copy
__device__ __forceinline__ void stage(void* dst, const void* src,
                                      uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait for the completion of ``bar``'s phase ``parity``
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The rows of a staged chunk whose rect16 covers the CTA's cell, in pair
// order: warp 0 writes their indices to idx[0, m) and m to *count, and
// thread r < kChunk (warps 0 and 1) prepares row r's block-test terms in
// pre[r] if it is one of them (under kMxu with the margin of the 32x32
// tile centred at (cx, cy)). The caller synchronises the CTA before
// reading them.
template <bool kMxu = false>
__device__ __forceinline__ void compact_rect(const float4 (*rows)[4], int n,
                                             float t16x, float t16y,
                                             unsigned char* idx, int* count,
                                             float4 (*pre)[2],
                                             float cx = 0.0f,
                                             float cy = 0.0f) {
  const int tid = threadIdx.x;
  if (tid < kChunk && tid < n &&
      rect_ok(rows[tid][2], rows[tid][3], t16x, t16y)) {
    if constexpr (kMxu) {
      prepare_mxu(rows[tid][0], rows[tid][1], cx, cy, &pre[tid][0],
                  &pre[tid][1]);
    } else {
      prepare(rows[tid][0], rows[tid][1], &pre[tid][0], &pre[tid][1]);
    }
  }
  if ((tid >> 5) != 0) return;
  const int lane = tid & 31;
  int off = 0;
#pragma unroll
  for (int h = 0; h < kChunk / 32; ++h) {
    const int r = h * 32 + lane;
    const bool ok = r < n && rect_ok(rows[r][2], rows[r][3], t16x, t16y);
    const unsigned b = __ballot_sync(kFull, ok);
    if (ok) idx[off + __popc(b & ((1u << lane) - 1u))] =
        static_cast<unsigned char>(r);
    off += __popc(b);
  }
  if (lane == 0) *count = off;
}

// The warp's survivors of the block test (under kBF16 with the bfloat16
// margin) among the m compacted rows: bit k of keep[g] is row
// idx[32 g + k].
template <bool kBF16 = false>
__device__ __forceinline__ void cull(const float4 (*pre)[2],
                                     const unsigned char* idx, int m,
                                     float xb, float yb,
                                     unsigned keep[kChunk / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kChunk / 32; ++g) {
    const int j = g * 32 + lane;
    bool k = false;
    if (j < m) {
      const int r = idx[j];
      k = block_keep<kBF16>(pre[r][0], pre[r][1], xb, yb);
    }
    keep[g] = __ballot_sync(kFull, k);
  }
}

}  // namespace subtile
