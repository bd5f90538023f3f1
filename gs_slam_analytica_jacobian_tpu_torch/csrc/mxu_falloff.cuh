// The Gaussian falloff on the tensor cores, shared by the forward
// (tile32_fwd_subtile_mxu.cu, with its check mxu_power_tile) and the
// backward (tile32_bwd_subtile.cu) under mxu.
//
// Replaces the MXU bodies of the Pallas TPU kernels in
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::_mxu_power (:96-128), reached from make_forward_kernel (:225-234)
//   and make_backward_kernel (:387-398) under mxu=True.
// The quadratic form expands in the tile-local pixel basis
//   P8 = [pxl^2, pxl pyl, pyl^2, pxl, pyl, 1, 0, 0],
//   pxl = x - (tx*32 + 15.5), pyl = y - (ty*32 + 15.5),
// with per-pair coefficients from the tile-local mean mxl = mx - cx_t,
// myl = my - cy_t:
//   G8 = [-0.5 ca, -cb, -0.5 cc, ca mxl + cb myl, cb mxl + cc myl,
//         -0.5 (ca mxl^2 + 2 cb mxl myl + cc myl^2), 0, 0],
// so power = G8 . P8, a (pairs x 8) @ (8 x pixels) product per chunk.
// Tile-local coordinates keep the terms at ~1e2-1e3 against a power of
// O(10) (the global pixel basis would lose ~7 digits to cancellation).
//
// The product runs on nvcuda::wmma m16n16k8 fragments in TF32. One TF32
// pass keeps 11 significant bits, ~0.1-0.5 absolute error in the power at
// those magnitudes, so the product takes three TF32 passes (3xTF32). P8
// is exact in TF32: its entries are half-integers |pxl|, |pyl| <= 15.5
// and their products, at most 10 significant bits. So the three passes go
// to the G8 operand, split into hi = tf32(x), mid = tf32(x - hi) and
// lo = tf32(x - hi - mid), 33 bits that hold the f32 value exactly, and
// the block accumulates lo.P8 + mid.P8 + hi.P8 in f32: every product is
// exact and only the f32 accumulation rounds, as in an f32 matmul. (The
// usual 3xTF32, hi.hi + hi.lo + lo.hi, would spend its hi.lo pass on P8's
// zero remainder and leave G8's at 2^-22 of each term: on the H100 that
// put the images' 99.9th percentile 2e-4 off the f32 plain version.) The
// reference documents ~1e-4 for its bf16x3 MXU pass (:105-108,
// :121-122). The power is clamped to <= 0 (:128): the form is positive
// semi-definite, but rounding can leave a tiny positive value. A NaN
// stays NaN, as under jnp.minimum.

#pragma once

#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>

namespace mxu_falloff {

using namespace nvcuda;

constexpr int kG = 8;       // basis columns (6 used, 2 zero)
constexpr int kBlock = 16;  // pairs per power block (the fragments' M)
constexpr int kPix = 32;    // pixels per warp (two N = 16): a tile row,
                            // or the sub-tile kernel's 8x4 block
constexpr float kHalfTile = 15.5f;  // (32 - 1) / 2

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

// One pair's G8 row from (mx, my, ca, cb, cc) and the tile centre
// (cx, cy), in the reference's operation order.
__device__ __forceinline__ void g8_row(float mx, float my, float ca,
                                       float cb, float cc, float cx,
                                       float cy, float* g) {
  const float mxl = mx - cx;
  const float myl = my - cy;
  g[0] = -0.5f * ca;
  g[1] = -cb;
  g[2] = -0.5f * cc;
  g[3] = ca * mxl + cb * myl;
  g[4] = cb * mxl + cc * myl;
  g[5] = -0.5f * (ca * mxl * mxl + 2.0f * cb * mxl * myl + cc * myl * myl);
  g[6] = 0.0f;
  g[7] = 0.0f;
}

// Lane ``lane`` writes its pixel's P8 column into ``p8`` (8 x 32,
// row-major): the warp's 32 pixels in lane order, tile-local (pxl, pyl).
__device__ __forceinline__ void p8_column(float pxl, float pyl, float* p8,
                                          int lane) {
  p8[0 * kPix + lane] = pxl * pxl;
  p8[1 * kPix + lane] = pxl * pyl;
  p8[2 * kPix + lane] = pyl * pyl;
  p8[3 * kPix + lane] = pxl;
  p8[4 * kPix + lane] = pyl;
  p8[5 * kPix + lane] = 1.0f;
  p8[6 * kPix + lane] = 0.0f;
  p8[7 * kPix + lane] = 0.0f;
}

// x = hi + mid + lo, each rounded to TF32: hi.x[i] on entry holds x.
template <class Frag>
__device__ __forceinline__ void split3_tf32(Frag& hi, Frag& mid, Frag& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float x = hi.x[i];
    const float h = wmma::__float_to_tf32(x);
    const float r = x - h;
    const float m = wmma::__float_to_tf32(r);
    hi.x[i] = h;
    mid.x[i] = m;
    lo.x[i] = wmma::__float_to_tf32(r - m);
  }
}

// Warp-collective: the unclamped power of 16 pairs (``g8``: 16 rows of
// G8, row-major, 32-byte aligned) at the warp's 32 pixels (``p8``: its
// P8, 8 x 32 row-major) into ``out`` (16 x 32 row-major: pair i, pixel
// lane at out[i * 32 + lane]). Every lane of the warp must call it.
__device__ __forceinline__ void power_block(const float* g8, const float* p8,
                                            float* out) {
  FragA a_hi, a_mid, a_lo;
  wmma::load_matrix_sync(a_hi, g8, kG);
  split3_tf32(a_hi, a_mid, a_lo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    FragB b;  // exact in TF32: no rounding to undo
    wmma::load_matrix_sync(b, p8 + 16 * h, kPix);
    FragC c;
    wmma::fill_fragment(c, 0.0f);
    wmma::mma_sync(c, a_lo, b, c);
    wmma::mma_sync(c, a_mid, b, c);
    wmma::mma_sync(c, a_hi, b, c);
    wmma::store_matrix_sync(out + 16 * h, c, kPix, wmma::mem_row_major);
  }
}

__device__ __forceinline__ float clamp_power(float p) {
  return p > 0.0f ? 0.0f : p;
}

// The tile-local origin (cx or cy) of 32-px tile column or row ``t``
// (a tile's edge is kPix pixels).
__device__ __forceinline__ float tile_centre(int t) {
  return static_cast<float>(t * kPix) + kHalfTile;
}

// The dynamic shared memory of a kernel that stages kChunk pair rows at a
// time with kWarps warps of one tile row each (floats): the chunk's G8
// rows, then per warp its P8 (8 x 32) and its power block (16 x 32).
// Every part starts 32-byte aligned, as the WMMA loads and stores need,
// if ``base`` is.
template <int kChunk, int kWarps>
struct Smem {
  static constexpr int kG8Floats = kChunk * kG;
  static constexpr int kWarpFloats = kG * kPix + kBlock * kPix;
  static constexpr size_t kBytes =
      sizeof(float) * (kG8Floats + kWarps * kWarpFloats);
  float* g8;   // (kChunk, 8)
  float* p8;   // this warp's (8, 32)
  float* pow;  // this warp's (16, 32)
  __device__ __forceinline__ Smem(float* base, int warp)
      : g8(base),
        p8(base + kG8Floats + warp * kWarpFloats),
        pow(base + kG8Floats + warp * kWarpFloats + kG * kPix) {}
};

// Threads tid < kChunk write G8 row tid of the chunk at the tile centred at
// (cx, cy): from pair row tid of ``rows`` (four float4 a pair: mx, my, ca,
// cb | cc, ...) where tid < n, zero past the chunk's n rows (their powers
// are then 0 and never read). The block synchronizes before the rows are
// read.
template <int kChunk>
__device__ __forceinline__ void fill_g8(float* g8, const float4* rows, int n,
                                        int tid, float cx, float cy) {
  if (tid >= kChunk) return;
  float* g = g8 + tid * kG;
  if (tid < n) {
    const float4 f0 = rows[tid * 4];
    g8_row(f0.x, f0.y, f0.z, f0.w, rows[tid * 4 + 1].x, cx, cy, g);
  } else {
#pragma unroll
    for (int j = 0; j < kG; ++j) g[j] = 0.0f;
  }
}

// Warp-collective, at pair k of a chunk: every kBlock pairs the next
// block of powers into ``pow``, unless no lane of the warp is ``live``
// (k is the same on every lane, so the whole warp takes the branch).
__device__ __forceinline__ void block_step(int k, bool live, const float* g8,
                                           const float* p8, float* pow) {
  if (k % kBlock == 0 && __any_sync(0xffffffffu, live)) {
    __syncwarp();  // the previous block is read
    power_block(g8 + k * kG, p8, pow);
    __syncwarp();
  }
}

// Opt ``Kernel`` into ``bytes`` of dynamic shared memory (above the 48 KB
// default), once per device: later launches skip the driver call.
template <auto Kernel>
inline cudaError_t opt_in_smem(size_t bytes) {
  static std::atomic<unsigned long long> set_on{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (set_on.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace mxu_falloff
