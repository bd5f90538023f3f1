// 32x32 forward alpha compositing for Hopper (sm_90a), on 16x16 sub-tile
// CTAs with per-warp conservative culling and asynchronous staging: the
// 32-px instantiations of subtile_fwd.cuh's body.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::make_forward_kernel (pallas_call at :642 with n_touched, :662 without)
// in two of its bodies:
// - composite32_fwd (B1 / B1'), the f32 body;
// - composite32_fwd_bf16 (B1-bf16 / B1'-bf16), bf16=True: the falloff of
//   _chunk_terms' bf16 branch (tile_kernel2.py:160-175), power and
//   opa exp(power) in bfloat16 from f32 deltas (bf16_falloff.cuh),
//   widened before the 0.99 cap and the skip tests; the block test with
//   the bfloat16 margin (subtile_cull.cuh, kCullBf16Rel / kCullBf16Abs).
// The per-cell arithmetic and its order are the plain version's, built
// with -fmad=false, so the images are bit for bit the plain version's
// (ops/tile_kernel2.py::plain_walk, with or without bf16).
//
// What bounds it on the H100: the FP32 operations of the cells a pixel
// evaluates (under bf16 the scalar bfloat16 operations and conversions
// run on the same CUDA-core pipes, no faster). At the room's plans 3-8%
// of the (pair, pixel) cells of a 32x32 tile-walk pass the skip tests;
// the rest cost the falloff and the tests for nothing, and one CTA of
// 1024 threads per tile left the card part empty at s=4 and s=2 (60 and
// 209 tiles on 132 SMs).
// What the design does about it (subtile_fwd.cuh, subtile_cull.cuh): one
// CTA of 256 threads per 16x16 quarter of a tile (4 x n_tiles CTAs,
// several resident on an SM), all reading their tile's range; the rect16
// compaction once per staged pair; an 8x4 pixel block per warp, tested
// against the compacted pairs before the walk; chunks of 64 rows staged
// by TMA bulk copies into a double buffer; n_touched summed over the 8
// warps in a fixed order, then one float atomicAdd per pair and quarter
// (whole numbers: exact, deterministic).
//
// Resources (-Xptxas -v, sm_90a, chip_smoke.py's build lines): with
// n_touched (either rule) 48 registers and 12384 bytes of static shared
// memory, without it 47 and 10336, no spills, in f32 and in bf16 alike.
// The f32 instantiations keep the registers, the shared memory and the
// images (bit for bit) of this file's body before it moved to
// subtile_fwd.cuh: only the template axes are new.

#include "subtile_fwd.cuh"

// C entries, loaded with ctypes: composite32_fwd (f32) and
// composite32_fwd_bf16 (the bfloat16 falloff), both 32x32 tiles of
// subtile_fwd.cuh's body. feat: (B_al, 16) f32, 16-byte aligned; ranges:
// (n_tiles, 2) int32; out: (5, H, W) f32; ntouch: (B_al,) f32,
// zero-filled by the caller (pairs a tile never reaches must read 0).
// Launch on ``stream`` and return cudaGetLastError().
extern "C" int composite32_fwd(const void* feat, const void* ranges,
                               void* out, void* ntouch, int n_tiles,
                               int n_tx, int W, int H, int with_ntouch,
                               int nt_weight, void* stream) {
  return subtile::launch_fwd<false, false>(feat, ranges, out, ntouch,
                                           n_tiles, n_tx, W, H, with_ntouch,
                                           nt_weight, stream);
}

extern "C" int composite32_fwd_bf16(const void* feat, const void* ranges,
                                    void* out, void* ntouch, int n_tiles,
                                    int n_tx, int W, int H, int with_ntouch,
                                    int nt_weight, void* stream) {
  return subtile::launch_fwd<true, false>(feat, ranges, out, ntouch,
                                          n_tiles, n_tx, W, H, with_ntouch,
                                          nt_weight, stream);
}
