// 16x16 forward alpha compositing for Hopper (sm_90a), with per-warp
// conservative culling and asynchronous staging: the 16-px instantiation
// of subtile_fwd.cuh's body.
//
// Replaces the Pallas TPU kernel
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py
//   ::make_forward_kernel16 (pallas_call at :562 with n_touched, B3; :582
//   without, B3')
// with the per-pixel semantics of the 32x32 forward on the 16-px pair
// plan: tile t = ty * n_tx + tx of the (2 ceil(W/32)) x (2 ceil(H/32))
// grid walks the pairs [ranges[t,0], ranges[t,1]) of feat (B_al x 16 f32
// rows [mean2d, conic, opa, rgb, depth, rect16, pad]) front to back for
// every pixel, in f32 (tile16 with bf16 or mxu raises in the port, as
// ROADMAP notes, so only the f32 body is instantiated). Built with
// -fmad=false, so the images are bit for bit the plain version's
// (ops/tile_kernel2.py::plain_walk(tile=16)).
//
// What bounds it on the H100: the FP32 operations of the cells a pixel
// evaluates. The design it replaced (one thread per pixel, a warp two
// pixel rows) evaluated the falloff at every cell of the
// tile-walk before the rect test, staged 128 rows at a time with plain
// loads and met two or three CTA barriers a chunk.
// What the design does about it (subtile_fwd.cuh, subtile_cull.cuh):
// - one CTA of 256 threads per 16x16 tile (geometry16); the tile is
//   exactly one rect16 cell, so the rect test runs once per staged pair
//   (warp 0, ballot + prefix compaction). The compaction matters here:
//   the plan bins a Gaussian by its radius scaled and padded (mapping:
//   x 1.1 + 6 px), the row's rect16 by its own radius, so a run holds
//   rows that fail its tile's rect test (on the room map the test keeps
//   55% of the mapping plan's tile-walk cells: chip_smoke.py's rect_cells);
// - an 8x4 pixel block per warp, tested against the compacted pairs with
//   the f32 margin (the power is the direct f32 form, so the derivation
//   in subtile_cull.cuh holds as it stands);
// - chunks of 64 rows staged by TMA bulk copies into a double buffer,
//   inside [ranges[t,0], ranges[t,1]): the plan's dead pad slots (each
//   run starts at a multiple of K16 = 128; pair_gather zeroes the slots
//   between runs) are never staged or walked;
// - n_touched: a pair of the 16-px plan belongs to one tile, so the
//   fixed-order sum over the 8 warps is stored once, without atomics;
// - the early exit is per CTA (__syncthreads_count); a tile wholly
//   outside the image (the grid's spare column or row) returns at once.
//
// Resources (-Xptxas -v, sm_90a, chip_smoke.py's build lines): those of
// the 32-px instantiations, 48 registers and 12384 bytes of static shared
// memory with n_touched, 47 and 10336 without, no spills (the design it
// replaced: 40 registers, 12288 / 8192 bytes).

#include "subtile_fwd.cuh"

// C entry, loaded with ctypes: composite16_fwd (B3 / B3'), the signature
// of composite32_fwd. feat: (B_al, 16) f32, 16-byte aligned; ranges:
// (n_tiles, 2) int32 over the n_tx-wide 16-px grid; out: (5, H, W) f32;
// ntouch: (B_al,) f32, zero-filled by the caller (rows a tile drops or
// never reaches must read 0). Launch on ``stream`` and return
// cudaGetLastError().
extern "C" int composite16_fwd(const void* feat, const void* ranges,
                               void* out, void* ntouch, int n_tiles,
                               int n_tx, int W, int H, int with_ntouch,
                               int nt_weight, void* stream) {
  return subtile::launch_fwd<false, true>(feat, ranges, out, ntouch, n_tiles,
                                          n_tx, W, H, with_ntouch, nt_weight,
                                          stream);
}
