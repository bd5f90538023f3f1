// The bfloat16 bodies of the 32x32 compositing kernels, shared by the
// forward (tile_kernel2_fwd.cu) and the backward (tile_kernel2_bwd.cu).
//
// They replace the bf16 branches of the Pallas TPU kernels in
//   gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py
//   ::_chunk_terms (bf16=True, :160-175) and make_backward_kernel (:488-508)
// and round exactly where the port's plain PyTorch versions round
// (ops/tile_kernel2.py::_falloff and plain_bwd_walk): every bfloat16
// product, sum and difference is rounded to nearest even once, in the
// expression's order. __hmul_rn, __hadd_rn and __hsub_rn are used because
// neither -fmad=false nor anything else stops the compiler from
// contracting plain bfloat16 arithmetic into fused multiply-adds. exp is
// taken in f32 on the widened value and rounded once, as torch's bfloat16
// exp does (f32 op math, one rounding); hexp would round differently.
// Widening a bfloat16 to f32 is exact.

#pragma once

#include <cuda_bf16.h>

namespace bf16_falloff {

__device__ __forceinline__ __nv_bfloat16 bf(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// power = -0.5 (ca dx dx + cc dy dy) - cb dx dy in bfloat16 from the f32
// pixel deltas (mean2d coordinates up to ~1200 would lose whole pixels in
// bfloat16, so the deltas are formed in f32 first), clamped to <= 0: the
// quadratic form is positive semi-definite, but bfloat16 cancellation can
// round a tiny negative power positive. A NaN stays NaN (and then fails
// the caller's power <= 0 test), as under torch.clamp.
__device__ __forceinline__ float power(float dx, float dy, float ca,
                                       float cb, float cc) {
  const __nv_bfloat16 dxb = bf(dx);
  const __nv_bfloat16 dyb = bf(dy);
  const __nv_bfloat16 qa = __hmul_rn(__hmul_rn(bf(ca), dxb), dxb);
  const __nv_bfloat16 qc = __hmul_rn(__hmul_rn(bf(cc), dyb), dyb);
  const __nv_bfloat16 qb = __hmul_rn(__hmul_rn(bf(cb), dxb), dyb);
  const float p =
      f32(__hsub_rn(__hmul_rn(bf(-0.5f), __hadd_rn(qa, qc)), qb));
  return p > 0.0f ? 0.0f : p;
}

// a_un = opa exp(power) in bfloat16, widened; ``power`` is power()'s
// (bfloat16-exact) result.
__device__ __forceinline__ float a_un(float opa, float power) {
  return f32(__hmul_rn(bf(opa), bf(expf(power))));
}

// The five quadratic-form gradient products of one included cell,
// widened: [dL/dG dG/ddx, dL/dG dG/ddy, dL/dG (-0.5 G dx dx),
// dL/dG (-G dx dy), dL/dG (-0.5 G dy dy)] with G, dx, dy, dL/dG and the
// conic rounded to bfloat16 and every product formed in bfloat16.
__device__ __forceinline__ void quad_grads(float G, float dx, float dy,
                                           float dLdG, float ca, float cb,
                                           float cc, float* v) {
  const __nv_bfloat16 Gb = bf(G);
  const __nv_bfloat16 dxb = bf(dx);
  const __nv_bfloat16 dyb = bf(dy);
  const __nv_bfloat16 gb = bf(dLdG);
  const __nv_bfloat16 cab = bf(ca);
  const __nv_bfloat16 cbb = bf(cb);
  const __nv_bfloat16 ccb = bf(cc);
  const __nv_bfloat16 neg_half = bf(-0.5f);
  const __nv_bfloat16 gdx = __hmul_rn(Gb, dxb);
  const __nv_bfloat16 gdy = __hmul_rn(Gb, dyb);
  const __nv_bfloat16 ngdx = __hneg(gdx);
  const __nv_bfloat16 ngdy = __hneg(gdy);
  const __nv_bfloat16 dG_ddx =
      __hsub_rn(__hmul_rn(ngdx, cab), __hmul_rn(gdy, cbb));
  const __nv_bfloat16 dG_ddy =
      __hsub_rn(__hmul_rn(ngdy, ccb), __hmul_rn(gdx, cbb));
  v[0] = f32(__hmul_rn(gb, dG_ddx));
  v[1] = f32(__hmul_rn(gb, dG_ddy));
  v[2] = f32(__hmul_rn(gb, __hmul_rn(__hmul_rn(neg_half, gdx), dxb)));
  v[3] = f32(__hmul_rn(gb, __hmul_rn(ngdx, dyb)));
  v[4] = f32(__hmul_rn(gb, __hmul_rn(__hmul_rn(neg_half, gdy), dyb)));
}

}  // namespace bf16_falloff
