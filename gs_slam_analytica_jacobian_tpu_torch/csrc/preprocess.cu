// The tiled renderer's per-Gaussian preprocess for Hopper (sm_90a): one
// forward kernel from the map's raw parameters to the packed pair-gather
// table, and its analytic backward, with the pose twist's gradient.
//
// Replaces no Pallas TPU kernel. The JAX package writes this stage in
// plain jnp (gs_slam_analytica_jacobian_tpu/ops/gaussian_math.py
// ::preprocess, the activations of models/gaussian_map.py and
// ops/renderer_tiled.py::pack_table), which XLA fuses into a few fusions
// on the TPU. Run eagerly, op by op, the same work is some 440 PyTorch
// operations forward and 600 through autograd per rendered view, most of
// them a launch each, and the host issuing them set the pace of the
// mapping iteration. Here: one launch forward; two backward (the
// per-Gaussian chain with per-block partial sums of the pose gradient,
// then one block that sums the partials in a fixed order and applies the
// Jacobian of se3_exp: no float atomics, so the pose gradient is the same
// from run to run).
//
// The arithmetic is the plain version's (ops/gaussian_math.py preprocess,
// ops/sh.py, ops/lie.py; the backward ops/preprocess_fused.py
// ::preprocess_bwd_plain, term by term), in its order where one is
// written and, for the small products and sums that torch leaves to
// cuBLAS and its reductions, in the order and with the fused
// multiply-adds those take on the card (mm3, mv3, sum3 below): the
// forward's values are the plain version's bit for bit there, so that a
// thin splat's conic (whose determinant cancels) is the same too. Built
// with -fmad=false, in float32 throughout: IEEE division and square root,
// the accurate expf, logf, sinf and cosf, no fast-math.
// The plain version's stop-gradients are kept: the frustum clamp's
// clamped branch, |tz| < 1e-8, campos (tau[:3] still reaches the view
// direction through campos_eff), the radius, the rect and the cull
// extents' q, a and c, det == 0's safe branch, the colour's clamp at 0.
//
// What bounds it on the H100: device memory, lightly. One thread per
// capacity slot; the forward reads 56 bytes of parameters (SH degree 0;
// 8 more with a screen-space offset, 1 with the active mask) and writes
// the (N, 16) table (64), the (N, 8) aux floats (32), the (N, 4) rect
// (16), tiles_touched (4) and valid (1); the backward reads the same
// parameters and 10 of the table gradient's 16 columns (40) and writes the
// parameter gradients (56) and the offset's (8): 182 and 160 bytes a slot.
// On the H100: 8.7 us forward and 16.5 us backward with its pose pass at
// 2^16 slots, 29 and 39 us at 2^18, 19% to 50% of that bound
// (chip_smoke.py's kernels line, PERF.md); the ~770 launches a
// rendered view they replace cost the host ~19 us each. Nothing is
// staged: each thread reads and writes its own rows, neighbouring threads
// neighbouring rows.
//
// Resources (-Xptxas -v, sm_90a, CUDA 12.8): the forward 40 / 45 / 48 /
// 48 registers at SH degree 0 / 1 / 2 / 3, the backward 99 / 110 / 128 /
// 128 (at degrees 2 and 3 with a 520- and a 632-byte stack frame for the
// SH arrays), the pose pass 64 and 16 KB of shared memory; no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace prep {

constexpr int kThreads = 256;
constexpr int kPart = 16;  // floats of a block's pose-gradient partials

// The scalars of one call; ops/preprocess_fused.py PrepParams mirrors
// the layout.
struct Params {
  float proj[16];        // row-major P: p_clip = P [p_view, 1]
  float fx, fy;
  float limx, limy;      // 1.3 tan(fov / 2): the EWA frustum clamp
  float low_pass;        // screen-space dilation (px^2)
  float scale_mod;
  int width, height;
  int n;                 // capacity slots
  int k_rest;            // features_rest rows a slot holds
  int iso;               // scaling has one column (an isotropic map)
  int sh_degree;
  int g_s0, g_s1;        // element strides of the table gradient
};

// ---------------------------------------------------------------------------
// se3_exp(tau) @ [R | t] (ops/lie.py), on float or on a dual number that
// carries the derivative in one component of tau (the backward's pose
// chain, forward mode: the derivative of the same operations).

struct Dual {
  float v, d;
  __device__ Dual(float v_ = 0.f, float d_ = 0.f) : v(v_), d(d_) {}
};
__device__ inline Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ inline Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ inline Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ inline Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ inline Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}
__device__ inline float val(float a) { return a; }
__device__ inline float val(Dual a) { return a.v; }
__device__ inline float sqrt_(float a) { return sqrtf(a); }
__device__ inline Dual sqrt_(Dual a) {
  float s = sqrtf(a.v);
  return {s, a.d / (2.f * s)};
}
__device__ inline float sin_(float a) { return sinf(a); }
__device__ inline Dual sin_(Dual a) { return {sinf(a.v), cosf(a.v) * a.d}; }
__device__ inline float cos_(float a) { return cosf(a); }
__device__ inline Dual cos_(Dual a) { return {cosf(a.v), -sinf(a.v) * a.d}; }
// torch.clamp(x, min=lo): the gradient passes where x >= lo
__device__ inline float clamp_min_(float a, float lo) { return a < lo ? lo : a; }
__device__ inline Dual clamp_min_(Dual a, float lo) {
  return a.v < lo ? Dual(lo, 0.f) : a;
}

// The rounding of the plain version's small products and sums as torch
// computes them on the card, so that the forward's values are the plain
// version's bit for bit there (found on the H100 with torch 2.11 and
// CUDA 12.8; -fmad=false keeps every other operation a rounding of its
// own). cuBLAS's (N, 3) x (3, 3) and batched 3 x 3 products accumulate in
// order with fused multiply-adds (mm3); its length-3 matrix-vector
// products and einsum contractions fuse the first two terms only (mv3),
// as do its 4 x 4 products pairwise; torch.sum over a last axis of 3 adds
// (x0 + x2) + x1 (sum3), of 4 (x0 + x2) + (x1 + x3).
__device__ inline float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ inline Dual fma_(Dual a, Dual b, Dual c) {
  return {__fmaf_rn(a.v, b.v, c.v), (a.d * b.v + a.v * b.d) + c.d};
}
template <typename S>
__device__ inline S mm3(S a0, S b0, S a1, S b1, S a2, S b2) {
  return fma_(a2, b2, fma_(a1, b1, a0 * b0));
}
template <typename S>
__device__ inline S mv3(S a0, S b0, S a1, S b1, S a2, S b2) {
  return fma_(a1, b1, a0 * b0) + a2 * b2;
}
template <typename S>
__device__ inline S sum3(S x0, S x1, S x2) { return (x0 + x2) + x1; }

// sin(x)/x, (1-cos(x))/x^2 and (x-sin(x))/x^3 of x^2 = angle2, with the
// Taylor branches below 1e-5 (ops/lie.py _taylor_switch)
template <typename S>
__device__ void so3_coeffs(S angle2, S& sx, S& omc, S& xms) {
  S angle = sqrt_(clamp_min_(angle2, 1e-24f));
  if (val(angle) < 1e-5f) {
    sx = S(1.f) - angle2 / S(6.f);
    omc = S(0.5f) - angle2 / S(24.f);
    xms = S(1.f / 6.f) - angle2 / S(120.f);
  } else {
    S s = sin_(angle), c = cos_(angle);
    sx = s / angle;
    omc = (S(1.f) - c) / (angle * angle);
    xms = (angle - s) / ((angle * angle) * angle);
  }
}

// W (3x3, row-major) and tv (3): the rotation and translation of
// w2c_eff = se3_exp(tau) @ w2c, w2c = [[Rc, tc], [0, 1]]
template <typename S>
__device__ void pose_eff(const S tau[6], const float* Rc, const float* tc,
                         S W[9], S tv[3]) {
  const S x = tau[3], y = tau[4], z = tau[5];
  const S zero(0.f);
  const S K[9] = {zero, -z, y, z, zero, -x, -y, x, zero};
  S K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = mv3(K[3 * i], K[j], K[3 * i + 1], K[3 + j],
                          K[3 * i + 2], K[6 + j]);
  S angle2 = sum3(x * x, y * y, z * z);
  S sx, omc, xms;
  so3_coeffs(angle2, sx, omc, xms);
  S E[9], V[9];
  for (int k = 0; k < 9; ++k) {
    S eye((k % 4 == 0) ? 1.f : 0.f);
    E[k] = (eye + sx * K[k]) + omc * K2[k];
    V[k] = (eye + omc * K[k]) + xms * K2[k];
  }
  // [E, V rho; 0, 1] @ [Rc, tc; 0, 1], pairwise over the four terms
  for (int i = 0; i < 3; ++i) {
    S vrho = mv3(V[3 * i], tau[0], V[3 * i + 1], tau[1], V[3 * i + 2],
                 tau[2]);
    for (int j = 0; j < 3; ++j)
      W[3 * i + j] = mv3(E[3 * i], S(Rc[j]), E[3 * i + 1], S(Rc[3 + j]),
                         E[3 * i + 2], S(Rc[6 + j]));
    tv[i] = fma_(E[3 * i + 1], S(tc[1]), E[3 * i] * S(tc[0]))
            + fma_(vrho, S(1.f), E[3 * i + 2] * S(tc[2]));
  }
}

// The block's camera: W[9], tv[3] and campos_eff[3] = -(W^T tv) + tau[:3]
// (campos itself a stop-gradient). tau == nullptr reads as zero.
__device__ void block_pose(const float* tau, const float* Rc,
                           const float* tc, float* cam) {
  float t6[6];
  for (int k = 0; k < 6; ++k) t6[k] = tau ? tau[k] : 0.f;
  pose_eff<float>(t6, Rc, tc, cam, cam + 9);
  for (int j = 0; j < 3; ++j)
    cam[12 + j] = -mv3(cam[j], cam[9], cam[3 + j], cam[10], cam[6 + j],
                       cam[11]) + t6[j];
}

// ---------------------------------------------------------------------------
// One Gaussian's forward, every intermediate the backward reads.

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f, kC2_1 = -1.0925484305920792f,
                kC2_2 = 0.31539156525252005f, kC2_3 = -1.0925484305920792f,
                kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f, kC3_1 = 2.890611442640554f,
                kC3_2 = -0.4570457994644658f, kC3_3 = 0.3731763325901154f,
                kC3_4 = -0.4570457994644658f, kC3_5 = 1.445305721320277f,
                kC3_6 = -0.5900435899266435f;

template <int DEG>
struct Geo {
  static constexpr int NB = (DEG + 1) * (DEG + 1);
  float x[3];
  float s[3], sp[3];        // exp(scaling), scale_mod * exp(scaling)
  float qn[4], qnorm;       // normalised quaternion (w, x, y, z), its norm
  float R[9], M[9];         // rotation; M = R diag(sp)
  float V[9];               // Sigma = M M^T (full, symmetric)
  float opa;
  float pv[3];              // view-space point
  float ph0, ph1, p_w;      // clip x, y and 1 / (w + 1e-7)
  float m0, m1;             // mean2d
  bool clx, cly, tiny;      // frustum-clamped x, y; |tz| < 1e-8
  float txo, tyo, inv_z, inv_z2;
  float J00, J02, J11, J12;
  float T0[3], T1[3], VT0[3], VT1[3];
  float a, b, c, det, di;   // cov2d (low-pass in), det, 1 / det_safe
  bool dv;                  // det != 0
  float d[3], nrm, u[3];    // x - campos_eff, its norm, the unit direction
  float bas[NB];            // SH basis at u (sign included)
  float sh[NB][3];
  float v[3];               // eval_sh + 0.5 (before the clamp at 0)
};

template <int DEG>
__device__ __forceinline__ void geo(
    const Params& p, const float* cam, int i, const float* xyz,
    const float* scaling, const float* rot, const float* opa_raw,
    const float* fdc, const float* frest, const float* m2o, Geo<DEG>& g) {
  for (int k = 0; k < 3; ++k) g.x[k] = xyz[3 * i + k];
  for (int k = 0; k < 3; ++k) {
    g.s[k] = expf(p.iso ? scaling[i] : scaling[3 * i + k]);
    g.sp[k] = p.scale_mod * g.s[k];
  }
  // quat_to_rotmat (ops/lie.py)
  float q[4];
  for (int k = 0; k < 4; ++k) q[k] = rot[4 * i + k];
  g.qnorm = sqrtf(((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]))
                  + 1e-24f);
  for (int k = 0; k < 4; ++k) g.qn[k] = q[k] / g.qnorm;
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  g.R[0] = 1.f - 2.f * (y * y + z * z);
  g.R[1] = 2.f * (x * y - r * z);
  g.R[2] = 2.f * (x * z + r * y);
  g.R[3] = 2.f * (x * y + r * z);
  g.R[4] = 1.f - 2.f * (x * x + z * z);
  g.R[5] = 2.f * (y * z - r * x);
  g.R[6] = 2.f * (x * z - r * y);
  g.R[7] = 2.f * (y * z + r * x);
  g.R[8] = 1.f - 2.f * (x * x + y * y);
  // build_cov3d (ops/gaussian_math.py)
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) g.M[3 * a + k] = g.R[3 * a + k] * g.sp[k];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k)
      g.V[3 * a + k] = mm3(g.M[3 * a], g.M[3 * k], g.M[3 * a + 1],
                           g.M[3 * k + 1], g.M[3 * a + 2], g.M[3 * k + 2]);
  g.opa = 1.f / (1.f + expf(-opa_raw[i]));

  // projection
  const float* W = cam;
  const float* tv = cam + 9;
  for (int a = 0; a < 3; ++a)
    g.pv[a] = mm3(g.x[0], W[3 * a], g.x[1], W[3 * a + 1], g.x[2],
                  W[3 * a + 2]) + tv[a];
  const float* P = p.proj;
  g.ph0 = mm3(g.pv[0], P[0], g.pv[1], P[1], g.pv[2], P[2]) + P[3];
  g.ph1 = mm3(g.pv[0], P[4], g.pv[1], P[5], g.pv[2], P[6]) + P[7];
  const float pw = mv3(g.pv[0], P[12], g.pv[1], P[13], g.pv[2], P[14])
                   + P[15];
  g.p_w = 1.f / (pw + 1e-7f);
  const float px = g.ph0 * g.p_w, py = g.ph1 * g.p_w;
  g.m0 = ((px + 1.f) * (float)p.width - 1.f) * 0.5f;
  g.m1 = ((py + 1.f) * (float)p.height - 1.f) * 0.5f;
  if (m2o) {
    g.m0 = g.m0 + m2o[2 * i];
    g.m1 = g.m1 + m2o[2 * i + 1];
  }

  // EWA: clamp_view_point and compute_cov2d
  const float tx = g.pv[0], ty = g.pv[1], tz = g.pv[2];
  g.tiny = fabsf(tz) < 1e-8f;
  const float tzs = g.tiny ? 1e-8f : tz;
  const float rx = tx / tzs, ry = ty / tzs;
  g.clx = (rx < -p.limx) | (rx > p.limx);
  g.cly = (ry < -p.limy) | (ry > p.limy);
  g.txo = g.clx ? fminf(fmaxf(rx, -p.limx), p.limx) * tz : tx;
  g.tyo = g.cly ? fminf(fmaxf(ry, -p.limy), p.limy) * tz : ty;
  g.inv_z = 1.f / tzs;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.J00 = p.fx * g.inv_z;
  g.J02 = (-p.fx * g.txo) * g.inv_z2;
  g.J11 = p.fy * g.inv_z;
  g.J12 = (-p.fy * g.tyo) * g.inv_z2;
  for (int k = 0; k < 3; ++k) {
    g.T0[k] = g.J00 * W[k] + g.J02 * W[6 + k];
    g.T1[k] = g.J11 * W[3 + k] + g.J12 * W[6 + k];
  }
  for (int a = 0; a < 3; ++a) {
    g.VT0[a] = mv3(g.V[3 * a], g.T0[0], g.V[3 * a + 1], g.T0[1],
                   g.V[3 * a + 2], g.T0[2]);
    g.VT1[a] = mv3(g.V[3 * a], g.T1[0], g.V[3 * a + 1], g.T1[1],
                   g.V[3 * a + 2], g.T1[2]);
  }
  g.a = sum3(g.T0[0] * g.VT0[0], g.T0[1] * g.VT0[1], g.T0[2] * g.VT0[2])
        + p.low_pass;
  g.b = sum3(g.T0[0] * g.VT1[0], g.T0[1] * g.VT1[1], g.T0[2] * g.VT1[2]);
  g.c = sum3(g.T1[0] * g.VT1[0], g.T1[1] * g.VT1[1], g.T1[2] * g.VT1[2])
        + p.low_pass;
  g.det = g.a * g.c - g.b * g.b;
  g.dv = g.det != 0.f;
  g.di = 1.f / (g.dv ? g.det : 1.f);

  // colour: the view direction from campos_eff, then SH (ops/sh.py)
  const float* ce = cam + 12;
  for (int k = 0; k < 3; ++k) g.d[k] = g.x[k] - ce[k];
  g.nrm = sqrtf(sum3(g.d[0] * g.d[0], g.d[1] * g.d[1], g.d[2] * g.d[2])
                + 1e-24f);
  for (int k = 0; k < 3; ++k) g.u[k] = g.d[k] / g.nrm;
  for (int ch = 0; ch < 3; ++ch) g.sh[0][ch] = fdc[3 * i + ch];
  for (int k = 1; k < Geo<DEG>::NB; ++k)
    for (int ch = 0; ch < 3; ++ch)
      g.sh[k][ch] = frest[(i * p.k_rest + (k - 1)) * 3 + ch];
  g.bas[0] = kC0;
  if constexpr (DEG > 0) {
    const float ux = g.u[0], uy = g.u[1], uz = g.u[2];
    g.bas[1] = -(kC1 * uy);
    g.bas[2] = kC1 * uz;
    g.bas[3] = -(kC1 * ux);
    if constexpr (DEG > 1) {
      const float xx = ux * ux, yy = uy * uy, zz = uz * uz;
      const float xy = ux * uy, yz = uy * uz, xz = ux * uz;
      g.bas[4] = kC2_0 * xy;
      g.bas[5] = kC2_1 * yz;
      g.bas[6] = kC2_2 * ((2.f * zz - xx) - yy);
      g.bas[7] = kC2_3 * xz;
      g.bas[8] = kC2_4 * (xx - yy);
      if constexpr (DEG > 2) {
        g.bas[9] = (kC3_0 * uy) * (3.f * xx - yy);
        g.bas[10] = (kC3_1 * xy) * uz;
        g.bas[11] = (kC3_2 * uy) * ((4.f * zz - xx) - yy);
        g.bas[12] = (kC3_3 * uz) * ((2.f * zz - 3.f * xx) - 3.f * yy);
        g.bas[13] = (kC3_4 * ux) * ((4.f * zz - xx) - yy);
        g.bas[14] = (kC3_5 * uz) * (xx - yy);
        g.bas[15] = (kC3_6 * ux) * (xx - 3.f * yy);
      }
    }
  }
  for (int ch = 0; ch < 3; ++ch) {
    float acc = kC0 * g.sh[0][ch];
    for (int k = 1; k < Geo<DEG>::NB; ++k) acc = acc + g.bas[k] * g.sh[k][ch];
    g.v[ch] = acc + 0.5f;
  }
}

// ops/gaussian_math.py to_int32: NaN -> 0, saturating, then truncation
__device__ inline int to_int32(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -2147483648.f), 2147483520.f);
  return (int)x;
}

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Forward: table rows [mean2d(2), conic(3), opacity, color(3), depth,
// rect16(4), 0, 0] (ops/renderer_tiled.py pack_table), aux rows [radius,
// radius_x, radius_y, cov2d a, b, c, 0, 0], rect (rect_min, rect_max),
// tiles_touched and valid; with the active mask as renderer_tiled.render
// applies it (valid, radius and tiles_touched; radius_xy stays masked by
// the unmasked valid, as the plain version leaves it).

template <int DEG>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    Params p, const float* __restrict__ xyz, const float* __restrict__ scaling,
    const float* __restrict__ rot, const float* __restrict__ opa_raw,
    const float* __restrict__ fdc, const float* __restrict__ frest,
    const float* __restrict__ tau, const float* __restrict__ Rc,
    const float* __restrict__ tc, const float* __restrict__ m2o,
    const bool* __restrict__ active, float* __restrict__ table,
    float* __restrict__ aux, int* __restrict__ rect, int* __restrict__ tiles,
    bool* __restrict__ valid) {
  __shared__ float cam[15];
  if (threadIdx.x == 0) block_pose(tau, Rc, tc, cam);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Geo<DEG> g;
  geo<DEG>(p, cam, i, xyz, scaling, rot, opa_raw, fdc, frest, m2o, g);

  // radius: a ceil, no gradient
  const float mid = 0.5f * (g.a + g.c);
  const float lam = mid + sqrtf(clamp_min_(mid * mid - g.det, 0.1f));
  const float radius = ceilf(3.f * sqrtf(clamp_min_(lam, 0.f)));
  // per-axis cull half-extents (q, a, c stop-gradients)
  const float q = clamp_min_(
      2.f * logf(clamp_min_(255.f * g.opa, 1e-12f)), 0.f);
  const float hx = fminf(radius, ceilf(sqrtf(q * clamp_min_(g.a, 0.f))));
  const float hy = fminf(radius, ceilf(sqrtf(q * clamp_min_(g.c, 0.f))));
  const bool nonempty = q > 0.f;
  const int grid_x = (p.width + 15) / 16, grid_y = (p.height + 15) / 16;
  const int rminx = clampi(to_int32((g.m0 - hx) / 16.f), 0, grid_x);
  const int rminy = clampi(to_int32((g.m1 - hy) / 16.f), 0, grid_y);
  // (mx + half_x + BLOCK_X - 1) / BLOCK_X, in the plain version's order
  const int rmaxx =
      clampi(to_int32((((g.m0 + hx) + 16.f) - 1.f) / 16.f), 0, grid_x);
  const int rmaxy =
      clampi(to_int32((((g.m1 + hy) + 16.f) - 1.f) / 16.f), 0, grid_y);
  const int nt = nonempty ? (rmaxx - rminx) * (rmaxy - rminy) : 0;
  const bool ok = (g.pv[2] > 0.2f) & g.dv & (nt > 0);
  const bool ok_act = ok & (active ? active[i] : true);

  float col[3];
  for (int ch = 0; ch < 3; ++ch) col[ch] = g.v[ch] < 0.f ? 0.f : g.v[ch];
  float4* trow = reinterpret_cast<float4*>(table + 16 * (size_t)i);
  trow[0] = make_float4(g.m0, g.m1, g.c * g.di, -g.b * g.di);
  trow[1] = make_float4(g.a * g.di, g.opa, col[0], col[1]);
  trow[2] = make_float4(col[2], g.pv[2], (float)rminx, (float)rminy);
  trow[3] = make_float4((float)rmaxx, (float)rmaxy, 0.f, 0.f);
  float4* arow = reinterpret_cast<float4*>(aux + 8 * (size_t)i);
  arow[0] = make_float4(ok_act ? radius : 0.f, ok ? hx : 0.f,
                        ok ? hy : 0.f, g.a);
  arow[1] = make_float4(g.b, g.c, 0.f, 0.f);
  reinterpret_cast<int4*>(rect)[i] = make_int4(rminx, rminy, rmaxx, rmaxy);
  tiles[i] = ok_act ? nt : 0;
  valid[i] = ok_act;
}

// ---------------------------------------------------------------------------
// Backward: the gradients of one Gaussian's raw parameters and its
// screen-space offset from its table-gradient row, and the block's partial
// sums of the gradients of W (9), tv (3) and campos_eff (3), the pose's
// route.

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    Params p, const float* __restrict__ xyz, const float* __restrict__ scaling,
    const float* __restrict__ rot, const float* __restrict__ opa_raw,
    const float* __restrict__ fdc, const float* __restrict__ frest,
    const float* __restrict__ tau, const float* __restrict__ Rc,
    const float* __restrict__ tc, const float* __restrict__ gtab,
    float* __restrict__ g_xyz, float* __restrict__ g_scaling,
    float* __restrict__ g_rot, float* __restrict__ g_opa,
    float* __restrict__ g_fdc, float* __restrict__ g_frest,
    float* __restrict__ g_m2o, float* __restrict__ partials) {
  __shared__ float cam[15];
  __shared__ float red[kThreads / 32][kPart];
  if (threadIdx.x == 0) block_pose(tau, Rc, tc, cam);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float pg[15];  // this Gaussian's share of dL/dW, dL/dtv, dL/dcampos_eff
  for (int k = 0; k < 15; ++k) pg[k] = 0.f;
  if (i < p.n) {
    Geo<DEG> g;
    geo<DEG>(p, cam, i, xyz, scaling, rot, opa_raw, fdc, frest, nullptr, g);
    const float* W = cam;
    float gt[10];
    for (int k = 0; k < 10; ++k)
      gt[k] = gtab[(size_t)i * p.g_s0 + (size_t)k * p.g_s1];
    const float gm0 = gt[0], gm1 = gt[1];
    if (g_m2o) {
      g_m2o[2 * i] = gm0;
      g_m2o[2 * i + 1] = gm1;
    }
    float gx[3] = {0.f, 0.f, 0.f};

    // colour: the clamp at 0, SH coefficients, the view direction
    float gv[3];
    for (int ch = 0; ch < 3; ++ch) gv[ch] = g.v[ch] < 0.f ? 0.f : gt[6 + ch];
    for (int ch = 0; ch < 3; ++ch) g_fdc[3 * i + ch] = gv[ch] * kC0;
    for (int k = 1; k <= p.k_rest; ++k)
      for (int ch = 0; ch < 3; ++ch)
        g_frest[(i * p.k_rest + (k - 1)) * 3 + ch] =
            k < Geo<DEG>::NB ? gv[ch] * g.bas[k] : 0.f;
    if constexpr (DEG > 0) {
      // dL/d basis_k = gv . sh_k; dL/du through each basis' gradient
      float gb[Geo<DEG>::NB];
      for (int k = 1; k < Geo<DEG>::NB; ++k)
        gb[k] = (gv[0] * g.sh[k][0] + gv[1] * g.sh[k][1]) + gv[2] * g.sh[k][2];
      const float ux = g.u[0], uy = g.u[1], uz = g.u[2];
      float gu[3];
      gu[0] = -kC1 * gb[3];
      gu[1] = -kC1 * gb[1];
      gu[2] = kC1 * gb[2];
      if constexpr (DEG > 1) {
        const float xx = ux * ux, yy = uy * uy, zz = uz * uz;
        gu[0] += kC2_0 * uy * gb[4] + kC2_2 * (-2.f * ux) * gb[6]
                 + kC2_3 * uz * gb[7] + kC2_4 * (2.f * ux) * gb[8];
        gu[1] += kC2_0 * ux * gb[4] + kC2_1 * uz * gb[5]
                 + kC2_2 * (-2.f * uy) * gb[6] + kC2_4 * (-2.f * uy) * gb[8];
        gu[2] += kC2_1 * uy * gb[5] + kC2_2 * (4.f * uz) * gb[6]
                 + kC2_3 * ux * gb[7];
        if constexpr (DEG > 2) {
          gu[0] += kC3_0 * (6.f * ux * uy) * gb[9]
                   + kC3_1 * (uy * uz) * gb[10]
                   + kC3_2 * (-2.f * ux * uy) * gb[11]
                   + kC3_3 * (-6.f * ux * uz) * gb[12]
                   + kC3_4 * (4.f * zz - 3.f * xx - yy) * gb[13]
                   + kC3_5 * (2.f * ux * uz) * gb[14]
                   + kC3_6 * (3.f * xx - 3.f * yy) * gb[15];
          gu[1] += kC3_0 * (3.f * xx - 3.f * yy) * gb[9]
                   + kC3_1 * (ux * uz) * gb[10]
                   + kC3_2 * (4.f * zz - xx - 3.f * yy) * gb[11]
                   + kC3_3 * (-6.f * uy * uz) * gb[12]
                   + kC3_4 * (-2.f * ux * uy) * gb[13]
                   + kC3_5 * (-2.f * uy * uz) * gb[14]
                   + kC3_6 * (-6.f * ux * uy) * gb[15];
          gu[2] += kC3_1 * (ux * uy) * gb[10]
                   + kC3_2 * (8.f * uy * uz) * gb[11]
                   + kC3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * gb[12]
                   + kC3_4 * (8.f * ux * uz) * gb[13]
                   + kC3_5 * (xx - yy) * gb[14];
        }
      }
      // u = d / |d|: dd = gu / n - d (d . gu) / n^3
      const float dgu = (g.d[0] * gu[0] + g.d[1] * gu[1]) + g.d[2] * gu[2];
      const float gn = -dgu / (g.nrm * g.nrm);
      for (int k = 0; k < 3; ++k) {
        const float dd = gu[k] / g.nrm + g.d[k] * gn / g.nrm;
        gx[k] += dd;
        pg[12 + k] = -dd;
      }
    }

    // conic = (c, -b, a) / det_safe
    const float gk0 = gt[2], gk1 = gt[3], gk2 = gt[4];
    float ga = gk2 * g.di, gbb = -gk1 * g.di, gc = gk0 * g.di;
    if (g.dv) {
      const float gdi = (gk0 * g.c - gk1 * g.b) + gk2 * g.a;
      const float gdet = -gdi * g.di * g.di;
      ga += gdet * g.c;
      gc += gdet * g.a;
      gbb += -2.f * g.b * gdet;
    }
    // a = T0.V.T0 + lp, b = T0.V.T1, c = T1.V.T1 + lp
    float gT0[3], gT1[3];
    for (int k = 0; k < 3; ++k) {
      gT0[k] = 2.f * ga * g.VT0[k] + gbb * g.VT1[k];
      gT1[k] = gbb * g.VT0[k] + 2.f * gc * g.VT1[k];
    }
    // dL/dSigma on the upper triangle, symmetrised: G = gS + gS^T
    float G[9];
    for (int a = 0; a < 3; ++a)
      for (int k = a; k < 3; ++k) {
        float gv_ak = ga * g.T0[a] * g.T0[k] + gbb * g.T0[a] * g.T1[k]
                      + gc * g.T1[a] * g.T1[k];
        if (k != a)
          gv_ak += ga * g.T0[k] * g.T0[a] + gbb * g.T0[k] * g.T1[a]
                   + gc * g.T1[k] * g.T1[a];
        G[3 * a + k] = (k == a) ? 2.f * gv_ak : gv_ak;
        G[3 * k + a] = G[3 * a + k];
      }
    // T0 = J00 W0 + J02 W2, T1 = J11 W1 + J12 W2
    const float gJ00 = (gT0[0] * W[0] + gT0[1] * W[1]) + gT0[2] * W[2];
    const float gJ02 = (gT0[0] * W[6] + gT0[1] * W[7]) + gT0[2] * W[8];
    const float gJ11 = (gT1[0] * W[3] + gT1[1] * W[4]) + gT1[2] * W[5];
    const float gJ12 = (gT1[0] * W[6] + gT1[1] * W[7]) + gT1[2] * W[8];
    for (int k = 0; k < 3; ++k) {
      pg[k] += g.J00 * gT0[k];
      pg[3 + k] += g.J11 * gT1[k];
      pg[6 + k] += g.J02 * gT0[k] + g.J12 * gT1[k];
    }
    float g_invz = p.fx * gJ00 + p.fy * gJ11;
    const float g_invz2 = (-p.fx * g.txo) * gJ02 + (-p.fy * g.tyo) * gJ12;
    g_invz += 2.f * g.inv_z * g_invz2;
    const float g_tz_j = g.tiny ? 0.f : -g_invz * g.inv_z * g.inv_z;
    const float g_tx_j = g.clx ? 0.f : gJ02 * g.inv_z2 * (-p.fx);
    const float g_ty_j = g.cly ? 0.f : gJ12 * g.inv_z2 * (-p.fy);

    // mean2d = ((p_proj + 1) * size - 1) / 2, p_proj = ph / (pw + 1e-7)
    const float gpx = gm0 * 0.5f * (float)p.width;
    const float gpy = gm1 * 0.5f * (float)p.height;
    const float gph0 = gpx * g.p_w, gph1 = gpy * g.p_w;
    const float gpw_inv = gpx * g.ph0 + gpy * g.ph1;
    const float gpw = -gpw_inv * g.p_w * g.p_w;
    const float* P = p.proj;
    float gpv[3];
    for (int k = 0; k < 3; ++k)
      gpv[k] = (P[k] * gph0 + P[4 + k] * gph1) + P[12 + k] * gpw;
    gpv[0] += g_tx_j;
    gpv[1] += g_ty_j;
    gpv[2] += g_tz_j + gt[9];  // depth
    // pv = W x + tv
    for (int k = 0; k < 3; ++k) {
      gx[k] += (W[k] * gpv[0] + W[3 + k] * gpv[1]) + W[6 + k] * gpv[2];
      for (int a = 0; a < 3; ++a) pg[3 * a + k] += gpv[a] * g.x[k];
      pg[9 + k] = gpv[k];
    }
    for (int k = 0; k < 3; ++k) g_xyz[3 * i + k] = gx[k];

    // opacity = sigmoid(raw)
    g_opa[i] = gt[5] * (1.f - g.opa) * g.opa;

    // Sigma = M M^T, M = R diag(sp): dM = G M
    float gR[9], gsp[3] = {0.f, 0.f, 0.f};
    for (int a = 0; a < 3; ++a)
      for (int k = 0; k < 3; ++k) {
        const float gM = (G[3 * a] * g.M[k] + G[3 * a + 1] * g.M[3 + k])
                         + G[3 * a + 2] * g.M[6 + k];
        gR[3 * a + k] = gM * g.sp[k];
        gsp[k] += gM * g.R[3 * a + k];
      }
    if (p.iso) {
      g_scaling[i] = ((p.scale_mod * gsp[0]) * g.s[0]
                      + (p.scale_mod * gsp[1]) * g.s[1])
                     + (p.scale_mod * gsp[2]) * g.s[2];
    } else {
      for (int k = 0; k < 3; ++k)
        g_scaling[3 * i + k] = (p.scale_mod * gsp[k]) * g.s[k];
    }
    // the rotation matrix of the normalised quaternion (w, x, y, z)
    const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
    float gq[4];
    gq[0] = 2.f * (((-z * gR[1] + y * gR[2]) + (z * gR[3] - x * gR[5]))
                   + (-y * gR[6] + x * gR[7]));
    gq[1] = 2.f * (((y * gR[1] + z * gR[2]) + (y * gR[3] - 2.f * x * gR[4]))
                   + ((-r * gR[5] + z * gR[6]) + (r * gR[7] - 2.f * x * gR[8])));
    gq[2] = 2.f * (((-2.f * y * gR[0] + x * gR[1]) + (r * gR[2] + x * gR[3]))
                   + ((z * gR[5] - r * gR[6]) + (z * gR[7] - 2.f * y * gR[8])));
    gq[3] = 2.f * (((-2.f * z * gR[0] - r * gR[1]) + (x * gR[2] + r * gR[3]))
                   + ((-2.f * z * gR[4] + y * gR[5]) + (x * gR[6] + y * gR[7])));
    // q / |q|: dq = (dqn - qn (qn . dqn)) / |q|
    const float dot = ((g.qn[0] * gq[0] + g.qn[1] * gq[1]) + g.qn[2] * gq[2])
                      + g.qn[3] * gq[3];
    for (int k = 0; k < 4; ++k)
      g_rot[4 * i + k] = (gq[k] - g.qn[k] * dot) / g.qnorm;
  }

  if (partials) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int k = 0; k < 15; ++k) {
      const float s = warp_sum(pg[k]);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < 15) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
      partials[blockIdx.x * kPart + threadIdx.x] = s;
    }
  }
}

// One block: the partials summed in a fixed order, then dL/dtau =
// sum over W, tv of dL/dW * dW/dtau (forward mode through se3_exp, one
// thread per component of tau) + dL/dcampos_eff on tau[:3].
__global__ void __launch_bounds__(kThreads) pose_kernel(
    const float* __restrict__ partials, int n_blocks,
    const float* __restrict__ tau, const float* __restrict__ Rc,
    const float* __restrict__ tc, float* __restrict__ g_tau) {
  __shared__ float red[kThreads][kPart];
  for (int k = 0; k < 15; ++k) {
    float s = 0.f;
    for (int b = threadIdx.x; b < n_blocks; b += kThreads)
      s += partials[b * kPart + k];
    red[threadIdx.x][k] = s;
  }
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      for (int k = 0; k < 15; ++k)
        red[threadIdx.x][k] += red[threadIdx.x + half][k];
    __syncthreads();
  }
  if (threadIdx.x < 6) {
    const int j = threadIdx.x;
    Dual t6[6];
    for (int k = 0; k < 6; ++k) t6[k] = Dual(tau[k], k == j ? 1.f : 0.f);
    Dual W[9], tv[3];
    pose_eff<Dual>(t6, Rc, tc, W, tv);
    const float* G = red[0];
    float s = 0.f;
    for (int k = 0; k < 9; ++k) s += G[k] * W[k].d;
    for (int k = 0; k < 3; ++k) s += G[9 + k] * tv[k].d;
    if (j < 3) s += G[12 + j];
    g_tau[j] = s;
  }
}

template <int DEG>
int launch_fwd(const Params& p, const float* const* in, const bool* active,
               float* table, float* aux, int* rect, int* tiles, bool* valid,
               cudaStream_t st) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  fwd_kernel<DEG><<<blocks, kThreads, 0, st>>>(
      p, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      in[9], active, table, aux, rect, tiles, valid);
  return (int)cudaGetLastError();
}

template <int DEG>
int launch_bwd(const Params& p, const float* const* in, const float* gtab,
               float* const* out, float* partials, float* g_tau,
               cudaStream_t st) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  bwd_kernel<DEG><<<blocks, kThreads, 0, st>>>(
      p, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      gtab, out[0], out[1], out[2], out[3], out[4], out[5], out[6],
      g_tau ? partials : nullptr);
  int err = (int)cudaGetLastError();
  if (err || !g_tau) return err;
  pose_kernel<<<1, kThreads, 0, st>>>(partials, blocks, in[6], in[7], in[8],
                                       g_tau);
  return (int)cudaGetLastError();
}

}  // namespace prep

// C entries, loaded with ctypes. params: a host pointer to Params. The
// inputs, device pointers to contiguous float32: xyz (N, 3), scaling
// (N, 3) or (N, 1), rotation (N, 4), opacity (N, 1), features_dc (N, 1,
// 3), features_rest (N, k_rest, 3), tau (6) or null (zero), R (3, 3), t
// (3), mean2d_offset (N, 2) or null; active (N) bool or null. Outputs:
// table (N, 16), aux (N, 8) f32, rect (N, 4) int32, tiles (N) int32,
// valid (N) bool, 16-byte aligned. Launch on ``stream``, return
// cudaGetLastError().
extern "C" int preprocess_fwd(const void* params, const void* xyz,
                              const void* scaling, const void* rotation,
                              const void* opacity, const void* fdc,
                              const void* frest, const void* tau,
                              const void* R, const void* t, const void* m2o,
                              const void* active, void* table, void* aux,
                              void* rect, void* tiles, void* valid,
                              void* stream) {
  const prep::Params& p = *static_cast<const prep::Params*>(params);
  const float* in[10] = {
      (const float*)xyz, (const float*)scaling, (const float*)rotation,
      (const float*)opacity, (const float*)fdc, (const float*)frest,
      (const float*)tau, (const float*)R, (const float*)t,
      (const float*)m2o};
  auto st = static_cast<cudaStream_t>(stream);
  auto act = static_cast<const bool*>(active);
  auto args = [&](auto launch) {
    return launch(p, in, act, (float*)table, (float*)aux, (int*)rect,
                  (int*)tiles, (bool*)valid, st);
  };
  switch (p.sh_degree) {
    case 0: return args(prep::launch_fwd<0>);
    case 1: return args(prep::launch_fwd<1>);
    case 2: return args(prep::launch_fwd<2>);
    case 3: return args(prep::launch_fwd<3>);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: the same params and inputs (no offset, no mask), gtab the
// table's gradient (N, 16) at element strides (params g_s0, g_s1); the
// outputs the raw parameters' gradients, contiguous, shaped as their
// parameters, g_m2o (N, 2) or null, partials (ceil(N / 256), 16) scratch
// and g_tau (6), both null when tau is (then no pose gradient is formed).
extern "C" int preprocess_bwd(const void* params, const void* xyz,
                              const void* scaling, const void* rotation,
                              const void* opacity, const void* fdc,
                              const void* frest, const void* tau,
                              const void* R, const void* t,
                              const void* gtab, void* g_xyz, void* g_scaling,
                              void* g_rotation, void* g_opacity, void* g_fdc,
                              void* g_frest, void* g_m2o, void* partials,
                              void* g_tau, void* stream) {
  const prep::Params& p = *static_cast<const prep::Params*>(params);
  const float* in[9] = {
      (const float*)xyz, (const float*)scaling, (const float*)rotation,
      (const float*)opacity, (const float*)fdc, (const float*)frest,
      (const float*)tau, (const float*)R, (const float*)t};
  float* out[7] = {(float*)g_xyz, (float*)g_scaling, (float*)g_rotation,
                   (float*)g_opacity, (float*)g_fdc, (float*)g_frest,
                   (float*)g_m2o};
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(p, in, (const float*)gtab, out, (float*)partials,
                  (float*)g_tau, st);
  };
  switch (p.sh_degree) {
    case 0: return args(prep::launch_bwd<0>);
    case 1: return args(prep::launch_bwd<1>);
    case 2: return args(prep::launch_bwd<2>);
    case 3: return args(prep::launch_bwd<3>);
  }
  return (int)cudaErrorInvalidValue;
}
