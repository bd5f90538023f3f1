// The 16x16 forward chunk-body ablation harness for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/abl16.py (make_kernel :55,
// pallas_call in run :237): B3's forward chunk body (tile_kernel16.py)
// stripped stage by stage on a synthetic plan, to see which operation
// class costs what. One C entry per variant (abl16.py:56-62):
//   full      the chunk body with every stage
//   noexp     opa (1 + power) in place of opa exp(power)
//   noscan    T_excl = T (1 - alpha) per pair in place of the prefix product
//   nomxu     acc += sum_k w + cfeat[0, 0] in place of acc += cfeat^T w
//   notrans   every pair row reads 0.5 + feat[0, first pair of the chunk]
//   minimal   noexp + noscan + nomxu + notrans
//   dyn       full with each subtile's own chunk count ceil(n / 128)
//   prodbody  B3's production arithmetic (_chunk_terms16: global pixel
//             rows, rect16 test, 1e-4 stop, done pixels) with dyn's counts
// Variants other than dyn and prodbody walk NC chunks from each subtile's
// start whatever its range says, at subtile-local pixels (x, y) =
// (q % 16, q / 16), without rect test or stop. feat is (16, B) f32,
// feature-major as the script's DMA slices it; ranges (n_tiles16, 2)
// int32 on the 2 n_gx x 2 n_gy grid of 16-px tiles. Output, per 32x32
// group (gy, gx) and subtile j = 2 (row) + (column), the row sum
// sum_c acc_c + T_final of each of its 256 pixels: (n_gy, n_gx, 4, 256)
// f32 (the script's block img[0, gy*8 + 2j + r, gx*128 + l] is pixel
// r*128 + l of subtile j).
//
// The design follows the script's: one CTA per 32x32 group walks its four
// subtiles in turn, 256 threads, one per pixel; a chunk of 128 pair rows
// is staged in shared memory (8 KB) and read by all threads as broadcasts.
// Each thread walks its pixel's pairs in order, so the TPU's
// Hillis-Steele scan is a running product and the "mxu" accumulate
// cfeat^T w four fused multiply-adds a cell. What bounds it: arithmetic,
// ~20-32 FP32 operations a (pair, pixel) cell (counted per variant in
// scripts/abl16.py) against 64 bytes of pair row shared by 256 pixels.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;       // features per pair row
constexpr int kChunk = 128;  // pair rows per chunk (the plan's alignment)
constexpr int kPix = 256;    // pixels per 16x16 subtile: one thread each
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

template <bool kExp, bool kScan, bool kMxu, bool kTrans, bool kDyn,
          bool kProd>
__global__ void __launch_bounds__(kPix)
abl16_kernel(const float* __restrict__ feat,  // (16, B)
             const int* __restrict__ ranges,  // (n_tiles16, 2)
             float* __restrict__ out,         // (n_gy, n_gx, 4, 256)
             int n_gx, int W, int H, int nc_fixed, int B) {
  __shared__ float s_feat[kChunk][kF + 1];  // +1: no bank conflicts
  const int group = blockIdx.x;
  const int gx = group % n_gx;
  const int gy = group / n_gx;
  const int q = threadIdx.x;
  const int n_tx16 = 2 * n_gx;

  for (int j = 0; j < 4; ++j) {
    const int t16 = (2 * gy + j / 2) * n_tx16 + (2 * gx + j % 2);
    const int start = ranges[2 * t16];
    const int n_live = ranges[2 * t16 + 1] - start;
    const int nc = kDyn ? (n_live + kChunk - 1) / kChunk : nc_fixed;
    float px, py;
    bool done = false;
    if constexpr (kProd) {
      const int x = gx * 32 + (j % 2) * 16 + q % 16;
      const int y = gy * 32 + (j / 2) * 16 + q / 16;
      px = static_cast<float>(x);
      py = static_cast<float>(y);
      done = !((x < W) && (y < H));
    } else {
      px = static_cast<float>(q % 16);
      py = static_cast<float>(q / 16);
    }
    const float t16x = floorf(px / 16.0f);
    const float t16y = floorf(py / 16.0f);
    float T = 1.0f;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;

    for (int c = 0; c < nc; ++c) {
      const int base = start + c * kChunk;
      __syncthreads();  // the previous chunk's rows are consumed
      if constexpr (kTrans) {
        for (int i = q; i < kChunk * kF; i += kPix) {
          const int f = i / kChunk;
          const int k = i % kChunk;
          const int p = base + k;
          s_feat[k][f] = p < B ? feat[static_cast<size_t>(f) * B + p] : 0.0f;
        }
      } else {
        const float v = 0.5f + (base < B ? feat[base] : 0.0f);
        for (int i = q; i < kChunk * kF; i += kPix) {
          s_feat[i / kF][i % kF] = v;
        }
      }
      __syncthreads();

      const float T_chunk = T;
      float cum = 1.0f;  // running product of (1 - alpha_eff)
      for (int k = 0; k < kChunk; ++k) {
        const float* r = s_feat[k];
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        const float power =
            -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        const float a_un = kExp ? r[5] * expf(power) : r[5] * (1.0f + power);
        const float alpha = fminf(kAlphaMax, a_un);
        bool ok = power <= 0.0f && alpha >= kAlphaMin;
        if constexpr (kProd) {
          const bool rect_ok = (t16x >= r[10]) && (t16x < r[12]) &&
                               (t16y >= r[11]) && (t16y < r[13]);
          ok = ok && rect_ok && (k < n_live - c * kChunk) && !done;
        }
        const float a_eff = ok ? alpha : 0.0f;
        float T_excl, T_incl;
        if constexpr (kScan) {
          T_excl = T_chunk * cum;
          cum = cum * (1.0f - a_eff);
          T_incl = T_chunk * cum;
        } else {
          T_excl = T_chunk * (1.0f - a_eff);
          T_incl = T_excl;
        }
        float w = a_eff * T_excl;
        if constexpr (kProd) {
          if (ok && T_incl < kTEps) {
            done = true;  // the triggering pair is dropped
            w = 0.0f;
          } else if (ok) {
            T = fminf(T, T_incl);
          }
        } else {
          T = fminf(T, T_incl);
        }
        if constexpr (kMxu) {
          acc0 = __fmaf_rn(r[6], w, acc0);
          acc1 = __fmaf_rn(r[7], w, acc1);
          acc2 = __fmaf_rn(r[8], w, acc2);
          acc3 = __fmaf_rn(r[9], w, acc3);
        } else {
          acc0 += w;
        }
      }
      if constexpr (!kMxu) acc0 += s_feat[0][6];
    }
    out[(static_cast<size_t>(group) * 4 + j) * kPix + q] =
        ((acc0 + acc1) + acc2) + acc3 + T;
  }
}

template <bool kExp, bool kScan, bool kMxu, bool kTrans, bool kDyn,
          bool kProd>
int launch(const void* feat, const void* ranges, void* out, int n_gx,
           int n_gy, int W, int H, int nc, int B, void* stream) {
  if (n_gx * n_gy <= 0) return 0;
  abl16_kernel<kExp, kScan, kMxu, kTrans, kDyn, kProd>
      <<<n_gx * n_gy, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(feat), static_cast<const int*>(ranges),
          static_cast<float*>(out), n_gx, W, H, nc, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, loaded with ctypes, one per variant: feat (16, B) f32,
// ranges (n_tiles16, 2) int32, out (n_gy, n_gx, 4, 256) f32; nc the fixed
// chunk count of the non-dynamic variants. Launch on ``stream`` and
// return cudaGetLastError().
#define ABL16_ENTRY(NAME, EXP, SCAN, MXU, TRANS, DYN, PROD)                 \
  extern "C" int NAME(const void* feat, const void* ranges, void* out,      \
                      int n_gx, int n_gy, int W, int H, int nc, int B,      \
                      void* stream) {                                       \
    return launch<EXP, SCAN, MXU, TRANS, DYN, PROD>(feat, ranges, out, n_gx, \
                                                    n_gy, W, H, nc, B,      \
                                                    stream);                \
  }

ABL16_ENTRY(abl16_full, true, true, true, true, false, false)
ABL16_ENTRY(abl16_noexp, false, true, true, true, false, false)
ABL16_ENTRY(abl16_noscan, true, false, true, true, false, false)
ABL16_ENTRY(abl16_nomxu, true, true, false, true, false, false)
ABL16_ENTRY(abl16_notrans, true, true, true, false, false, false)
ABL16_ENTRY(abl16_minimal, false, false, false, false, false, false)
ABL16_ENTRY(abl16_dyn, true, true, true, true, true, false)
ABL16_ENTRY(abl16_prodbody, true, true, true, true, true, true)
