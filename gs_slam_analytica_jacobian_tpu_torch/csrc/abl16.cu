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
// Every variant evaluates every cell it walks: the cost per cell is what
// the harness measures, so nothing is culled. A pixel walks its pairs in
// order, so the TPU's Hillis-Steele scan is a running product and the
// "mxu" accumulate cfeat^T w four fused multiply-adds a cell. The
// arithmetic of a cell is the same in both designs below, operation for
// operation (expf, __fmaf_rn, built with -fmad=false), and so is the order
// of every sum: the two give the same output bit for bit.
//
// What bounds it on the H100: instruction issue. A cell takes ~20-32 FP32
// operations (counted per variant in scripts/abl16.py), against 64 bytes
// of pair row shared by 256 pixels, and almost none of them is a fused
// multiply-add, so the FP32 peak (which counts an FMA as two) is out of
// reach by about half even when every issue slot does arithmetic; the
// shared-memory loads and the loop's integer work take issue slots too.
//
// Two designs, both here:
// - abl16_<variant> (the design in use): one CTA of 64 threads per 16x16
//   subtile (4 n_gx n_gy CTAs: 3,344 at the script's shape), four pixels
//   a thread, (x, y + 4 m) for m < 4. The chunk's (16 x 128) feature-major
//   box is copied as it lies in feat (cp.async, 16 bytes a copy, zero-
//   filled past B; 4-byte copies where feat or the range is not 16-byte
//   aligned) into a double buffer, chunk c + 1 in flight while chunk c is
//   walked, one CTA barrier a chunk. The walk takes four pairs at a time,
//   two such groups a loop step: one 16-byte broadcast load per feature
//   the variant reads (6, 10 or 14) serves four pairs and the thread's
//   four pixels, 0.625 shared-memory loads a cell under full (0.875 under
//   prodbody) against 10 (14). The four pixels share x, so dx and its
//   products with the conic (r2 dx, r2 dx dx, r3 dx) are computed once for
//   them, as are prodbody's rect and row tests (one 16-px tile, one row
//   index). Two pixels a thread (128 threads), or one four-pair group a
//   step, ran slower on the H100.
// - abl16_<variant>_group (the first port's design, kept as a yardstick
//   that only chip_smoke.py and tests/test_torch_cuda.py launch): one CTA
//   of 256 threads, a thread per pixel, per 32x32 group walks its four
//   subtiles in turn; a chunk of 128 pair rows is staged between two
//   barriers into a pair-major [128][17] table (8.5 KB) and a cell reads
//   its row with 10 scalar loads (14 under prodbody): about one
//   shared-memory load per three FP32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 16;       // features per pair row
constexpr int kChunk = 128;  // pair rows per chunk (the plan's alignment)
constexpr int kPix = 256;    // pixels per 16x16 subtile
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// ---------------------------------------------------------------------------
// abl16_<variant>: one CTA per subtile, four pixels a thread
// ---------------------------------------------------------------------------

constexpr int kPPT = 4;            // pixels a thread
constexpr int kThreads = kPix / kPPT;  // 64: two warps a CTA
constexpr int kUnroll = 2;         // groups of four pairs a loop step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy ``bytes`` (0: none, the destination zero-filled) of a 16- or 4-byte
// piece from global to shared memory, asynchronously
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start filling ``box`` (16 x 128, feature-major) with the chunk at pair
// ``base``: under kTrans the features of pairs base .. base + 127 (zero past
// B), else the constant 0.5 + feat[0, base] (0.5 past B), stored at once.
template <bool kTrans>
__device__ __forceinline__ void fill_box(float (*box)[kChunk],
                                         const float* __restrict__ feat,
                                         int base, int B, int tid) {
  if constexpr (kTrans) {
    if (((B | base) & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(feat) & 15) == 0) {
      // 16-byte pieces, 8 a thread; p < B implies p + 3 < B
      for (int i = tid; i < kF * kChunk / 4; i += kThreads) {
        const int f = i / (kChunk / 4);
        const int k = (i - f * (kChunk / 4)) * 4;
        const int p = base + k;
        const bool in = p < B;
        copy16(&box[f][k], in ? feat + static_cast<size_t>(f) * B + p : feat,
               in ? 16u : 0u);
      }
    } else {
      for (int i = tid; i < kF * kChunk; i += kThreads) {
        const int f = i / kChunk;
        const int k = i - f * kChunk;
        const int p = base + k;
        const bool in = p < B;
        copy4(&box[f][k], in ? feat + static_cast<size_t>(f) * B + p : feat,
              in ? 4u : 0u);
      }
    }
    copy_commit();
  } else {
    const float v = 0.5f + (base < B ? feat[base] : 0.0f);
    const float4 v4 = make_float4(v, v, v, v);
    float4* b4 = reinterpret_cast<float4*>(&box[0][0]);
    for (int i = tid; i < kF * kChunk / 4; i += kThreads) b4[i] = v4;
  }
}

// One pixel's running state through the walk.
struct Pixel {
  float py;
  float T = 1.0f;
  float T_chunk = 1.0f;
  float cum = 1.0f;  // running product of (1 - alpha_eff) in the chunk
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  bool done = false;
};

// One (pair, pixel) cell, the group kernel's arithmetic: r the pair's
// features, dx = r[0] - px and the dx terms shared with the thread's other
// pixels, ``keep`` prodbody's rect and row tests.
template <bool kExp, bool kScan, bool kMxu, bool kProd>
__device__ __forceinline__ void cell(const float* r, float dx, float cadx2,
                                     float cbdx, bool keep, Pixel& s) {
  const float dy = r[1] - s.py;
  const float power = -0.5f * (cadx2 + r[4] * dy * dy) - cbdx * dy;
  const float a_un = kExp ? r[5] * expf(power) : r[5] * (1.0f + power);
  const float alpha = fminf(kAlphaMax, a_un);
  bool ok = power <= 0.0f && alpha >= kAlphaMin;
  if constexpr (kProd) ok = ok && keep && !s.done;
  const float a_eff = ok ? alpha : 0.0f;
  float T_excl, T_incl;
  if constexpr (kScan) {
    T_excl = s.T_chunk * s.cum;
    s.cum = s.cum * (1.0f - a_eff);
    T_incl = s.T_chunk * s.cum;
  } else {
    T_excl = s.T_chunk * (1.0f - a_eff);
    T_incl = T_excl;
  }
  float w = a_eff * T_excl;
  if constexpr (kProd) {
    if (ok && T_incl < kTEps) {
      s.done = true;  // the triggering pair is dropped
      w = 0.0f;
    } else if (ok) {
      s.T = fminf(s.T, T_incl);
    }
  } else {
    s.T = fminf(s.T, T_incl);
  }
  if constexpr (kMxu) {
    s.acc0 = __fmaf_rn(r[6], w, s.acc0);
    s.acc1 = __fmaf_rn(r[7], w, s.acc1);
    s.acc2 = __fmaf_rn(r[8], w, s.acc2);
    s.acc3 = __fmaf_rn(r[9], w, s.acc3);
  } else {
    s.acc0 += w;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <bool kExp, bool kScan, bool kMxu, bool kTrans, bool kDyn,
          bool kProd>
__global__ void __launch_bounds__(kThreads)
abl16_subtile_kernel(const float* __restrict__ feat,  // (16, B)
                     const int* __restrict__ ranges,  // (n_tiles16, 2)
                     float* __restrict__ out,         // (n_gy, n_gx, 4, 256)
                     int n_gx, int W, int H, int nc_fixed, int B) {
  // the features the variant reads: mean, conic, opacity; colour; rect16
  constexpr int kNF = kProd ? 14 : (kMxu ? 10 : 6);
  __shared__ __align__(16) float s_box[2][kF][kChunk];
  const int sub = blockIdx.x;  // group * 4 + j
  const int group = sub >> 2;
  const int j = sub & 3;
  const int gx = group % n_gx;
  const int gy = group / n_gx;
  const int tid = threadIdx.x;
  const int t16 = (2 * gy + j / 2) * (2 * n_gx) + (2 * gx + j % 2);
  const int start = ranges[2 * t16];
  const int n_live = ranges[2 * t16 + 1] - start;
  const int nc = kDyn ? (n_live + kChunk - 1) / kChunk : nc_fixed;

  // pixels q = tid + 64 m of the subtile (m < 4): the same x, rows
  // y + 4 m
  const int x = (kProd ? gx * 32 + (j % 2) * 16 : 0) + tid % 16;
  const int y = (kProd ? gy * 32 + (j / 2) * 16 : 0) + tid / 16;
  const float px = static_cast<float>(x);
  Pixel p[kPPT];
#pragma unroll
  for (int m = 0; m < kPPT; ++m) {
    const int ym = y + m * (kThreads / 16);
    p[m].py = static_cast<float>(ym);
    if constexpr (kProd) p[m].done = !((x < W) && (ym < H));
  }
  // floor(p / 16) of every pixel of the subtile (one 16-px tile)
  const float t16x = floorf(px / 16.0f);
  const float t16y = floorf(p[0].py / 16.0f);

  if (nc > 0) fill_box<kTrans>(s_box[0], feat, start, B, tid);
  for (int c = 0; c < nc; ++c) {
    if constexpr (kTrans) copy_wait_all();
    // chunk c is in s_box[c & 1] for every thread, and chunk c - 1's
    // buffer is read: chunk c + 1 goes there while c is walked
    __syncthreads();
    if (c + 1 < nc) {
      fill_box<kTrans>(s_box[(c + 1) & 1], feat, start + (c + 1) * kChunk,
                       B, tid);
    }
    const float(*box)[kChunk] = s_box[c & 1];
    const int n_row = n_live - c * kChunk;  // prodbody's row test
#pragma unroll
    for (int m = 0; m < kPPT; ++m) {
      p[m].T_chunk = p[m].T;
      p[m].cum = 1.0f;
    }
    // kUnroll groups of four pairs a step; a group's 16-byte loads serve
    // its four pairs and the thread's four pixels
#pragma unroll 1
    for (int k0 = 0; k0 < kChunk; k0 += 4 * kUnroll) {
#pragma unroll
      for (int k4 = k0; k4 < k0 + 4 * kUnroll; k4 += 4) {
        float4 v[kNF];
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          v[f] = *reinterpret_cast<const float4*>(&box[f][k4]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float r[kNF];
#pragma unroll
          for (int f = 0; f < kNF; ++f) r[f] = lane_of(v[f], i);
          const float dx = r[0] - px;
          const float cadx2 = r[2] * dx * dx;
          const float cbdx = r[3] * dx;
          bool keep = true;
          if constexpr (kProd) {
            keep = (t16x >= r[10]) && (t16x < r[12]) && (t16y >= r[11]) &&
                   (t16y < r[13]) && (k4 + i < n_row);
          }
#pragma unroll
          for (int m = 0; m < kPPT; ++m) {
            cell<kExp, kScan, kMxu, kProd>(r, dx, cadx2, cbdx, keep, p[m]);
          }
        }
      }
    }
    if constexpr (!kMxu) {
#pragma unroll
      for (int m = 0; m < kPPT; ++m) p[m].acc0 += box[6][0];
    }
  }
  float* o = out + static_cast<size_t>(sub) * kPix + tid;
#pragma unroll
  for (int m = 0; m < kPPT; ++m) {
    o[m * kThreads] =
        ((p[m].acc0 + p[m].acc1) + p[m].acc2) + p[m].acc3 + p[m].T;
  }
}

// ---------------------------------------------------------------------------
// abl16_<variant>_group: the yardstick, one CTA per 32x32 group
// ---------------------------------------------------------------------------

template <bool kExp, bool kScan, bool kMxu, bool kTrans, bool kDyn,
          bool kProd>
__global__ void __launch_bounds__(kPix)
abl16_group_kernel(const float* __restrict__ feat,  // (16, B)
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
          bool kProd, bool kGroup>
int launch(const void* feat, const void* ranges, void* out, int n_gx,
           int n_gy, int W, int H, int nc, int B, void* stream) {
  if (n_gx * n_gy <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const int* r = static_cast<const int*>(ranges);
  float* o = static_cast<float*>(out);
  if constexpr (kGroup) {
    abl16_group_kernel<kExp, kScan, kMxu, kTrans, kDyn, kProd>
        <<<n_gx * n_gy, kPix, 0, s>>>(f, r, o, n_gx, W, H, nc, B);
  } else {
    abl16_subtile_kernel<kExp, kScan, kMxu, kTrans, kDyn, kProd>
        <<<4 * n_gx * n_gy, kThreads, 0, s>>>(f, r, o, n_gx, W, H, nc, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, loaded with ctypes, two per variant (abl16_<variant>, one CTA
// per subtile; abl16_<variant>_group, the yardstick): feat (16, B) f32,
// ranges (n_tiles16, 2) int32, out (n_gy, n_gx, 4, 256) f32; nc the fixed
// chunk count of the non-dynamic variants. Launch on ``stream`` and
// return cudaGetLastError().
#define ABL16_ENTRY(NAME, EXP, SCAN, MXU, TRANS, DYN, PROD, GROUP)          \
  extern "C" int NAME(const void* feat, const void* ranges, void* out,      \
                      int n_gx, int n_gy, int W, int H, int nc, int B,      \
                      void* stream) {                                       \
    return launch<EXP, SCAN, MXU, TRANS, DYN, PROD, GROUP>(                 \
        feat, ranges, out, n_gx, n_gy, W, H, nc, B, stream);                \
  }
#define ABL16_ENTRIES(V, EXP, SCAN, MXU, TRANS, DYN, PROD)                  \
  ABL16_ENTRY(abl16_##V, EXP, SCAN, MXU, TRANS, DYN, PROD, false)           \
  ABL16_ENTRY(abl16_##V##_group, EXP, SCAN, MXU, TRANS, DYN, PROD, true)

ABL16_ENTRIES(full, true, true, true, true, false, false)
ABL16_ENTRIES(noexp, false, true, true, true, false, false)
ABL16_ENTRIES(noscan, true, false, true, true, false, false)
ABL16_ENTRIES(nomxu, true, true, false, true, false, false)
ABL16_ENTRIES(notrans, true, true, true, false, false, false)
ABL16_ENTRIES(minimal, false, false, false, false, false, false)
ABL16_ENTRIES(dyn, true, true, true, true, true, false)
ABL16_ENTRIES(prodbody, true, true, true, true, true, true)
