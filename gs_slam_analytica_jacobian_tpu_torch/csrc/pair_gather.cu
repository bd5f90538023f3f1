// The renderer's per-pair feature gather and its transpose, the
// per-Gaussian segment sum, for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel. The JAX package writes both in plain jnp
// (gs_slam_analytica_jacobian_tpu/ops/pair_gather.py: _fwd_impl, a
// packed row gather, and _pg_bwd / segment_reduce_pairs, a gather into
// emission order, a cumsum over the whole pair capacity and two (N, F)
// gathers of the prefix sums), which XLA fuses on the TPU. Run eagerly
// that chain walks the fixed capacity (2^20 pairs at 640x480), not the
// live pairs: torch's innermost-dimension scan gives each of the F = 16
// rows to one block, and its 16-byte gather is bound by scheduling
// blocks, ~3.3 ms a rendered view on the H100 for ~50 us of bytes.
//
// pair_gather_fwd: feat[a] = table[gid1[a] - 1], zero where gid1[a] == 0,
// one thread a (aligned slot, 16-byte quarter of the row) with float4
// loads and stores (one a (slot, float) where the table's rows are not
// float4-aligned). Every slot is written, dead ones too: the compositing
// kernels stage whole chunks. A copy, so bit-equal to the plain version.
//
// segment_reduce_fwd: every Gaussian's pairs are one contiguous emission
// segment [seg_start[g], min(seg_end[g], capacity)). A group of F / 4
// lanes (F for rows read one float at a time; one lane at F = 1) walks
// its Gaussian's segment in emission order and adds values[aligned_of_em[e]]
// wherever aligned_of_em[e] < B_al (culled, dropped and overflowed pairs
// are skipped, as the plain version's mask skips them), then writes the
// (N, F) row once. No scan, no atomics and no second pass: the sum order
// is fixed, so two runs on one input are bit-identical, and each term is
// added directly instead of taken as the difference of two prefix sums
// over up to 2^20 terms. Emission slots past num_pairs are never read.
// Each lane loads four indices ahead and then their four rows, so that
// four row reads are in flight at once; the adds keep emission order.
//
// What bounds them on the H100: device memory. The forward writes B_al
// rows (64 B each at F = 16; 69.6 MB at 2^20 + 300 * 128 slots) and reads
// the live pairs' table rows (the table, 16.8 MB at 2^18 slots, sits in
// L2); the backward reads the live pairs' indices (4 B) and rows (64 B)
// and writes the (N, F) table gradient. Strides are arguments: a
// gradient or a table at any strides is read in place.
//
// Built with -fmad=false like every source here; only float additions.

#include <cuda_runtime.h>

namespace pg {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // indices (and rows) a lane loads ahead

__device__ __forceinline__ void add(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void add(float& acc, float v) { acc += v; }

template <int VEC>
struct Row;

template <>
struct Row<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Row<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
};

// thread t -> (slot a, lane q) with f / VEC lanes a slot; the lane's first
// column is q * VEC (contiguous columns at VEC = 4, column stride 1)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ gid1,
                  const float* __restrict__ table, long long t_s0,
                  long long t_s1, float* __restrict__ feat, int b_al,
                  int f) {
  using R = Row<VEC>;
  const int lanes = f / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)b_al * lanes) return;
  const int a = (int)(t / lanes);
  const int q = (int)(t - (long long)a * lanes);
  const int g = __ldg(gid1 + a);
  typename R::T v = R::zero();
  if (g > 0) v = R::load(table + (long long)(g - 1) * t_s0 + q * VEC * t_s1);
  R::store(feat + (long long)a * f + q * VEC, v);
}

// thread t -> (Gaussian g, lane q); out is (n, f) contiguous
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const int* __restrict__ seg_start,
                   const int* __restrict__ seg_end,
                   const int* __restrict__ aligned_of_em,
                   const float* __restrict__ values, long long v_s0,
                   long long v_s1, float* __restrict__ out, int n, int f,
                   int capacity, int b_al) {
  using R = Row<VEC>;
  const int lanes = f / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * lanes) return;
  const int g = (int)(t / lanes);
  const int q = (int)(t - (long long)g * lanes);
  const int lo = min(__ldg(seg_start + g), capacity);
  const int hi = min(__ldg(seg_end + g), capacity);
  const float* col = values + q * VEC * v_s1;
  typename R::T acc = R::zero();
  for (int e = lo; e < hi; e += kAhead) {
    int a[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      a[u] = e + u < hi ? __ldg(aligned_of_em + e + u) : b_al;
    typename R::T v[kAhead] = {R::zero(), R::zero(), R::zero(), R::zero()};
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (a[u] < b_al) v[u] = R::load(col + (long long)a[u] * v_s0);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (a[u] < b_al) add(acc, v[u]);
  }
  R::store(out + (long long)g * f + q * VEC, acc);
}

inline unsigned blocks(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace pg

// feat (b_al, f) contiguous from table (N, f) at element strides t_s0,
// t_s1 and gid1 (b_al,) int32; vec 4 needs f % 4 == 0, t_s1 == 1, t_s0 %
// 4 == 0 and a 16-byte-aligned table, vec 1 takes any strides.
extern "C" int pair_gather_fwd(const void* gid1, const void* table,
                               long long t_s0, long long t_s1, void* feat,
                               int b_al, int f, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) || f % vec != 0 || f <= 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)b_al * (f / vec);
  if (threads == 0) return 0;
  if (vec == 4)
    pg::gather_kernel<4><<<pg::blocks(threads), pg::kThreads, 0, st>>>(
        (const int*)gid1, (const float*)table, t_s0, t_s1, (float*)feat,
        b_al, f);
  else
    pg::gather_kernel<1><<<pg::blocks(threads), pg::kThreads, 0, st>>>(
        (const int*)gid1, (const float*)table, t_s0, t_s1, (float*)feat,
        b_al, f);
  return (int)cudaGetLastError();
}

// out (n, f) contiguous: each Gaussian's sum of values (b_al, f) at
// element strides v_s0, v_s1 over its emission segment; seg_start,
// seg_end (n,) and aligned_of_em (capacity,) int32. vec as above.
extern "C" int segment_reduce_fwd(const void* seg_start, const void* seg_end,
                                  const void* aligned_of_em,
                                  const void* values, long long v_s0,
                                  long long v_s1, void* out, int n, int f,
                                  int capacity, int b_al, int vec,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) || f % vec != 0 || f <= 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)n * (f / vec);
  if (threads == 0) return 0;
  if (vec == 4)
    pg::segment_kernel<4><<<pg::blocks(threads), pg::kThreads, 0, st>>>(
        (const int*)seg_start, (const int*)seg_end,
        (const int*)aligned_of_em, (const float*)values, v_s0, v_s1,
        (float*)out, n, f, capacity, b_al);
  else
    pg::segment_kernel<1><<<pg::blocks(threads), pg::kThreads, 0, st>>>(
        (const int*)seg_start, (const int*)seg_end,
        (const int*)aligned_of_em, (const float*)values, v_s0, v_s1,
        (float*)out, n, f, capacity, b_al);
  return (int)cudaGetLastError();
}
