// Line taps: out[n, r] = prod_{a<k} lerp(line_a, coords[n, axis_a])[r] for
// k = 1 (a VM line) or k = 3 (CP's three lines), each lookup two taps of an
// f32 line table [D, R].
//
// It replaces no Pallas kernel. The JAX package looks a line up as an XLA
// dot of a dense two-tap matrix [N, D] with the line
// (tensoir_tpu/ops/interp.py:284), and the port does the same wherever a
// gradient can flow through the lookup (ops/interp.py: lerp_line_matmul),
// since the line's gradient is then a product too. Without a gradient the
// matrix is waste on this card: its fill writes D floats a point, and its
// f32 GEMM does D/2 times the work of the two taps (250x for a 500-node CP
// line), about 38 TFLOP/s with TF32 off. This kernel reads the two taps of
// each line and writes the [N, R] result once.
//
// What bounds it on the H100: bytes. A call must write N*R*4 bytes and read
// the N*12 bytes of coordinates, at 3.35 TB/s. The line tables (at most
// 3 x 500 x 288 x 4 B = 1.7 MB) stay in the 50 MB L2 and are read through
// the read-only path; the output is stored evict-first, since nothing of
// this call reads it again.
//
// The arithmetic is the matrix route's, in its order, with no contraction:
// - the node coordinate: iz = ((c + 1) * 0.5) * (D - 1), ops/interp.py's
//   _unnormalize, each step rounded (__fadd_rn, __fmul_rn);
// - clipped taps (VM): i0 = clamp(floor(iz), 0, D - 2), i1 = i0 + 1,
//   w1 = clamp(iz - i0, 0, 1);
// - extrapolating taps (CP): i0 = clamp(floor(iz), 0, D - 1),
//   i1 = min(i0 + 1, D - 1), w1 = iz - i0 unclipped; where i0 == i1 the one
//   weight is fl(fl(1 - w1) + w1), as the matrix's scatter_add_ writes it;
// - the two taps summed as the GEMM sums a row of the matrix in ascending
//   node order from zero: fma(w1, l1, fl((1 - w1) * l0));
// - CP's three lookups multiplied left to right.
//
// Layout: one thread writes 4 consecutive components of a row as a float4;
// neighbouring threads take neighbouring components of a row and then the
// next rows, so the stores are coalesced. Each thread reads its row's
// coordinates itself (the same 12 bytes for the R/4 threads of a row, from
// L1). Rows whose width is not a multiple of 4, or tables or strides not
// 16-byte aligned, take the same kernel one component a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLines = 3;

struct Lines {
  const float* line[kMaxLines];  // [D_a, R] rows, unit column stride
  int64_t ld[kMaxLines];         // row stride in floats
  int64_t d[kMaxLines];          // nodes
  int axis[kMaxLines];           // coordinate column of each line
};

// The two taps of a line at coordinate c: nodes i0, i1 and weights w0, w1;
// w1 == 0 with i1 == i0 where the taps fall on one node.
template <bool Extrapolate>
__device__ __forceinline__ void taps(float c, int64_t d, int64_t& i0,
                                     int64_t& i1, float& w0, float& w1) {
  const float dm1 = static_cast<float>(d - 1);
  const float iz = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), dm1);
  const float hi = Extrapolate ? dm1 : static_cast<float>(d - 2);
  const float f = fminf(fmaxf(floorf(iz), 0.0f), hi);
  i0 = static_cast<int64_t>(f);
  if (Extrapolate) {
    w1 = __fsub_rn(iz, f);
    w0 = __fsub_rn(1.0f, w1);
    i1 = i0 + 1 < d ? i0 + 1 : d - 1;
    if (i1 == i0) {
      w0 = __fadd_rn(w0, w1);
      w1 = 0.0f;
    }
  } else {
    w1 = fminf(fmaxf(__fsub_rn(iz, f), 0.0f), 1.0f);
    w0 = __fsub_rn(1.0f, w1);
    i1 = i0 + 1;
  }
}

__device__ __forceinline__ float tap_sum(float w0, float l0, float w1,
                                         float l1) {
  return __fmaf_rn(w1, l1, __fmul_rn(w0, l0));
}

// Work item t of a row of `per_row` items: 4 components (Vec) or 1. The
// launch keeps total <= 2^32 - 1 - kThreads, so t never wraps.
template <int K, bool Extrapolate, bool Vec>
__global__ void __launch_bounds__(kThreads)
line_taps_kernel(Lines L, const float* __restrict__ coords,
                 float* __restrict__ out, uint32_t total, uint32_t per_row) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const uint32_t row = t / per_row;
  const uint32_t item = t - row * per_row;
  const int64_t col = Vec ? 4 * static_cast<int64_t>(item)
                          : static_cast<int64_t>(item);
  const float* c = coords + 3 * static_cast<int64_t>(row);
  if (Vec) {
    float4 acc;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      int64_t i0, i1;
      float w0, w1;
      taps<Extrapolate>(__ldg(&c[L.axis[a]]), L.d[a], i0, i1, w0, w1);
      const float4 l0 =
          __ldg(reinterpret_cast<const float4*>(L.line[a] + i0 * L.ld[a] + col));
      const float4 l1 =
          __ldg(reinterpret_cast<const float4*>(L.line[a] + i1 * L.ld[a] + col));
      const float4 v = make_float4(
          tap_sum(w0, l0.x, w1, l1.x), tap_sum(w0, l0.y, w1, l1.y),
          tap_sum(w0, l0.z, w1, l1.z), tap_sum(w0, l0.w, w1, l1.w));
      if (a == 0) {
        acc = v;
      } else {
        acc = make_float4(__fmul_rn(acc.x, v.x), __fmul_rn(acc.y, v.y),
                          __fmul_rn(acc.z, v.z), __fmul_rn(acc.w, v.w));
      }
    }
    __stcs(reinterpret_cast<float4*>(out) + t, acc);
  } else {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      int64_t i0, i1;
      float w0, w1;
      taps<Extrapolate>(__ldg(&c[L.axis[a]]), L.d[a], i0, i1, w0, w1);
      const float v = tap_sum(w0, __ldg(L.line[a] + i0 * L.ld[a] + col), w1,
                              __ldg(L.line[a] + i1 * L.ld[a] + col));
      acc = a == 0 ? v : __fmul_rn(acc, v);
    }
    __stcs(out + t, acc);
  }
}

template <int K, bool Extrapolate, bool Vec>
cudaError_t launch(const Lines& L, const float* coords, float* out,
                   int64_t total, int64_t per_row, cudaStream_t stream) {
  // 32-bit work items: a refused call would write 16 GiB or more, far
  // above any caller's output
  if (total > 0xffffffffLL - kThreads) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  line_taps_kernel<K, Extrapolate, Vec><<<grid, kThreads, 0, stream>>>(
      L, coords, out, static_cast<uint32_t>(total),
      static_cast<uint32_t>(per_row));
  return cudaGetLastError();
}

template <int K, bool Extrapolate>
cudaError_t dispatch_vec(const Lines& L, const float* coords, float* out,
                         int64_t n, int64_t r, bool vec, cudaStream_t s) {
  return vec ? launch<K, Extrapolate, true>(L, coords, out, n * (r / 4),
                                            r / 4, s)
             : launch<K, Extrapolate, false>(L, coords, out, n * r, r, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// lines: k (1 or 3) f32 tables [D_a, R] at line0..2 with row strides
// ld0..2 (floats) and nodes d0..2, looked up at coords[:, axis_a]; coords
// [N, 3] and out [N, R] contiguous f32, all on the current device.
// extrapolate: CP's taps (1) or VM's clipped taps (0). Returns the
// cudaError_t of the launch (0 = success); on empty input nothing launches;
// more than 2^32 - 1 - 256 work items (N * R / 4, or N * R for rows that
// take one component a thread) are refused (cudaErrorInvalidValue).
extern "C" int line_taps_f32(const void* line0, const void* line1,
                             const void* line2, int64_t ld0, int64_t ld1,
                             int64_t ld2, int64_t d0, int64_t d1, int64_t d2,
                             int axis0, int axis1, int axis2, int k,
                             int extrapolate, const void* coords, void* out,
                             int64_t n, int64_t r, void* stream) {
  if (k != 1 && k != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || r == 0) return static_cast<int>(cudaGetLastError());
  Lines L;
  const void* lines[kMaxLines] = {line0, line1, line2};
  const int64_t lds[kMaxLines] = {ld0, ld1, ld2};
  const int64_t ds[kMaxLines] = {d0, d1, d2};
  const int axes[kMaxLines] = {axis0, axis1, axis2};
  bool vec = (r % 4 == 0) && aligned16(out);
  for (int a = 0; a < kMaxLines; ++a) {
    L.line[a] = static_cast<const float*>(lines[a]);
    L.ld[a] = lds[a];
    L.d[a] = ds[a];
    L.axis[a] = axes[a];
    if (a < k) vec = vec && aligned16(lines[a]) && (lds[a] % 4 == 0);
  }
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 1) {
    err = extrapolate ? dispatch_vec<1, true>(L, c, o, n, r, vec, s)
                      : dispatch_vec<1, false>(L, c, o, n, r, vec, s);
  } else {
    err = extrapolate ? dispatch_vec<3, true>(L, c, o, n, r, vec, s)
                      : dispatch_vec<3, false>(L, c, o, n, r, vec, s);
  }
  return static_cast<int>(err);
}
