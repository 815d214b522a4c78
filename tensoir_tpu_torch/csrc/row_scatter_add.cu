// K2 row scatter-add: out = zeros(R, C); out[idx[i], :] += val[i, :]
// (f32 rows; int32 or int64 indices)
//
// Replaces the Pallas TPU kernel `make_scatter_add` (its inner `kernel`,
// scripts/bench_pallas_scatter.py:37-47; pl.pallas_call at :52). On the TPU
// the accumulator table stayed resident in VMEM across the sequential grid,
// was zeroed at grid step 0, and took one row add per loop step. In the
// port it is the backward of K1 at the corner-packed VM plane lookup: the
// gradient of the packed plane table.
//
// What bounds it on the H100: bytes, and the atomics' throughput in L2. A
// call must read N indices and N*C floats and write R*C floats. The
// accumulator (4 MB for a density plane, 12 MB for an appearance plane)
// stays in the 50 MB L2, where the f32 atomic adds are resolved.
//
// Design: Hopper's blocks run in no order, so nothing like the TPU's
// resident accumulator carries from one block to the next. The output is
// zeroed with one memset on the stream, then every block takes kRows
// consecutive value rows, loads their indices into shared memory once, and
// its threads add each element with an f32 atomicAdd (a fire-and-forget RED
// in L2, since the result is unused). Reads of `val` are coalesced. The order
// of the adds into one row changes from run to run, so sums agree with a
// sequential sum to f32 rounding, not bit for bit. A sorted segmented reduce
// that needs no atomics is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;

template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
row_scatter_add_kernel(const IdxT* __restrict__ idx,
                       const float* __restrict__ val, float* __restrict__ out,
                       int64_t n, int c) {
  __shared__ int64_t rows[kRows];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t left = n - row0;
  const int nrows = left < kRows ? static_cast<int>(left) : kRows;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    rows[r] = static_cast<int64_t>(idx[row0 + r]);
  }
  __syncthreads();
  const int total = nrows * c;
  const float* src = val + row0 * c;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t / c;
    const int col = t - r * c;
    atomicAdd(&out[rows[r] * c + col], __ldg(&src[t]));
  }
}

}  // namespace

// idx [N], val [N, C], out [R, C]; all contiguous on the current device.
// Zeroes `out` on the stream first. Returns the cudaError_t (0 = success).
extern "C" int row_scatter_add_f32(const void* idx, int idx_is_int64,
                                   const void* val, void* out, int64_t n,
                                   int64_t num_rows, int64_t c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, num_rows * c * sizeof(float), s);
  if (err != cudaSuccess || n == 0 || c == 0) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  if (idx_is_int64) {
    row_scatter_add_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(idx), v, o, n, static_cast<int>(c));
  } else {
    row_scatter_add_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), v, o, n, static_cast<int>(c));
  }
  return static_cast<int>(cudaGetLastError());
}
