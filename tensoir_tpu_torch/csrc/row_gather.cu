// K1 row gather: out[i, :] = table[idx[i], :]  (f32 or 2-byte rows; int32 or
// int64 indices)
//
// Replaces the Pallas TPU kernel `make_gather` (its inner `kernel`,
// scripts/bench_pallas_scatter.py:78-84; pl.pallas_call at :89). On the TPU
// the whole table sat in VMEM and the indices streamed through SMEM in
// chunks, one row copy per loop step. In the port it serves the
// corner-packed VM plane lookup (ops/interp.py: bilerp_plane_packed), the
// site of `jnp.take(packed, ...)` in the JAX package, with f32 rows, and the
// corner-packed trilinear lookups of the baked sigma grid and the alpha mask
// (models/field.py: density_feature_packed), with bf16 rows of 8 corners.
//
// What bounds it on the H100: bytes. A call must read N indices and write
// N*C elements. An f32 plane table (15876 x 64 f32 = 4 MB for a density
// plane, 12 MB for an appearance plane) fits in the 50 MB L2, so device
// memory sees it about once; the output write is the traffic that counts.
// The bf16 baked grid (157^3 rows x 16 B = 62 MB) does not fit: every
// gathered 16-byte row costs a 32-byte sector read from device memory.
//
// Design: every block takes kRows consecutive rows, loads their indices into
// shared memory once, then its threads copy the rows. Neighbouring threads
// handle neighbouring 16-byte pieces of a row and then the next row, so the
// output writes are fully coalesced. The copy moves bytes, not values: where
// the row is a multiple of 16 bytes and both pointers are 16-byte aligned
// each thread moves a uint4 (one whole bf16 row of 8 corners, or 4 floats),
// otherwise one element. The kernel does not clamp: the callers clip their
// indices into range, and the plain version and the tests check the range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;

template <typename IdxT, typename VecT>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const VecT* __restrict__ table, const IdxT* __restrict__ idx,
                  VecT* __restrict__ out, int64_t n, int cv) {
  __shared__ int64_t rows[kRows];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t left = n - row0;
  const int nrows = left < kRows ? static_cast<int>(left) : kRows;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    rows[r] = static_cast<int64_t>(idx[row0 + r]);
  }
  __syncthreads();
  const int total = nrows * cv;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t / cv;
    const int c = t - r * cv;
    out[(row0 + r) * cv + c] = __ldg(&table[rows[r] * cv + c]);
  }
}

// ElemT is the element as the kernel copies it when the row cannot be moved
// in 16-byte pieces: float for f32 rows, unsigned short for 2-byte rows.
template <typename IdxT, typename ElemT>
cudaError_t launch(const void* table, const void* idx, void* out, int64_t n,
                   int64_t c, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  const int64_t row_bytes = c * static_cast<int64_t>(sizeof(ElemT));
  const bool vec = (row_bytes % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    row_gather_kernel<IdxT, uint4><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(table), static_cast<const IdxT*>(idx),
        static_cast<uint4*>(out), n, static_cast<int>(row_bytes / 16));
  } else {
    row_gather_kernel<IdxT, ElemT><<<blocks, kThreads, 0, stream>>>(
        static_cast<const ElemT*>(table), static_cast<const IdxT*>(idx),
        static_cast<ElemT*>(out), n, static_cast<int>(c));
  }
  return cudaGetLastError();
}

template <typename ElemT>
int gather(const void* table, const void* idx, int idx_is_int64, void* out,
           int64_t n, int64_t c, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx_is_int64 ? launch<int64_t, ElemT>(table, idx, out, n, c, s)
                   : launch<int32_t, ElemT>(table, idx, out, n, c, s);
  return static_cast<int>(err);
}

}  // namespace

// table [R, C], idx [N], out [N, C]; all contiguous on the current device.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int row_gather_f32(const void* table, const void* idx,
                              int idx_is_int64, void* out, int64_t n,
                              int64_t c, void* stream) {
  return gather<float>(table, idx, idx_is_int64, out, n, c, stream);
}

// The same for 2-byte elements (bf16 or f16: the bytes are copied as they
// are). A row of 8 bf16 corners is one uint4 per thread.
extern "C" int row_gather_b16(const void* table, const void* idx,
                              int idx_is_int64, void* out, int64_t n,
                              int64_t c, void* stream) {
  return gather<unsigned short>(table, idx, idx_is_int64, out, n, c, stream);
}
