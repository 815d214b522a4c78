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
// gathered 16-byte row costs a 32-byte sector read from device memory, so
// its true floor is N * (4 + 16 + 32) bytes.
//
// The copy moves bytes, not values, in one of three routes:
// - narrow rows (a multiple of 16 bytes, at most 64, both pointers 16-byte
//   aligned): every thread owns one whole row, so a warp reads 32
//   consecutive indices and writes 32 consecutive rows. It loads its index,
//   issues the row's 16-byte read-only loads (ld.global.nc), then stores
//   them. No shared memory, no barrier and no idle thread: the wide-row
//   kernel below gives a 16-byte row to one thread in four of its block and
//   stages the indices first, which leaves an SM a quarter of the loads in
//   flight that this route keeps. (Owning 2, 4 or 8 rows per thread, with
//   all loads issued before the stores, measured no faster.)
// - wide rows (a multiple of 16 bytes, over 64): every block takes kRows
//   consecutive rows, loads their indices into shared memory once, then its
//   threads copy 16-byte pieces; neighbouring threads take neighbouring
//   pieces of a row and then the next row, so the writes are coalesced.
// - any other row (not a multiple of 16 bytes, or a misaligned pointer):
//   the wide-row kernel, one element per thread.
// The kernel does not clamp: the callers clip their indices into range, and
// the plain version and the tests check the range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kNarrowPieces = 4;  // 16-byte pieces in the widest narrow row

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

// One row of CV 16-byte pieces per thread.
template <typename IdxT, int CV>
__global__ void __launch_bounds__(kThreads)
row_gather_narrow_kernel(const uint4* __restrict__ table,
                         const IdxT* __restrict__ idx,
                         uint4* __restrict__ out, int64_t n) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint4* src = table + static_cast<int64_t>(idx[r]) * CV;
  uint4 v[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) v[j] = __ldg(&src[j]);
#pragma unroll
  for (int j = 0; j < CV; ++j) out[r * CV + j] = v[j];
}

template <typename IdxT, int CV>
void launch_narrow(const void* table, const void* idx, void* out, int64_t n,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  row_gather_narrow_kernel<IdxT, CV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(table), static_cast<const IdxT*>(idx),
      static_cast<uint4*>(out), n);
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
  const int64_t cv = row_bytes / 16;
  if (vec && cv <= kNarrowPieces) {
    switch (cv) {
      case 1: launch_narrow<IdxT, 1>(table, idx, out, n, stream); break;
      case 2: launch_narrow<IdxT, 2>(table, idx, out, n, stream); break;
      case 3: launch_narrow<IdxT, 3>(table, idx, out, n, stream); break;
      default: launch_narrow<IdxT, 4>(table, idx, out, n, stream); break;
    }
  } else if (vec) {
    row_gather_kernel<IdxT, uint4><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(table), static_cast<const IdxT*>(idx),
        static_cast<uint4*>(out), n, static_cast<int>(cv));
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
// are). A row of 8 bf16 corners is one 16-byte piece: the narrow route.
extern "C" int row_gather_b16(const void* table, const void* idx,
                              int idx_is_int64, void* out, int64_t n,
                              int64_t c, void* stream) {
  return gather<unsigned short>(table, idx, idx_is_int64, out, n, c, stream);
}
