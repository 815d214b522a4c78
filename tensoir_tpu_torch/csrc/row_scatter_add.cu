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
// What bounds it on the H100: bytes, and L2. A call must read N indices and
// N*C floats and write R*C floats. The accumulator (4 MB for a density
// plane, 19 MB for a relight appearance plane) stays in the 50 MB L2, where
// the atomic adds are resolved, so besides the values streaming in from
// device memory, L2 also takes one atomic payload per value that reaches
// it. In the training step the index stream is clustered: neighbouring
// samples of a ray fall into one plane cell, and a ray's appearance points
// into a few cells, so many atomics of one warp land on the same row.
//
// Design: Hopper's blocks run in no order, so nothing like the TPU's
// resident accumulator carries from one block to the next. The output is
// zeroed with one memset on the stream. Then every block takes kChunk = 32
// consecutive entries, one warp's worth: the warp reads their indices and
// groups the lanes that share an index (__match_any_sync), led by the
// lowest lane. The block's threads then take (group, 16-byte column group)
// items, neighbouring threads neighbouring groups of one row, so the reads
// of `val` are coalesced. Each item sums its group's float4 values in
// registers, in index order, up to four loads in flight, and issues ONE
// 128-bit vector atomic (atomicAdd on float4, which compute capability 9.x
// has on global memory). That is 4x fewer atomic instructions than one scalar
// atomic per element on any stream, and one per distinct row of a warp on
// the step's clustered ones. `val` is read with the evict-first hint
// (ld.global.cs), so that the values streaming through L2 do not push the
// accumulator's lines out. Rows whose C is not a multiple of 4, or whose
// `val` or `out` is not 16-byte aligned, take the same kernel with one float
// per item and scalar atomics.
//
// The sum is still order-dependent: groups that meet on one row from
// several blocks add in the order the blocks reach L2, which changes from
// run to run. So sums agree with a sequential sum to f32 rounding, not bit
// for bit: the same tolerance as before (2 * n_max * eps * max|v| in
// chip_smoke.py, 1e-5 in the tests). A counting-sort segmented reduce would
// be deterministic and need no memset, at 3-4 launches per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;           // entries per block: one warp's lanes

__device__ __forceinline__ void add_to(float* dst, float v) {
  atomicAdd(dst, v);
}

__device__ __forceinline__ void add_to(float4* dst, float4 v) {
  atomicAdd(dst, v);
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float plus(float a, float b) { return a + b; }

// VecT is float4 (cg = C / 4 column groups) or float (cg = C).
template <typename IdxT, typename VecT>
__global__ void __launch_bounds__(kThreads)
row_scatter_add_kernel(const IdxT* __restrict__ idx,
                       const VecT* __restrict__ val, VecT* __restrict__ out,
                       int64_t n, int cg) {
  __shared__ int64_t group_row[kChunk];
  __shared__ unsigned group_lanes[kChunk];
  __shared__ int num_groups;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t left = n - e0;
  const int nrows = left < kChunk ? static_cast<int>(left) : kChunk;
  const int t = threadIdx.x;

  if (t < 32) {
    const long long row = t < nrows ? static_cast<long long>(idx[e0 + t]) : -1;
    // the lanes whose entries share this entry's index form one group, led
    // by its lowest lane
    const unsigned same = __match_any_sync(0xffffffffu, row);
    const bool lead = t < nrows && t == __ffs(same) - 1;
    const unsigned leads = __ballot_sync(0xffffffffu, lead);
    if (lead) {
      const int gi = __popc(leads & ((1u << t) - 1u));
      group_row[gi] = row;
      group_lanes[gi] = same;
    }
    if (t == 0) num_groups = __popc(leads);
  }
  __syncthreads();

  const VecT* src = val + e0 * cg;
  const int items = num_groups * cg;
  for (int it = t; it < items; it += kThreads) {
    const int gi = it / cg;
    const int g = it - gi * cg;
    unsigned m = group_lanes[gi];
    const int first = __ffs(m) - 1;
    m &= m - 1;
    VecT sum = __ldcs(&src[static_cast<int64_t>(first) * cg + g]);
    // the other members in lane (= index) order, four loads at a time
    while (m) {
      int lane[4];
      bool ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ok[k] = m != 0;
        lane[k] = ok[k] ? __ffs(m) - 1 : first;
        m &= m - 1;
      }
      VecT v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (ok[k]) v[k] = __ldcs(&src[static_cast<int64_t>(lane[k]) * cg + g]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (ok[k]) sum = plus(sum, v[k]);
      }
    }
    add_to(&out[group_row[gi] * cg + g], sum);
  }
}

template <typename IdxT>
void launch(const IdxT* idx, const void* val, void* out, int64_t n, int64_t c,
            cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kChunk - 1) / kChunk);
  const bool vec = (c % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(val) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    row_scatter_add_kernel<IdxT, float4><<<blocks, kThreads, 0, s>>>(
        idx, static_cast<const float4*>(val), static_cast<float4*>(out), n,
        static_cast<int>(c / 4));
  } else {
    row_scatter_add_kernel<IdxT, float><<<blocks, kThreads, 0, s>>>(
        idx, static_cast<const float*>(val), static_cast<float*>(out), n,
        static_cast<int>(c));
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
  if (idx_is_int64) {
    launch(static_cast<const int64_t*>(idx), val, out, n, c, s);
  } else {
    launch(static_cast<const int32_t*>(idx), val, out, n, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
