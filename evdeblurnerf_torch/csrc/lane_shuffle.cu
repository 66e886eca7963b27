// Per-ray sample gathers of the c2f renderer: kernels K1, K2 and K3.
//
// K1 permute_lanes: out[r, j] = x[r, idx[r, j]]
//   Replaces evdeblurnerf_tpu/ops/lane_shuffle.py::_take2d_kernel (Pallas,
//   via _lane_take_2d and permute_lanes): moves sigma into depth order and
//   the weights back into evaluation order (models/voxnerf.py:287,291).
//   Its gradient is the same kernel launched with the inverse permutation.
//   Bound: device-memory bytes. At the eval shape [32768, 128] it reads
//   16 MiB of x and 16 MiB of int32 indices and writes 16 MiB, 50 MB in
//   all (15.7 MB at the paper step's [10240, 128]); there is no
//   arithmetic beyond addresses. Design: fill the card, 16 bytes a
//   thread, no barrier. A thread takes four consecutive outputs of one
//   row: it reads their four indices as one int4, picks the four values
//   from the row of x through the read-only path (a row of 128 floats is
//   four cache lines, which L1 serves as well as shared memory would; the
//   row is not staged) and writes one float4. At S2 = 128 that is one
//   warp a row, 10,240 rows are 1,280 blocks of 256 threads, every SM
//   holds several, and index load and store are coalesced 512-byte rows.
//   Narrower rows share a warp; any S works, since nothing is staged. An
//   S2 that is no multiple of 4, or a pointer that is not 16-byte
//   aligned, takes the scalar kernel, one thread an element. The TPU
//   kernel's 128-lane limit does not exist here.
//
// K2 permute_lanes_3d: out[r, c, j] = x[r, c, idx[r, j]], one pick per ray
//   shared by all C channels.
//   Replaces evdeblurnerf_tpu/ops/lane_shuffle.py::_take3d_kernel (Pallas,
//   via _lane_take_3d and permute_lanes): moves the fine field's per-sample
//   features [R, C, S] into depth order for AWP (models/voxnerf.py:334-340).
//   Its gradient is the same kernel launched with the inverse permutation.
//   Bound: device-memory bytes. At the paper step [10240, 128, 128] it
//   reads 671 MB and writes 671 MB (~0.4 ms at 3.35 TB/s, computed), and
//   reads the 5 MB of indices once. Design: one block per ray stages the
//   ray's indices in shared memory once; consecutive threads take
//   consecutive samples j of one channel row, so the output store is
//   coalesced and the gathered loads of a warp fall inside one 512-byte
//   row of x (four 128-byte lines, served by L1).
//
// K3 cdf_take: the four inverse-CDF gathers of sample_pdf,
//   cb = cdf[below], ca = cdf[above], bb = bins[below], ba = bins[above].
//   Replaces evdeblurnerf_tpu/ops/lane_shuffle.py::_cdf_kernel (Pallas, via
//   _cdf_take_pallas and cdf_take), called at ops/sample_pdf.py:61.
//   Bound: device-memory bytes; at R=32768, M=63, N=64 it reads ~33 MiB
//   and writes 32 MiB. Design: one warp per ray; the warp's lanes walk the
//   N draws, read both indices coalesced and write the four outputs
//   coalesced. The cdf and bins rows (252 bytes each) are read through the
//   read-only/L1 path, where the first gather of the warp brings the row in
//   and the other 63 hit. All four gathers share one index read.
//
// All three are exact (a gather copies values). An index outside
// [0, width) writes NaN instead of reading out of bounds.
#include <cmath>

#include "common.cuh"

namespace {

// 48 KiB of words: the shared memory a block may use without opting in.
constexpr int kStageFloats = 12288;

// i / per_row, by 32-bit division where the whole launch fits it.
__device__ __forceinline__ int64_t row_of(int64_t i, int64_t total,
                                          int per_row) {
  return total <= INT32_MAX ? static_cast<int>(i) / per_row : i / per_row;
}

__device__ __forceinline__ float pick(const float* __restrict__ row, int k,
                                      int S) {
  return (k >= 0 && k < S) ? __ldg(row + k) : NAN;
}

// One thread per four outputs: quads = S2 / 4 pieces a row.
__global__ void __launch_bounds__(evdn::kThreads)
permute_lanes_vec_kernel(const float* __restrict__ x,
                         const int4* __restrict__ idx4,
                         float4* __restrict__ out4, int64_t total, int S,
                         int quads) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * evdn::kThreads + threadIdx.x;
  if (i >= total) return;
  const float* row = x + row_of(i, total, quads) * S;
  const int4 k = __ldg(idx4 + i);
  out4[i] = make_float4(pick(row, k.x, S), pick(row, k.y, S),
                        pick(row, k.z, S), pick(row, k.w, S));
}

// One thread per output.
__global__ void __launch_bounds__(evdn::kThreads)
permute_lanes_scalar_kernel(const float* __restrict__ x,
                            const int32_t* __restrict__ idx,
                            float* __restrict__ out, int64_t total, int S,
                            int S2) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * evdn::kThreads + threadIdx.x;
  if (i >= total) return;
  out[i] = pick(x + row_of(i, total, S2) * S, __ldg(idx + i), S);
}

template <bool kStage>
__global__ void permute_lanes_3d_kernel(const float* __restrict__ x,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ out, int C, int S,
                                        int S2) {
  extern __shared__ int32_t stage_idx[];
  const int64_t r = blockIdx.x;
  const int32_t* ir = idx + r * S2;
  if (kStage) {
    for (int j = threadIdx.x; j < S2; j += blockDim.x) stage_idx[j] = ir[j];
    __syncthreads();
  }
  const int32_t* pick = kStage ? stage_idx : ir;
  const float* xr = x + r * C * S;
  float* orow = out + r * C * S2;
  const int64_t work = static_cast<int64_t>(C) * S2;
  for (int64_t i = threadIdx.x; i < work; i += blockDim.x) {
    const int c = static_cast<int>(i / S2);
    const int k = pick[i - static_cast<int64_t>(c) * S2];
    orow[i] = (k >= 0 && k < S) ? __ldg(xr + static_cast<int64_t>(c) * S + k)
                                : NAN;
  }
}

__global__ void cdf_take_kernel(const float* __restrict__ cdf,
                                const float* __restrict__ bins,
                                const int32_t* __restrict__ below,
                                const int32_t* __restrict__ above,
                                float* __restrict__ cb, float* __restrict__ ca,
                                float* __restrict__ bb, float* __restrict__ ba,
                                int64_t rows, int M, int Mb, int N) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                    threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* crow = cdf + r * M;
  const float* brow = bins + r * Mb;
  for (int j = lane; j < N; j += 32) {
    const int64_t o = r * N + j;
    const int lo = below[o];
    const int hi = above[o];
    cb[o] = (lo >= 0 && lo < M) ? __ldg(crow + lo) : NAN;
    ca[o] = (hi >= 0 && hi < M) ? __ldg(crow + hi) : NAN;
    bb[o] = (lo >= 0 && lo < Mb) ? __ldg(brow + lo) : NAN;
    ba[o] = (hi >= 0 && hi < Mb) ? __ldg(brow + hi) : NAN;
  }
}

}  // namespace

EVDN_API int evdn_permute_lanes(const float* x, const int32_t* idx,
                                float* out, int64_t rows, int S, int S2,
                                int device, cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (rows <= 0 || S2 <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = S2 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int64_t total = rows * (S2 / 4);
    permute_lanes_vec_kernel<<<evdn::blocks_for(total, evdn::kThreads),
                               evdn::kThreads, 0, stream>>>(
        x, reinterpret_cast<const int4*>(idx),
        reinterpret_cast<float4*>(out), total, S, S2 / 4);
  } else {
    const int64_t total = rows * S2;
    permute_lanes_scalar_kernel<<<evdn::blocks_for(total, evdn::kThreads),
                                  evdn::kThreads, 0, stream>>>(
        x, idx, out, total, S, S2);
  }
  return static_cast<int>(cudaGetLastError());
}

EVDN_API int evdn_permute_lanes_3d(const float* x, const int32_t* idx,
                                   float* out, int64_t rows, int C, int S,
                                   int S2, int device, cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (rows <= 0 || C <= 0 || S2 <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  // one block per ray: rows is at most the grid's 2^31 - 1 blocks
  if (S2 <= kStageFloats) {
    permute_lanes_3d_kernel<true>
        <<<static_cast<unsigned int>(rows), evdn::kThreads,
           static_cast<size_t>(S2) * sizeof(int32_t), stream>>>(x, idx, out,
                                                                C, S, S2);
  } else {
    permute_lanes_3d_kernel<false>
        <<<static_cast<unsigned int>(rows), evdn::kThreads, 0, stream>>>(
            x, idx, out, C, S, S2);
  }
  return static_cast<int>(cudaGetLastError());
}

EVDN_API int evdn_cdf_take(const float* cdf, const float* bins,
                           const int32_t* below, const int32_t* above,
                           float* cb, float* ca, float* bb, float* ba,
                           int64_t rows, int M, int Mb, int N, int device,
                           cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (rows <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kRowsPerBlock = evdn::kThreads / 32;
  cdf_take_kernel<<<evdn::blocks_for(rows, kRowsPerBlock), evdn::kThreads, 0,
                    stream>>>(cdf, bins, below, above, cb, ca, bb, ba, rows, M,
                              Mb, N);
  return static_cast<int>(cudaGetLastError());
}
