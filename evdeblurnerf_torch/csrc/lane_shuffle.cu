// Per-ray sample gathers of the c2f renderer: kernels K1, K2 and K3.
//
// K1 permute_lanes: out[r, j] = x[r, idx[r, j]]
//   Replaces evdeblurnerf_tpu/ops/lane_shuffle.py::_take2d_kernel (Pallas,
//   via _lane_take_2d and permute_lanes): moves sigma into depth order and
//   the weights back into evaluation order (models/voxnerf.py:287,291).
//   Its gradient is the same kernel launched with the inverse permutation.
//   Bound: device-memory bytes. At the eval shape [32768, 128] it reads
//   16 MiB of x and 16 MiB of indices and writes 16 MiB, with 2 flops of
//   address arithmetic per element. Design: a block stages whole rows of x
//   in shared memory with coalesced loads, then every thread gathers from
//   shared memory and writes its output coalesced, so the random pick
//   never touches device memory. The TPU kernel's 128-lane limit does not
//   exist here: rows wider than the shared-memory budget are gathered
//   straight from device memory (through L1) instead.
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
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

// 48 KiB of floats: the shared memory a block may use without opting in.
constexpr int kStageFloats = 12288;
constexpr int kMaxRowsPerBlock = 64;

template <bool kStage>
__global__ void permute_lanes_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int64_t rows,
                                     int S, int S2, int rows_per_block) {
  extern __shared__ float stage[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = rows - row0;
  const int nrows =
      left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const float* xb = x + row0 * S;
  if (kStage) {
    for (int i = threadIdx.x; i < nrows * S; i += blockDim.x) stage[i] = xb[i];
    __syncthreads();
  }
  const float* src = kStage ? stage : xb;
  const int32_t* ib = idx + row0 * S2;
  float* ob = out + row0 * S2;
  for (int i = threadIdx.x; i < nrows * S2; i += blockDim.x) {
    const int r = i / S2;
    const int k = ib[i];
    ob[i] = (k >= 0 && k < S) ? src[static_cast<int64_t>(r) * S + k] : NAN;
  }
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
  if (S <= kStageFloats) {
    const int rpb =
        std::max(1, std::min(kMaxRowsPerBlock, kStageFloats / std::max(S, 1)));
    const size_t smem = static_cast<size_t>(rpb) * S * sizeof(float);
    permute_lanes_kernel<true>
        <<<evdn::blocks_for(rows, rpb), evdn::kThreads, smem, stream>>>(
            x, idx, out, rows, S, S2, rpb);
  } else {
    permute_lanes_kernel<false>
        <<<evdn::blocks_for(rows, 1), evdn::kThreads, 0, stream>>>(
            x, idx, out, rows, S, S2, 1);
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
