// Line-table gradient accumulation: kernel K6.
//
// line_grad: out[d, w] += sum_n [idx[n] == d] * g[n, w]
//   Replaces evdeblurnerf_tpu/ops/line_matmul.py::_grad_kernel (Pallas, via
//   line_grad_matmul and take_rows_line). It reduces the per-point packed
//   line-row cotangents that K5 writes ([N, 2C], fused_sample.cu) into the
//   packed line-table gradient [D, 2C]. The TPU kernel runs the reduction
//   as a one-hot matmul on the MXU, over a sequential grid that keeps the
//   [D, W] output resident in VMEM.
//   Bound: the one read of g. At the paper step the fine line tables are
//   D = 366/605/605 rows of W = 128/32/32 floats, and g is 671 MB for the
//   128-wide table at 1.31 M points. Design: on Hopper blocks run in
//   parallel and cannot carry a sum from one grid step to the next, so
//   each block takes a chunk of points, accumulates its [D, Wt] tile in
//   shared memory with shared-memory atomics (a row of g is read
//   coalesced, one column per thread), and then adds each nonzero entry of
//   its tile to the output with one device atomic. Tables wider than the
//   48 KiB shared-memory tile are split over W along the grid's second
//   axis, each split re-reading only its own columns of g.
//   Exactness: f32 sums in another order than the one-hot matmul's, and an
//   order that varies from run to run with the atomics. Indices outside
//   [0, D) add nothing, as a one-hot row of zeros would.
#include <algorithm>

#include "common.cuh"

namespace {

// 48 KiB of floats: the shared memory a block may use without opting in.
constexpr int kTileFloats = 12288;
constexpr int kPointsPerBlock = 4096;

__global__ void line_grad_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ g,
                                 float* __restrict__ out, int64_t n, int D,
                                 int W, int Wt) {
  extern __shared__ float acc[];
  const int w0 = blockIdx.y * Wt;
  const int wt = min(Wt, W - w0);
  const int tile = D * wt;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPointsPerBlock;
  const int64_t np = min(static_cast<int64_t>(kPointsPerBlock), n - p0);
  const int64_t work = np * wt;
  for (int64_t i = threadIdx.x; i < work; i += blockDim.x) {
    const int64_t pn = p0 + i / wt;
    const int w = static_cast<int>(i % wt);
    const int d = __ldg(idx + pn);
    if (d >= 0 && d < D) atomicAdd(acc + d * wt + w, __ldg(g + pn * W + w0 + w));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(out + (i / wt) * W + w0 + i % wt, v);
  }
}

}  // namespace

EVDN_API int evdn_line_grad(const int32_t* idx, const float* g, float* out,
                            int64_t n, int D, int W, int device,
                            cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (n <= 0 || D <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kTileFloats) return static_cast<int>(cudaErrorInvalidValue);
  const int Wt = std::min(W, kTileFloats / D);
  const dim3 grid(evdn::blocks_for(n, kPointsPerBlock),
                  evdn::blocks_for(W, Wt));
  line_grad_kernel<<<grid, evdn::kThreads,
                     static_cast<size_t>(D) * Wt * sizeof(float), stream>>>(
      idx, g, out, n, D, W, Wt);
  return static_cast<int>(cudaGetLastError());
}
