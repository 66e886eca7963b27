// Line-table gradient accumulation: kernel K6.
//
// line_grad: out[d, w] += sum_n [idx[n] == d] * g[n, w]
//   Replaces evdeblurnerf_tpu/ops/line_matmul.py::_grad_kernel (Pallas, via
//   line_grad_matmul and take_rows_line). It reduces the per-point packed
//   line-row cotangents that K5 writes ([N, 2C], fused_sample.cu) into the
//   line-table gradient, for the line tables that K5's fused kernel cannot
//   hold in its own shared memory. The TPU kernel runs the reduction as a
//   one-hot matmul on the MXU, over a sequential grid that keeps the
//   [D, W] output resident in VMEM.
//   Bound: the one read of g. At the paper step the fine line tables are
//   D = 366/605/605 rows of W = 128/32/32 floats, and g is 671 MB for the
//   128-wide table at 1.31 M points.
//   Design: the output stays resident here too. A block opts in to
//   Hopper's large dynamic shared memory (227 KB), which holds the whole
//   [D, W] tile at every paper shape (366 x 128 floats = 187 KB), and the
//   grid is persistent: about one block a multiprocessor, each walking one
//   contiguous slab of points, so a launch zeroes and flushes ~132 tiles
//   whatever N is. A table above the budget is split, along W in groups of
//   128 columns (512 bytes, so no split cuts a 128-byte sector) and along
//   D in ranges of rows; a D-split loads only the rows of g whose index
//   falls in its range. No size is refused.
//   Inside a block, groups of 32 lanes each walk a contiguous run of
//   points. A lane owns the columns lane, lane + 32, ... of the tile, so a
//   row of g is read as full 128-byte lines and the tile's row is touched
//   without bank conflicts; 16 loads are in flight a thread (four points
//   ahead on a 128-column tile, sixteen on a 32-column one). A group keeps
//   its sum in registers while the row index does not change and adds to
//   the tile only when it does: on a ray-ordered stream the lines that
//   follow x and y keep their row for several points on end, the line
//   along the ray changes it at nearly every one.
//   Shared-memory atomicAdd(float) is no native instruction on this card:
//   it compiles to a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS),
//   which only retries when two groups hit the same address
//   at once. The run sums in registers, the conflict-free column ownership
//   and one tile a multiprocessor (32 groups, not thousands of threads,
//   per tile) keep those retries rare.
//   Flush: a tile whose rows are whole rows of a [D, W] output (W a
//   multiple of 4, no split along W) is laid out as the output and leaves
//   in one bulk reduce-add (cp.reduce.async.bulk ... .add.f32, the TMA
//   unit adds 187 KB into the L2 with no thread busy): 3-4% under a flush
//   by per-entry atomics on the one-table entry (PERF.md). Otherwise each
//   nonzero tile entry goes to the output with one device atomic,
//   coalesced along the output's fastest axis. With `fold` the output is
//   the RAW line gradient [C, D] (W = 2C): packed row d holds texels
//   (d, d + 1), so entry (d, w) adds to out[w mod C, d + w / C], which is
//   the pack_line VJP, and the last row's second slot, which packs the
//   zero padding, adds nothing; its runs along D start on no 16-byte
//   boundary, so it flushes by atomics, and for that transposed walk the
//   tile's row stride is odd.
//   Up to three tables that share N go in one launch: the blocks are
//   dealt out in proportion to the tables' widths.
//   Exactness: f32 sums in another order than the one-hot matmul's, and an
//   order that varies from run to run with the atomics. Indices outside
//   [0, D) add nothing, as a one-hot row of zeros would.
//   Precision (line_grad only): "highest" sums g as it is; "default", the
//   TPU kernel's other option (line_matmul.py:19-23,49-53 there, its MXU
//   pass at default precision), rounds every element of g to bf16 (ties to
//   even, evdn::round_bf16) as it is loaded and sums the rounded values in
//   f32. No model path takes "default", as in the JAX package.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBlockThreads = 1024;   // with one tile a multiprocessor
constexpr int kMaxTables = 3;
constexpr int kSplitCols = 128;       // columns of a tile: four a lane
constexpr int kLoadsAhead = 16;       // loads in flight a thread
constexpr int kMinPointsPerBlock = 4096;

struct LineTable {
  const int32_t* idx;  // [n]
  const float* g;      // [n, W]
  float* out;          // [D, W]; with fold [W / 2, D]
  int D, W;
  int Dt, nds;         // rows of a tile, splits along D
  int Wt, ncs;         // columns of a tile, splits along W
  int workers;         // blocks that share the points of one split
  int block0;          // the table's first block
  int round_g;         // g rounded to bf16 on load (precision "default")
};

struct LineTables {
  LineTable t[kMaxTables];
  int count;
  int fold;
  int64_t n;
};

// One group's walk over its points [s, e): KPT columns a lane, SPLIT_D when
// the tile holds only rows [d0, d0 + dt) of the table.
template <int KPT, bool SPLIT_D>
__device__ __forceinline__ void accumulate(const LineTable& t, float* tile,
                                           int stride, int d0, int dt,
                                           int w0, int wt, int lane,
                                           int64_t s, int64_t e) {
  // points loaded ahead of the adds: a narrow table needs more of them to
  // keep as many bytes in flight
  constexpr int kAhead = kLoadsAhead / KPT;
  const float* gcol = t.g + w0 + lane;
  float acc[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) acc[k] = 0.f;
  int cur = -1;
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int k = 0; k < KPT; ++k)
      if (lane + 32 * k < wt)
        atomicAdd(tile + cur * stride + lane + 32 * k, acc[k]);
  };
  for (int64_t p = s; p < e; p += kAhead) {
    int r[kAhead];
    float v[kAhead][KPT];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      r[u] = p + u < e ? __ldg(t.idx + p + u) - d0 : -1;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      // without a D-split the loads do not wait for the index
      const bool row = SPLIT_D ? static_cast<unsigned>(r[u]) <
                                     static_cast<unsigned>(dt)
                               : p + u < e;
#pragma unroll
      for (int k = 0; k < KPT; ++k)
        v[u][k] = (row && lane + 32 * k < wt)
                      ? __ldcs(gcol + (p + u) * t.W + 32 * k)
                      : 0.f;
      if (t.round_g) {
#pragma unroll
        for (int k = 0; k < KPT; ++k) v[u][k] = evdn::round_bf16(v[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int ru = static_cast<unsigned>(r[u]) < static_cast<unsigned>(dt)
                         ? r[u]
                         : -1;
      if (ru != cur) {
        flush();
        cur = ru;
#pragma unroll
        for (int k = 0; k < KPT; ++k) acc[k] = v[u][k];
      } else {
#pragma unroll
        for (int k = 0; k < KPT; ++k) acc[k] += v[u][k];
      }
    }
  }
  flush();
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    line_grad_kernel(const __grid_constant__ LineTables a) {
  extern __shared__ __align__(16) float tile[];
  int ti = 0;
  while (ti + 1 < a.count && static_cast<int>(blockIdx.x) >= a.t[ti + 1].block0)
    ++ti;
  const LineTable& t = a.t[ti];
  int b = blockIdx.x - t.block0;
  const int worker = b % t.workers;
  b /= t.workers;
  const int w0 = (b % t.ncs) * t.Wt;
  const int d0 = (b / t.ncs) * t.Dt;
  const int wt = min(t.Wt, t.W - w0);
  const int dt = min(t.Dt, t.D - d0);
  // a tile whose rows are whole, 16-byte aligned rows of the output leaves
  // in one bulk reduce-add and is laid out as the output is
  const bool bulk = !a.fold && t.ncs == 1 && t.W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(t.out) % 16 == 0;
  const int stride = bulk ? t.Wt : (t.Wt | 1);
  for (int i = threadIdx.x; i < dt * stride; i += kBlockThreads) tile[i] = 0.f;
  __syncthreads();

  // the block's slab of points, and in it the run of this thread's group
  const int64_t slab = (a.n + t.workers - 1) / t.workers;
  const int64_t p0 = worker * slab;
  const int64_t p1 = min(a.n, p0 + slab);
  const int q = min(wt, 32);  // lanes a row
  const int groups = kBlockThreads / q;
  const int grp = threadIdx.x / q;
  if (grp < groups && p0 < p1) {
    const int lane = threadIdx.x - grp * q;
    const int64_t run = (p1 - p0 + groups - 1) / groups;
    const int64_t s = p0 + grp * run;
    const int64_t e = min(p1, s + run);
    const bool split_d = t.nds > 1;
    if (wt <= 32) {
      if (split_d)
        accumulate<1, true>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
      else
        accumulate<1, false>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
    } else if (wt <= 64) {
      if (split_d)
        accumulate<2, true>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
      else
        accumulate<2, false>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
    } else {
      if (split_d)
        accumulate<4, true>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
      else
        accumulate<4, false>(t, tile, stride, d0, dt, w0, wt, lane, s, e);
    }
  }
  if (bulk) {
    // the generic-proxy adds above must be seen by the async proxy's read
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      float* dst = t.out + static_cast<int64_t>(d0) * t.W;
      const unsigned src =
          static_cast<unsigned>(__cvta_generic_to_shared(tile));
      const unsigned bytes = static_cast<unsigned>(dt) * t.W * 4u;
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
          "[%0], [%1], %2;" ::"l"(dst),
          "r"(src), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the tile must outlive the copy's read of it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane32 = threadIdx.x % 32;
  constexpr int kWarps = kBlockThreads / 32;
  if (!a.fold) {
    for (int r = warp; r < dt; r += kWarps)
      for (int c = lane32; c < wt; c += 32) {
        const float v = tile[r * stride + c];
        if (v != 0.f)
          atomicAdd(t.out + static_cast<int64_t>(d0 + r) * t.W + w0 + c, v);
      }
  } else {
    const int C = t.W / 2;
    for (int c = warp; c < wt; c += kWarps) {
      const int slot = w0 + c >= C ? 1 : 0;
      float* col = t.out + static_cast<int64_t>(w0 + c - slot * C) * t.D;
      for (int r = lane32; r < dt; r += 32) {
        const float v = tile[r * stride + c];
        const int dd = d0 + r + slot;
        if (v != 0.f && dd < t.D) atomicAdd(col + dd, v);
      }
    }
  }
}

int launch(LineTables a, int device, cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  static bool raised[evdn::kMaxDevices];
  int sms = 0, smem = 0;
  cudaError_t err = evdn::device_limits(device, &sms, &smem);
  if (err == cudaSuccess)
    err = evdn::raise_shared_memory(line_grad_kernel, smem, device, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int budget = smem / static_cast<int>(sizeof(float));
  int64_t width = 0;
  for (int i = 0; i < a.count; ++i) {
    if (a.t[i].D <= 0 || a.t[i].W <= 0 || (a.fold && a.t[i].W % 2))
      return static_cast<int>(cudaErrorInvalidValue);
    width += a.t[i].W;
  }
  const int64_t max_workers =
      std::max<int64_t>(1, a.n / kMinPointsPerBlock);
  int blocks = 0, tile_floats = 0;
  for (int i = 0; i < a.count; ++i) {
    LineTable& t = a.t[i];
    t.Wt = std::min(t.W, kSplitCols);
    const int stride = t.Wt | 1;
    t.Dt = std::min(t.D, budget / stride);
    t.ncs = (t.W + t.Wt - 1) / t.Wt;
    t.nds = (t.D + t.Dt - 1) / t.Dt;
    const int64_t share = sms * static_cast<int64_t>(t.W) / width;
    t.workers = static_cast<int>(std::min(
        max_workers, std::max<int64_t>(1, share / (t.ncs * t.nds))));
    t.block0 = blocks;
    blocks += t.workers * t.ncs * t.nds;
    tile_floats = std::max(tile_floats, t.Dt * stride);
  }
  line_grad_kernel<<<blocks, kBlockThreads, tile_floats * sizeof(float),
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// round_g 0: precision "highest"; 1: "default" (g rounded to bf16)
EVDN_API int evdn_line_grad(const int32_t* idx, const float* g, float* out,
                            int64_t n, int D, int W, int round_g, int device,
                            cudaStream_t stream) {
  LineTables a{};
  a.t[0].round_g = round_g != 0;
  a.t[0].idx = idx;
  a.t[0].g = g;
  a.t[0].out = out;
  a.t[0].D = D;
  a.t[0].W = W;
  a.count = 1;
  a.fold = 0;
  a.n = n;
  return launch(a, device, stream);
}

// The three packed line tables of one sampler backward (W = 2C each) over
// the same n points in one launch, folded: each out is the raw line
// gradient [W / 2, D] (see the header).
EVDN_API int evdn_line_grad_tables(
    const int32_t* idx0, const int32_t* idx1, const int32_t* idx2,
    const float* g0, const float* g1, const float* g2, float* out0,
    float* out1, float* out2, int64_t n, int D0, int W0, int D1, int W1,
    int D2, int W2, int device, cudaStream_t stream) {
  LineTables a{};
  const int32_t* idx[3] = {idx0, idx1, idx2};
  const float* g[3] = {g0, g1, g2};
  float* out[3] = {out0, out1, out2};
  const int D[3] = {D0, D1, D2}, W[3] = {W0, W1, W2};
  for (int i = 0; i < 3; ++i) {
    a.t[i].idx = idx[i];
    a.t[i].g = g[i];
    a.t[i].out = out[i];
    a.t[i].D = D[i];
    a.t[i].W = W[i];
  }
  a.count = 3;
  a.fold = 1;
  a.n = n;
  return launch(a, device, stream);
}
