// Row placement at dynamic offsets: kernel K8.
//
// place_rows: out[offsets[r] : offsets[r] + G, :] = rows[r*G : (r+1)*G, :]
//   for every run r of G contiguous rows of width W; no arithmetic. Rows
//   that no run targets are left as they were (the wrapper allocates the
//   output with torch.empty: undefined, as the Pallas output is).
//   Replaces tools/probe_scatter.py::_dma_kernel (Pallas, via
//   pallas_row_dma), the TPU probe of the floor of "place N rows at N
//   arbitrary offsets": each run one DMA from HBM to HBM, eight in flight.
//   Bound: device-memory bytes. The function reads the N/G offsets and
//   the runs that land and writes them: where no two runs share a
//   destination (a permutation of N/G destinations into K = N rows) that
//   is 2*N*W*4 bytes plus the offsets over 3.35 TB/s, 0.72 ms at the
//   probe's N = 2,359,296 rows of W = 128. At the probe's own draw (K =
//   262,144, about nine runs a destination) only the last run aimed at a
//   destination lands: 2*(runs landing)*G*W*4 bytes plus the offsets.
//   Design: latency, not bytes, sets the time of short runs: a run is
//   a chain of two dependent loads (its offset, then its destination's
//   winner) before its bytes move, or do not. So for runs of G < 8 rows
//   (kBatchBelow) a warp takes 32 runs at once: each lane loads one
//   offset (coalesced) and that run's winner, 32 independent chains in
//   flight, and __ballot_sync picks the runs that land. Their (run,
//   offset) pairs go into the warp's slice of shared memory, and the
//   warp copies them as a flat list of 32-lane pieces, kInFlight pieces
//   at a time: each lane's kInFlight 16-byte loads are all in flight
//   before their stores. Longer runs keep one warp a run, or a piece of
//   up to kPiece float4 of a long run, at a time (a grid-stride loop
//   over the pieces), four loads in flight a lane. Both move 16-byte
//   lanes, neighbouring lanes on neighbouring addresses, a run being
//   G*W*4 contiguous bytes on both sides, with streaming hints (__ldcs,
//   __stcs), since nothing is read twice. Rows are not staged: on this
//   card a 512-byte row is one coalesced request, the unit the TPU's DMA
//   engine needed a descriptor for.
//   Collisions: runs aimed at one destination are written whole, never
//   mixed. The TPU kernel's DMAs ran one after another on one core; here
//   warps run side by side, and two runs copied into one place at once
//   would leave a mix of both. So a first launch records, per destination
//   run, the highest index of a run aimed at it (atomicMax), and a second
//   copies those winners only: each destination ends as the last run
//   aimed at it, as a loop over the runs in order leaves it (the Pallas
//   kernel in interpret mode does), and a run that another overwrites is
//   never read. The first launch also counts offsets that are no multiple
//   of G or lie outside the output; such runs are copied nowhere and the
//   wrapper raises.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kPiece = 1024;     // float4 a warp moves per work item: 16 KiB
constexpr int kWarps = evdn::kThreads / 32;
constexpr int kBatchBelow = 8;   // runs of fewer rows go 32 to a warp
constexpr int kInFlight = 8;     // loads a lane holds before its stores

__global__ void __launch_bounds__(evdn::kThreads)
place_rows_claim(const int32_t* __restrict__ offsets, int64_t runs, int group,
                 int64_t slots, int32_t* __restrict__ winner,
                 int32_t* __restrict__ bad) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < runs; r += stride) {
    const int32_t off = __ldg(offsets + r);
    if (off < 0 || off % group != 0 || off / group >= slots) {
      atomicAdd(bad, 1);
      continue;
    }
    atomicMax(winner + off / group, static_cast<int32_t>(r + 1));
  }
}

// Copies the runs that win their destination, 32 runs a warp at once
// (runs of fewer than kBatchBelow rows). q_row: float4 pieces of a row,
// W / 4.
__global__ void __launch_bounds__(evdn::kThreads)
place_rows_copy_batch(const float4* __restrict__ rows,
                 const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ winner, float4* __restrict__ out,
                 int64_t runs, int group, int64_t slots, int q_row) {
  // each warp's landing runs of its current 32: (run, offset)
  __shared__ int2 landing[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_run = group * q_row;
  const int pieces = (q_run + 31) / 32;     // 32-lane pieces a run
  const int64_t batches = (runs + 31) / 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t bt = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       bt < batches; bt += warps) {
    const int64_t r = bt * 32 + lane;
    int32_t off = 0;
    bool lands = false;
    if (r < runs) {
      off = __ldg(offsets + r);
      lands = off >= 0 && off % group == 0 && off / group < slots &&
              __ldg(winner + off / group) == r + 1;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, lands);
    if (lands)
      landing[warp][__popc(mask & ((1u << lane) - 1u))] =
          make_int2(static_cast<int>(r), off);
    __syncwarp();
    const int items = __popc(mask) * pieces;
    for (int it0 = 0; it0 < items; it0 += kInFlight) {
      float4 v[kInFlight];
      int64_t dst[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        dst[u] = -1;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int it = it0 + u;
        if (it < items) {
          const int k = it / pieces;
          const int i = (it - k * pieces) * 32 + lane;
          if (i < q_run) {
            const int2 e = landing[warp][k];
            v[u] = __ldcs(rows + static_cast<int64_t>(e.x) * q_run + i);
            dst[u] = static_cast<int64_t>(e.y) * q_row + i;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (dst[u] >= 0) __stcs(out + dst[u], v[u]);
    }
    __syncwarp();           // the slice is rewritten by the next 32
  }
}

// Copies the runs that win their destination, a warp a run or a piece of
// one (runs of kBatchBelow rows or more). q_row: float4 pieces of a row,
// W / 4.
__global__ void __launch_bounds__(evdn::kThreads)
place_rows_copy(const float4* __restrict__ rows,
                const int32_t* __restrict__ offsets,
                const int32_t* __restrict__ winner, float4* __restrict__ out,
                int64_t runs, int group, int64_t slots, int q_row) {
  const int lane = threadIdx.x & 31;
  const int64_t q_run = static_cast<int64_t>(group) * q_row;
  const int64_t pieces = (q_run + kPiece - 1) / kPiece;
  const int64_t items = runs * pieces;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
       it < items; it += warps) {
    const int64_t r = it / pieces;
    const int64_t p = it - r * pieces;
    const int32_t off = __ldg(offsets + r);
    if (off < 0 || off % group != 0 || off / group >= slots) continue;
    if (__ldg(winner + off / group) != r + 1) continue;
    const int64_t first = p * kPiece;
    const int64_t n = q_run - first < kPiece ? q_run - first : kPiece;
    const float4* src = rows + r * q_run + first;
    float4* dst = out + static_cast<int64_t>(off) * q_row + first;
    int64_t i = lane;
    // four loads in flight a lane before their stores
    for (; i + 96 < n; i += 128) {
      const float4 a = __ldcs(src + i), b = __ldcs(src + i + 32);
      const float4 c = __ldcs(src + i + 64), d = __ldcs(src + i + 96);
      __stcs(dst + i, a);
      __stcs(dst + i + 32, b);
      __stcs(dst + i + 64, c);
      __stcs(dst + i + 96, d);
    }
    for (; i < n; i += 32) __stcs(dst + i, __ldcs(src + i));
  }
}

}  // namespace

// rows [runs * group, W] f32, offsets [runs] int32, out [slots * group, W]
// f32 with W a multiple of 4, rows and out 16-byte aligned; scratch
// [slots + 1] int32, zeroed here: the winner of each destination run, and
// in scratch[slots] the count of offsets refused (no multiple of group,
// or outside the output), which the caller reads after the launch.
EVDN_API int evdn_place_rows(const float* rows, const int32_t* offsets,
                             float* out, int32_t* scratch, int64_t runs,
                             int group, int64_t slots, int W, int device,
                             cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (group <= 0 || W <= 0 || W % 4 != 0 || slots <= 0 ||
      runs >= (int64_t{1} << 31) - 1 ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(slots + 1) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (runs <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0, smem_optin = 0;
  err = evdn::device_limits(device, &sms, &smem_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a full SM's worth of resident blocks, walking the work in grid strides
  const int64_t resident = static_cast<int64_t>(sms) * 8;
  const unsigned int claim_grid = static_cast<unsigned int>(
      std::min<int64_t>(evdn::blocks_for(runs, evdn::kThreads), resident));
  place_rows_claim<<<claim_grid, evdn::kThreads, 0, stream>>>(
      offsets, runs, group, slots, scratch, scratch + slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_row = W / 4;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (group < kBatchBelow) {
    const unsigned int batch_grid = static_cast<unsigned int>(
        std::min<int64_t>(evdn::blocks_for((runs + 31) / 32, kWarps),
                          resident));
    place_rows_copy_batch<<<batch_grid, evdn::kThreads, 0, stream>>>(
        rows4, offsets, scratch, out4, runs, group, slots, q_row);
  } else {
    const int64_t pieces =
        (static_cast<int64_t>(group) * q_row + kPiece - 1) / kPiece;
    const unsigned int copy_grid = static_cast<unsigned int>(
        std::min<int64_t>(evdn::blocks_for(runs * pieces, kWarps), resident));
    place_rows_copy<<<copy_grid, evdn::kThreads, 0, stream>>>(
        rows4, offsets, scratch, out4, runs, group, slots, q_row);
  }
  return static_cast<int>(cudaGetLastError());
}
