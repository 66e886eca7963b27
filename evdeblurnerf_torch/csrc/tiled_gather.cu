// Tiled plane gather: kernel K7.
//
// tiled_plane_gather: out[n, :] = bilinear sample of plane[H, W, C] at the
//   texel coordinates (fu[n], fv[n]), taken relative to the TH x TW tile
//   that the point's group of 128 shares; a point whose 2x2 footprint
//   leaves its group's tile gives a row of zeros.
//   Replaces evdeblurnerf_tpu/ops/tiled_gather.py::_kernel (Pallas, via
//   tiled_plane_gather). The TPU kernel copies each group's tile into VMEM
//   (two slots, the next group's copy in flight) and contracts it with
//   one-hot tent-weight matrices, y on the MXU and x on the VPU, because a
//   table-row gather is the dear operation there. With two nonzeros per
//   one-hot row that product is the four-corner sum, added in the TPU
//   kernel's order: first over y, a(x) = wy0*t[v0][x] + wy1*t[v0+1][x] for
//   the two columns x = u0, u0+1, then over x, a(u0)*wx0 + a(u0+1)*wx1.
//   Bound: device-memory bytes. The function reads the touched part of the
//   plane and the coordinates once and writes N*C floats; at the bench's
//   shapes (plane 512 x 512 x 64, N = 1,310,720) that is at most 67 MB of
//   plane, 10.5 MB of coordinates and 335.5 MB of output, and the output
//   store sets the time. Design: on this card a 256-byte texel row read
//   through L1/L2 is the cheap operation and a staged tile the dear one
//   (a 64 x 64 tile of 64 channels is 1 MiB a group, 26 times the
//   function's bytes), so nothing is staged. The tile is what it is in the
//   contract, the spill mask, and is never copied. C/4 consecutive threads
//   take one point (a half-warp at C = 64): each computes the point's
//   local coordinates and in-tile test from the group's origin, makes the
//   four corner loads as four independent 16-byte read-only loads (the two
//   x-neighbours are 2C contiguous floats), does its 4 channels' products
//   and sums and writes one float4, so a point's row leaves as C
//   contiguous floats. One block walks one group's 128 points, so one
//   SM's L1 sees a whole ray, whose consecutive samples hit the same or
//   the neighbouring texel; the 50 MB L2 serves the repeats across blocks.
//   No shared memory and no barrier: many blocks a SM, the loads of many
//   points in flight. The output is written with a streaming store
//   (__stcs), which keeps 335 MB of results from pushing the plane out of
//   L2. Any tile with 2 <= TH <= H and 2 <= TW <= W runs, and the time
//   does not depend on the tile.
//   Exactness: __fmul_rn/__fadd_rn keep the compiler from contracting the
//   sums into FMAs, so the kernel rounds where the plain PyTorch version
//   rounds and the two agree bitwise.
#include "common.cuh"

namespace {

constexpr int kGroup = 128;

__device__ __forceinline__ float corner_sum(float wy0, float wy1, float wx0,
                                            float wx1, float t00, float t01,
                                            float t10, float t11) {
  const float a0 = __fadd_rn(__fmul_rn(wy0, t00), __fmul_rn(wy1, t10));
  const float a1 = __fadd_rn(__fmul_rn(wy0, t01), __fmul_rn(wy1, t11));
  return __fadd_rn(__fmul_rn(a0, wx0), __fmul_rn(a1, wx1));
}

// q_count: float4 pieces of a texel's row, C / 4.
__global__ void __launch_bounds__(evdn::kThreads)
tiled_gather_kernel(const float* __restrict__ plane,
                    const float* __restrict__ fu,
                    const float* __restrict__ fv,
                    const int32_t* __restrict__ oy,
                    const int32_t* __restrict__ ox, float* __restrict__ out,
                    int H, int W, int q_count, int TH, int TW) {
  const int64_t g = blockIdx.x;
  // origins as group_origins gives them lie in the plane; any other is
  // clamped there, so no corner load leaves the plane
  const int gy = min(max(__ldg(oy + g), 0), H - TH);
  const int gx = min(max(__ldg(ox + g), 0), W - TW);
  const float fgy = static_cast<float>(gy), fgx = static_cast<float>(gx);
  const float max_u = static_cast<float>(TW - 1);
  const float max_v = static_cast<float>(TH - 1);
  const int64_t row_stride = static_cast<int64_t>(W) * q_count;
  const float4* plane4 = reinterpret_cast<const float4*>(plane);
  float4* out4 = reinterpret_cast<float4*>(out) + g * kGroup * q_count;

#pragma unroll 4
  for (int i = threadIdx.x; i < kGroup * q_count; i += evdn::kThreads) {
    const int p = i / q_count, q = i - p * q_count;
    const float lu = __fsub_rn(__ldg(fu + g * kGroup + p), fgx);
    const float lv = __fsub_rn(__ldg(fv + g * kGroup + p), fgy);
    const float u0 = floorf(lu), v0 = floorf(lv);
    const bool ok = u0 >= 0.f && u0 + 1.f <= max_u && v0 >= 0.f &&
                    v0 + 1.f <= max_v;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const float au = __fsub_rn(lu, u0), av = __fsub_rn(lv, v0);
      const float wy0 = __fsub_rn(1.f, av), wx0 = __fsub_rn(1.f, au);
      const float4* t = plane4 +
          (static_cast<int64_t>(gy + static_cast<int>(v0)) * W +
           (gx + static_cast<int>(u0))) * q_count + q;
      const float4 t00 = __ldg(t), t01 = __ldg(t + q_count);
      const float4 t10 = __ldg(t + row_stride);
      const float4 t11 = __ldg(t + row_stride + q_count);
      r.x = corner_sum(wy0, av, wx0, au, t00.x, t01.x, t10.x, t11.x);
      r.y = corner_sum(wy0, av, wx0, au, t00.y, t01.y, t10.y, t11.y);
      r.z = corner_sum(wy0, av, wx0, au, t00.z, t01.z, t10.z, t11.z);
      r.w = corner_sum(wy0, av, wx0, au, t00.w, t01.w, t10.w, t11.w);
    }
    __stcs(out4 + i, r);
  }
}

}  // namespace

// plane [H, W, C] f32 with C a multiple of 4; fu, fv [groups * 128] f32;
// oy, ox [groups] int32, clamped by the kernel to 0 <= oy <= H - TH and
// 0 <= ox <= W - TW; out [groups * 128, C] f32. plane and out are read and
// written in 16-byte pieces and must be 16-byte aligned.
EVDN_API int evdn_tiled_plane_gather(const float* plane, const float* fu,
                                     const float* fv, const int32_t* oy,
                                     const int32_t* ox, float* out,
                                     int64_t groups, int H, int W, int C,
                                     int TH, int TW, int device,
                                     cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (groups <= 0) return static_cast<int>(cudaGetLastError());
  if (C <= 0 || C % 4 != 0 || TH < 2 || TW < 2 || TH > H || TW > W ||
      reinterpret_cast<uintptr_t>(plane) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // one block per group: groups is at most the grid's 2^31 - 1 blocks
  const unsigned int grid = static_cast<unsigned int>(groups);
  tiled_gather_kernel<<<grid, evdn::kThreads, 0, stream>>>(
      plane, fu, fv, oy, ox, out, H, W, C / 4, TH, TW);
  return static_cast<int>(cudaGetLastError());
}
