// Tiled plane gather: kernel K7.
//
// tiled_plane_gather: out[n, :] = bilinear sample of plane[H, W, C] at the
//   texel coordinates (fu[n], fv[n]), read from the TH x TW tile that the
//   point's group of 128 shares; a point whose 2x2 footprint leaves its
//   group's tile gives a row of zeros.
//   Replaces evdeblurnerf_tpu/ops/tiled_gather.py::_kernel (Pallas, via
//   tiled_plane_gather). The TPU kernel copies each group's tile into VMEM
//   (two slots, the next group's copy in flight) and contracts it with
//   one-hot tent-weight matrices, y on the MXU and x on the VPU. With two
//   nonzeros per one-hot row that product is the four-corner sum, so this
//   kernel reads the four corners from the staged tile and adds them in
//   the TPU kernel's order: first over y, a(x) = wy0*t[v0][x] +
//   wy1*t[v0+1][x] for the two columns x = u0, u0+1, then over x,
//   a(u0)*wx0 + a(u0+1)*wx1.
//   Bound: bytes. The function reads the plane and the coordinates once
//   and writes N*C floats; the kernel reads G*TH*TW*C floats, every
//   group's whole tile (1 MiB for a 64 x 64 tile of 64 channels), which is
//   several times the rows the points touch. Design: one block per group.
//   A whole tile does not fit a block's shared memory (227 KiB), so the
//   block walks the channels in chunks of CH = 8 (32 bytes of a texel's
//   row, one DRAM sector; 4 where C is not a multiple of 8): it stages the
//   chunk's [TH*TW, CH] tile with 16-byte loads, consecutive threads on
//   consecutive pieces of the chunk, synchronises, and each thread then
//   computes (point, channel) pairs from shared memory. The per-point
//   weights and corner offsets are computed once per block and kept in
//   shared memory. Chunks of 8 channels make a 64 x 64 tile 128 KiB and a
//   48 x 128 tile 192 KiB: one block per SM, nothing overlaps a block's
//   loads with its arithmetic. Copies in flight across groups (cp.async or
//   TMA, the counterpart of the TPU's two slots) are left for later.
//   Exactness: __fmul_rn/__fadd_rn keep the compiler from contracting the
//   sums into FMAs, so the kernel rounds where the plain PyTorch version
//   rounds and the two agree bitwise.
#include "common.cuh"

namespace {

constexpr int kGroup = 128;

template <int CH>
__global__ void tiled_gather_kernel(const float* __restrict__ plane,
                                    const float* __restrict__ fu,
                                    const float* __restrict__ fv,
                                    const int32_t* __restrict__ oy,
                                    const int32_t* __restrict__ ox,
                                    float* __restrict__ out, int H, int W,
                                    int C, int TH, int TW) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  __shared__ float s_wy0[kGroup], s_wy1[kGroup], s_wx0[kGroup],
      s_wx1[kGroup];
  __shared__ int s_base[kGroup];    // v0 * TW + u0 in the tile, -1: spilled

  const int64_t g = blockIdx.x;
  // origins as group_origins gives them lie in the plane; any other is
  // clamped there, so the staging loop below never leaves the plane
  const int gy = min(max(oy[g], 0), H - TH);
  const int gx = min(max(ox[g], 0), W - TW);
  if (threadIdx.x < kGroup) {
    const int p = threadIdx.x;
    const float lu = __fsub_rn(fu[g * kGroup + p], static_cast<float>(gx));
    const float lv = __fsub_rn(fv[g * kGroup + p], static_cast<float>(gy));
    const float u0 = floorf(lu), v0 = floorf(lv);
    const float au = __fsub_rn(lu, u0), av = __fsub_rn(lv, v0);
    const bool ok = u0 >= 0.f && u0 + 1.f <= static_cast<float>(TW - 1) &&
                    v0 >= 0.f && v0 + 1.f <= static_cast<float>(TH - 1);
    s_base[p] = ok ? static_cast<int>(v0) * TW + static_cast<int>(u0) : -1;
    s_wy0[p] = __fsub_rn(1.f, av);
    s_wy1[p] = av;
    s_wx0[p] = __fsub_rn(1.f, au);
    s_wx1[p] = au;
  }

  constexpr int kQuads = CH / 4;          // float4 pieces of a texel's chunk
  const int n_quads = TH * TW * kQuads;
  for (int c0 = 0; c0 < C; c0 += CH) {
    __syncthreads();   // the last chunk is read; the point table is written
    for (int i = threadIdx.x; i < n_quads; i += blockDim.x) {
      const int texel = i / kQuads, q = i - texel * kQuads;
      const int y = texel / TW, x = texel - y * TW;
      const float* src = plane +
          (static_cast<int64_t>(gy + y) * W + (gx + x)) * C + c0 + 4 * q;
      tile4[i] = __ldg(reinterpret_cast<const float4*>(src));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kGroup * CH; i += blockDim.x) {
      const int p = i / CH, c = i - p * CH;
      const int base = s_base[p];
      float v = 0.f;
      if (base >= 0) {
        const float* t = tile + base * CH + c;
        const float wy0 = s_wy0[p], wy1 = s_wy1[p];
        const float a0 = __fadd_rn(__fmul_rn(wy0, t[0]),
                                   __fmul_rn(wy1, t[TW * CH]));
        const float a1 = __fadd_rn(__fmul_rn(wy0, t[CH]),
                                   __fmul_rn(wy1, t[TW * CH + CH]));
        v = __fadd_rn(__fmul_rn(a0, s_wx0[p]), __fmul_rn(a1, s_wx1[p]));
      }
      out[(g * kGroup + p) * C + c0 + c] = v;
    }
  }
}

template <int CH>
int launch(const float* plane, const float* fu, const float* fv,
           const int32_t* oy, const int32_t* ox, float* out, int64_t groups,
           int H, int W, int C, int TH, int TW, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TH) * TW * CH * sizeof(float);
  if (smem > 48 * 1024) {
    // above 48 KiB a block must opt in; refused beyond the card's 227 KiB
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_gather_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the next launch's check starts clean
      return static_cast<int>(err);
    }
  }
  tiled_gather_kernel<CH><<<static_cast<unsigned int>(groups),
                            evdn::kThreads, smem, stream>>>(
      plane, fu, fv, oy, ox, out, H, W, C, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plane [H, W, C] f32 with C a multiple of 4; fu, fv [groups * 128] f32;
// oy, ox [groups] int32, clamped by the kernel to 0 <= oy <= H - TH and
// 0 <= ox <= W - TW; out [groups * 128, C] f32.
EVDN_API int evdn_tiled_plane_gather(const float* plane, const float* fu,
                                     const float* fv, const int32_t* oy,
                                     const int32_t* ox, float* out,
                                     int64_t groups, int H, int W, int C,
                                     int TH, int TW, int device,
                                     cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (groups <= 0) return static_cast<int>(cudaGetLastError());
  if (C <= 0 || C % 4 != 0 || TH < 2 || TW < 2 || TH > H || TW > W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C % 8 == 0)
    return launch<8>(plane, fu, fv, oy, ox, out, groups, H, W, C, TH, TW,
                     stream);
  return launch<4>(plane, fu, fv, oy, ox, out, groups, H, W, C, TH, TW,
                   stream);
}
