// Tri-plane feature sampler: forward kernel K4 and backward kernel K5.
//
// K4 replaces evdeblurnerf_tpu/ops/fused_sample.py::_fwd_kernel (Pallas,
// via _fused_fwd_call and fused_triplane_features). The TPU kernel receives
// rows that six XLA takes gathered beforehand; this kernel gathers its own
// rows from the neighbour-packed tables in device memory.
//
// Per point and for each of the 3 projections i (MAT_MODE / VEC_MODE of
// ops/triplane.py):
//   1. texel coordinates f = (x + 1) * 0.5 * (size - 1) and clipped base
//      indices (ops/fused_sample.py:212-230);
//   2. slot weights with zeros-padding validity and the f0 == base routing
//      (ops/fused_sample.py:55-71);
//   3. one packed plane row [4C] (the (y,x), (y,x+1), (y+1,x), (y+1,x+1)
//      texels) and one packed line row [2C] ((d), (d+1));
//   4. plane = 4-slot weighted sum, line = 2-slot weighted sum, plane*line;
//   5. writes out[n, off_i + c], out being [N, C0 + C1 + C2] f32.
//
// K4. Bound: random row reads from device memory. At the paper width the
// fine 64-component packed plane is ~373 MB and the coarse one ~93 MB;
// neither fits the 50 MB L2, so nearly every point pays a fresh row read:
// 1 KiB of plane row for projection 0 plus 256 B for each of the other two,
// and the line rows. Arithmetic is ~10 flops per output. Design: one thread
// per output element (point, channel). The threads of a warp cover
// consecutive channels of one point, so each of the four (two) slot reads
// of a row is one coalesced 128-byte access and the output store is
// coalesced. The per-point scalar work (coordinates, weights, row index) is
// repeated by each channel's thread: it is a few dozen flops against the
// memory wait. Sums are written with __fmul_rn/__fadd_rn, which the
// compiler does not contract into FMAs, so the kernel rounds where the
// plain PyTorch version (ops/triplane.py::triplane_features_packed) rounds.
//
// K5 replaces evdeblurnerf_tpu/ops/fused_sample.py::_bwd_kernel (Pallas,
// via _fused_bwd_call), and with it the XLA scatter into the packed layout
// and the pack VJP that follow it there (ops/fused_sample.py:297-321). It
// saves nothing but xyz from the forward: the texel coordinates, slot
// weights and rows are re-derived from xyz exactly as K4 derives them.
// Given g = dL/d(features) [N, C0 + C1 + C2] it produces
//   * d(planes): each point's four corner terms d_pf * w_corner are added
//     with atomicAdd into a texel-major [H*W, C] gradient (one coalesced
//     row of C per corner); the caller permutes it to the parameter's
//     [C, H, W]. This is the scatter plus pack VJP in one step: corner
//     (y+dy, x+dx) is the texel that packed slot (dy, dx) holds;
//   * d(lines): the per-point packed line-row cotangents [N, 2C]
//     (d_lf * q0, d_lf * q1, ops/fused_sample.py:141), which kernel K6
//     (line_matmul.cu) reduces into the [D, 2C] packed-line gradient;
//   * d(xyz) [N, 3]: the channel sums of d_pf * row and d_lf * row give the
//     slot-weight cotangents, chained through _slot_weights_bwd
//     (ops/fused_sample.py:74-83) and the texel scaling
//     (_d_fcoords_to_d_xyz, :233-243). Through d(xyz) the warped rays, and
//     so the RBK motion heads, learn.
// K5. Bound: the same random row reads as K4 plus four atomic row updates
// per point and projection into gradients of 94 MB (fine plane 0) that do
// not fit the L2 either. Design: one warp per point; the lanes walk the
// channels of each projection, so every row read, atomic row update and
// line-cotangent store is coalesced, and the six per-point channel sums
// are warp shuffles. Contention: uniformly random points rarely hit the
// same texel at once, but a trained scene concentrates its samples near
// surfaces, where neighbouring rays add into the same texels; atomics then
// serialise per address. A sort-by-texel segmented reduce would remove
// that, and the run-to-run variation of the sums below, at the price of a
// sort per step.
// Determinism: the order of the atomic additions varies from run to run,
// so the plane gradients differ from run to run in the last bits, as the
// reference's grid_sample backward does (ops/triplane.py:6-9).
//
// Coordinates must be finite: NaN coordinates give NaN features (the base
// index is clipped with fmaxf/fminf, which drop the NaN, so no row outside
// the table is ever read).
#include "common.cuh"

namespace {

struct Projection {
  const float* plane;  // [H * W, 4C] neighbour-packed
  const float* line;   // [D, 2C] neighbour-packed
  int H, W, D, C;
  int m0, m1, v;       // xyz columns: plane x, plane y, line
};

struct Tables {
  Projection p[3];
  int ctot;
};

// Base row index and the two slot weights of coordinate f on an axis of
// `size` texels; mirrors ops/fused_sample.py::_slot_weights.
__device__ __forceinline__ int slot_weights(float f, int size, float* s0,
                                            float* s1) {
  const float f0 = floorf(f);
  const float frac = __fsub_rn(f, f0);
  const float base = fminf(fmaxf(f0, 0.f), static_cast<float>(size - 2));
  const bool off0 = (f0 == base);
  const float valid0 = (f0 >= 0.f && f0 <= size - 1) ? 1.f : 0.f;
  const float valid1 = (f0 + 1.f >= 0.f && f0 + 1.f <= size - 1) ? 1.f : 0.f;
  const float w0 = __fmul_rn(__fsub_rn(1.f, frac), valid0);
  const float w1 = __fmul_rn(frac, valid1);
  *s0 = off0 ? w0 : w1;
  *s1 = off0 ? w1 : w0;
  return static_cast<int>(base);
}

__device__ __forceinline__ float texel_coord(float x, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(x, 1.f), 0.5f),
                   static_cast<float>(size - 1));
}

__global__ void triplane_fwd_kernel(const float* __restrict__ xyz,
                                    const __grid_constant__ Tables t,
                                    float* __restrict__ out, int64_t n) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= n * t.ctot) return;
  const int64_t pt = g / t.ctot;
  int c = static_cast<int>(g - pt * t.ctot);
  int i = 0;
  if (c >= t.p[0].C) {
    c -= t.p[0].C;
    i = 1;
    if (c >= t.p[1].C) {
      c -= t.p[1].C;
      i = 2;
    }
  }
  const Projection& p = t.p[i];
  const float* q = xyz + pt * 3;
  float sx0, sx1, sy0, sy1, q0, q1;
  const int bx = slot_weights(texel_coord(q[p.m0], p.W), p.W, &sx0, &sx1);
  const int by = slot_weights(texel_coord(q[p.m1], p.H), p.H, &sy0, &sy1);
  const int bl = slot_weights(texel_coord(q[p.v], p.D), p.D, &q0, &q1);

  const int C = p.C;
  const float* pr = p.plane + (static_cast<int64_t>(by) * p.W + bx) * 4 * C;
  const float* lr = p.line + static_cast<int64_t>(bl) * 2 * C;
  float pf = __fmul_rn(__ldg(pr + c), __fmul_rn(sy0, sx0));
  pf = __fadd_rn(pf, __fmul_rn(__ldg(pr + C + c), __fmul_rn(sy0, sx1)));
  pf = __fadd_rn(pf, __fmul_rn(__ldg(pr + 2 * C + c), __fmul_rn(sy1, sx0)));
  pf = __fadd_rn(pf, __fmul_rn(__ldg(pr + 3 * C + c), __fmul_rn(sy1, sx1)));
  const float lf = __fadd_rn(__fmul_rn(__ldg(lr + c), q0),
                             __fmul_rn(__ldg(lr + C + c), q1));
  out[g] = __fmul_rn(pf, lf);
}

// d(loss)/d(f) from the two slot-weight cotangents; mirrors
// ops/fused_sample.py::_slot_weights_bwd.
__device__ __forceinline__ float slot_weights_bwd(float f, int size,
                                                  float d_s0, float d_s1) {
  const float f0 = floorf(f);
  const float base = fminf(fmaxf(f0, 0.f), static_cast<float>(size - 2));
  const bool off0 = (f0 == base);
  const float valid0 = (f0 >= 0.f && f0 <= size - 1) ? 1.f : 0.f;
  const float valid1 = (f0 + 1.f >= 0.f && f0 + 1.f <= size - 1) ? 1.f : 0.f;
  const float d_w0 = off0 ? d_s0 : d_s1;
  const float d_w1 = off0 ? d_s1 : d_s0;
  return d_w1 * valid1 - d_w0 * valid0;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Grads {
  float* plane[3];  // [H * W, C] texel-major, zeroed by the caller
  float* line[3];   // [N, 2C] per-point packed line-row cotangents
  float* xyz;       // [N, 3]
};

__global__ void triplane_bwd_kernel(const float* __restrict__ xyz,
                                    const __grid_constant__ Tables t,
                                    const float* __restrict__ g,
                                    const __grid_constant__ Grads d,
                                    int64_t n) {
  const int64_t pt = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                     threadIdx.x / 32;
  if (pt >= n) return;
  const int lane = threadIdx.x % 32;
  const float* q = xyz + pt * 3;
  float d_xyz[3] = {0.f, 0.f, 0.f};
  int off = 0;
  for (int i = 0; i < 3; ++i) {
    const Projection& p = t.p[i];
    const float fx = texel_coord(q[p.m0], p.W);
    const float fy = texel_coord(q[p.m1], p.H);
    const float fl = texel_coord(q[p.v], p.D);
    float sx0, sx1, sy0, sy1, q0, q1;
    const int bx = slot_weights(fx, p.W, &sx0, &sx1);
    const int by = slot_weights(fy, p.H, &sy0, &sy1);
    const int bl = slot_weights(fl, p.D, &q0, &q1);
    const float w00 = __fmul_rn(sy0, sx0), w01 = __fmul_rn(sy0, sx1);
    const float w10 = __fmul_rn(sy1, sx0), w11 = __fmul_rn(sy1, sx1);

    const int C = p.C;
    const int64_t texel = static_cast<int64_t>(by) * p.W + bx;
    const float* pr = p.plane + texel * 4 * C;
    const float* lr = p.line + static_cast<int64_t>(bl) * 2 * C;
    const float* gp = g + pt * t.ctot + off;
    float* dp = d.plane[i];
    float* dl = d.line[i] + pt * 2 * C;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float s00 = __ldg(pr + c), s01 = __ldg(pr + C + c);
      const float s10 = __ldg(pr + 2 * C + c), s11 = __ldg(pr + 3 * C + c);
      const float l0 = __ldg(lr + c), l1 = __ldg(lr + C + c);
      const float pf = s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11;
      const float lf = l0 * q0 + l1 * q1;
      const float gi = __ldg(gp + c);
      const float d_pf = gi * lf;
      const float d_lf = gi * pf;
      dl[c] = d_lf * q0;
      dl[C + c] = d_lf * q1;
      atomicAdd(dp + texel * C + c, d_pf * w00);
      atomicAdd(dp + (texel + 1) * C + c, d_pf * w01);
      atomicAdd(dp + (texel + p.W) * C + c, d_pf * w10);
      atomicAdd(dp + (texel + p.W + 1) * C + c, d_pf * w11);
      a00 += d_pf * s00;
      a01 += d_pf * s01;
      a10 += d_pf * s10;
      a11 += d_pf * s11;
      b0 += d_lf * l0;
      b1 += d_lf * l1;
    }
    a00 = warp_sum(a00);
    a01 = warp_sum(a01);
    a10 = warp_sum(a10);
    a11 = warp_sum(a11);
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    const float d_fx = slot_weights_bwd(fx, p.W, a00 * sy0 + a10 * sy1,
                                        a01 * sy0 + a11 * sy1);
    const float d_fy = slot_weights_bwd(fy, p.H, a00 * sx0 + a01 * sx1,
                                        a10 * sx0 + a11 * sx1);
    const float d_fl = slot_weights_bwd(fl, p.D, b0, b1);
    d_xyz[p.m0] += d_fx * (0.5f * (p.W - 1));
    d_xyz[p.m1] += d_fy * (0.5f * (p.H - 1));
    d_xyz[p.v] += d_fl * (0.5f * (p.D - 1));
    off += C;
  }
  if (lane == 0) {
    d.xyz[pt * 3] = d_xyz[0];
    d.xyz[pt * 3 + 1] = d_xyz[1];
    d.xyz[pt * 3 + 2] = d_xyz[2];
  }
}

}  // namespace

namespace {

// MAT_MODE ((0, 1), (0, 2), (1, 2)) and VEC_MODE (2, 1, 0)
Tables make_tables(const float* plane0, const float* plane1,
                   const float* plane2, const float* line0, const float* line1,
                   const float* line2, int H0, int W0, int D0, int C0, int H1,
                   int W1, int D1, int C1, int H2, int W2, int D2, int C2) {
  return Tables{{{plane0, line0, H0, W0, D0, C0, 0, 1, 2},
                 {plane1, line1, H1, W1, D1, C1, 0, 2, 1},
                 {plane2, line2, H2, W2, D2, C2, 1, 2, 0}},
                C0 + C1 + C2};
}

}  // namespace

EVDN_API int evdn_triplane_features(
    const float* xyz, const float* plane0, const float* plane1,
    const float* plane2, const float* line0, const float* line1,
    const float* line2, float* out, int64_t n, int H0, int W0, int D0, int C0,
    int H1, int W1, int D1, int C1, int H2, int W2, int D2, int C2, int device,
    cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  const Tables t = make_tables(plane0, plane1, plane2, line0, line1, line2,
                               H0, W0, D0, C0, H1, W1, D1, C1, H2, W2, D2,
                               C2);
  const int64_t work = n * t.ctot;
  if (work <= 0) return static_cast<int>(cudaGetLastError());
  triplane_fwd_kernel<<<evdn::blocks_for(work, evdn::kThreads),
                        evdn::kThreads, 0, stream>>>(xyz, t, out, n);
  return static_cast<int>(cudaGetLastError());
}

EVDN_API int evdn_triplane_features_bwd(
    const float* xyz, const float* plane0, const float* plane1,
    const float* plane2, const float* line0, const float* line1,
    const float* line2, const float* g, float* dplane0, float* dplane1,
    float* dplane2, float* dline0, float* dline1, float* dline2, float* dxyz,
    int64_t n, int H0, int W0, int D0, int C0, int H1, int W1, int D1, int C1,
    int H2, int W2, int D2, int C2, int device, cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  const Tables t = make_tables(plane0, plane1, plane2, line0, line1, line2,
                               H0, W0, D0, C0, H1, W1, D1, C1, H2, W2, D2,
                               C2);
  const Grads d{{dplane0, dplane1, dplane2}, {dline0, dline1, dline2}, dxyz};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kPointsPerBlock = evdn::kThreads / 32;
  triplane_bwd_kernel<<<evdn::blocks_for(n, kPointsPerBlock), evdn::kThreads,
                        0, stream>>>(xyz, t, g, d, n);
  return static_cast<int>(cudaGetLastError());
}
