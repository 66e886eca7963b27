// Tri-plane feature sampler, forward: kernel K4.
//
// Replaces evdeblurnerf_tpu/ops/fused_sample.py::_fwd_kernel (Pallas, via
// _fused_fwd_call and fused_triplane_features). The TPU kernel receives
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
// Bound: random row reads from device memory. At the paper width the fine
// 64-component packed plane is ~373 MB and the coarse one ~93 MB; neither
// fits the 50 MB L2, so nearly every point pays a fresh row read: 1 KiB of
// plane row for projection 0 plus 256 B for each of the other two, and the
// line rows. Arithmetic is ~10 flops per output. Design: one thread per
// output element (point, channel). The threads of a warp cover consecutive
// channels of one point, so each of the four (two) slot reads of a row is
// one coalesced 128-byte access and the output store is coalesced. The
// per-point scalar work (coordinates, weights, row index) is repeated by
// each channel's thread: it is a few dozen flops against the memory wait.
// Sums are written with __fmul_rn/__fadd_rn, which the compiler does not
// contract into FMAs, so the kernel rounds where the plain PyTorch version
// (ops/triplane.py::triplane_features_packed) rounds.
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

}  // namespace

EVDN_API int evdn_triplane_features(
    const float* xyz, const float* plane0, const float* plane1,
    const float* plane2, const float* line0, const float* line1,
    const float* line2, float* out, int64_t n, int H0, int W0, int D0, int C0,
    int H1, int W1, int D1, int C1, int H2, int W2, int D2, int C2, int device,
    cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  // MAT_MODE ((0, 1), (0, 2), (1, 2)) and VEC_MODE (2, 1, 0)
  const Tables t{{{plane0, line0, H0, W0, D0, C0, 0, 1, 2},
                  {plane1, line1, H1, W1, D1, C1, 0, 2, 1},
                  {plane2, line2, H2, W2, D2, C2, 1, 2, 0}},
                 C0 + C1 + C2};
  const int64_t work = n * t.ctot;
  if (work <= 0) return static_cast<int>(cudaGetLastError());
  triplane_fwd_kernel<<<evdn::blocks_for(work, evdn::kThreads),
                        evdn::kThreads, 0, stream>>>(xyz, t, out, n);
  return static_cast<int>(cudaGetLastError());
}
