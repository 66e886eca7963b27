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
// neither fits the 50 MB L2, so on uniformly random points nearly every
// point pays a fresh row read: 1 KiB of plane row for projection 0 plus
// 256 B for each of the other two, and the line rows; the samples of a ray
// cross few texels, so on a ray-ordered stream neighbouring points find
// their rows in L1/L2 and what remains is the [N, C0 + C1 + C2] output and
// the issue rate. Arithmetic is ~10 flops per output. Design: C / 4
// lanes per point and projection (16 for C = 64, 4 for C = 16), each on
// four channels: the four plane slots and the two line slots move as
// 16-byte loads and the result goes out as one 16-byte streaming store
// (st.cs: it is written once and read next by a GEMM). The per-point scalar
// work (texel coordinates, slot weights, row indices) is done once a point
// and projection, by the first 3 x 64 threads of a block for the block's
// 64 points, and handed to the lanes through shared memory; the block then
// takes its points through the three projections in turn, several points
// a warp on the narrow ones, so no lane idles. Sums are written with
// __fmul_rn/__fadd_rn per component in the plain version's order, which
// the compiler does not contract into FMAs, so the kernel rounds where the
// plain PyTorch version (ops/triplane.py::triplane_features_packed) rounds
// and equals it bitwise. Component counts that are no multiple of 4, or
// pointers off a 16-byte boundary, take the scalar kernel: one thread per
// output element (point, channel), 4-byte loads, the scalar work repeated
// by every channel's thread. The float4 kernel also reads texel-major
// UNPACKED tables (planes [H * W, C], lines [D, C]: the slots of a row are
// then two segments of 2C floats a plane and one a line), the layout K5
// adds its gradients into; that form serves the bench tool's comparison of
// the two layouts and no model path.
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
//   * d(lines): the raw [C, D] line gradients, summed in shared memory
//     from the per-point packed line-row cotangents (d_lf * q0, d_lf * q1,
//     ops/fused_sample.py:141); where the tables do not fit there, those
//     cotangents [N, 2C] and the packed line row [N] each point reads,
//     from which kernel K6 (line_matmul.cu) sums the same gradients;
//   * d(xyz) [N, 3]: the channel sums of d_pf * row and d_lf * row give the
//     slot-weight cotangents, chained through _slot_weights_bwd
//     (ops/fused_sample.py:74-83) and the texel scaling
//     (_d_fcoords_to_d_xyz, :233-243). Through d(xyz) the warped rays, and
//     so the RBK motion heads, learn.
// K5. Bound: the same random row reads as K4 plus four atomic row updates
// per point and projection into gradients of 94 MB (fine plane 0) that do
// not fit the L2 either. Design: C / 4 lanes per point and projection (16
// for C = 64, 4 for C = 16), each on four channels: rows and cotangent
// move as 16-byte loads, the four corner terms go out as
// atomicAdd(float4*) (red.global.add.v4.f32, a quarter of the reduction
// instructions and L2 requests of scalar adds; the texel-major rows are
// 16-byte aligned when C is a multiple of 4), no lane idles on the narrow
// projections, and the six per-point channel sums are shuffles inside the
// sub-group only. A block takes its points through the three projections
// in turn; each projection's d(xyz) terms meet in shared memory, so d(xyz)
// is written once, coalesced, with no atomics. The cotangent is read once
// and streams past the L2 (ld.cs). Three kernels, chosen by the wrapper
// from the shapes:
//   * fused (every C a multiple of 4 and at most 128, the three line
//     tables together within the 227 KB of shared memory a block can opt
//     in to: 198 KB at the paper's fine tables): the line gradients never
//     leave the chip. A persistent grid of one 512-thread block a
//     multiprocessor holds the three [D, C] tiles; a sub-group walks
//     consecutive points (16 on a 64-component projection, 4 on a
//     16-component one) with the sums of its two current line rows (cur,
//     cur + 1) in registers and adds them to the tile when the row moves,
//     by one row reusing the shared row: neighbouring points of a ray
//     share their rows, and shared-memory float adds are compare-and-swap
//     loops that retry on every collision (line_matmul.cu), so adding
//     each point straight into the tile ran 18% slower on a ray-ordered
//     stream than the scratch and K6. Tile rows are four floats apart
//     and hold channel 4l + k at k * C / 4 + l, which spreads a warp's
//     adds over the banks; the flush adds each nonzero entry to the raw
//     [C, D] gradient, the pack VJP already in the row arithmetic;
//   * float4 with scratch (tables above that budget, or a C above 128):
//     64 points a block; the per-point line-row cotangents [N, 2C] and the
//     packed line row of each point (int32 [N] per projection, K6's index)
//     are written once, streaming (st.cs), for K6 to reduce;
//   * scalar (one warp per point, 4-byte accesses, scratch for K6) for
//     component counts that are no multiple of 4 and pointers off a
//     16-byte boundary.
// Contention: uniformly random points rarely hit the same texel at once,
// but the 64 or 128 samples of a ray cross few texels of a plane, so
// neighbouring points add into the same texel rows and the atomics
// serialise per address in the L2 (PERF.md has both streams' times).
// Determinism: the order of the atomic additions varies from run to run,
// so the plane gradients differ from run to run in the last bits, as the
// reference's grid_sample backward does (ops/triplane.py:6-9).
//
// bf16 tables (--triplane_bf16; ops/fused_sample.py:271-279 and
// ops/triplane.py:238-266 of the JAX package). Every kernel above is a
// template on the element type of the packed tables, f32 or bf16 (kept as
// its 16 bits, evdn::bf16_bits), in three forms:
//   * K4 over bf16 rows: the rows are widened to f32 on load (exact: a
//     shift of the bits), and the math and the output stay f32, so the
//     kernel equals its plain version (the f32 sampler over the widened
//     rows) bitwise. The design is the f32 one, with eight channels a
//     lane: C / 8 lanes a point, the slots moving as 16-byte loads of 8
//     bf16 (mode 3; 9-14% less kernel time than four channels a lane on
//     8-byte loads at the paper's shapes, the same sectors in half the
//     load instructions). Every C a multiple of 8 and every table and the
//     output on a 16-byte boundary, else four channels a lane (every C a
//     multiple of 4, an 8-byte boundary), else the scalar form. At the
//     paper width the packed tables are half the f32 ones (~0.25 GB), the
//     bound's output and xyz do not shrink;
//   * K4 under the bf16 eval chain (table_bf16 and not is_train in the JAX
//     package's voxnerf.py:107-112): rows, the slot weights, every product
//     and sum, plane x line and the output [N, C0 + C1 + C2] in bf16. Each
//     operation is done in f32 and rounded to bf16 (evdn::round_bf16, one
//     hardware conversion, ties to even as PyTorch's) where the plain
//     version's bf16 tensor operation rounds, in its order, so this form
//     too equals its plain version bitwise; XLA may round such chains at
//     other places (on the CPU test inputs it does not), so the JAX
//     function may differ from both by a few bf16 ulps. Bound: bytes, as
//     the f32 form, plus ~12 roundings a channel to issue; its lanes are
//     the row form's (eight channels a lane: 1-4% less kernel time);
//   * K5 over bf16 rows: pf and lf are recomputed from the same bf16 pack
//     the forward read, widened as above; the cotangent, every gradient,
//     the float4 atomics into the raw f32 grids and the line tiles in
//     shared memory are the f32 kernel's. The gradient of the grids is the
//     exact f32 scatter of the JAX package's _take_rows_bf16 custom VJP
//     (ops/triplane.py:120-143 there); d(xyz) and the plane x line terms
//     use the bf16-rounded row values, its residuals.
//
// Coordinates must be finite: NaN coordinates give NaN features (the base
// index is clipped with fmaxf/fminf, which drop the NaN, so no row outside
// the table is ever read).
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using evdn::bf16_bits;
using evdn::round_bf16;

struct Projection {
  const void* plane;   // [H * W, 4C] neighbour-packed, f32 or bf16
  const void* line;    // [D, 2C] neighbour-packed, f32 or bf16
  int H, W, D, C;
  int m0, m1, v;       // xyz columns: plane x, plane y, line
};

// One table element widened to f32, and four (on a 16-byte boundary for
// f32, an 8-byte one for bf16).
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16_bits* p) {
  return evdn::bf16_to_float(__ldg(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16_bits* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Eight bf16 elements on a 16-byte boundary, widened: channels 0-3 and
// 4-7.
__device__ __forceinline__ void ld8(const bf16_bits* p, float4* lo,
                                    float4* hi) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  *lo = make_float4(__uint_as_float(u.x << 16),
                    __uint_as_float(u.x & 0xffff0000u),
                    __uint_as_float(u.y << 16),
                    __uint_as_float(u.y & 0xffff0000u));
  *hi = make_float4(__uint_as_float(u.z << 16),
                    __uint_as_float(u.z & 0xffff0000u),
                    __uint_as_float(u.w << 16),
                    __uint_as_float(u.w & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ const T* plane_of(const Projection& p) {
  return static_cast<const T*>(p.plane);
}
template <typename T>
__device__ __forceinline__ const T* line_of(const Projection& p) {
  return static_cast<const T*>(p.line);
}

// K4's output element: f32, or bf16 under the bf16 eval chain
template <bool kBf16Math>
using OutT = std::conditional_t<kBf16Math, bf16_bits, float>;

// A slot weight as the math takes it: rounded to bf16 under the chain
template <bool kBf16Math>
__device__ __forceinline__ float math_weight(float w) {
  return kBf16Math ? round_bf16(w) : w;
}

struct Tables {
  Projection p[3];
  int ctot;
  int unpacked;  // K4's float4 kernel only: planes [H * W, C], lines [D, C]
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

// One component of the output, rounded as the plain version rounds: f32
// sums with no FMA contraction, or under the bf16 chain every product and
// sum rounded to bf16 (the weights arrive rounded).
template <bool kBf16Math>
__device__ __forceinline__ float feature(float s00, float s01, float s10,
                                         float s11, float l0, float l1,
                                         float w00, float w01, float w10,
                                         float w11, float q0, float q1) {
  if (kBf16Math) {
    float pf = round_bf16(__fmul_rn(s00, w00));
    pf = round_bf16(__fadd_rn(pf, round_bf16(__fmul_rn(s01, w01))));
    pf = round_bf16(__fadd_rn(pf, round_bf16(__fmul_rn(s10, w10))));
    pf = round_bf16(__fadd_rn(pf, round_bf16(__fmul_rn(s11, w11))));
    const float lf = round_bf16(__fadd_rn(round_bf16(__fmul_rn(l0, q0)),
                                          round_bf16(__fmul_rn(l1, q1))));
    return round_bf16(__fmul_rn(pf, lf));
  }
  float pf = __fmul_rn(s00, w00);
  pf = __fadd_rn(pf, __fmul_rn(s01, w01));
  pf = __fadd_rn(pf, __fmul_rn(s10, w10));
  pf = __fadd_rn(pf, __fmul_rn(s11, w11));
  const float lf = __fadd_rn(__fmul_rn(l0, q0), __fmul_rn(l1, q1));
  return __fmul_rn(pf, lf);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16_bits* p, float v) {
  *p = static_cast<bf16_bits>(evdn::bf16_bits_of(v));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4(bf16_bits* p, float4 v) {
  uint2 u;
  u.x = evdn::bf16_bits_of(v.x) | (evdn::bf16_bits_of(v.y) << 16);
  u.y = evdn::bf16_bits_of(v.z) | (evdn::bf16_bits_of(v.w) << 16);
  __stcs(reinterpret_cast<uint2*>(p), u);
}
// Eight outputs on a 16-byte boundary (two f32 stores, or one of bf16).
__device__ __forceinline__ void store8(float* p, float4 lo, float4 hi) {
  store4(p, lo);
  store4(p + 4, hi);
}
__device__ __forceinline__ void store8(bf16_bits* p, float4 lo, float4 hi) {
  uint4 u;
  u.x = evdn::bf16_bits_of(lo.x) | (evdn::bf16_bits_of(lo.y) << 16);
  u.y = evdn::bf16_bits_of(lo.z) | (evdn::bf16_bits_of(lo.w) << 16);
  u.z = evdn::bf16_bits_of(hi.x) | (evdn::bf16_bits_of(hi.y) << 16);
  u.w = evdn::bf16_bits_of(hi.z) | (evdn::bf16_bits_of(hi.w) << 16);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// Four channels of the output from their four plane slots and two line
// slots; the weights as in feature().
template <bool kBf16Math>
__device__ __forceinline__ float4 feature4(float4 s00, float4 s01,
                                           float4 s10, float4 s11,
                                           float4 l0, float4 l1,
                                           const float* w) {
  float4 r;
  r.x = feature<kBf16Math>(s00.x, s01.x, s10.x, s11.x, l0.x, l1.x, w[0],
                           w[1], w[2], w[3], w[4], w[5]);
  r.y = feature<kBf16Math>(s00.y, s01.y, s10.y, s11.y, l0.y, l1.y, w[0],
                           w[1], w[2], w[3], w[4], w[5]);
  r.z = feature<kBf16Math>(s00.z, s01.z, s10.z, s11.z, l0.z, l1.z, w[0],
                           w[1], w[2], w[3], w[4], w[5]);
  r.w = feature<kBf16Math>(s00.w, s01.w, s10.w, s11.w, l0.w, l1.w, w[0],
                           w[1], w[2], w[3], w[4], w[5]);
  return r;
}

template <typename T, bool kBf16Math>
__global__ void triplane_fwd_scalar_kernel(const float* __restrict__ xyz,
                                    const __grid_constant__ Tables t,
                                    OutT<kBf16Math>* __restrict__ out,
                                    int64_t n) {
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
  const T* pr =
      plane_of<T>(p) + (static_cast<int64_t>(by) * p.W + bx) * 4 * C;
  const T* lr = line_of<T>(p) + static_cast<int64_t>(bl) * 2 * C;
  const float v = feature<kBf16Math>(
      ld1(pr + c), ld1(pr + C + c), ld1(pr + 2 * C + c), ld1(pr + 3 * C + c),
      ld1(lr + c), ld1(lr + C + c),
      math_weight<kBf16Math>(__fmul_rn(sy0, sx0)),
      math_weight<kBf16Math>(__fmul_rn(sy0, sx1)),
      math_weight<kBf16Math>(__fmul_rn(sy1, sx0)),
      math_weight<kBf16Math>(__fmul_rn(sy1, sx1)),
      math_weight<kBf16Math>(q0), math_weight<kBf16Math>(q1));
  store1(out + g, v);
}

// ---- K4 on four channels a lane ----

constexpr int kFwdPoints = 64;  // points a block takes

// Lanes a point: the power of two that holds C / 4, at most a warp.
__device__ __forceinline__ int group_shift(int q4) {
  int shift = 0;
  while ((1 << shift) < q4 && shift < 5) ++shift;
  return shift;
}

// Every C a multiple of kVec, every table and the output on a boundary of
// kVec elements (kVec 4: 16 bytes f32, 8 bytes bf16; kVec 8, bf16 tables
// only: 16 bytes). Thread tid < 3 * 64 prepares point tid % 64 on
// projection tid / 64; then thread tid works on point tid / G of the
// block's 64, G the lanes a point of the projection at hand, kVec channels
// a lane.
template <typename T, bool kBf16Math, int kVec = 4>
__global__ void __launch_bounds__(evdn::kThreads)
    triplane_fwd_kernel(const float* __restrict__ xyz,
                        const __grid_constant__ Tables t,
                        OutT<kBf16Math>* __restrict__ out, int64_t n) {
  __shared__ int s_texel[3 * kFwdPoints];  // by * W + bx
  __shared__ int s_row[3 * kFwdPoints];    // bl
  // the four corner weights and the two line weights
  __shared__ float s_w[6][3 * kFwdPoints];
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kFwdPoints;
  if (tid < 3 * kFwdPoints) {
    const int i = tid / kFwdPoints;
    const int64_t pt = p0 + (tid - i * kFwdPoints);
    if (pt < n) {
      const Projection& p = t.p[i];
      const float* q = xyz + pt * 3;
      float sx0, sx1, sy0, sy1, q0, q1;
      const int bx =
          slot_weights(texel_coord(__ldg(q + p.m0), p.W), p.W, &sx0, &sx1);
      const int by =
          slot_weights(texel_coord(__ldg(q + p.m1), p.H), p.H, &sy0, &sy1);
      s_row[tid] =
          slot_weights(texel_coord(__ldg(q + p.v), p.D), p.D, &q0, &q1);
      s_texel[tid] = by * p.W + bx;
      s_w[0][tid] = math_weight<kBf16Math>(__fmul_rn(sy0, sx0));
      s_w[1][tid] = math_weight<kBf16Math>(__fmul_rn(sy0, sx1));
      s_w[2][tid] = math_weight<kBf16Math>(__fmul_rn(sy1, sx0));
      s_w[3][tid] = math_weight<kBf16Math>(__fmul_rn(sy1, sx1));
      s_w[4][tid] = math_weight<kBf16Math>(q0);
      s_w[5][tid] = math_weight<kBf16Math>(q1);
    }
  }
  __syncthreads();
  int off = 0;
  for (int i = 0; i < 3; ++i) {
    const Projection& p = t.p[i];
    const int C = p.C;
    const int shift = group_shift(C / kVec);
    const int G = 1 << shift;
    const int lane = tid & (G - 1);
    const int groups = evdn::kThreads >> shift;
    // floats from one row to the next, and from slot (0, 0) to slots
    // (0, 1), (1, 0), (1, 1) of a plane row and to slot 1 of a line row
    const int pstride = t.unpacked ? C : 4 * C;
    const int lstride = t.unpacked ? C : 2 * C;
    const int o10 = t.unpacked ? p.W * C : 2 * C;
    for (int pl = tid >> shift; pl < kFwdPoints; pl += groups) {
      const int64_t pt = p0 + pl;
      if (pt >= n) break;
      const int k = i * kFwdPoints + pl;
      const float w[6] = {s_w[0][k], s_w[1][k], s_w[2][k],
                          s_w[3][k], s_w[4][k], s_w[5][k]};
      const T* pr =
          plane_of<T>(p) + static_cast<int64_t>(s_texel[k]) * pstride;
      const T* lr = line_of<T>(p) + static_cast<int64_t>(s_row[k]) * lstride;
      OutT<kBf16Math>* o = out + pt * t.ctot + off;
      for (int c = lane * kVec; c < C; c += G * kVec) {
        if constexpr (kVec == 8) {
          float4 a00, b00, a01, b01, a10, b10, a11, b11, a0, b0, a1, b1;
          ld8(pr + c, &a00, &b00);
          ld8(pr + C + c, &a01, &b01);
          ld8(pr + o10 + c, &a10, &b10);
          ld8(pr + o10 + C + c, &a11, &b11);
          ld8(lr + c, &a0, &b0);
          ld8(lr + C + c, &a1, &b1);
          store8(o + c,
                 feature4<kBf16Math>(a00, a01, a10, a11, a0, a1, w),
                 feature4<kBf16Math>(b00, b01, b10, b11, b0, b1, w));
        } else {
          store4(o + c, feature4<kBf16Math>(
                            ld4(pr + c), ld4(pr + C + c), ld4(pr + o10 + c),
                            ld4(pr + o10 + C + c), ld4(lr + c),
                            ld4(lr + C + c), w));
        }
      }
    }
    off += C;
  }
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
  float* line[3];   // [N, 2C] per-point packed line-row cotangents; for
                    // the fused kernel the raw [C, D] gradient, zeroed
  int32_t* row[3];  // [N] the packed line row each point reads (K6's
                    // index); not written by the fused kernel
  float* xyz;       // [N, 3]
};

template <typename T>
__global__ void triplane_bwd_scalar_kernel(const float* __restrict__ xyz,
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
    const T* pr = plane_of<T>(p) + texel * 4 * C;
    const T* lr = line_of<T>(p) + static_cast<int64_t>(bl) * 2 * C;
    const float* gp = g + pt * t.ctot + off;
    float* dp = d.plane[i];
    float* dl = d.line[i] + pt * 2 * C;
    if (lane == 0) d.row[i][pt] = bl;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float s00 = ld1(pr + c), s01 = ld1(pr + C + c);
      const float s10 = ld1(pr + 2 * C + c), s11 = ld1(pr + 3 * C + c);
      const float l0 = ld1(lr + c), l1 = ld1(lr + C + c);
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

// ---- K5 on four channels a lane ----

constexpr int kBwdPoints = 64;  // points a block takes

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// a * s + b * t
__device__ __forceinline__ float4 axpby4(float4 a, float s, float4 b,
                                         float t) {
  return make_float4(a.x * s + b.x * t, a.y * s + b.y * t, a.z * s + b.z * t,
                     a.w * s + b.w * t);
}

__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// One point's geometry on one projection: texel coordinates, slot weights,
// base indices.
struct PointGeom {
  float fx, fy, fl;
  float sx0, sx1, sy0, sy1, q0, q1;
  int bx, by, bl;
};

__device__ __forceinline__ PointGeom point_geom(const Projection& p,
                                                const float* q) {
  PointGeom m;
  m.fx = texel_coord(q[p.m0], p.W);
  m.fy = texel_coord(q[p.m1], p.H);
  m.fl = texel_coord(q[p.v], p.D);
  m.bx = slot_weights(m.fx, p.W, &m.sx0, &m.sx1);
  m.by = slot_weights(m.fy, p.H, &m.sy0, &m.sy1);
  m.bl = slot_weights(m.fl, p.D, &m.q0, &m.q1);
  return m;
}

// The six channel sums of one point and projection, and from them d(xyz).
struct SlotSums {
  float a00, a01, a10, a11, b0, b1;
};

__device__ __forceinline__ void group_sum(SlotSums& s, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) {
    s.a00 += __shfl_xor_sync(0xffffffffu, s.a00, o);
    s.a01 += __shfl_xor_sync(0xffffffffu, s.a01, o);
    s.a10 += __shfl_xor_sync(0xffffffffu, s.a10, o);
    s.a11 += __shfl_xor_sync(0xffffffffu, s.a11, o);
    s.b0 += __shfl_xor_sync(0xffffffffu, s.b0, o);
    s.b1 += __shfl_xor_sync(0xffffffffu, s.b1, o);
  }
}

// dxyz[0..2] += this projection's terms; one thread a point and projection
__device__ __forceinline__ void add_dxyz(float* dxyz, const Projection& p,
                                         const PointGeom& m,
                                         const SlotSums& s) {
  const float d_fx =
      slot_weights_bwd(m.fx, p.W, s.a00 * m.sy0 + s.a10 * m.sy1,
                       s.a01 * m.sy0 + s.a11 * m.sy1);
  const float d_fy =
      slot_weights_bwd(m.fy, p.H, s.a00 * m.sx0 + s.a01 * m.sx1,
                       s.a10 * m.sx0 + s.a11 * m.sx1);
  const float d_fl = slot_weights_bwd(m.fl, p.D, s.b0, s.b1);
  dxyz[p.m0] += d_fx * (0.5f * (p.W - 1));
  dxyz[p.m1] += d_fy * (0.5f * (p.H - 1));
  dxyz[p.v] += d_fl * (0.5f * (p.D - 1));
}

// Channels c..c+3 of one point and projection: reads the rows and the
// cotangent gp[c..], adds the four corner terms into the plane gradient
// dplane (texel-major [H * W, C]), adds this lane's part to the channel
// sums and returns the two line-row cotangents d_lf * q0, d_lf * q1.
template <typename T>
__device__ __forceinline__ void lane_terms(const Projection& p,
                                           const PointGeom& m,
                                           const float* gp, float* dplane,
                                           int c, SlotSums& s, float4* t0,
                                           float4* t1) {
  const int C = p.C;
  const float w00 = __fmul_rn(m.sy0, m.sx0), w01 = __fmul_rn(m.sy0, m.sx1);
  const float w10 = __fmul_rn(m.sy1, m.sx0), w11 = __fmul_rn(m.sy1, m.sx1);
  const int64_t texel = static_cast<int64_t>(m.by) * p.W + m.bx;
  const T* pr = plane_of<T>(p) + texel * 4 * C + c;
  const T* lr = line_of<T>(p) + static_cast<int64_t>(m.bl) * 2 * C + c;
  float* dp = dplane + texel * C + c;
  const float4 s00 = ld4(pr), s01 = ld4(pr + C);
  const float4 s10 = ld4(pr + 2 * C), s11 = ld4(pr + 3 * C);
  const float4 l0 = ld4(lr), l1 = ld4(lr + C);
  const float4 gi = __ldcs(reinterpret_cast<const float4*>(gp + c));
  const float4 top = axpby4(s00, w00, s01, w01);
  const float4 bot = axpby4(s10, w10, s11, w11);
  const float4 pf = axpby4(top, 1.f, bot, 1.f);
  const float4 lf = axpby4(l0, m.q0, l1, m.q1);
  const float4 d_pf = mul4(gi, lf);
  const float4 d_lf = mul4(gi, pf);
  red4(dp, scale4(d_pf, w00));
  red4(dp + C, scale4(d_pf, w01));
  red4(dp + static_cast<int64_t>(p.W) * C, scale4(d_pf, w10));
  red4(dp + static_cast<int64_t>(p.W + 1) * C, scale4(d_pf, w11));
  s.a00 += dot4(d_pf, s00);
  s.a01 += dot4(d_pf, s01);
  s.a10 += dot4(d_pf, s10);
  s.a11 += dot4(d_pf, s11);
  s.b0 += dot4(d_lf, l0);
  s.b1 += dot4(d_lf, l1);
  *t0 = scale4(d_lf, m.q0);
  *t1 = scale4(d_lf, m.q1);
}

// The float4 kernel with scratch. Every C a multiple of 4, every pointer
// on a 16-byte boundary. Thread tid works on point tid / G of the block's
// 64; a warp's lanes run the same trips, so the sub-group shuffles are
// full-warp calls.
template <typename T>
__global__ void __launch_bounds__(evdn::kThreads)
    triplane_bwd_kernel(const float* __restrict__ xyz,
                        const __grid_constant__ Tables t,
                        const float* __restrict__ g,
                        const __grid_constant__ Grads d, int64_t n) {
  __shared__ float s_dxyz[kBwdPoints * 3];
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kBwdPoints;
  if (tid < kBwdPoints * 3) s_dxyz[tid] = 0.f;
  __syncthreads();
  int off = 0;
  for (int i = 0; i < 3; ++i) {
    const Projection& p = t.p[i];
    const int C = p.C;
    const int shift = group_shift(C >> 2);
    const int G = 1 << shift;
    const int lane = tid & (G - 1);
    const int groups = evdn::kThreads >> shift;
    for (int pl = tid >> shift; pl < kBwdPoints; pl += groups) {
      const int64_t pt = p0 + pl;
      const bool valid = pt < n;
      SlotSums s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      PointGeom m{};
      if (valid) {
        m = point_geom(p, xyz + pt * 3);
        float* dl = d.line[i] + pt * 2 * C;
        if (lane == 0) d.row[i][pt] = m.bl;
        for (int c = lane * 4; c < C; c += G * 4) {
          float4 t0, t1;
          lane_terms<T>(p, m, g + pt * t.ctot + off, d.plane[i], c, s, &t0,
                        &t1);
          __stcs(reinterpret_cast<float4*>(dl + c), t0);
          __stcs(reinterpret_cast<float4*>(dl + C + c), t1);
        }
      }
      group_sum(s, G);
      // one sub-group a point and projection: no other thread adds here
      // before the barrier below
      if (valid && lane == 0) add_dxyz(s_dxyz + pl * 3, p, m, s);
    }
    __syncthreads();
    off += C;
  }
  if (tid < kBwdPoints * 3 && p0 * 3 + tid < n * 3)
    d.xyz[p0 * 3 + tid] = s_dxyz[tid];
}

// ---- K5 fused with the line reduction ----

constexpr int kFusedThreads = 512;
constexpr int kFusedPoints = 512;  // points a pass of the block's loop
constexpr int kTilePad = 4;        // floats between the rows of a tile

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// row of a projection's tile += v, the lane's channels 4l..4l + 3 at
// positions l, q4 + l, 2 q4 + l, 3 q4 + l
__device__ __forceinline__ void tile_add(float* row, int q4, int l,
                                         float4 v) {
  atomicAdd(row + l, v.x);
  atomicAdd(row + q4 + l, v.y);
  atomicAdd(row + 2 * q4 + l, v.z);
  atomicAdd(row + 3 * q4 + l, v.w);
}

// Floats of dynamic shared memory the fused kernel needs: d(xyz) of a pass
// and the three tiles, row d of projection i at d * (C + kTilePad).
__host__ __device__ inline int64_t fused_floats(const Tables& t) {
  int64_t f = kFusedPoints * 3;
  for (int i = 0; i < 3; ++i)
    f += static_cast<int64_t>(t.p[i].D) * (t.p[i].C + kTilePad);
  return f;
}

// Every C a multiple of 4 and at most 128 (one float4 a lane), every
// pointer on a 16-byte boundary. d.line[i] is the raw [C, D] gradient.
template <typename T>
__global__ void __launch_bounds__(kFusedThreads, 1)
    triplane_bwd_fused_kernel(const float* __restrict__ xyz,
                              const __grid_constant__ Tables t,
                              const float* __restrict__ g,
                              const __grid_constant__ Grads d, int64_t n) {
  extern __shared__ __align__(16) float smem[];
  float* s_dxyz = smem;
  float* tile[3];
  tile[0] = smem + kFusedPoints * 3;
  tile[1] = tile[0] + t.p[0].D * (t.p[0].C + kTilePad);
  tile[2] = tile[1] + t.p[1].D * (t.p[1].C + kTilePad);
  const int tid = threadIdx.x;
  const int total = static_cast<int>(fused_floats(t));
  for (int j = kFusedPoints * 3 + tid; j < total; j += kFusedThreads)
    smem[j] = 0.f;
  // the block's slab of points, in whole passes
  int64_t slab = (n + gridDim.x - 1) / gridDim.x;
  slab = (slab + kFusedPoints - 1) / kFusedPoints * kFusedPoints;
  const int64_t s0 = blockIdx.x * slab;
  const int64_t s1 = min(n, s0 + slab);
  for (int64_t p0 = s0; p0 < s1; p0 += kFusedPoints) {
    __syncthreads();
    for (int j = tid; j < kFusedPoints * 3; j += kFusedThreads)
      s_dxyz[j] = 0.f;
    __syncthreads();
    int off = 0;
    for (int i = 0; i < 3; ++i) {
      const Projection& p = t.p[i];
      const int C = p.C, q4 = C >> 2;
      const int shift = group_shift(q4);
      const int G = 1 << shift;
      const int lane = tid & (G - 1);
      const bool active = lane < q4;
      // consecutive points of one sub-group
      const int per = kFusedPoints / (kFusedThreads >> shift);
      const int stride = C + kTilePad;
      // the sums of the line rows cur and cur + 1, in registers while the
      // points stay on them
      float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
      int cur = -2;  // no row yet
      auto flush0 = [&]() {
        if (cur >= 0) tile_add(tile[i] + cur * stride, q4, lane, acc0);
      };
      auto flush1 = [&]() {
        if (cur >= 0) tile_add(tile[i] + (cur + 1) * stride, q4, lane, acc1);
      };
      for (int k = 0; k < per; ++k) {
        const int pl = (tid >> shift) * per + k;
        const int64_t pt = p0 + pl;
        const bool valid = pt < s1;
        SlotSums s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        PointGeom m{};
        if (valid) {
          m = point_geom(p, xyz + pt * 3);
          if (active) {
            float4 t0, t1;
            lane_terms<T>(p, m, g + pt * t.ctot + off, d.plane[i], lane * 4,
                          s, &t0, &t1);
            if (m.bl == cur) {
              acc0 = add4(acc0, t0);
              acc1 = add4(acc1, t1);
            } else if (m.bl == cur + 1) {  // row cur + 1 stays in registers
              flush0();
              acc0 = add4(acc1, t0);
              acc1 = t1;
              cur = m.bl;
            } else if (m.bl == cur - 1) {
              flush1();
              acc1 = add4(acc0, t1);
              acc0 = t0;
              cur = m.bl;
            } else {
              flush0();
              flush1();
              acc0 = t0;
              acc1 = t1;
              cur = m.bl;
            }
          }
        }
        group_sum(s, G);
        if (valid && lane == 0) add_dxyz(s_dxyz + pl * 3, p, m, s);
      }
      if (active) {
        flush0();
        flush1();
      }
      __syncthreads();
      off += C;
    }
    for (int j = tid; j < kFusedPoints * 3; j += kFusedThreads)
      if (p0 * 3 + j < s1 * 3) d.xyz[p0 * 3 + j] = s_dxyz[j];
  }
  __syncthreads();
  // flush: tile entry (row r, channel c) adds to the raw gradient [c, r];
  // row bl + 1 <= D - 1 always, so nothing falls outside
  const int warp = tid / 32, lane32 = tid % 32;
  for (int i = 0; i < 3; ++i) {
    const int C = t.p[i].C, q4 = C >> 2, D = t.p[i].D, stride = C + kTilePad;
    for (int c = warp; c < C; c += kFusedThreads / 32) {
      const int pos = (c & 3) * q4 + (c >> 2);
      float* col = d.line[i] + static_cast<int64_t>(c) * D;
      for (int r = lane32; r < D; r += 32) {
        const float v = tile[i][r * stride + pos];
        if (v != 0.f) atomicAdd(col + r, v);
      }
    }
  }
}

}  // namespace

namespace {

// MAT_MODE ((0, 1), (0, 2), (1, 2)) and VEC_MODE (2, 1, 0)
Tables make_tables(const void* plane0, const void* plane1, const void* plane2,
                   const void* line0, const void* line1, const void* line2,
                   int H0, int W0, int D0, int C0, int H1, int W1, int D1,
                   int C1, int H2, int W2, int D2, int C2) {
  return Tables{{{plane0, line0, H0, W0, D0, C0, 0, 1, 2},
                 {plane1, line1, H1, W1, D1, C1, 0, 2, 1},
                 {plane2, line2, H2, W2, D2, C2, 1, 2, 0}},
                C0 + C1 + C2, 0};
}

template <typename T, bool kBf16Math>
void launch_fwd(const float* xyz, const Tables& t, void* out, int64_t n,
                int mode, cudaStream_t stream) {
  auto* o = static_cast<OutT<kBf16Math>*>(out);
  if constexpr (std::is_same_v<T, bf16_bits>) {
    if (mode == 3) {
      triplane_fwd_kernel<T, kBf16Math, 8>
          <<<evdn::blocks_for(n, kFwdPoints), evdn::kThreads, 0, stream>>>(
              xyz, t, o, n);
      return;
    }
  }
  if (mode) {
    triplane_fwd_kernel<T, kBf16Math>
        <<<evdn::blocks_for(n, kFwdPoints), evdn::kThreads, 0, stream>>>(
            xyz, t, o, n);
  } else {
    triplane_fwd_scalar_kernel<T, kBf16Math>
        <<<evdn::blocks_for(n * t.ctot, evdn::kThreads), evdn::kThreads, 0,
           stream>>>(xyz, t, o, n);
  }
}

template <typename T>
int launch_bwd(const float* xyz, const Tables& t, const float* g,
               const Grads& d, int64_t n, int mode, int device,
               cudaStream_t stream) {
  if (mode == 2) {
    if (t.p[0].C > 128 || t.p[1].C > 128 || t.p[2].C > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    static bool raised[evdn::kMaxDevices];
    int sms = 0, optin = 0;
    cudaError_t err = evdn::device_limits(device, &sms, &optin);
    const int64_t bytes = fused_floats(t) * sizeof(float);
    if (err == cudaSuccess && bytes > optin) err = cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = evdn::raise_shared_memory(triplane_bwd_fused_kernel<T>, optin,
                                      device, raised);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = static_cast<int>(
        std::min<int64_t>(sms, evdn::blocks_for(n, kFusedPoints)));
    triplane_bwd_fused_kernel<T><<<blocks, kFusedThreads, bytes, stream>>>(
        xyz, t, g, d, n);
  } else if (mode == 1) {
    triplane_bwd_kernel<T><<<evdn::blocks_for(n, kBwdPoints), evdn::kThreads,
                             0, stream>>>(xyz, t, g, d, n);
  } else {
    constexpr int kPointsPerBlock = evdn::kThreads / 32;
    triplane_bwd_scalar_kernel<T><<<evdn::blocks_for(n, kPointsPerBlock),
                                    evdn::kThreads, 0, stream>>>(xyz, t, g,
                                                                 d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: the scalar kernel, 1: the vector kernel (four channels a lane),
// both over the neighbour-packed tables; 2: the vector kernel over
// texel-major unpacked tables (plane* [H * W, C], line* [D, C]; f32 only);
// 3: the vector kernel on eight channels a lane (bf16 tables, every C a
// multiple of 8, tables and output on a 16-byte boundary). tables 0: f32
// tables and output; 1: bf16 tables, f32 math and output; 2: bf16 tables,
// math and output (the bf16 eval chain).
EVDN_API int evdn_triplane_features(
    const float* xyz, const void* plane0, const void* plane1,
    const void* plane2, const void* line0, const void* line1,
    const void* line2, void* out, int64_t n, int H0, int W0, int D0, int C0,
    int H1, int W1, int D1, int C1, int H2, int W2, int D2, int C2,
    int tables, int mode, int device, cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  Tables t = make_tables(plane0, plane1, plane2, line0, line1, line2, H0, W0,
                         D0, C0, H1, W1, D1, C1, H2, W2, D2, C2);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((mode && (C0 % 4 || C1 % 4 || C2 % 4)) || tables < 0 || tables > 2 ||
      mode < 0 || mode > 3 || (mode == 2 && tables) ||
      (mode == 3 && (!tables || C0 % 8 || C1 % 8 || C2 % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  t.unpacked = mode == 2;
  if (tables == 0)
    launch_fwd<float, false>(xyz, t, out, n, mode, stream);
  else if (tables == 1)
    launch_fwd<bf16_bits, false>(xyz, t, out, n, mode, stream);
  else
    launch_fwd<bf16_bits, true>(xyz, t, out, n, mode, stream);
  return static_cast<int>(cudaGetLastError());
}

// mode 0: the scalar kernel, 1: the float4 kernel (both write the [N, 2C]
// scratch dline* and the rows drow* for K6), 2: the fused kernel (dline*
// are the raw [C, D] line gradients, zeroed; drow* are not used). tables
// 0: f32 packed tables, 1: bf16 ones (the gradients stay f32).
EVDN_API int evdn_triplane_features_bwd(
    const float* xyz, const void* plane0, const void* plane1,
    const void* plane2, const void* line0, const void* line1,
    const void* line2, const float* g, float* dplane0, float* dplane1,
    float* dplane2, float* dline0, float* dline1, float* dline2,
    int32_t* drow0, int32_t* drow1, int32_t* drow2, float* dxyz, int64_t n,
    int H0, int W0, int D0, int C0, int H1, int W1, int D1, int C1, int H2,
    int W2, int D2, int C2, int tables, int mode, int device,
    cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  const Tables t = make_tables(plane0, plane1, plane2, line0, line1, line2,
                               H0, W0, D0, C0, H1, W1, D1, C1, H2, W2, D2,
                               C2);
  const Grads d{{dplane0, dplane1, dplane2},
                {dline0, dline1, dline2},
                {drow0, drow1, drow2},
                dxyz};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((mode && (C0 % 4 || C1 % 4 || C2 % 4)) || tables < 0 || tables > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return tables ? launch_bwd<bf16_bits>(xyz, t, g, d, n, mode, device, stream)
                : launch_bwd<float>(xyz, t, g, d, n, mode, device, stream);
}
