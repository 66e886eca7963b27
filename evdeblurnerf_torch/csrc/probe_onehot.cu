// One-hot tent contraction on the tensor cores: kernel K9.
//
// onehot_lerp: out[n, :] = sum_k w[n, k] * tile[k, :], where
//   w[n, k] = [k = idx[n]] * cast(1 - frac[n]) + [k = idx[n] + 1] *
//   cast(frac[n]): a two-corner tent one-hot built in the tile's type
//   (bf16 or f32), contracted with f32 accumulation into [N, C] f32.
//   Replaces tools/probe_onehot.py::make_kernel (Pallas, via run): the TPU
//   probe of whether building a [rows, K] one-hot in registers and
//   contracting it with a resident [K, C] tile on the matrix unit beats a
//   row gather. The kernel must build and contract the whole one-hot: a
//   shortcut to the two rows it selects would be the gather it is held
//   against (F.embedding_bag), and answer another question. No k-step is
//   skipped, and no row is read directly.
//   Bound: max(bytes / 3.35 TB/s, 2*N*K*C / the route's tensor-core rate).
//   Bytes: N*(8 + 4C) plus the tile, 0.083 ms at N = 1,048,576, C = 64.
//   Operations: bf16 at 989 TFLOP/s, 0.035 / 0.139 / 0.556 ms at K = 256 /
//   1024 / 4096; f32 by three TF32 products a product (below) at 495
//   TFLOP/s, so 2*N*K*C over 165 TFLOP/s, 0.21 / 0.83 / 3.33 ms. Above K =
//   256 in bf16, and at every K in f32, the operations bound it.
//   Design (warpgroup products; only wgmma reaches the card's rate):
//   * The product: wgmma.mma_async m64 k16 (bf16) or k8 (TF32), with
//     register A and shared B, the sums in registers. ptxas keeps a
//     commit group of such products in flight only where some register
//     fragment feeds two of them; else it serialises every product
//     (warning C7513). TF32 feeds each fragment to the three products
//     below (n = C, in n64 pieces at C = 128). bf16 takes every tile but
//     a warpgroup's last in one product of n = C and the last in two of n
//     = C / 2 (C = 128: two n64 for every tile); on the H100 that ran
//     faster than splitting every tile, and both far faster than the
//     serialised whole-width form.
//   * A block holds kConsumerGroups consumer warpgroups (three over bf16
//     tiles, two over f32), each kTiles m64 tiles of rows (kRows rows a
//     block), and one producer warp; kTiles keeps a consumer within the
//     registers a thread of such a block gets.
//   * The one-hot (operand A) is built in registers from each row's idx
//     and its two weights, cast to the tile's type, straight into the
//     wgmma A fragments. A thread's row meets the one-hot's two nonzero
//     columns in at most one k-step, so a row keeps that step and its two
//     fragment registers (two more for the TF32 lo parts); building a
//     k-step is one compare and a select a register. The fragments are
//     double-buffered: k-step s + 1 is built while the product of k-step s
//     runs (wgmma.fence, commit_group, wait_group 1), and no register a
//     product in flight reads is written.
//   * The tile (operand B) sits in shared memory K-major in the
//     128-byte-swizzled layout the wgmma descriptor names (8-row groups of
//     128-byte rows, 16-byte chunk j of row r at j ^ r). TF32 has no
//     transposed-B form (the PTX ISA gives imm-trans-b to f16/bf16 only),
//     so the tile is written [C, K]; bf16 takes the same layout. A first
//     launch packs the tile once into that image, stage by stage, zeros
//     past row K; over an f32 tile it splits each value into TF32 hi and
//     lo planes (microseconds at K*C <= 4096*128). A ring of kStages
//     stages is filled by the producer warp with cp.async.bulk, each stage
//     signalled by an mbarrier; consumers release a stage once the
//     products reading it have completed.
//   * Blocks are persistent, one an SM, in clusters of kCluster: the two
//     blocks of a cluster take neighbouring row groups and share every
//     stage, each loading half of it and multicasting that half to both,
//     so the tile is read from L2 once a cluster pass:
//     ceil(N / (kCluster * kRows)) times its packed bytes a call.
//   * The producer warp also stages each row group's idx and frac in
//     shared memory (double-buffered, its own mbarriers), ahead of the
//     consumers.
//   * bf16: each nonzero product of two bf16 values is exact in f32; a
//     row's sum rounds as the tensor core accumulates.
//   * f32: never plain TF32, which rounds the tile to 11 significant bits
//     (about 1e-3 off). Each f32 value x is split into hi = tf32(x) and lo
//     = tf32(x - hi), and a product is taken as lo_a*hi_b + hi_a*lo_b +
//     hi_a*hi_b (three wgmma, the small terms first), within a few 1e-7
//     of the f32 product.
//   * Epilogue: each lane pair trades one half of its two rows' pairs, so
//     a lane holds four neighbouring columns of one row: 16-byte
//     streaming stores into [N, C] f32.
//   Rows past N build a zero one-hot and are not stored; tile rows past K
//   are zeros.
#include "common.cuh"

namespace {

constexpr int kCluster = 2;                 // blocks sharing each stage
static_assert(kCluster > 1, "the stages are multicast");
constexpr int kSwizzle = 128;               // bytes of a swizzled row
constexpr int kStageTarget = 8192;          // bytes a stage, at least
constexpr int kRingBudget = 192 * 1024;     // bytes of the stage ring
constexpr int kMaxStages = 16;
// clocks a barrier wait may take before the kernel traps (about 2 s): a
// launch that stalls ends with an error instead of holding the card
constexpr long long kWaitClocks = 4000000000LL;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The geometry of one tile type and width; ops/probe_onehot.py::plan is
// its twin.
template <bool kBf16, int C>
struct Plan {
  static constexpr int kConsumerGroups = kBf16 ? 3 : 2;
  static constexpr int kConsumerWarps = kConsumerGroups * 4;
  static constexpr int kThreads = kConsumerWarps * 32 + 32;
  static constexpr int kElem = kBf16 ? 2 : 4;
  static constexpr int kPlanes = kBf16 ? 1 : 2;    // f32: TF32 hi, lo
  static constexpr int kAtomK = kSwizzle / kElem;  // K a swizzled row holds
  static constexpr int kStepK = 32 / kElem;        // K of one wgmma
  static constexpr int kStepsPerAtom = kAtomK / kStepK;
  static constexpr int kPlaneBytes = C * kSwizzle;
  static constexpr int kAtomBytes = kPlaneBytes * kPlanes;
  static constexpr int kAtomsPerStage = cmax(1, kStageTarget / kAtomBytes);
  static constexpr int kStageBytes = kAtomsPerStage * kAtomBytes;
  static constexpr int kStageK = kAtomsPerStage * kAtomK;
  static constexpr int kSteps = kAtomsPerStage * kStepsPerAtom;
  static constexpr int kStages = cmin(kMaxStages, kRingBudget / kStageBytes);
  // m64 tiles a consumer warpgroup holds: C / 2 accumulators, both
  // fragment buffers and the rows' one-hots each, within the registers a
  // thread gets (the 65,536 of an SM over whole warpgroups of the block:
  // 128 over bf16 tiles, 168 over f32)
  static constexpr int kTiles =
      C == 128 ? 1 : (C == 64 ? 2 : (C == 32 ? 3 : 4));
  static constexpr int kRows = kConsumerGroups * kTiles * 64;
  // N of one wgmma where C is split: bf16 in halves (the last tile of a
  // warpgroup, and every tile at C = 128), TF32 in n64 pieces
  static constexpr int kN = kBf16 ? C / 2 : cmin(C, 64);
  static constexpr int kRegs = 4 * kPlanes;          // A registers a tile
  static constexpr int kRowBytes = 2 * kRows * 8;    // idx, frac; two groups
  static constexpr int kBars = 2 * kStages + 4;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kRowBytes + kBars * 8;
  static_assert(kSteps % 2 == 0, "fragment buffers alternate by k-step");
  static_assert(kStageBytes % (16 * kCluster) == 0, "bulk copies of 16 B");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of `parity` to complete; traps past kWaitClocks.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > kWaitClocks) __trap();
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrives on the barrier at the same offset in the cluster's block `rank`.
__device__ __forceinline__ void bar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` from global to the shared memory of every block of the
// cluster in `mask`, at `dst` in each, counted on its own `bar`.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Pins a register's value at this point of the program: every definition
// before it, every use after (an operand of wgmma must be complete before
// wgmma.fence, and an accumulator is read only after wgmma.wait_group).
__device__ __forceinline__ void pin(unsigned& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void pin(uint64_t& r) {
  asm volatile("" : "+l"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending)
               : "memory");
}

// The wgmma descriptor of a K-major, 128-byte-swizzled operand at shared
// address `addr`: 8-row groups 1024 bytes apart (SBO), the leading offset
// unused by this layout.
__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), held in the
// bits of an f32.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D[64, N] += A[64, K] (registers) * B[K, N] (shared, descriptor), one
// wgmma; kBf16: k16 over bf16, else k8 over TF32.
template <bool kBf16, int N>
struct Wgmma {
  // one: a register holding 1 (accumulate into d), defined before the
  // wgmma.fence like every other operand
  __device__ static void run(float* d, const unsigned* a, uint64_t desc,
                             uint32_t one);
};

template <>
__device__ __forceinline__ void Wgmma<true, 8>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<true, 16>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<true, 32>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<true, 64>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<false, 16>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<false, 32>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}

template <>
__device__ __forceinline__ void Wgmma<false, 64>::run(
    float* d, const unsigned* a, uint64_t desc, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(one));
}


// Writes the tile [K, C] (bf16 bits or f32) as the shared-memory image of
// its stages: atom a holds K rows [a * kAtomK, (a + 1) * kAtomK), each
// plane C rows of 128 bytes in 8-row groups of 1024, the 16-byte chunk j
// of row n at j ^ (n % 8); f32 as its TF32 hi plane, then its lo plane.
// One 16-byte chunk a thread.
template <bool kBf16, int C>
__global__ void __launch_bounds__(evdn::kThreads)
onehot_pack(const void* __restrict__ tile, uint4* __restrict__ packed,
            int K, int64_t chunks) {
  using P = Plan<kBf16, C>;
  constexpr int kPer = 16 / P::kElem;        // tile values a chunk
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < chunks; q += stride) {
    const int64_t atom = q * 16 / P::kAtomBytes;
    int rem = static_cast<int>(q * 16 - atom * P::kAtomBytes);
    const int plane = rem / P::kPlaneBytes;
    rem -= plane * P::kPlaneBytes;
    const int n = (rem >> 10) * 8 + ((rem >> 7) & 7);
    const int j = ((rem >> 4) & 7) ^ (n & 7);
    const int64_t k0 = atom * P::kAtomK + j * kPer;
    unsigned w[4];
    if constexpr (kBf16) {
      const uint16_t* t = static_cast<const uint16_t*>(tile);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t k = k0 + 2 * e;
        const unsigned lo = k < K ? t[k * C + n] : 0u;
        const unsigned hi = k + 1 < K ? t[(k + 1) * C + n] : 0u;
        w[e] = lo | (hi << 16);
      }
    } else {
      const float* t = static_cast<const float*>(tile);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t k = k0 + e;
        const float x = k < K ? t[k * C + n] : 0.f;
        const unsigned hi = tf32_bits(x);
        w[e] = plane == 0 ? hi : tf32_bits(x - __uint_as_float(hi));
      }
    }
    packed[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The one-hot of the rows a consumer thread's fragments touch: m64 tile
// mt, half h (fragment rows g and g + 8). step: the only k-step where the
// thread's registers of that row are not zero (-1: none); first, second:
// those registers, the columns (2t, 2t + 1) and (2t + 8, 2t + 9) of a
// bf16 k16 step, or t and t + 4 of a TF32 k8 step, for each plane (TF32
// hi, lo).
template <bool kBf16, int C>
struct Hots {
  using P = Plan<kBf16, C>;
  int step[P::kTiles][2];
  unsigned first[P::kTiles][2][P::kPlanes];
  unsigned second[P::kTiles][2][P::kPlanes];

  __device__ __forceinline__ void set(int mt, int h, int2 row, int t) {
    const int i = row.x;
    step[mt][h] = -1;
#pragma unroll
    for (int pl = 0; pl < P::kPlanes; ++pl)
      first[mt][h][pl] = second[mt][h][pl] = 0u;
    if (i < 0) return;                      // a row past N
    const float f = __int_as_float(row.y);
    const float wl = 1.f - f;               // the twin's (1.0 - f) in f32
    // w0, w1: the weights of the first and the second corner
    if constexpr (kBf16) {
      const unsigned w0 = evdn::bf16_bits_of(evdn::round_bf16(wl));
      const unsigned w1 = evdn::bf16_bits_of(evdn::round_bf16(f));
      const int p = i & 15;
      auto val = [&](int c) { return c == p ? w0 : (c == p + 1 ? w1 : 0u); };
      step[mt][h] = i >> 4;
      if (t == 0 && p == 15) {              // the second corner, next step
        step[mt][h] += 1;
        first[mt][h][0] = w1;
      } else {
        first[mt][h][0] = val(2 * t) | (val(2 * t + 1) << 16);
        second[mt][h][0] = val(2 * t + 8) | (val(2 * t + 9) << 16);
      }
    } else {
      // each weight as its TF32 planes, hi and lo
      unsigned w0[2], w1[2];
      w0[0] = tf32_bits(wl);
      w0[1] = tf32_bits(wl - __uint_as_float(w0[0]));
      w1[0] = tf32_bits(f);
      w1[1] = tf32_bits(f - __uint_as_float(w1[0]));
      const int p = i & 7;
      step[mt][h] = i >> 3;
#pragma unroll
      for (int pl = 0; pl < P::kPlanes; ++pl) {
        if (t == 0 && p == 7) {
          first[mt][h][pl] = w1[pl];
        } else {
          first[mt][h][pl] = t == p ? w0[pl] : (t == p + 1 ? w1[pl] : 0u);
          second[mt][h][pl] =
              t + 4 == p ? w0[pl] : (t + 4 == p + 1 ? w1[pl] : 0u);
        }
      }
      if (t == 0 && p == 7) step[mt][h] += 1;
    }
  }

  // The A fragments of k-step ks: per plane a0 (row g, first), a1 (row
  // g + 8, first), a2 (row g, second), a3 (row g + 8, second).
  __device__ __forceinline__ void build(unsigned (&a)[P::kTiles][P::kRegs],
                                        int ks) const {
#pragma unroll
    for (int mt = 0; mt < P::kTiles; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool on = ks == step[mt][h];
#pragma unroll
        for (int pl = 0; pl < P::kPlanes; ++pl) {
          a[mt][4 * pl + h] = on ? first[mt][h][pl] : 0u;
          a[mt][4 * pl + 2 + h] = on ? second[mt][h][pl] : 0u;
        }
      }
    }
  }
};

// stages: ring stages a pass over the tile; groups: row groups of
// kCluster * kRows rows.
template <bool kBf16, int C>
__global__ void __launch_bounds__(Plan<kBf16, C>::kThreads, 1)
onehot_kernel(const int32_t* __restrict__ idx,
              const float* __restrict__ frac,
              const unsigned char* __restrict__ packed,
              float* __restrict__ out, int64_t n, int stages,
              int64_t groups) {
  using P = Plan<kBf16, C>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: stages start on that boundary
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t ring = smem_u32(base);
  int2* rowbuf = reinterpret_cast<int2*>(base + P::kStages * P::kStageBytes);
  const uint32_t bars = smem_u32(rowbuf + 2 * P::kRows);
  // full[s], empty[s], then rows_full[2], rows_empty[2]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (P::kStages + s); };
  auto rows_full = [&](int b) { return bars + 8u * (2 * P::kStages + b); };
  auto rows_empty = [&](int b) {
    return bars + 8u * (2 * P::kStages + 2 + b);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), P::kConsumerWarps * kCluster);
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(rows_full(b), 32);
      bar_init(rows_empty(b), P::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block's barriers exist before any block arrives on them
  cluster_sync();
  const uint32_t rank = cluster_rank();
  const int64_t first_group = blockIdx.x / kCluster;
  const int64_t group_stride = gridDim.x / kCluster;

  if (warp == P::kConsumerWarps) {
    // the producer: each group's rows, then the tile's stages
    uint32_t slot = 0, phase = 0;
    int64_t local = 0;
    for (int64_t gi = first_group; gi < groups; gi += group_stride, ++local) {
      const int b = static_cast<int>(local & 1);
      bar_wait(rows_empty(b), static_cast<uint32_t>((local >> 1) & 1) ^ 1u);
      const int64_t row0 = (gi * kCluster + rank) * P::kRows;
      int2* rb = rowbuf + b * P::kRows;
#pragma unroll 4
      for (int r = lane; r < P::kRows; r += 32) {
        const int64_t row = row0 + r;
        rb[r] = row < n ? make_int2(__ldg(idx + row),
                                    __float_as_int(__ldg(frac + row)))
                        : make_int2(-1, 0);
      }
      bar_arrive(rows_full(b));
      if (lane == 0) {
        for (int st = 0; st < stages; ++st) {
          bar_wait(empty(slot), phase ^ 1u);
          bar_expect(full(slot), P::kStageBytes);
          const uint32_t dst = ring + slot * P::kStageBytes;
          const unsigned char* src =
              packed + static_cast<int64_t>(st) * P::kStageBytes;
          // this block's share of the stage, into every block
          constexpr uint32_t kShare = P::kStageBytes / kCluster;
          bulk_load_multicast(dst + rank * kShare, src + rank * kShare,
                              kShare, full(slot), (1u << kCluster) - 1u);
          if (++slot == P::kStages) {
            slot = 0;
            phase ^= 1u;
          }
        }
      }
      __syncwarp();
    }
    // no block leaves while another may still arrive on its barriers
    cluster_sync();
  } else {
    // the consumers: two warpgroups, kTiles m64 tiles of rows each
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int tile_row = wg * P::kTiles * 64 + wq * 16 + g;
    auto release = [&](uint32_t s) {
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (uint32_t r = 0; r < kCluster; ++r) bar_arrive_at(empty(s), r);
      }
    };
    Hots<kBf16, C> hots;
    float acc[P::kTiles][C / 2];
    unsigned a[2][P::kTiles][P::kRegs] = {};
    uint32_t one = 1;
    pin(one);
    uint32_t slot = 0, phase = 0;
    int64_t local = 0;
    for (int64_t gi = first_group; gi < groups; gi += group_stride, ++local) {
      const int b = static_cast<int>(local & 1);
      bar_wait(rows_full(b), static_cast<uint32_t>((local >> 1) & 1));
      const int2* rb = rowbuf + b * P::kRows;
#pragma unroll
      for (int mt = 0; mt < P::kTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hots.set(mt, h, rb[tile_row + mt * 64 + h * 8], t);
      __syncwarp();
      if (lane == 0) bar_arrive(rows_empty(b));
#pragma unroll
      for (int mt = 0; mt < P::kTiles; ++mt)
#pragma unroll
        for (int i = 0; i < C / 2; ++i) {
          acc[mt][i] = 0.f;
          pin(acc[mt][i]);
        }
      uint32_t used = 0;
      for (int st = 0; st < stages; ++st) {
        bar_wait(full(slot), phase);
        const uint32_t stage = ring + slot * P::kStageBytes;
#pragma unroll
        for (int kk = 0; kk < P::kSteps; ++kk) {
          hots.build(a[kk & 1], st * P::kSteps + kk);
#pragma unroll
          for (int mt = 0; mt < P::kTiles; ++mt)
#pragma unroll
            for (int i = 0; i < P::kRegs; ++i) pin(a[kk & 1][mt][i]);
          const uint32_t at = stage +
                              (kk / P::kStepsPerAtom) * P::kAtomBytes +
                              (kk % P::kStepsPerAtom) * 32;
          // the B descriptors of each n-chunk and plane, complete before
          // the fence
          uint64_t desc[C / P::kN][P::kPlanes];
#pragma unroll
          for (int nc = 0; nc < C / P::kN; ++nc)
#pragma unroll
            for (int pl = 0; pl < P::kPlanes; ++pl) {
              desc[nc][pl] = desc_of(at + nc * (P::kN / 8) * 1024 +
                                     pl * P::kPlaneBytes);
              pin(desc[nc][pl]);
            }
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < P::kTiles; ++mt) {
#pragma unroll
            for (int nc = 0; nc < C / P::kN; ++nc) {
              float* d = &acc[mt][nc * P::kN / 2];
              const unsigned* am = a[kk & 1][mt];
              if constexpr (kBf16 && C <= 64) {
                // every tile but the last in one product of n = C, the
                // last in two of n = C / 2
                if (mt + 1 < P::kTiles) {
                  if (nc == 0) Wgmma<true, C>::run(d, am, desc[0][0], one);
                } else {
                  Wgmma<true, P::kN>::run(d, am, desc[nc][0], one);
                }
              } else if constexpr (kBf16) {
                Wgmma<true, P::kN>::run(d, am, desc[nc][0], one);
              } else {
                // lo*hi, hi*lo, hi*hi: the small terms first
                Wgmma<kBf16, P::kN>::run(d, am + 4, desc[nc][0], one);
                Wgmma<kBf16, P::kN>::run(d, am, desc[nc][1], one);
                Wgmma<kBf16, P::kN>::run(d, am, desc[nc][0], one);
              }
            }
          }
          wgmma_commit();
          // the products of the step before have read their fragments
          // and, at a stage's first step, the previous stage; those
          // fragments stay allocated until here, so that no product in
          // flight shares its registers with another
          wgmma_wait<1>();
#pragma unroll
          for (int mt = 0; mt < P::kTiles; ++mt)
#pragma unroll
            for (int i = 0; i < P::kRegs; ++i) pin(a[(kk & 1) ^ 1][mt][i]);
          if (kk == 0 && st > 0) release(used);
        }
        used = slot;
        if (++slot == P::kStages) {
          slot = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < P::kTiles; ++mt) {
#pragma unroll
        for (int i = 0; i < P::kRegs; ++i) pin(a[(P::kSteps - 1) & 1][mt][i]);
#pragma unroll
        for (int i = 0; i < C / 2; ++i) pin(acc[mt][i]);
      }
      release(used);
      // lane pairs trade halves: even t keeps row g, odd t row g + 8,
      // each four neighbouring columns
      const int64_t row0 = (gi * kCluster + rank) * P::kRows + tile_row;
      const bool odd = t & 1;
      const int col = 4 * (t >> 1);
#pragma unroll
      for (int mt = 0; mt < P::kTiles; ++mt) {
        const int64_t row = row0 + mt * 64 + (odd ? 8 : 0);
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const float* d = &acc[mt][4 * j];
          const float s0 = odd ? d[0] : d[2], s1 = odd ? d[1] : d[3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const float4 v = odd ? make_float4(r0, r1, d[2], d[3])
                               : make_float4(d[0], d[1], r0, r1);
          if (row < n)
            __stcs(reinterpret_cast<float4*>(out + row * C + 8 * j + col),
                   v);
        }
      }
    }
    cluster_sync();
  }
}

template <bool kBf16, int C>
int launch_k9(const int32_t* idx, const float* frac, const void* tile,
              unsigned char* packed, int64_t packed_bytes, float* out,
              int64_t n, int K, int device, cudaStream_t stream) {
  using P = Plan<kBf16, C>;
  const int stages = (K + P::kStageK - 1) / P::kStageK;
  if (packed_bytes != static_cast<int64_t>(stages) * P::kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = packed_bytes / 16;
  onehot_pack<kBf16, C><<<evdn::blocks_for(chunks, evdn::kThreads),
                          evdn::kThreads, 0, stream>>>(
      tile, reinterpret_cast<uint4*>(packed), K, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[evdn::kMaxDevices];
  auto kernel = onehot_kernel<kBf16, C>;
  err = evdn::raise_shared_memory(kernel, P::kSmem, device, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups =
      (n + static_cast<int64_t>(kCluster) * P::kRows - 1) /
      (static_cast<int64_t>(kCluster) * P::kRows);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once, at most one
  // a row group
  static int resident[evdn::kMaxDevices];
  if (resident[device] == 0) {
    cfg.gridDim = dim3(kCluster);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[device] = clusters;
  }
  const int64_t clusters =
      groups < resident[device] ? groups : resident[device];
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  err = cudaLaunchKernelEx(&cfg, kernel, idx, frac,
                           static_cast<const unsigned char*>(packed), out, n,
                           stages, groups);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int C>
int launch_width(bool bf16, const int32_t* idx, const float* frac,
                 const void* tile, unsigned char* packed,
                 int64_t packed_bytes, float* out, int64_t n, int K,
                 int device, cudaStream_t stream) {
  if (bf16)
    return launch_k9<true, C>(idx, frac, tile, packed, packed_bytes, out, n,
                              K, device, stream);
  return launch_k9<false, C>(idx, frac, tile, packed, packed_bytes, out, n,
                             K, device, stream);
}

}  // namespace

// idx [n] int32 (the one-hot's first corner, in [0, K - 1)), frac [n] f32,
// tile [K, C] bf16 (bf16 != 0) or f32, C one of 16, 32, 64 or 128; packed:
// scratch of packed_bytes (ops/probe_onehot.py::plan), 16-byte aligned,
// for the tile's shared-memory image; out [n, C] f32, 16-byte aligned.
EVDN_API int evdn_onehot_lerp(const int32_t* idx, const float* frac,
                              const void* tile, void* packed,
                              int64_t packed_bytes, float* out, int64_t n,
                              int K, int C, int bf16, int device,
                              cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (K < 2 || reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  unsigned char* pk = static_cast<unsigned char*>(packed);
  switch (C) {
    case 16:
      return launch_width<16>(bf16 != 0, idx, frac, tile, pk, packed_bytes,
                              out, n, K, device, stream);
    case 32:
      return launch_width<32>(bf16 != 0, idx, frac, tile, pk, packed_bytes,
                              out, n, K, device, stream);
    case 64:
      return launch_width<64>(bf16 != 0, idx, frac, tile, pk, packed_bytes,
                              out, n, K, device, stream);
    case 128:
      return launch_width<128>(bf16 != 0, idx, frac, tile, pk, packed_bytes,
                               out, n, K, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
