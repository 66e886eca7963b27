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
//   against (F.embedding_bag), and answer another question.
//   Bound: max(bytes / 3.35 TB/s, 2*N*K*C / the route's tensor-core rate).
//   Bytes: N*(8 + 4C) plus the tile, 0.083 ms at N = 1,048,576, C = 64.
//   Operations: bf16 at 989 TFLOP/s, 0.035 / 0.139 / 0.556 ms at K = 256 /
//   1024 / 4096; f32 by three TF32 products a product (below) at 495
//   TFLOP/s, so 2*N*K*C over 165 TFLOP/s, 0.21 / 0.83 / 3.33 ms. Above K =
//   256 in bf16, and at every K in f32, the operations bound it.
//   Design. The TPU kept the whole tile resident in VMEM; here a bf16
//   [4096, 64] tile is 512 KiB, past the 227 KB a block may use, so the
//   tile streams through shared memory in chunks of kChunk rows, two
//   stages, the next chunk's cp.async copies in flight while the tensor
//   cores work on this one (rows padded by 8 elements: conflict-free
//   ldmatrix and scalar fragment loads). A block takes kBlockRows rows of
//   the output, a warp 32 of them (two m16 tiles) over all C columns, the
//   sums in registers. The one-hot operand is built in registers straight
//   into the mma.sync A fragments from each row's idx and its two weights,
//   with no memory traffic: a lane's element (row, column c) is w_lo where
//   c = idx, w_hi where c = idx + 1, else 0.
//   * bf16: mma.sync.m16n8k16 bf16 x bf16 -> f32, the tile's fragments by
//     ldmatrix.trans. Each nonzero product of two bf16 values is exact in
//     f32; the sum of a row's two products rounds once, up to how the
//     tensor core rounds its accumulation.
//   * f32: never plain TF32, which rounds the tile to 11 significant bits
//     (about 1e-3 off). Each f32 value x is split into two TF32 values,
//     hi = tf32(x) and lo = tf32(x - hi); a product is taken as
//     lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (m16n8k8, three mma.sync, the
//     small terms first), within a few 1e-7 of the f32 product.
//   Rows past N build a zero one-hot and are not stored. Columns past K
//   (the last chunk's padding) hold zero tile rows, copied as zeros.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreadsK9 = kWarps * 32;
constexpr int kWarpRows = 32;                  // two m16 tiles a warp
constexpr int kBlockRows = kWarps * kWarpRows;
constexpr int kChunk = 64;                     // tile rows a stage

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void copy16(unsigned dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), held in the
// bits of an f32.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// A row's one-hot: its index and its two weights, as the A fragment
// takes them (bf16 bits, or TF32 hi and lo bits).
struct Hot {
  int idx;
  unsigned lo, hi;          // bf16: the weights' bits; f32: their hi parts
  unsigned lo_r, hi_r;      // f32: the lo parts of the weights
};

__device__ __forceinline__ unsigned pick(const Hot& h, int c, unsigned at_idx,
                                         unsigned at_next) {
  return c == h.idx ? at_idx : (c == h.idx + 1 ? at_next : 0u);
}

// Loads tile rows [k0, k0 + kChunk) of the [K, C] tile (elem bytes a
// value) into a stage of shared memory of row stride S elements, zeros
// past row K.
template <int C, int S, typename T>
__device__ __forceinline__ void load_chunk(T* stage, const T* tile, int k0,
                                           int K) {
  constexpr int kPerRow = C * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < kChunk * kPerRow; i += kThreadsK9) {
    const int r = i / kPerRow, q = i - r * kPerRow;
    const bool in = k0 + r < K;
    const T* src = in ? tile + static_cast<int64_t>(k0 + r) * C + q * kPer16
                      : tile;
    copy16(smem_addr(stage + r * S + q * kPer16), src, in ? 16 : 0);
  }
  copy_commit();
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The one-hots of the four rows a lane's fragments touch: m16 tile mt,
// half h (the fragment rows g and g + 8).
template <bool kBf16>
__device__ __forceinline__ void load_hots(Hot (&hot)[2][2],
                                          const int32_t* __restrict__ idx,
                                          const float* __restrict__ frac,
                                          int64_t row0, int g, int64_t n) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + mt * 16 + h * 8 + g;
      Hot& o = hot[mt][h];
      o = Hot{-2, 0u, 0u, 0u, 0u};          // matches no column
      if (r >= n) continue;
      const float f = __ldg(frac + r);
      const float wl = 1.f - f;             // the twin's (1.0 - f) in f32
      o.idx = __ldg(idx + r);
      if (kBf16) {
        o.lo = evdn::bf16_bits_of(evdn::round_bf16(wl));
        o.hi = evdn::bf16_bits_of(evdn::round_bf16(f));
      } else {
        o.lo = tf32_bits(wl);
        o.hi = tf32_bits(f);
        o.lo_r = tf32_bits(wl - __uint_as_float(o.lo));
        o.hi_r = tf32_bits(f - __uint_as_float(o.hi));
      }
    }
  }
}

// Writes a warp's [32, C] sums: fragment element (row g or g + 8, columns
// 2t and 2t + 1 of n8 tile j).
template <int NT>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[2][NT][4],
                                           int64_t row0, int g, int t,
                                           int64_t n) {
  constexpr int C = NT * 8;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + mt * 16 + h * 8 + g;
      if (r >= n) continue;
      float* o = out + r * C + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        __stcs(reinterpret_cast<float2*>(o + j * 8),
               make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]));
    }
  }
}

// NT: n8 tiles of C (C = 8 * NT, NT even). tile: bf16 bits.
template <int NT>
__global__ void __launch_bounds__(kThreadsK9)
onehot_bf16_kernel(const int32_t* __restrict__ idx,
                   const float* __restrict__ frac,
                   const uint16_t* __restrict__ tile, float* __restrict__ out,
                   int64_t n, int K) {
  constexpr int C = NT * 8, S = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  Hot hot[2][2];
  load_hots<true>(hot, idx, frac, row0, g, n);
  float acc[2][NT][4] = {};
  // ldmatrix.x4.trans: lane l gives the address of row l % 8 of matrix
  // l / 8; matrices (k 0-7 | k 8-15) x (n 0-7 | n 8-15) of a k16 x n16 block
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  const int chunks = (K + kChunk - 1) / kChunk;
  load_chunk<C, S>(smem, tile, 0, K);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load_chunk<C, S>(smem + ((ch + 1) & 1) * kChunk * S, tile,
                       (ch + 1) * kChunk, K);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const uint16_t* stage = smem + (ch & 1) * kChunk * S;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      const int c0 = ch * kChunk + ks * 16 + 2 * t;
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a0: row g, columns c0, c0 + 1; a1: row g + 8; a2, a3: the
          // same rows at columns c0 + 8, c0 + 9
          const Hot& hh = hot[mt][q & 1];
          const int c = c0 + (q >> 1) * 8;
          a[mt][q] = pick(hh, c, hh.lo, hh.hi) |
                     (pick(hh, c + 1, hh.lo, hh.hi) << 16);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(smem_addr(stage + (ks * 16 + lrow) * S + np * 16 + lcol)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();      // the stage is refilled two chunks on
  }
  store_rows<NT>(out, acc, row0, g, t, n);
}

template <int NT>
__global__ void __launch_bounds__(kThreadsK9)
onehot_f32_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ frac,
                  const float* __restrict__ tile, float* __restrict__ out,
                  int64_t n, int K) {
  constexpr int C = NT * 8, S = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  Hot hot[2][2];
  load_hots<false>(hot, idx, frac, row0, g, n);
  float acc[2][NT][4] = {};

  const int chunks = (K + kChunk - 1) / kChunk;
  load_chunk<C, S>(smem, tile, 0, K);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load_chunk<C, S>(smem + ((ch + 1) & 1) * kChunk * S, tile,
                       (ch + 1) * kChunk, K);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* stage = smem + (ch & 1) * kChunk * S;
#pragma unroll 2
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const int c0 = ch * kChunk + ks * 8 + t;
      // a0: (g, c0), a1: (g+8, c0), a2: (g, c0+4), a3: (g+8, c0+4)
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Hot& hh = hot[mt][q & 1];
          const int c = c0 + (q >> 1) * 4;
          ahi[mt][q] = pick(hh, c, hh.lo, hh.hi);
          alo[mt][q] = pick(hh, c, hh.lo_r, hh.hi_r);
        }
      }
      const float* brow0 = stage + (ks * 8 + t) * S + g;
      const float* brow1 = brow0 + 4 * S;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b0: (k = t, n = g), b1: (k = t + 4, n = g) of n8 tile j
        const float x0 = brow0[j * 8], x1 = brow1[j * 8];
        const unsigned h0 = tf32_bits(x0), h1 = tf32_bits(x1);
        const unsigned l0 = tf32_bits(x0 - __uint_as_float(h0));
        const unsigned l1 = tf32_bits(x1 - __uint_as_float(h1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][j], alo[mt], h0, h1);
          mma_tf32(acc[mt][j], ahi[mt], l0, l1);
          mma_tf32(acc[mt][j], ahi[mt], h0, h1);
        }
      }
    }
    __syncthreads();      // the stage is refilled two chunks on
  }
  store_rows<NT>(out, acc, row0, g, t, n);
}

// Launches the kernel of a C = 8 * NT on tile values of type T.
template <int NT, typename T, typename Kernel>
int launch_tiles(Kernel kernel, bool* raised, const int32_t* idx,
                 const float* frac, const void* tile, float* out, int64_t n,
                 int K, int device, cudaStream_t stream) {
  constexpr int kSmem =
      2 * kChunk * (NT * 8 + 8) * static_cast<int>(sizeof(T));
  if (kSmem > 48 * 1024) {
    const cudaError_t err =
        evdn::raise_shared_memory(kernel, kSmem, device, raised);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<evdn::blocks_for(n, kBlockRows), kThreadsK9, kSmem, stream>>>(
      idx, frac, static_cast<const T*>(tile), out, n, K);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_k9(bool bf16, const int32_t* idx, const float* frac,
              const void* tile, float* out, int64_t n, int K, int device,
              cudaStream_t stream) {
  static bool raised_bf16[evdn::kMaxDevices], raised_f32[evdn::kMaxDevices];
  if (bf16)
    return launch_tiles<NT, uint16_t>(onehot_bf16_kernel<NT>, raised_bf16,
                                      idx, frac, tile, out, n, K, device,
                                      stream);
  return launch_tiles<NT, float>(onehot_f32_kernel<NT>, raised_f32, idx,
                                 frac, tile, out, n, K, device, stream);
}

}  // namespace

// idx [n] int32 (the one-hot's first corner, in [0, K - 1)), frac [n] f32,
// tile [K, C] bf16 (bf16 != 0) or f32, 16-byte aligned, with C one of 16,
// 32, 64 or 128; out [n, C] f32.
EVDN_API int evdn_onehot_lerp(const int32_t* idx, const float* frac,
                              const void* tile, float* out, int64_t n, int K,
                              int C, int bf16, int device,
                              cudaStream_t stream) {
  EVDN_SET_DEVICE(device);
  if (K < 2 || reinterpret_cast<uintptr_t>(tile) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      (n + kBlockRows - 1) / kBlockRows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (C) {
    case 16:
      return launch_k9<2>(bf16 != 0, idx, frac, tile, out, n, K, device,
                          stream);
    case 32:
      return launch_k9<4>(bf16 != 0, idx, frac, tile, out, n, K, device,
                          stream);
    case 64:
      return launch_k9<8>(bf16 != 0, idx, frac, tile, out, n, K, device,
                          stream);
    case 128:
      return launch_k9<16>(bf16 != 0, idx, frac, tile, out, n, K, device,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
