// Tensor-core building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), for Hopper (sm_90a).
//
// - Warp-level products with `mma.sync`: bfloat16 inputs on
//   m16n8k16.bf16, float32 inputs as 3xTF32 on m16n8k8.tf32 (each operand
//   split into a TF32 hi part and a TF32 lo part, a*b ~ ah*bh + ah*bl +
//   al*bh, which keeps about 21 bits of the product instead of TF32's 11).
//   Accumulators are float32 in both cases.
// - Tiles in shared memory are rows of D elements cut into 16-byte chunks
//   whose position is XOR-swizzled by the row (`swz`): the 8 rows one
//   `ldmatrix` reads and the strided scalar reads of the float32 "B^T"
//   operand land in distinct banks, and every chunk stays 16-byte aligned
//   for `cp.async`.
// - 16-byte `cp.async` copies (zero-filled past a ragged edge) with commit
//   groups: a ring of tiles whose next tile is in flight while the current
//   one is multiplied.
//
// Fragment shapes (per thread of a warp; g = lane / 4, t = lane % 4):
//   C (16 x 8, float):  c[0], c[1] at (row g, cols 2t, 2t+1); c[2], c[3] at
//   row g + 8. A covers 16 rows x MK (the mma depth: 16 bf16 or 8 tf32), B
//   covers MK x 8.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt_attn {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back (the TPU kernels' casts of p and ds)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 2^x (ex2.approx: relative error ~2^-22; exp2(-inf) = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ swizzle
// Byte offset of 16-byte chunk `chunk` of row `row` in a tile whose rows
// hold NC chunks. Rows of 8+ chunks XOR the chunk with row % 8; narrower
// rows (R = 8 / NC rows share 128 bytes) XOR it with (row / R) % NC. Any 8
// consecutive rows (from a multiple of 8) at one logical chunk then fill
// the 8 distinct 16-byte bank groups.
template <int NC>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  if constexpr (NC >= 8) {
    return (uint32_t)(row * NC + (chunk ^ (row & 7))) * 16u;
  } else {
    constexpr int R = 8 / NC;
    return (uint32_t)(row * NC + (chunk ^ ((row / R) & (NC - 1)))) * 16u;
  }
}

// byte offset of element (row, col) of a swizzled tile of T with D columns
template <typename T, int D>
__device__ __forceinline__ uint32_t swz_elem(int row, int col) {
  constexpr int E = 16 / sizeof(T);  // elements per chunk
  return swz<D / E>(row, col / E) + (uint32_t)(col % E) * sizeof(T);
}

// ------------------------------------------------------------ cp.async
// 16 bytes global -> shared; src_bytes = 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a strided [S, DV] matrix of T (contiguous rows,
// 16-byte aligned) -> a swizzled tile of D >= DV columns at shared address
// `dst`; rows past S and columns past DV are zero-filled. All NT threads
// of the block take part. DV < D is a head dim that runs in a wider
// dim's tile plan (80 and 96 in D128's): zero columns add nothing to a
// product over the head dim, and the columns of an output past DV are
// never stored.
template <typename T, int D, int ROWS, int NT, int DV = D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* src,
                                                long long stride, int r0,
                                                int S) {
  constexpr int E = 16 / sizeof(T);
  constexpr int NC = D / E;
  static_assert(DV <= D && DV % 8 == 0, "valid head dim");
  for (int e = threadIdx.x; e < ROWS * NC; e += NT) {
    const int r = e / NC, c = e % NC;
    const bool ok = r0 + r < S && c * E < DV;
    const T* p = ok ? src + (long long)(r0 + r) * stride + c * E : src;
    cp_async16(dst + swz<NC>(r, c), p, ok ? 16 : 0);
  }
}

// ------------------------------------------------------------ ldmatrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ------------------------------------------------------------ mma.sync
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// ------------------------------------------------------------ fragments
// Mma<T>: the fragment types and loads for inputs of type T.
//   load_a(a, tile, r0, ks): A = rows [r0, r0+16) x depth step ks of a
//     row-major [rows][D] tile (ldmatrix; for float32 each 16-byte row of
//     an 8x8 b16 matrix is 4 floats, which is the tf32 A layout).
//   load_b2(b0, b1, tile, n0, ks): B for n-tiles [n0, n0+8) and
//     [n0+8, n0+16) of a tile stored [n][D] (B = tile^T).
//   load_bt2<D, kFromC>(b0, b1, tile, k0, n0): B for n-tiles [n0, n0+8),
//     [n0+8, n0+16) at depth rows [k0, k0+MK) of a tile stored [k][D]
//     (B = tile); kFromC: the A it meets comes from p_frag, not load_a.
//   p_frag(a, c, j): the A fragment of depth step j of a product whose A
//     is a row block of C fragments in registers (P or dS).
//   mma(c, a, b): c += a b.
// For float32 the depth of the "B = tile" and "A from C" steps is
// relabelled: mma index t <-> column 2t, t + 4 <-> column 2t + 1 of the
// 8-column C tile, so a C fragment is an A fragment without shuffles; the
// B loads apply the same relabelling to its rows.
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int MK = 16;  // mma depth
  static constexpr int CT = 2;   // C n-tiles per depth step of "A from C"
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  template <int D>
  static __device__ __forceinline__ void load_a(A& a, uint32_t tile, int r0,
                                                int ks) {
    const int lane = threadIdx.x & 31;
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(a.x, tile + swz<D / 8>(r, 2 * ks + (lane >> 4)));
  }
  template <int D>
  static __device__ __forceinline__ void load_b2(B& b0, B& b1, uint32_t tile,
                                                 int n0, int ks) {
    const int lane = threadIdx.x & 31;
    const int r = n0 + (lane & 7) + (lane >> 4) * 8;
    uint32_t x[4];
    ldsm_x4(x, tile + swz<D / 8>(r, 2 * ks + ((lane >> 3) & 1)));
    b0.x[0] = x[0]; b0.x[1] = x[1]; b1.x[0] = x[2]; b1.x[1] = x[3];
  }
  template <int D, bool kFromC = true>
  static __device__ __forceinline__ void load_bt2(B& b0, B& b1, uint32_t tile,
                                                  int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    uint32_t x[4];
    ldsm_x4_t(x, tile + swz<D / 8>(r, n0 / 8 + (lane >> 4)));
    b0.x[0] = x[0]; b0.x[1] = x[1]; b1.x[0] = x[2]; b1.x[1] = x[3];
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <int N>
  static __device__ __forceinline__ void p_frag(A& a, const float (&c)[N][4],
                                                int j) {
    a.x[0] = pack(c[2 * j][0], c[2 * j][1]);
    a.x[1] = pack(c[2 * j][2], c[2 * j][3]);
    a.x[2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
    a.x[3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x[0], b.x[1]);
  }
};

template <> struct Mma<float> {
  using T = float;
  static constexpr int MK = 8;
  static constexpr int CT = 1;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void split_a(A& a, const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], a.hi[i], a.lo[i]);
  }
  static __device__ __forceinline__ void split_b(B& b, float x0, float x1) {
    split_tf32(x0, b.hi[0], b.lo[0]);
    split_tf32(x1, b.hi[1], b.lo[1]);
  }
  template <int D>
  static __device__ __forceinline__ void load_a(A& a, uint32_t tile, int r0,
                                                int ks) {
    const int lane = threadIdx.x & 31;
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    uint32_t x[4];
    ldsm_x4(x, tile + swz<D / 4>(r, 2 * ks + (lane >> 4)));
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(x[i]);
    split_a(a, f);
  }
  template <int D>
  static __device__ __forceinline__ void load_b2(B& b0, B& b1, uint32_t tile,
                                                 int n0, int ks) {
    const int lane = threadIdx.x & 31;
    const int r = n0 + (lane & 7) + (lane >> 4) * 8;
    uint32_t x[4];
    ldsm_x4(x, tile + swz<D / 4>(r, 2 * ks + ((lane >> 3) & 1)));
    split_b(b0, __uint_as_float(x[0]), __uint_as_float(x[1]));
    split_b(b1, __uint_as_float(x[2]), __uint_as_float(x[3]));
  }
  static __device__ __forceinline__ float lds(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
  }
  template <int D, bool kFromC = true>
  static __device__ __forceinline__ void load_bt2(B& b0, B& b1, uint32_t tile,
                                                  int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // mma rows t, t + 4 <-> tile rows 2t, 2t + 1 (relabelled, for an A
    // from p_frag) or t, t + 4 (for an A from load_a)
    const int r0 = kFromC ? k0 + 2 * t : k0 + t;
    const int r1 = kFromC ? r0 + 1 : r0 + 4;
    split_b(b0, lds(tile + swz_elem<float, D>(r0, n0 + g)),
            lds(tile + swz_elem<float, D>(r1, n0 + g)));
    split_b(b1, lds(tile + swz_elem<float, D>(r0, n0 + 8 + g)),
            lds(tile + swz_elem<float, D>(r1, n0 + 8 + g)));
  }
  template <int N>
  static __device__ __forceinline__ void p_frag(A& a, const float (&c)[N][4],
                                                int j) {
    // a0 (g, t) = col 2t, a1 (g+8, t), a2 (g, t+4) = col 2t+1, a3 (g+8, t+4)
    const float x[4] = {c[j][0], c[j][2], c[j][1], c[j][3]};
    split_a(a, x);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
  }
};

// max / sum over the 4 lanes of a quad (the threads of one C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// stores the pair (x0, x1) of T at p (4 or 8 bytes, aligned)
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace pt_attn
