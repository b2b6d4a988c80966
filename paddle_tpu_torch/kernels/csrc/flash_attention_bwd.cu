// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU backward kernels of
// paddle_tpu/kernels/flash_attention.py `_bwd_pallas`:
//   K2 `_bwd_single_kernel` (dq, dk, dv in one pass, used when Sk fits
//      one TPU block)           -> flash_bwd_k2_kernel
//   K3 `_dq_kernel`  (dq)       -> flash_bwd_q_kernel
//   K4 `_dkv_kernel` (dk, dv)   -> flash_bwd_kv_kernel
// For q [B,H,Sq,D], k/v [B,H,Sk,D] (float32 or bfloat16; strided views
// with a contiguous head dim), an optional additive key bias [B,1,1,Sk]
// (a constant mask: it gets no gradient), an optional causal mask (key j
// visible to query i iff j <= i), dO [B,H,Sq,D] contiguous, the forward's
// base-2 log-sum-exp lse2 [B,H,1,Sq] and delta = rowsum(dO * O)
// [B,H,1,Sq], both float32:
//   p  = exp2(q k^T * scale * log2(e) + bias * log2(e) - lse2)  (masked: 0)
//   dp = dO v^T
//   ds = p * (dp - delta) * scale, rounded to k's type
//   dq = ds k,  dk = ds^T q,  dv = p^T dO  (p rounded to dO's type)
// Sums are taken in float32; outputs are written in the input type.
//
// What bounds it on the H100: the causal backward at GPT-base shapes does
// about 5 (K2: s, dp, dq, dk, dv) or 7 (K3: s, dp, dq; K4: s, dp, dk, dv)
// score-sized products, 2 * B*H*live*D operations each, against a few
// [B,H,S,D] tensors of input and output: bound by operations at every
// training shape (bf16 against the 989 TFLOP/s tensor cores; float32
// against 165 TFLOP/s, the 3xTF32 rate of the K2 kernel, or the CUDA
// cores' 67 TFLOP/s for K3 and K4, which still compute in float32 FMA).
//
// K2, FlashAttention-2's backward on mma.sync (attention_mma.cuh): one
// block of 4 warps per (b, h, 64-key tile) loops over the live q tiles
// (bf16: 64 rows, 32 at D = 128; float32: 32, 16 at D = 128, as its
// fragments take twice the registers). Each warp owns 16 keys, so it computes the
// transposed scores S^T = K Q^T and dP^T = V dO^T for its keys across the
// q tile on the tensor cores (bf16 m16n8k16, float32 as 3xTF32 m16n8k8);
// p and ds are formed in registers (the mask only on diagonal and
// ragged-edge tile pairs), and P^T, dS^T feed dV += P^T dO and dK += dS^T
// Q straight from the accumulators, so dK and dV stay in registers for
// the whole loop. dS goes once through swizzled shared memory for this
// pair's dQ share, dS K, computed by warps split over q rows and added to
// a zeroed float32 buffer with 16-byte vector atomics (float4 atomicAdd,
// compute capability 9.x); a small epilogue casts it for bf16. Q/dO tiles
// stream through a 2-stage cp.async ring (16-byte copies, zero-filled
// past Sq), so tile t+1 loads while tile t is multiplied. k tiles are
// launched in ascending order, which under a causal mask is heaviest
// first.
//
// K3 and K4 keep the first design, in float32 FMA on the CUDA cores. The
// TPU kernels walk a sequential grid and carry dq (K3) or dk/dv (K4) in
// VMEM scratch across grid steps; a CUDA block has no such memory and
// blocks run in no order, so:
//   - K3: one block per (b, h, 64-row q tile) loops over the live k tiles
//     and keeps dq in registers; dq is written once.
//   - K4: one block per (b, h, 64-key k tile) loops over the live q tiles
//     and keeps dk, dv in registers; they are written once.
// Dead causal tiles are never visited (the TPU kernels' `_block_live`).
// Ragged Sq/Sk are masked: rows past Sq and keys past Sk load as zeros,
// get p = 0, and are not stored. 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns tile rows ty + 16i and columns tx + 16j, so shared-memory
// reads are conflict-free or broadcasts (the transposed tiles are padded
// to 65 columns). Tiles live in dynamic shared memory (100 KB at D = 64,
// 166 KB at D = 128), hence cudaFuncSetAttribute.
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace pt_attn;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int KP = BK + 1;  // padded row of a [*, BK] or transposed tile

// rows [r0, r0 + 64) of a strided [S, D] matrix -> dst[r][D + 1]
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int r0, int S) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] =
        r0 + r < S ? to_f(src[(long long)(r0 + r) * stride + d]) : 0.f;
  }
}

// rows [r0, r0 + 64) of a strided [S, D] matrix -> dst[d][KP], transposed
template <typename T, int D>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src,
                                            long long stride, int r0,
                                            int S) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    dst[d * KP + r] =
        r0 + r < S ? to_f(src[(long long)(r0 + r) * stride + d]) : 0.f;
  }
}

// 64 float32 values of a [S] row (lse2 or delta) -> dst[64]
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int r0, int S) {
  for (int r = threadIdx.x; r < 64; r += NT)
    dst[r] = r0 + r < S ? src[r0 + r] : 0.f;
}

// acc[i][j] = sum_d A[ty + 16i][d] * Bt[d][tx + 16j] over one tile pair:
// A is [64][D + 1] (q rows), Bt is [D][KP] (keys, transposed)
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* Bt, int tx, int ty) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[d * KP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = A[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// p and ds of one (q tile, k tile) pair from the raw scores s = q k^T and
// dp = dO v^T; rows q0 + ty + 16i, keys k0 + tx + 16j
template <typename T>
__device__ __forceinline__ void p_and_ds(
    float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
    const float* delta_s, const float* bb, int q0, int k0, int Sq, int Sk,
    float scale, float scale2, int causal, int tx, int ty) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx + 16 * j;
    const float bj = (bb != nullptr && col < Sk) ? bb[col] * LOG2E : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      const bool ok = row < Sq && col < Sk && (!causal || col <= row);
      const float p = ok ? exp2f(s[i][j] * scale2 + bj - lse_s[r]) : 0.f;
      dp[i][j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);  // ds
      s[i][j] = round_to<T>(p);                                       // p
    }
  }
}

template <int D>
constexpr size_t kv_smem_floats() {
  // Kt, Vt [D][KP]; Qs, dOs [BQ][D+1]; Ps, dSs [BQ][KP]; lse, delta [BQ]
  return 2 * D * KP + 2 * BQ * (D + 1) + 2 * BQ * KP + 2 * BQ;
}

template <int D>
constexpr size_t q_smem_floats() {
  // Qs, dOs [BQ][D+1]; Kt, Vt [D][KP]; dSs [BQ][KP]; lse, delta [BQ]
  return 2 * BQ * (D + 1) + 2 * D * KP + BQ * KP + 2 * BQ;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, Sk] or null
  const void* dout;    // [B, H, Sq, D] contiguous
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;            // [B, H, Sq, D] (K3)
  void* dk;            // [B, H, Sk, D] (K2, K4)
  void* dv;
  float* dq_acc;       // [B, H, Sq, D] float32, zeroed (K2)
  int H, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale, scale2;
  int causal;
};

// K4: one block per (k tile, h, b)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_kv_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + D * KP;
  float* Qs = Vt + D * KP;
  float* dOs = Qs + BQ * DP;
  float* Ps = dOs + BQ * DP;
  float* dSs = Ps + BQ * KP;
  float* lse_s = dSs + BQ * KP;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const T* dob = (const T*)a.dout + bh * a.Sq * D;
  const float* lb = a.lse + bh * a.Sq;
  const float* db = a.delta + bh * a.Sq;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  load_rows_t<T, D>(Kt, kb, a.kss, k0, a.Sk);
  load_rows_t<T, D>(Vt, vb, a.vss, k0, a.Sk);

  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dk[i][dd] = dv[i][dd] = 0.f;

  // a causal k tile is seen only by the q tiles from its own start on
  const int qstart = a.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(Qs, qb, a.qss, q0, a.Sq);
    load_rows<T, D>(dOs, dob, D, q0, a.Sq);
    load_vec(lse_s, lb, q0, a.Sq);
    load_vec(delta_s, db, q0, a.Sq);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Kt, tx, ty);
    tile_dot<D>(dp, dOs, Vt, tx, ty);
    p_and_ds<T>(s, dp, lse_s, delta_s, bb, q0, k0, a.Sq, a.Sk, a.scale,
                a.scale2, a.causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * KP + tx + 16 * j] = s[i][j];
        dSs[(ty + 16 * i) * KP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // dv[key][d] += sum_q p[q][key] dO[q][d]; dk[key][d] += ds[q][key] q[q][d]
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[r * KP + ty + 16 * i];
        dsk[i] = dSs[r * KP + ty + 16 * i];
      }
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float o = dOs[r * DP + tx + 16 * dd];
        const float qv = Qs[r * DP + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][dd] = fmaf(pk[i], o, dv[i][dd]);
          dk[i][dd] = fmaf(dsk[i], qv, dk[i][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Sk) continue;
    T* dkr = (T*)a.dk + (bh * a.Sk + key) * D;
    T* dvr = (T*)a.dv + (bh * a.Sk + key) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dkr[tx + 16 * dd] = from_f<T>(dk[i][dd]);
      dvr[tx + 16 * dd] = from_f<T>(dv[i][dd]);
    }
  }
}

// K3: one block per (q tile, h, b)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_q_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DP;
  float* Kt = dOs + BQ * DP;
  float* Vt = Kt + D * KP;
  float* dSs = Vt + D * KP;
  float* lse_s = dSs + BQ * KP;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const T* dob = (const T*)a.dout + bh * a.Sq * D;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  load_rows<T, D>(Qs, qb, a.qss, q0, a.Sq);
  load_rows<T, D>(dOs, dob, D, q0, a.Sq);
  load_vec(lse_s, a.lse + bh * a.Sq, q0, a.Sq);
  load_vec(delta_s, a.delta + bh * a.Sq, q0, a.Sq);

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;

  // keys [0, kend): a causal q tile sees nothing past its last row
  const int kend = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_rows_t<T, D>(Kt, kb, a.kss, k0, a.Sk);
    load_rows_t<T, D>(Vt, vb, a.vss, k0, a.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Kt, tx, ty);
    tile_dot<D>(dp, dOs, Vt, tx, ty);
    p_and_ds<T>(s, dp, lse_s, delta_s, bb, q0, k0, a.Sq, a.Sk, a.scale,
                a.scale2, a.causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * KP + tx + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[DPT];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) kv[dd] = Kt[(tx + 16 * dd) * KP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * KP + c];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd)
          acc[i][dd] = fmaf(ds, kv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    T* dqr = (T*)a.dq + (bh * a.Sq + row) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dqr[tx + 16 * dd] = from_f<T>(acc[i][dd]);
  }
}

// ---------------------------------------------------------------- K2

constexpr int K2_BK = 64;   // keys per block
constexpr int K2_NT = 128;  // 4 warps, 16 keys each
// q rows per tile: the S^T, dP^T, dK and dV accumulators share 255
// registers, and float32 fragments carry a hi and a lo part
template <typename T, int D>
__host__ __device__ constexpr int k2_bq() {
  return sizeof(T) == 4 ? (D >= 128 ? 16 : 32) : (D >= 128 ? 32 : 64);
}

template <typename T, int D>
constexpr size_t k2_smem_bytes() {
  // K, V [BK][D]; Q, dO [2][BQ][D]; dS [BQ][BK]; lse2, delta [2][BQ]
  return sizeof(T) * (2 * K2_BK * D + 4 * k2_bq<T, D>() * D +
                      k2_bq<T, D>() * K2_BK) +
         sizeof(float) * 4 * k2_bq<T, D>();
}

// K2: one block per (b, h, k tile); see the note at the top
template <typename T, int D>
__global__ void __launch_bounds__(K2_NT) flash_bwd_k2_kernel(Args a) {
  using M = Mma<T>;
  constexpr int BQ2 = k2_bq<T, D>();
  constexpr int KT = K2_BK * D * sizeof(T);   // bytes of the K or V tile
  constexpr int QT = BQ2 * D * sizeof(T);     // bytes of a Q or dO tile
  constexpr int KSTEPS = D * sizeof(T) / 32;  // depth steps over D
  constexpr int SSTEPS = K2_BK * sizeof(T) / 32;  // depth steps over keys
  constexpr int NS = BQ2 / 8;                 // n-tiles of S^T (q cols)
  constexpr int NO = D / 8;                   // n-tiles of dK, dV
  // dQ: WM warps over rows x WN over columns (strips of 16+ columns)
  constexpr int WM = BQ2 / 16;
  constexpr int WN = 4 / WM < D / 16 ? 4 / WM : D / 16;
  constexpr int DW = D / WN, NQ = DW / 8;
  constexpr uint32_t OFF_S = 2 * KT + 4 * QT;  // dS tile
  extern __shared__ __align__(128) unsigned char k2_smem[];
  const uint32_t sK = smem_u32(k2_smem), sV = sK + KT, sQ = sV + KT,
                 sO = sQ + 2 * QT, sS = sK + OFF_S;
  float* lse_s =
      reinterpret_cast<float*>(k2_smem + OFF_S + BQ2 * K2_BK * sizeof(T));
  float* dlt_s = lse_s + 2 * BQ2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * K2_BK;
  const int kw = k0 + warp * 16;  // the warp's first key
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const T* dob = (const T*)a.dout + (long long)bh * a.Sq * D;
  const float* lb = a.lse + (long long)bh * a.Sq;
  const float* db = a.delta + (long long)bh * a.Sq;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  // a causal k tile is seen only by the q tiles from its own start on
  const int qstart = a.causal ? (k0 / BQ2) * BQ2 : 0;
  const int nq = qstart < a.Sq ? (a.Sq - qstart + BQ2 - 1) / BQ2 : 0;

  float kbias[2];  // bias * log2(e) of the warp's rows kw + g, kw + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    kbias[r] = (bb != nullptr && key < a.Sk) ? bb[key] * LOG2E : 0.f;
  }

  load_tile_async<T, D, K2_BK, K2_NT>(sK, kb, a.kss, k0, a.Sk);
  load_tile_async<T, D, K2_BK, K2_NT>(sV, vb, a.vss, k0, a.Sk);
  if (nq > 0) {
    load_tile_async<T, D, BQ2, K2_NT>(sQ, qb, a.qss, qstart, a.Sq);
    load_tile_async<T, D, BQ2, K2_NT>(sO, dob, D, qstart, a.Sq);
    if (tid < BQ2) {
      const int q = qstart + tid;
      lse_s[tid] = q < a.Sq ? lb[q] : 0.f;
      dlt_s[tid] = q < a.Sq ? db[q] : 0.f;
    }
  }
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int q0 = qstart + it * BQ2, st = it & 1;
    float nl = 0.f, nd = 0.f;
    if (it + 1 < nq) {
      const int q1 = q0 + BQ2;
      load_tile_async<T, D, BQ2, K2_NT>(sQ + (st ^ 1) * QT, qb, a.qss, q1,
                                        a.Sq);
      load_tile_async<T, D, BQ2, K2_NT>(sO + (st ^ 1) * QT, dob, D, q1,
                                        a.Sq);
      if (tid < BQ2 && q1 + tid < a.Sq) {
        nl = lb[q1 + tid];
        nd = db[q1 + tid];
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q/dO tile it (and K, V) landed for every thread

    const uint32_t tQ = sQ + st * QT, tO = sO + st * QT;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      typename M::A ka, va;
      M::template load_a<D>(ka, sK, warp * 16, ks);
      M::template load_a<D>(va, sV, warp * 16, ks);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        typename M::B b0, b1;
        M::template load_b2<D>(b0, b1, tQ, n * 8, ks);
        M::mma(s[n], ka, b0);
        M::mma(s[n + 1], ka, b1);
        M::template load_b2<D>(b0, b1, tO, n * 8, ks);
        M::mma(dp[n], va, b0);
        M::mma(dp[n + 1], va, b1);
      }
    }

    // p and ds (rows: keys kw + g (+8); cols: q0 + 8n + 2t (+1)); the mask
    // only where the pair touches the diagonal or a ragged edge
    const bool edge = (a.causal && kw + 15 > q0) || q0 + BQ2 > a.Sq ||
                      kw + 16 > a.Sk;
    const float* ls = lse_s + st * BQ2;
    const float* dl = dlt_s + st * BQ2;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), r = e >> 1;
        float p = fast_exp2(s[n][e] * a.scale2 + kbias[r] - ls[c]);
        if (edge) {
          const int q = q0 + c, key = kw + g + 8 * r;
          if (q >= a.Sq || key >= a.Sk || (a.causal && key > q)) p = 0.f;
        }
        const float ds = p * (dp[n][e] - dl[c]) * a.scale;
        s[n][e] = round_to<T>(p);
        dp[n][e] = round_to<T>(ds);
      }

    // dV += P^T dO, dK += dS^T Q (depth: the q rows of the tile)
#pragma unroll
    for (int j = 0; j < BQ2 / M::MK; ++j) {
      typename M::A pa, da;
      M::p_frag(pa, s, j);
      M::p_frag(da, dp, j);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        typename M::B b0, b1;
        M::template load_bt2<D>(b0, b1, tO, j * M::MK, n * 8);
        M::mma(dv[n], pa, b0);
        M::mma(dv[n + 1], pa, b1);
        M::template load_bt2<D>(b0, b1, tQ, j * M::MK, n * 8);
        M::mma(dk[n], da, b0);
        M::mma(dk[n + 1], da, b1);
      }
    }

    // dS -> shared memory as [q][key] for this pair's dQ share
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int key = warp * 16 + g + 8 * (e >> 1);
        *reinterpret_cast<T*>(k2_smem + OFF_S +
                              swz_elem<T, K2_BK>(c, key)) =
            from_f<T>(dp[n][e]);
      }
    if (tid < BQ2 && it + 1 < nq) {
      lse_s[(st ^ 1) * BQ2 + tid] = nl;
      dlt_s[(st ^ 1) * BQ2 + tid] = nd;
    }
    __syncthreads();  // dS complete; every warp is done with Q/dO stage st

    // dQ share = dS K: warp (wm, wn) owns rows q0 + 16 wm, cols DW wn
    if (warp >= WM * WN) continue;  // the grid has fewer cells than warps
    const int wm = warp % WM, wn = warp / WM;
    float acc[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < SSTEPS; ++ks) {
      typename M::A sa;
      M::template load_a<K2_BK>(sa, sS, wm * 16, ks);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        typename M::B b0, b1;
        M::template load_bt2<D, false>(b0, b1, sK, ks * M::MK,
                                       wn * DW + n * 8);
        M::mma(acc[n], sa, b0);
        M::mma(acc[n + 1], sa, b1);
      }
    }
    // lanes t, t ^ 1 swap halves so that each holds 4 consecutive columns
    // of one row: even t row g, odd t row g + 8
    const bool odd = t & 1;
    const int row = q0 + wm * 16 + g + (odd ? 8 : 0);
    float* dqr = a.dq_acc + ((long long)bh * a.Sq + row) * D + wn * DW +
                 4 * (t >> 1);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float x0 = odd ? acc[n][0] : acc[n][2];
      const float x1 = odd ? acc[n][1] : acc[n][3];
      const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
      const float4 v = odd ? make_float4(y0, y1, acc[n][2], acc[n][3])
                           : make_float4(acc[n][0], acc[n][1], y0, y1);
      if (row < a.Sq) atomicAdd(reinterpret_cast<float4*>(dqr + n * 8), v);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= a.Sk) continue;
    T* dkr = (T*)a.dk + ((long long)bh * a.Sk + key) * D;
    T* dvr = (T*)a.dv + ((long long)bh * a.Sk + key) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store2(dkr + n * 8 + 2 * t, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dvr + n * 8 + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// K2's epilogue: the float32 dq buffer -> q's type
template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst,
                            long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

template <typename K>
cudaError_t raise_smem(K kern, size_t bytes, bool& done) {
  // once per instantiation: not a stream operation, so it never lands
  // inside a CUDA-graph capture of a launch
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

// kind: 0 = K2 (dk, dv + dq through dq_acc), 1 = K3 (dq), 2 = K4 (dk, dv)
template <typename T, int D>
cudaError_t launch(int kind, const Args& a, int B, cudaStream_t stream) {
  if (kind == 1) {
    static bool done = false;
    const size_t smem = sizeof(float) * q_smem_floats<D>();
    auto kern = flash_bwd_q_kernel<T, D>;
    cudaError_t e = raise_smem(kern, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
    kern<<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (kind == 2) {
    static bool done = false;
    const size_t smem = sizeof(float) * kv_smem_floats<D>();
    auto kern = flash_bwd_kv_kernel<T, D>;
    cudaError_t e = raise_smem(kern, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid((a.Sk + BK - 1) / BK, a.H, B);
    kern<<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  static bool done = false;
  const size_t smem = k2_smem_bytes<T, D>();
  auto kern = flash_bwd_k2_kernel<T, D>;
  cudaError_t e = raise_smem(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid(B * a.H, (a.Sk + K2_BK - 1) / K2_BK);
  kern<<<grid, K2_NT, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.dq == (void*)a.dq_acc) return e;
  const long long n = (long long)B * a.H * a.Sq * D;
  const int blocks = (int)((n + NT - 1) / NT < 4096 ? (n + NT - 1) / NT : 4096);
  cast_kernel<T><<<blocks, NT, 0, stream>>>(a.dq_acc, (T*)a.dq, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, int kind, const Args& a, int B,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(kind, a, B, stream);
    case 32: return launch<T, 32>(kind, a, B, stream);
    case 64: return launch<T, 64>(kind, a, B, stream);
    case 128: return launch<T, 128>(kind, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* pt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// kind: 0 = K2 (combined), 1 = K3 (dq), 2 = K4 (dk, dv). dtype: 0 =
// float32, 1 = bfloat16. strides: q, k, v (batch, head, seq) in elements;
// the head dim is contiguous. dout, lse, delta, dq, dk, dv, dq_acc are
// contiguous. bias is float32 [B, Sk] or null. For K2, dq_acc is a zeroed
// float32 [B, H, Sq, D] buffer (it may be dq itself when dtype is 0).
int pt_flash_attention_bwd(int kind, const void* q, const void* k,
                           const void* v, const void* bias, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           void* dk, void* dv, void* dq_acc, int dtype, int B,
                           int H, int Sq, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return cudaSuccess;
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = (const float*)bias;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_acc = (float*)dq_acc;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.qsb = strides[0];
  a.qsh = strides[1];
  a.qss = strides[2];
  a.ksb = strides[3];
  a.ksh = strides[4];
  a.kss = strides[5];
  a.vsb = strides[6];
  a.vsh = strides[7];
  a.vss = strides[8];
  a.scale = scale;
  a.scale2 = scale * LOG2E;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(D, kind, a, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, kind, a, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
