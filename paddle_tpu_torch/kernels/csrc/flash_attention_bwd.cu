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
// Sums are taken in float32; outputs are written once, in the input type.
//
// What bounds them on the H100: score-sized products, 2 * B*H*live*D
// operations each (live: the visible (query, key) pairs), against a few
// [B,H,S,D] tensors of input and output. K2 does 5 (s, dp, dq, dk, dv),
// K3 3 (s, dp, dq), K4 4 (s, dp, dk, dv): bound by operations at every
// training shape, bf16 against the tensor cores' 989 TFLOP/s, float32
// against 165 TFLOP/s (495 TF32 / 3, the three TF32 products of 3xTF32).
//
// All three run on the tensor cores with warp-level mma.sync
// (attention_mma.cuh: bf16 m16n8k16; float32 as 3xTF32 m16n8k8) and
// stream their tiles through a 2-stage cp.async ring of swizzled shared
// memory (16-byte copies, zero-filled past a ragged edge), so tile t+1
// loads while tile t is multiplied. p and ds are formed in registers from
// the accumulators; only tile pairs on the causal diagonal or a ragged
// edge evaluate the mask, and dead causal tiles are never visited (the
// TPU kernels' `_block_live`). The TPU kernels walk a sequential grid and
// carry dq (K3) or dk/dv (K4) in VMEM scratch across grid steps; a CUDA
// block has no such memory and blocks run in no order, so each block
// loops over the other operand's tiles and keeps its output in registers:
//
// K2 and K4 (one loop, kv_loop, with and without the dQ share): one block
// of 4 warps per (b, h, 64-key tile) loops over the live q tiles (bf16: 64
// rows, 32 at D = 128; float32: 32, 16 at D = 128, as its fragments carry
// a hi and a lo part). Each warp owns 16 keys and computes the transposed
// scores S^T = K Q^T and dP^T = V dO^T across the q tile, so P^T and dS^T
// leave the accumulators in the layout that dV += P^T dO and dK += dS^T Q
// take as their A operand: dK and dV stay in registers for the whole
// loop. K4 stops there (a warp whose keys the causal q tile cannot see
// skips the tile). K2 adds the pair's dQ share: dS goes once through
// swizzled shared memory, dS K is computed by warps split over q rows and
// added to a zeroed float32 buffer with 16-byte vector atomics (float4
// atomicAdd, compute capability 9.x); a small epilogue casts it for bf16.
// k tiles are launched in ascending order, under a causal mask heaviest
// first.
//
// K3: K1's loop (flash_attention_fwd.cu) with a second product. One block
// of 8 warps per (b, h, 128-row q tile), 16 rows per warp, walks the live
// key tiles (64 keys; 32 for float32 at D = 128, for registers): S = Q K^T
// and dP = dO V^T from the Q/dO tiles and the K/V ring, p and ds in
// registers (lse2 and delta are given, so no online rescaling), then dQ
// += dS K with dS taken from the accumulators as the A operand, exactly
// K1's P V step with K in V's place. dQ stays in registers and is written
// once. Causal q tiles are launched heaviest first.
//
// Left for later: `mma.sync`, not `wgmma` + TMA; in float32 every B
// fragment a warp reads is split into TF32 hi/lo parts on the fly (3 ALU
// instructions per element), and the "B = tile" loads are scalar.
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace pt_attn;

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

// ------------------------------------------------------------- K2, K4

constexpr int KV_BK = 64;   // keys per block
constexpr int KV_NT = 128;  // 4 warps, 16 keys each
// q rows per tile: the S^T, dP^T, dK and dV accumulators share 255
// registers, and float32 fragments carry a hi and a lo part
template <typename T, int D>
__host__ __device__ constexpr int kv_bq() {
  return sizeof(T) == 4 ? (D >= 128 ? 16 : 32) : (D >= 128 ? 32 : 64);
}

template <typename T, int D, bool kDq>
constexpr size_t kv_smem_bytes() {
  // K, V [BK][D]; Q, dO [2][BQ][D]; dS [BQ][BK] (K2); lse2, delta [2][BQ]
  constexpr int BQ = kv_bq<T, D>();
  return sizeof(T) * (2 * KV_BK * D + 4 * BQ * D + (kDq ? BQ * KV_BK : 0)) +
         sizeof(float) * 4 * BQ;
}

// one block per (b, h, k tile); see the note at the top
template <typename T, int D, bool kDq>
__device__ __forceinline__ void kv_loop(const Args& a) {
  using M = Mma<T>;
  constexpr int BQ = kv_bq<T, D>();
  constexpr int KT = KV_BK * D * sizeof(T);   // bytes of the K or V tile
  constexpr int QT = BQ * D * sizeof(T);      // bytes of a Q or dO tile
  constexpr int KSTEPS = D * sizeof(T) / 32;  // depth steps over D
  constexpr int SSTEPS = KV_BK * sizeof(T) / 32;  // depth steps over keys
  constexpr int NS = BQ / 8;                  // n-tiles of S^T (q cols)
  constexpr int NO = D / 8;                   // n-tiles of dK, dV
  // dQ: WM warps over rows x WN over columns (strips of 16+ columns)
  constexpr int WM = BQ / 16;
  constexpr int WN = 4 / WM < D / 16 ? 4 / WM : D / 16;
  constexpr int DW = D / WN, NQ = DW / 8;
  constexpr uint32_t OFF_S = 2 * KT + 4 * QT;  // dS tile (K2)
  constexpr uint32_t OFF_L = OFF_S + (kDq ? BQ * KV_BK * sizeof(T) : 0);
  extern __shared__ __align__(128) unsigned char kv_smem[];
  const uint32_t sK = smem_u32(kv_smem), sV = sK + KT, sQ = sV + KT,
                 sO = sQ + 2 * QT, sS = sK + OFF_S;
  float* lse_s = reinterpret_cast<float*>(kv_smem + OFF_L);
  float* dlt_s = lse_s + 2 * BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * KV_BK;
  const int kw = k0 + warp * 16;  // the warp's first key
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const T* dob = (const T*)a.dout + (long long)bh * a.Sq * D;
  const float* lb = a.lse + (long long)bh * a.Sq;
  const float* db = a.delta + (long long)bh * a.Sq;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  // a causal k tile is seen only by the q tiles from its own start on
  const int qstart = a.causal ? (k0 / BQ) * BQ : 0;
  const int nq = qstart < a.Sq ? (a.Sq - qstart + BQ - 1) / BQ : 0;

  float kbias[2];  // bias * log2(e) of the warp's rows kw + g, kw + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    kbias[r] = (bb != nullptr && key < a.Sk) ? bb[key] * LOG2E : 0.f;
  }

  load_tile_async<T, D, KV_BK, KV_NT>(sK, kb, a.kss, k0, a.Sk);
  load_tile_async<T, D, KV_BK, KV_NT>(sV, vb, a.vss, k0, a.Sk);
  if (nq > 0) {
    load_tile_async<T, D, BQ, KV_NT>(sQ, qb, a.qss, qstart, a.Sq);
    load_tile_async<T, D, BQ, KV_NT>(sO, dob, D, qstart, a.Sq);
    if (tid < BQ) {
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
    const int q0 = qstart + it * BQ, st = it & 1;
    float nl = 0.f, nd = 0.f;
    if (it + 1 < nq) {
      const int q1 = q0 + BQ;
      load_tile_async<T, D, BQ, KV_NT>(sQ + (st ^ 1) * QT, qb, a.qss, q1,
                                       a.Sq);
      load_tile_async<T, D, BQ, KV_NT>(sO + (st ^ 1) * QT, dob, D, q1, a.Sq);
      if (tid < BQ && q1 + tid < a.Sq) {
        nl = lb[q1 + tid];
        nd = db[q1 + tid];
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q/dO tile it (and K, V) landed for every thread

    // K4: warp-uniform, keys past Sk or (causal) keys no row here sees;
    // K2 computes them all, its dS tile needs their zeros
    const bool live =
        kDq || (kw < a.Sk && !(a.causal && kw > q0 + BQ - 1));
    const uint32_t tQ = sQ + st * QT, tO = sO + st * QT;
    float s[NS][4], dp[NS][4];
    if (live) {
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

      // p and ds (rows: keys kw + g (+8); cols: q0 + 8n + 2t (+1)); the
      // mask only where the pair touches the diagonal or a ragged edge
      const bool edge = (a.causal && kw + 15 > q0) || q0 + BQ > a.Sq ||
                        kw + 16 > a.Sk;
      const float* ls = lse_s + st * BQ;
      const float* dl = dlt_s + st * BQ;
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
      for (int j = 0; j < BQ / M::MK; ++j) {
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
    }

    if constexpr (kDq) {
      // dS -> shared memory as [q][key] for this pair's dQ share
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int key = warp * 16 + g + 8 * (e >> 1);
          *reinterpret_cast<T*>(kv_smem + OFF_S +
                                swz_elem<T, KV_BK>(c, key)) =
              from_f<T>(dp[n][e]);
        }
    }
    if (tid < BQ && it + 1 < nq) {
      lse_s[(st ^ 1) * BQ + tid] = nl;
      dlt_s[(st ^ 1) * BQ + tid] = nd;
    }
    __syncthreads();  // (dS complete;) every warp is done with stage st

    // K2's dQ share = dS K: warp (wm, wn) owns rows q0 + 16 wm, cols DW wn
    if constexpr (kDq) {
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
        M::template load_a<KV_BK>(sa, sS, wm * 16, ks);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          typename M::B b0, b1;
          M::template load_bt2<D, false>(b0, b1, sK, ks * M::MK,
                                         wn * DW + n * 8);
          M::mma(acc[n], sa, b0);
          M::mma(acc[n + 1], sa, b1);
        }
      }
      // lanes t, t ^ 1 swap halves so that each holds 4 consecutive
      // columns of one row: even t row g, odd t row g + 8
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

// K2: dk, dv and the dq shares
template <typename T, int D>
__global__ void __launch_bounds__(KV_NT) flash_bwd_k2_kernel(Args a) {
  kv_loop<T, D, true>(a);
}

// K4: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(KV_NT) flash_bwd_kv_kernel(Args a) {
  kv_loop<T, D, false>(a);
}

// K2's epilogue: the float32 dq buffer -> q's type
template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst,
                            long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

// ------------------------------------------------------------------ K3

constexpr int Q_BQ = 128;         // q rows per block
constexpr int Q_NT = Q_BQ / 16 * 32;  // 8 warps, 16 rows each
// keys per tile: the S, dP and dQ accumulators share 255 registers
template <typename T, int D>
__host__ __device__ constexpr int q_bk() {
  return sizeof(T) == 4 && D >= 128 ? 32 : 64;
}

template <typename T, int D>
constexpr size_t q_smem_bytes() {
  // Q, dO [BQ][D]; K, V [2][BK][D]; bias2 [2][BK]
  return sizeof(T) * D * (2 * Q_BQ + 4 * q_bk<T, D>()) +
         sizeof(float) * 2 * q_bk<T, D>();
}

// K3: one block per (b, h, q tile); see the note at the top
template <typename T, int D>
__global__ void __launch_bounds__(Q_NT) flash_bwd_q_kernel(Args a) {
  using M = Mma<T>;
  constexpr int BK = q_bk<T, D>();
  constexpr int TILE = BK * D * sizeof(T);    // bytes of a K or V tile
  constexpr int QT = Q_BQ * D * sizeof(T);    // bytes of the Q or dO tile
  constexpr int KSTEPS = D * sizeof(T) / 32;  // depth steps of Q K^T
  constexpr int NS = BK / 8;                  // n-tiles of S, dP
  constexpr int NO = D / 8;                   // n-tiles of dQ
  extern __shared__ __align__(128) unsigned char q_smem[];
  const uint32_t sQ = smem_u32(q_smem), sO = sQ + QT, sK = sO + QT,
                 sV = sK + 2 * TILE;
  float* bias_s = reinterpret_cast<float*>(q_smem + 2 * QT + 4 * TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * Q_BQ;
  const int qw = q0 + warp * 16;  // the warp's first row
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const T* dob = (const T*)a.dout + (long long)bh * a.Sq * D;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  // keys [0, kend): a causal q tile sees nothing past its last row
  const int kend = a.causal ? min(a.Sk, q0 + Q_BQ) : a.Sk;
  const int nk = (kend + BK - 1) / BK;

  load_tile_async<T, D, Q_BQ, Q_NT>(sQ, qb, a.qss, q0, a.Sq);
  load_tile_async<T, D, Q_BQ, Q_NT>(sO, dob, D, q0, a.Sq);
  if (nk > 0) {
    load_tile_async<T, D, BK, Q_NT>(sK, kb, a.kss, 0, a.Sk);
    load_tile_async<T, D, BK, Q_NT>(sV, vb, a.vss, 0, a.Sk);
  }
  cp_async_commit();
  if (bb != nullptr && tid < BK)
    bias_s[tid] = tid < a.Sk ? bb[tid] * LOG2E : 0.f;

  // lse2 and delta of the thread's rows qw + g, qw + g + 8 (rows past Sq
  // have zero q and dO, so ds = 0 there; they are not stored)
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const long long i = (long long)bh * a.Sq + row;
    lse[r] = row < a.Sq ? a.lse[i] : 0.f;
    dlt[r] = row < a.Sq ? a.delta[i] : 0.f;
  }

  float dq[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK, st = it & 1;
    float nb = 0.f;
    if (it + 1 < nk) {
      const int k1 = k0 + BK;
      load_tile_async<T, D, BK, Q_NT>(sK + (st ^ 1) * TILE, kb, a.kss, k1,
                                      a.Sk);
      load_tile_async<T, D, BK, Q_NT>(sV + (st ^ 1) * TILE, vb, a.vss, k1,
                                      a.Sk);
      if (bb != nullptr && tid < BK && k1 + tid < a.Sk)
        nb = bb[k1 + tid] * LOG2E;
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and Q, dO) landed for every thread

    // warp-uniform: rows past Sq, or (causal) rows that see no key here
    const bool live = qw < a.Sq && !(a.causal && k0 > qw + 15);
    if (live) {
      const uint32_t tK = sK + st * TILE, tV = sV + st * TILE;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        typename M::A qa, oa;
        M::template load_a<D>(qa, sQ, warp * 16, ks);
        M::template load_a<D>(oa, sO, warp * 16, ks);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          typename M::B b0, b1;
          M::template load_b2<D>(b0, b1, tK, n * 8, ks);
          M::mma(s[n], qa, b0);
          M::mma(s[n + 1], qa, b1);
          M::template load_b2<D>(b0, b1, tV, n * 8, ks);
          M::mma(dp[n], oa, b0);
          M::mma(dp[n + 1], oa, b1);
        }
      }

      // ds (rows qw + g (+8); keys k0 + 8n + 2t (+1)) into s; the mask
      // only on the diagonal and ragged-edge tiles
      const bool edge = (a.causal && k0 + BK - 1 > qw) || k0 + BK > a.Sk;
      const float* bt = bias_s + st * BK;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), r = e >> 1;
          float x = s[n][e] * a.scale2 - lse[r];
          if (bb != nullptr) x += bt[c];
          float p = fast_exp2(x);
          if (edge) {
            const int col = k0 + c, row = qw + g + 8 * r;
            if (col >= a.Sk || (a.causal && col > row)) p = 0.f;
          }
          s[n][e] = round_to<T>(p * (dp[n][e] - dlt[r]) * a.scale);
        }

      // dQ += dS K, dS from the accumulators
#pragma unroll
      for (int j = 0; j < BK / M::MK; ++j) {
        typename M::A da;
        M::p_frag(da, s, j);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          typename M::B b0, b1;
          M::template load_bt2<D>(b0, b1, tK, j * M::MK, n * 8);
          M::mma(dq[n], da, b0);
          M::mma(dq[n + 1], da, b1);
        }
      }
    }
    if (bb != nullptr && tid < BK && it + 1 < nk)
      bias_s[(st ^ 1) * BK + tid] = nb;
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= a.Sq) continue;
    T* dqr = (T*)a.dq + ((long long)bh * a.Sq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dqr + n * 8 + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------- launch

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
    const size_t smem = q_smem_bytes<T, D>();
    auto kern = flash_bwd_q_kernel<T, D>;
    cudaError_t e = raise_smem(kern, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid(B * a.H, (a.Sq + Q_BQ - 1) / Q_BQ);
    kern<<<grid, Q_NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  dim3 grid(B * a.H, (a.Sk + KV_BK - 1) / KV_BK);
  if (kind == 2) {
    static bool done = false;
    const size_t smem = kv_smem_bytes<T, D, false>();
    auto kern = flash_bwd_kv_kernel<T, D>;
    cudaError_t e = raise_smem(kern, smem, done);
    if (e != cudaSuccess) return e;
    kern<<<grid, KV_NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  static bool done = false;
  const size_t smem = kv_smem_bytes<T, D, true>();
  auto kern = flash_bwd_k2_kernel<T, D>;
  cudaError_t e = raise_smem(kern, smem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid, KV_NT, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.dq == (void*)a.dq_acc) return e;
  const long long n = (long long)B * a.H * a.Sq * D;
  const int NT = 256;
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
