// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// `_fwd_pallas` (`_fwd_single_kernel` and `_fwd_online_kernel`): for
// q [B,H,Sq,D], k/v [B,H,Sk,D] (float32 or bfloat16), an optional
// additive key bias [B,1,1,Sk] and an optional causal mask (key j is
// visible to query i iff j <= i), it returns
//   out  = softmax(q k^T * scale + bias) v          [B,H,Sq,D], q's type
//   lse2 = m2 + log2(l), the base-2 log-sum-exp      [B,H,1,Sq], float32
// where m2 is the row max of the base-2 scores and l the row sum of
// exp2(score - m2). A row with l == 0 gives 0.
//
// What bounds it on the H100: the causal forward does 2*B*H*Sq*Sk*D
// floating-point operations (two products, half of the score square)
// over B*H*(Sq+2*Sk)*D input elements, so it is bound by operations at
// every prefill length: bf16 inputs against the tensor cores' 989
// TFLOP/s, float32 inputs against 165 TFLOP/s (495 TF32 / 3: the three
// TF32 products an fp32-accurate product takes).
//
// Design (FlashAttention-2 on mma.sync; shared pieces in attention_mma.cuh):
// - One block of 8 warps owns one (b, h, 128-row q tile) and loops over
//   the live 64-key tiles; each warp owns 16 q rows across the whole key
//   tile, so the online-softmax max and sum reduce over the 4 lanes of a
//   quad in registers and the state (m, l, O) never leaves them.
// - S = Q K^T and O += P V run on the tensor cores: bf16 on m16n8k16,
//   float32 as 3xTF32 on m16n8k8 (see the header). `scale * log2(e)` is
//   applied to the float32 S accumulator, as the plain version scales
//   in float32, and exp2 replaces exp.
// - P goes from the S accumulators to the A operand of P V in registers
//   (bf16: two C tiles pack into one k16 A tile; float32: a relabelled
//   depth, see the header).
// - K/V tiles stream through a 2-stage ring of swizzled shared memory
//   filled with 16-byte cp.async: tile t+1 is in flight while tile t is
//   multiplied. q/k/v may be strided views, but their base addresses and
//   row strides must be multiples of 16 bytes (the wrapper checks).
// - Only tiles on the causal diagonal or the ragged Sk edge evaluate the
//   mask; a warp whose rows see none of a tile skips it; tiles past the
//   causal limit are never loaded (the TPU kernel's `_block_live`). Sq
//   and Sk need not divide the tiles (the TPU kernel demands it).
// - Causal q tiles are launched heaviest first (the tile index is the
//   slowest grid dimension, reversed), so the lightest tiles form the tail.
// - Head dims 80 and 96 run in D128's tile plan (DV < D): their columns
//   past DV load as zeros and are never stored.
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace pt_attn;

constexpr int BQ = 128;        // q rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NW = BQ / 16;    // warps, 16 rows each
constexpr int NT = NW * 32;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, Sk] or null
  void* out;          // [B, H, Sq, D] contiguous
  float* lse;         // [B, H, Sq]
  int H, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale2;
  int causal;
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D], K and V [2][BK][D], bias2 [2][BK]
  return sizeof(T) * D * (BQ + 4 * BK) + sizeof(float) * 2 * BK;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FwdArgs a) {
  using M = Mma<T>;
  constexpr int TILE = BK * D * sizeof(T);
  constexpr int KSTEPS = D * sizeof(T) / 32;  // depth steps of Q K^T
  constexpr int NS = BK / 8;                  // n-tiles of S
  constexpr int NO = D / 8;                   // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + BQ * D * sizeof(T);
  const uint32_t sV = sK + 2 * TILE;
  float* bias_s = reinterpret_cast<float*>(smem + sizeof(T) * D * (BQ + 4 * BK));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int qw = q0 + warp * 16;  // the warp's first row
  const T* qb = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kb = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vb = (const T*)a.v + b * a.vsb + h * a.vsh;
  const float* bb = a.bias ? a.bias + (long long)b * a.Sk : nullptr;

  // keys [0, kend): a causal q tile sees nothing past its last row
  const int kend = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  const int nk = (kend + BK - 1) / BK;

  load_tile_async<T, D, BQ, NT, DV>(sQ, qb, a.qss, q0, a.Sq);
  if (nk > 0) {
    load_tile_async<T, D, BK, NT, DV>(sK, kb, a.kss, 0, a.Sk);
    load_tile_async<T, D, BK, NT, DV>(sV, vb, a.vss, 0, a.Sk);
  }
  cp_async_commit();
  if (bb != nullptr && tid < BK)
    bias_s[tid] = tid < a.Sk ? bb[tid] * LOG2E : 0.f;

  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK, st = it & 1;
    float nb = 0.f;
    if (it + 1 < nk) {
      const int k1 = k0 + BK;
      load_tile_async<T, D, BK, NT, DV>(sK + (st ^ 1) * TILE, kb, a.kss, k1,
                                        a.Sk);
      load_tile_async<T, D, BK, NT, DV>(sV + (st ^ 1) * TILE, vb, a.vss, k1,
                                        a.Sk);
      if (bb != nullptr && tid < BK && k1 + tid < a.Sk)
        nb = bb[k1 + tid] * LOG2E;
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and Q) landed for every thread

    // warp-uniform: rows past Sq, or (causal) rows that see no key here
    const bool live = qw < a.Sq && !(a.causal && k0 > qw + 15);
    if (live) {
      const uint32_t tK = sK + st * TILE, tV = sV + st * TILE;
      float s[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        typename M::A qa;
        M::template load_a<D>(qa, sQ, warp * 16, ks);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          typename M::B b0, b1;
          M::template load_b2<D>(b0, b1, tK, n * 8, ks);
          M::mma(s[n], qa, b0);
          M::mma(s[n + 1], qa, b1);
        }
      }

      // base-2 scores; the mask only on the diagonal and ragged-edge tiles
      const bool edge = (a.causal && k0 + BK - 1 > qw) || k0 + BK > a.Sk;
      const float* bt = bias_s + st * BK;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * a.scale2;
          if (bb != nullptr) x += bt[c];
          if (edge) {
            const int col = k0 + c, row = qw + g + (e >> 1) * 8;
            if (col >= a.Sk || (a.causal && col > row)) x = -INFINITY;
          }
          s[n][e] = x;
        }

      // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = quad_max(mx);
        const float corr = fast_exp2(m[r] - mx);
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[n][e] = fast_exp2(s[n][e] - mx);  // masked: exp2(-inf) = 0
            ps += s[n][e];
          }
        l[r] = l[r] * corr + ps;  // the quad's partial sums, reduced last
        m[r] = mx;
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          o[i][2 * r] *= corr;
          o[i][2 * r + 1] *= corr;
        }
      }

      // O += P V, P from the S accumulators
#pragma unroll
      for (int j = 0; j < BK / M::MK; ++j) {
        typename M::A pa;
        M::p_frag(pa, s, j);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          typename M::B b0, b1;
          M::template load_bt2<D>(b0, b1, tV, j * M::MK, n * 8);
          M::mma(o[n], pa, b0);
          M::mma(o[n + 1], pa, b1);
        }
      }
    }
    if (bb != nullptr && tid < BK && it + 1 < nk) bias_s[(st ^ 1) * BK + tid] = nb;
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  const long long bh_off = (long long)bh * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + r * 8;
    const float lr = quad_sum(l[r]);
    if (row >= a.Sq) continue;
    const float li = lr == 0.f ? 1.f : lr;
    const float inv = 1.f / li;
    T* orow = (T*)a.out + (bh_off + row) * DV;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      store2(orow + i * 8 + 2 * t, o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
    if (t == 0) a.lse[bh_off + row] = m[r] + log2f(li);
  }
}

template <typename T, int D, int DV = D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  auto kern = flash_fwd_kernel<T, D, DV>;
  // raise the dynamic shared-memory cap once per instantiation (not a
  // stream operation: done before any CUDA-graph capture of a launch)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const FwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 128, 80>(a, B, stream);
    case 96: return launch<T, 128, 96>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* pt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// dtype: 0 = float32, 1 = bfloat16. strides: q (batch, head, seq),
// k (batch, head, seq), v (batch, head, seq), in elements; the head dim
// is contiguous, base addresses and strides are multiples of 16 bytes.
// out/lse are contiguous. bias is float32 [B, Sk] or null.
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* lse, int dtype,
                           int B, int H, int Sq, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = (const float*)bias;
  a.out = out;
  a.lse = (float*)lse;
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
  a.scale2 = scale * LOG2E;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(D, a, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, a, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
