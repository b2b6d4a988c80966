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
// over B*H*(Sq+2*Sk)*D input elements, so it is bound by operations,
// not bytes, at every prefill length of the serving path: float32
// inputs against the card's float32 rate (67 TFLOP/s), bfloat16 inputs
// against its bf16 tensor-core rate (989 TFLOP/s). This first version
// computes in float32 on the CUDA cores (FMA) for both; moving the
// products onto the tensor cores (wgmma + TMA) is the work of a later
// version.
//
// Design: the TPU kernel walks a sequential grid and carries the
// online-softmax state in VMEM scratch from one k block to the next. On
// the GPU one CUDA block owns one (b, h, 64-row q tile) and loops over
// the k/v tiles itself, so the state (m, l, acc) stays in registers in
// float32. One kernel covers both TPU variants (single block and
// online). Tiles past the causal limit of the q tile are never loaded
// (the TPU kernel's `_block_live`). Sq and Sk need not divide the tile:
// rows past Sq are not stored and keys past Sk are masked out (the TPU
// kernel demands divisibility). `scale * log2(e)` is folded into the q
// tile as the TPU kernel does, so exp2 replaces exp. 256 threads form a
// 16 x 16 grid: thread (ty, tx) owns rows ty + 16i and score columns
// tx + 16j, so shared-memory reads are conflict-free or broadcasts, and
// a row's 16 threads sit in one half-warp for the shuffle reductions.
// Q, K^T, V and P tiles live in dynamic shared memory (66 KB at D = 64,
// above the 48 KB default, hence cudaFuncSetAttribute).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
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

// reductions over the 16 lanes of one half-warp (one row's threads)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int Sq, int Sk, long long qsb, long long qsh,
                     long long qss, long long ksb, long long ksh,
                     long long kss, long long vsb, long long vsh,
                     long long vss, float scale2, int causal) {
  constexpr int DP = D + 1;
  constexpr int KP = BK + 1;
  constexpr int RPT = BQ / 16;  // rows per thread
  constexpr int CPT = BK / 16;  // score columns per thread
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][D+1], pre-scaled by scale*log2(e)
  float* Kt = Qs + BQ * DP;     // [D][BK+1], transposed K tile
  float* Vs = Kt + D * KP;      // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][BK+1], probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const float* bb = bias ? bias + (long long)b * Sk : nullptr;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f(qb[(long long)(q0 + r) * qss + d]) * scale2;
    Qs[r * DP + d] = x;
  }

  float m[RPT], l[RPT], o[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[i][dd] = 0.f;
  }

  // keys [0, kend): a causal q tile sees nothing past its last row
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        kx = to_f(kb[(long long)(k0 + c) * kss + d]);
        vx = to_f(vb[(long long)(k0 + c) * vss + d]);
      }
      Kt[d * KP + c] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + 16 * j;
      const float bj = (bb != nullptr && col < Sk) ? bb[col] * LOG2E : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty + 16 * i;
        const bool ok = col < Sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] + bj : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CPT; ++j) mx = fmaxf(mx, s[i][j]);
      const float mnew = fmaxf(m[i], half_max(mx));
      const float corr = exp2f(m[i] - mnew);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = exp2f(s[i][j] - mnew);  // masked: exp2(-inf) = 0
        Ps[(ty + 16 * i) * KP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + half_sum(ps);
      m[i] = mnew;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) o[i][dd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = Vs[c * D + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + 16 * i) * KP + c];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) o[i][dd] = fmaf(p, vv[dd], o[i][dd]);
      }
    }
  }

  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / li;
    T* orow = out + (bh * Sq + row) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      orow[tx + 16 * dd] = from_f<T>(o[i][dd] * inv);
    if (tx == 0) lse[bh * Sq + row] = m[i] + log2f(li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int B, int H,
                   int Sq, int Sk, const long long* st, float scale2,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  // raise the dynamic shared-memory cap once per instantiation (not a
  // stream operation: done before any CUDA-graph capture of a launch)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out,
      (float*)lse, H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int B, int H,
                       int Sq, int Sk, const long long* st, float scale2,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, bias, out, lse, B, H, Sq, Sk, st,
                           scale2, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, bias, out, lse, B, H, Sq, Sk, st,
                           scale2, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, out, lse, B, H, Sq, Sk, st,
                           scale2, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, out, lse, B, H, Sq, Sk, st,
                            scale2, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* pt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// dtype: 0 = float32, 1 = bfloat16. strides: q (batch, head, seq),
// k (batch, head, seq), v (batch, head, seq), in elements; the head dim
// is contiguous. out/lse are contiguous. bias is float32 [B, Sk] or null.
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* lse, int dtype,
                           int B, int H, int Sq, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           void* stream) {
  const float scale2 = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, bias, out, lse, B, H, Sq, Sk,
                             strides, scale2, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, out, lse, B, H, Sq,
                                     Sk, strides, scale2, causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
