// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
// `_pallas_paged_attention` (`_paged_kernel`): one query per row,
// q [B,H,1,D], attends over that row's KV cache stored as blocks of a
// shared pool k/v [N,H,bs,D] (float32, bfloat16, or int8 with float32
// scales [N,H,bs] per (block, head, slot)), routed through the row's
// block table tables[b, :] (int32). Key slot j is visible iff
// j <= pos[b]. A row with l == 0 (nothing visible) gives 0.
//
// What bounds it on the H100: every live key and value is read once and
// used for two multiply-adds per element, so the kernel is bound by
// bytes: 2 * sum_b(pos_b + 1) * H * D * elem (plus 4-byte scales for
// int8) over 3.35 TB/s. The design keeps the read to exactly those
// bytes: blocks past pos[b] // bs are never touched (the TPU kernel's
// dead-block skip, which also keeps the trash-block padding of the
// table out), int8 and bf16 blocks are read as they are stored and
// widened in registers, and nothing but the [B,H,1,D] output is
// written.
//
// Design: the TPU kernel prefetches the block table as scalars and
// walks a sequential grid (b, h, j) with the online-softmax state in
// VMEM scratch. Here one CUDA block of 8 warps owns one (b, h) and reads
// the row's table entries itself. Warp w folds blocks j = w, w + 8, ...
// into its own (m, l, acc) state; each lane holds D/32 elements of q,
// of a key and of the accumulator, a key's dot product is a warp
// shuffle reduction, and a block is folded as the TPU kernel folds it:
// block max, one rescale, then the block's probabilities times its
// values. Keys and values are loaded 8 tokens at a time so that each
// warp keeps several loads in flight. The 8 warp states merge through
// shared memory at the end. q may be float32 while the pool is bf16 or
// int8; all arithmetic is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;       // warps per block
constexpr int CHUNK = 8;    // tokens loaded together
constexpr int MAX_BS = 64;  // block-size cap (per-warp score buffer)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NW * 32)
    paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                      const TKV* __restrict__ vp,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc,
                      const int* __restrict__ tables,
                      const int* __restrict__ pos, TQ* __restrict__ out,
                      int H, int bs, int nblk, float scale2) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sc[NW][MAX_BS];
  __shared__ float wm[NW], wl[NW];
  __shared__ float wacc[NW][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = pos[b];
  const int* tab = tables + (long long)b * nblk;
  const long long bh = (long long)b * H + h;

  float qr[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    qr[e] = to_f(q[bh * D + lane * EPL + e]) * scale2;

  float m = NEG_BIG, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  const int last = p < 0 ? -1 : min(p / bs, nblk - 1);
  for (int j = w; j <= last; j += NW) {
    const long long base = ((long long)tab[j] * H + h) * bs;  // first slot
    float mb = -INFINITY;
    for (int t0 = 0; t0 < bs; t0 += CHUNK) {
      float kv[CHUNK][EPL];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int t = t0 + u;
        if (t < bs && j * bs + t <= p) {
          const TKV* kr = kp + (base + t) * D + lane * EPL;
#pragma unroll
          for (int e = 0; e < EPL; ++e) kv[u][e] = to_f(kr[e]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int t = t0 + u;
        if (t >= bs) break;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[e], kv[u][e], part);
        float s = warp_sum(part);
        if (ksc != nullptr) s *= ksc[base + t];
        if (j * bs + t > p) s = -INFINITY;
        mb = fmaxf(mb, s);
        if (lane == 0) sc[w][t] = s;
      }
    }
    __syncwarp();
    const float mnew = fmaxf(m, mb);
    const float corr = exp2f(m - mnew);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
    for (int t0 = 0; t0 < bs; t0 += CHUNK) {
      float vv[CHUNK][EPL];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int t = t0 + u;
        if (t < bs && j * bs + t <= p) {
          const TKV* vr = vp + (base + t) * D + lane * EPL;
#pragma unroll
          for (int e = 0; e < EPL; ++e) vv[u][e] = to_f(vr[e]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) vv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int t = t0 + u;
        if (t >= bs) break;
        const float pr = exp2f(sc[w][t] - mnew);  // masked: 0
        const float pv = vsc != nullptr ? pr * vsc[base + t] : pr;
        l += pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pv, vv[u][e], acc[e]);
      }
    }
    m = mnew;
    __syncwarp();
  }

  if (lane == 0) {
    wm[w] = m;
    wl[w] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) wacc[w][lane * EPL + e] = acc[e];
  __syncthreads();
  if (w == 0) {
    float M = NEG_BIG;
#pragma unroll
    for (int i = 0; i < NW; ++i) M = fmaxf(M, wm[i]);
    float L = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float f = exp2f(wm[i] - M);
      L = fmaf(wl[i], f, L);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        o[e] = fmaf(wacc[i][lane * EPL + e], f, o[e]);
    }
    const float inv = 1.f / (L == 0.f ? 1.f : L);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      out[bh * D + lane * EPL + e] = from_f<TQ>(o[e] * inv);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* pos, void* out, int B, int H, int bs,
                   int nblk, float scale2, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_attn_kernel<TQ, TKV, D><<<grid, NW * 32, 0, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
      (const float*)vs, (const int*)tables, (const int*)pos, (TQ*)out, H,
      bs, nblk, scale2);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* tables,
                       const void* pos, void* out, int B, int H, int bs,
                       int nblk, float scale2, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, ks, vs, tables, pos, out, B, H,
                                 bs, nblk, scale2, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, ks, vs, tables, pos, out, B, H,
                                 bs, nblk, scale2, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, ks, vs, tables, pos, out, B, H,
                                  bs, nblk, scale2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int D, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* tables, const void* pos, void* out,
                        int B, int H, int bs, int nblk, float scale2,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return dispatch_d<TQ, float>(D, q, k, v, ks, vs, tables, pos, out, B,
                                   H, bs, nblk, scale2, stream);
    case 1:
      return dispatch_d<TQ, __nv_bfloat16>(D, q, k, v, ks, vs, tables, pos,
                                           out, B, H, bs, nblk, scale2,
                                           stream);
    case 2:
      return dispatch_d<TQ, int8_t>(D, q, k, v, ks, vs, tables, pos, out, B,
                                    H, bs, nblk, scale2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* pt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale/v_scale then float32 [N,H,bs], else
// null). All tensors contiguous. bs <= 64.
int pt_paged_attention(const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale,
                       const void* tables, const void* pos, void* out,
                       int q_dtype, int kv_dtype, int B, int H, int D,
                       int bs, int nblk, float scale, void* stream) {
  const float scale2 = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H == 0) return cudaSuccess;
  if (bs < 1 || bs > MAX_BS) return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, D, q, k, v, k_scale, v_scale,
                              tables, pos, out, B, H, bs, nblk, scale2, s);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, k_scale,
                                      v_scale, tables, pos, out, B, H, bs,
                                      nblk, scale2, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
