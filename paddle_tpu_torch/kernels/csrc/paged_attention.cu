// Paged decode attention for Hopper (sm_90a), plain C interface:
// split-KV ("flash-decoding") over Hopper's bulk copies.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
// `_pallas_paged_attention` (`_paged_kernel`): one query per row,
// q [B,H,1,D] (float32 or bfloat16), attends over that row's KV cache
// stored as blocks of a shared pool k/v [N,H,bs,D] (float32, bfloat16, or
// int8 with float32 scales [N,H,bs] per (block, head, slot)), routed
// through the row's block table tables[b, :] (int32). Key slot j is
// visible iff j <= pos[b]; blocks past pos[b] // bs are never read (the
// TPU kernel's dead-block skip, which also keeps the trash-block padding
// of the table out). int8 is widened and scaled in registers; all
// arithmetic is float32. A row with nothing visible (pos < 0) gives 0.
// The output is [B,H,1,D] in q's type.
//
// What bounds it on the H100: every live key and value is read once and
// used for two multiply-adds per element (~0.5 FLOP per float32 byte),
// so the kernel is bound by bytes: 2 * sum_b(pos_b + 1) * H * D * elem,
// plus 8 bytes of scales per live slot and head for int8, over
// 3.35 TB/s. Tensor cores and wgmma cannot help; the only lever is to
// keep HBM busy from every SM.
//
// What held the first design back (one 8-warp CTA per (b, h), each warp
// folding blocks w, w + 8, ... with per-lane loads of D/32 elements):
// 96 CTAs at B8 H12 left 36 of 132 SMs idle and each busy SM 8 of its 64
// warp slots; the longest row set the time, its warps walking 16 blocks
// each in about four dependent trips to HBM per block (K in two chunks,
// then the block max, then V in two chunks); loads were 2-8 bytes a lane,
// with a 5-step shuffle per token and one scale load per token and lane.
// At B1 only 12 CTAs ran.
//
// This design:
// - The split. Every row's table is cut into splits of `bps` consecutive
//   entries (the host's split plan: max(1, 256 // bs) blocks, a function
//   of the block index alone, so a row's result is bitwise the same in
//   any batch and for any table width). Grid = (splits, H, B), sized from
//   the table width; a CTA whose split starts past pos[b] exits at once,
//   so the host never reads pos (no synchronisation; the call can be
//   captured in a CUDA graph).
// - The ring. A split's live slots are walked in tiles (each thread folds
//   SLOTS = 4 slots of a tile: 8 KB of K and 8 KB of V for float32 and
//   bf16 pools, 4 KB each for int8): part of a block, or several blocks.
//   A (block, head) slice of a pool is contiguous, so each block's share
//   of a tile is one `cp.async.bulk` global->shared copy for K and one
//   for V, completing on the stage's `mbarrier` by their byte count; K
//   and V of a tile travel together. The int8 scales (4 bytes a slot,
//   so a slice is a whole 16-byte vector only when the block size is a
//   multiple of 4) move as 4-byte `cp.async` copies, one per slot, whose
//   completion each lane of the issuing warp signals to the same
//   barrier. Warp 0 issues the next tile's copies while the CTA folds
//   the current one. The ring has two stages: a CTA then takes at most
//   ~34 KB of shared memory (under the 48 KB a launch gets without
//   opting in), so six CTAs share an SM and keep ~100 KB in flight on
//   it; four stages (three CTAs an SM) measured slower at the decode
//   shape. The copies of the last live block stop at pos[b], so past the
//   live bytes nothing is read.
// - The fold. Each thread owns one vector of a token row (16 bytes; 8
//   for int8) and every (128 / vectors-per-row)-th slot of a tile: a
//   score is a dot product of vector shared-memory reads with q in
//   registers, reduced over the row's lanes only (not 32). Each group of
//   lanes folds its slots of a tile as the TPU kernel folds a block: the
//   max, one rescale, then p * v, in base 2 (q is prescaled by scale *
//   log2(e)). The groups' states merge in shared memory at the end of
//   the split.
// - The merge. A row with a single live split writes its output
//   directly. Otherwise each live split writes (m, l, acc[D]) in float32
//   to a workspace, and a second kernel merges a row's live splits in a
//   fixed order (no atomics: the result is the same run to run). It is
//   launched as a programmatic dependent of the split kernel, so it is
//   scheduled while the split grid drains and waits for it on the card.
//   Every workspace cell the merge reads was written by this launch, so
//   the workspace needs no clearing.
//
// Sizes the copies cannot take: a bulk copy moves a multiple of 16 bytes
// between 16-byte aligned addresses. A token row of K or V is D * elem >=
// 16 bytes and a multiple of 16 (D = 16, 32, 64, 128), so every pool
// (float32, bf16, int8) takes any block size; the pools must start on
// 16 bytes. At D = 16 a float32 row is 4 vectors and a bf16 or int8 row
// 2, so 32 or 64 token groups fold a tile (128 or 256 slots).
//
// What is left: a persistent grid (one CTA per SM walking many splits,
// so one split's merge hides the next one's first copies), clusters that
// share a row's table reads, fp8 pools (not in the JAX package).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;                 // threads per CTA
constexpr int STAGES = 2;               // tiles in the ring
constexpr int SLOTS = 4;                // slots a thread folds per tile
// table entries of a split: the host's split plan takes at most 256
// slots, so at most 256 blocks of one slot
constexpr int MAX_BPS = 256;
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

// one vector of a pool row (16 bytes; 8 for int8) -> its values
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint2& u, float* f, int8_t) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] = (float)((int32_t)(w[i] << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared bulk copy (no tensor map); completes on `bar` by its
// byte count. bytes % 16 == 0, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global -> shared copy of 4 bytes (both addresses 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued has landed
// (.noinc: the arrival counts against the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Shared-memory layout of the split kernel (dynamic): the ring of
// STAGES tiles (K, V, then for int8 the K and V scales), reused for the
// groups' states once the ring is drained; the STAGES barriers; the
// split's table entries.
template <typename TKV, int D>
struct Plan {
  static constexpr int E = sizeof(TKV);
  static constexpr bool QUANT = E == 1;
  // bytes a thread reads of a row: 16, but 8 for int8, whose 16 values
  // of q and of the sum would not leave the thread registers to spare
  static constexpr int VB = QUANT ? 8 : 16;
  using Vec = typename std::conditional<QUANT, uint2, uint4>::type;
  static constexpr int VE = VB / E;       // values per vector
  static constexpr int NV = D / VE;       // vectors per token row
  static constexpr int NG = NT / NV;      // token groups of a CTA
  static constexpr int TPT = SLOTS;       // slots per thread per tile
  static constexpr int TT = TPT * NG;     // slots per tile
  static constexpr int KV_BYTES = TT * D * E;
  static constexpr int STAGE = 2 * KV_BYTES + (QUANT ? 2 * TT * 4 : 0);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int MERGE = (NG * D + 2 * NG) * 4;
  static constexpr int BAR_OFF = (RING > MERGE ? RING : MERGE);
  static constexpr int TAB_OFF = BAR_OFF + STAGES * 8;
  static_assert(NV >= 1 && NV <= 32 && 32 % NV == 0, "row vectors");
  static_assert(STAGE % 16 == 0, "stage alignment");
  static_assert(TAB_OFF + 4 * MAX_BPS <= 48 * 1024,
                "the plan fits the default dynamic shared memory cap");
  // arrivals a stage's barrier expects per tile: the expect_tx of the
  // bulk copies, and for int8 one per lane of the issuing warp (its
  // scale copies)
  static constexpr int ARRIVALS = QUANT ? 33 : 1;
  static size_t smem_bytes(int bps) { return TAB_OFF + 4 * (size_t)bps; }
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, TQ* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int H, int bs, int nblk,
                       int bps, int nsplit, float scale2) {
  using P = Plan<TKV, D>;
  constexpr int E = P::E, VE = P::VE, NV = P::NV, NG = P::NG, TT = P::TT;
  constexpr int TPT = P::TPT, KV_BYTES = P::KV_BYTES, STAGE = P::STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  int* tab_s = reinterpret_cast<int*>(smem + P::TAB_OFF);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = split * bps;
  // pos and the split's table entries load together (j0 < nblk)
  const int p = pos[b];
  const int* tab = tables + (long long)b * nblk;
  for (int i = tid; i < min(bps, nblk - j0); i += NT) tab_s[i] = tab[j0 + i];
  const int last = p < 0 ? -1 : min(p / bs, nblk - 1);
  if (j0 > last) return;                    // a dead split
  // the merge grid may be scheduled now (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int j1 = min(j0 + bps, last + 1);   // live blocks [j0, j1)
  const int t_begin = j0 * bs;
  const int t_end = min(p + 1, j1 * bs);    // live slots [t_begin, t_end)
  const int ntiles = (t_end - t_begin + TT - 1) / TT;
  const int g = tid / NV, c = tid % NV;     // token group, row vector
  const long long bh = (long long)b * H + h;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], P::ARRIVALS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0: tile i's copies into stage i % STAGES
  auto issue = [&](int i) {
    const int st = i % STAGES;
    unsigned char* sb = smem + st * STAGE;
    const int a = t_begin + i * TT;
    const int e = min(a + TT, t_end);
    if (lane == 0)
      mbar_arrive_expect_tx(&full[st], (uint32_t)(e - a) * 2 * D * E);
    __syncwarp();
    for (int j = a / bs + lane; j <= (e - 1) / bs; j += 32) {
      const int s0 = max(a, j * bs), s1 = min(e, (j + 1) * bs);
      const long long slot =
          ((long long)tab_s[j - j0] * H + h) * bs + (s0 - j * bs);
      const uint32_t n = s1 - s0;
      const int off = s0 - a;
      bulk_g2s(sb + off * D * E, kp + slot * D, n * D * E, &full[st]);
      bulk_g2s(sb + KV_BYTES + off * D * E, vp + slot * D, n * D * E,
               &full[st]);
    }
    if (P::QUANT) {
      for (int t = a + lane; t < e; t += 32) {
        const int j = t / bs;
        const long long slot =
            ((long long)tab_s[j - j0] * H + h) * bs + (t - j * bs);
        cp_async4(sb + 2 * KV_BYTES + (t - a) * 4, ksc + slot);
        cp_async4(sb + 2 * KV_BYTES + TT * 4 + (t - a) * 4, vsc + slot);
      }
      cp_async_arrive(&full[st]);
    }
  };
  if (warp == 0)
    for (int i = 0; i < STAGES - 1 && i < ntiles; ++i) issue(i);

  float qf[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) qf[e] = to_f(q[bh * D + c * VE + e]) * scale2;
  float m = NEG_BIG, l = 0.f, acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    // stage (i - 1) % STAGES was freed by the barrier ending tile i - 1
    if (warp == 0 && i + STAGES - 1 < ntiles) issue(i + STAGES - 1);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    const unsigned char* sb = smem + (i % STAGES) * STAGE;
    const float* ks_s = reinterpret_cast<const float*>(sb + 2 * KV_BYTES);
    const float* vs_s = ks_s + TT;
    const int n = min(TT, t_end - t_begin - i * TT);   // live slots
    float s[TPT], mt = m;
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int t = g + u * NG;
      const typename P::Vec kv = *reinterpret_cast<const typename P::Vec*>(
          sb + t * D * E + c * P::VB);
      float kf[VE];
      unpack(kv, kf, TKV());
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VE; ++e) part = fmaf(qf[e], kf[e], part);
#pragma unroll
      for (int o = NV / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (P::QUANT) part *= ks_s[t];
      s[u] = part;
      if (t < n) mt = fmaxf(mt, part);
    }
    const float corr = exp2f(m - mt);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int t = g + u * NG;
      if (t < n) {
        const float pr = exp2f(s[u] - mt);
        l += pr;
        const float pv = P::QUANT ? pr * vs_s[t] : pr;
        const typename P::Vec vv = *reinterpret_cast<
            const typename P::Vec*>(sb + KV_BYTES + t * D * E + c * P::VB);
        float vf[VE];
        unpack(vv, vf, TKV());
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
      }
    }
    m = mt;
    __syncthreads();
  }

  // the groups' states -> the split's (m, l, acc); the ring is drained
  float* gacc = reinterpret_cast<float*>(smem);   // [NG][D]
  float* gm = gacc + NG * D;
  float* gl = gm + NG;
#pragma unroll
  for (int e = 0; e < VE; ++e) gacc[g * D + c * VE + e] = acc[e];
  if (c == 0) {
    gm[g] = m;
    gl[g] = l;
  }
  __syncthreads();
  if (tid < D) {
    float M = NEG_BIG;
#pragma unroll 8
    for (int k = 0; k < NG; ++k) M = fmaxf(M, gm[k]);
    float L = 0.f, o = 0.f;
#pragma unroll 8
    for (int k = 0; k < NG; ++k) {
      const float f = exp2f(gm[k] - M);
      L = fmaf(gl[k], f, L);
      o = fmaf(gacc[k * D + tid], f, o);
    }
    if (last < bps) {           // the row's only live split
      out[bh * D + tid] = from_f<TQ>(o / L);
    } else {
      const long long cell = bh * nsplit + split;
      part_acc[cell * D + tid] = o;
      if (tid == 0) {
        part_ml[2 * cell] = M;
        part_ml[2 * cell + 1] = L;
      }
    }
  }
}

// merges a row's live splits in a fixed order: thread (d, y) folds
// splits y, y + MSG, ... in turn, then the MSG partial sums add up in y
// order. Rows with one live split were written by the split kernel, rows
// with none get 0.
constexpr int MSG = 8;

template <typename TQ>
__global__ void __launch_bounds__(128 * MSG)
    paged_merge_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml,
                       const int* __restrict__ pos, TQ* __restrict__ out,
                       int H, int D, int bs, int nblk, int bps, int nsplit) {
  __shared__ float red_m[MSG], red_l[MSG], red_o[MSG][128];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, y = threadIdx.y;
  const int p = pos[b];
  const int last = p < 0 ? -1 : min(p / bs, nblk - 1);
  const int nlive = last < 0 ? 0 : last / bps + 1;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (nlive == 1) return;
  const long long bh = (long long)b * H + h;
  float o = 0.f;
  if (nlive > 1) {
    const float* ml = part_ml + bh * nsplit * 2;
    const float* acc = part_acc + bh * nsplit * D + d;
    float M = NEG_BIG;
#pragma unroll 4
    for (int s = y; s < nlive; s += MSG) M = fmaxf(M, ml[2 * s]);
    if (d == 0) red_m[y] = M;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MSG; ++k) M = fmaxf(M, red_m[k]);
    float L = 0.f;
#pragma unroll 4
    for (int s = y; s < nlive; s += MSG) {
      const float f = exp2f(ml[2 * s] - M);
      L = fmaf(ml[2 * s + 1], f, L);
      o = fmaf(acc[(long long)s * D], f, o);
    }
    red_o[y][d] = o;
    if (d == 0) red_l[y] = L;
    __syncthreads();
    if (y != 0) return;
    o = L = 0.f;
#pragma unroll
    for (int k = 0; k < MSG; ++k) {
      o += red_o[k][d];
      L += red_l[k];
    }
    o /= L;
  } else if (y != 0) {
    return;
  }
  out[bh * D + d] = from_f<TQ>(o);
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *pos;
  void *out, *part;
  int B, H, D, bs, nblk, bps, nsplit;
  float scale2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  using P = Plan<TKV, D>;
  float* part_acc = static_cast<float*>(a.part);
  float* part_ml = part_acc == nullptr
                       ? nullptr
                       : part_acc + (size_t)a.B * a.H * a.nsplit * D;
  if (a.nsplit > 0) {
    const size_t smem = P::smem_bytes(a.bps);
    dim3 grid(a.nsplit, a.H, a.B);
    paged_split_kernel<TQ, TKV, D><<<grid, NT, smem, a.stream>>>(
        (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v,
        (const float*)a.ks, (const float*)a.vs, (const int*)a.tables,
        (const int*)a.pos, (TQ*)a.out, part_acc, part_ml, a.H, a.bs, a.nblk,
        a.bps, a.nsplit, a.scale2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3(D, MSG);
  cfg.stream = a.stream;
  // programmatic dependent launch: the merge grid is scheduled while the
  // split grid drains and waits for its results in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<TQ>,
                            (const float*)part_acc, (const float*)part_ml,
                            (const int*)a.pos, (TQ*)a.out, a.H, D, a.bs,
                            a.nblk, a.bps, a.nsplit);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const Args& a) {
  switch (a.D) {
    case 16:
      return launch<TQ, TKV, 16>(a);
    case 32:
      return launch<TQ, TKV, 32>(a);
    case 64:
      return launch<TQ, TKV, 64>(a);
    case 128:
      return launch<TQ, TKV, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0:
      return dispatch_d<TQ, float>(a);
    case 1:
      return dispatch_d<TQ, __nv_bfloat16>(a);
    case 2:
      return dispatch_d<TQ, int8_t>(a);
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
// null). All tensors contiguous, pools 16-byte aligned. bps <= 256
// table entries per split and nsplit =
// ceil(nblk / bps) splits come from the host's split plan; part is a
// float32 workspace of B * H * nsplit * (D + 2) values (null when
// nsplit <= 1).
int pt_paged_attention(const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale,
                       const void* tables, const void* pos, void* out,
                       void* part, int q_dtype, int kv_dtype, int B, int H,
                       int D, int bs, int nblk, int bps, int nsplit,
                       float scale, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (bs < 1 || bps < 1 || bps > MAX_BPS || nblk < 0 || (long long)nsplit * bps < nblk ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, tables, pos, out, part,
               B, H, D, bs, nblk, bps, nsplit, scale * LOG2E,
               (cudaStream_t)stream};
  if (q_dtype == 0) return dispatch_kv<float>(kv_dtype, a);
  if (q_dtype == 1) return dispatch_kv<__nv_bfloat16>(kv_dtype, a);
  return cudaErrorInvalidValue;
}

}  // extern "C"
