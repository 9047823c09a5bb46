// The backward of dense softmax attention (flash_attention.cu) for Hopper
// (sm_90a): given q [B, Sq, H, hd], k/v [B, Sk, Hkv, hd], the forward's
// output o and row log-sum-exp lse [B, H, Sq] (f32, natural log, scaled
// scores), and the output's gradient dout, it writes dq, dk and dv in the
// I/O dtype, f32 inside. The mask is the forward's: causal (query i sees
// keys j <= i + q_offset, top-left aligned at q_offset 0) or none, any Sq
// and Sk, GQA by h // (H / Hkv). A context-parallel rank passes the offset
// of its first query row, as to the forward.
//
// The reference has no backward kernel: it differentiates its jnp
// blockwise attention (repro/models/layers.py::blockwise_attention) with
// JAX autodiff, saving nothing of size S^2. This is FlashAttention-2's
// backward, which saves nothing of that size either:
//
// 1. delta_kernel: D_i = rowsum(dO_i * O_i) (f32, [B, H, Sq]);
// 2. dkdv_*: one block per (key tile, kv head, sequence) walks the query
//    tiles of every query head that reads the kv head (from the first row
//    that sees the key tile, when causal), recomputes P = exp(S * scale -
//    lse) and dS = P * (dO V^T - D), and accumulates dV += P^T dO and
//    dK += dS^T Q (times scale at the end);
// 3. dq_*: one block per (query tile, head, sequence) walks the key tiles
//    it can see and accumulates dQ += dS K (times scale).
//
// Every output element is summed by one block in a fixed order, with no
// atomics, so two runs give the same bits.
//
// Bound on the H100: the five products, 10 * hd flops per visible (query,
// key) pair and head (this design does seven: S and dP = dO V^T are
// recomputed in the second pass); the bytes of q, k, v, o, dout, lse and
// the three gradients are small beside them at training lengths. Two
// variants by (dtype, hd), the forward's rule:
//
// * wgmma (bf16, hd 64 or 128): both passes on the forward's Hopper
//   building blocks (hopper.cuh): TMA tensor maps over [B, S, heads * hd]
//   with 64-column, 128-byte-swizzled boxes, an mbarrier ring of 2 stages,
//   and two warpgroups of 64 rows running m64n64k16 wgmma, bf16 in and f32
//   accumulators in registers. Every product reads its shared-memory tiles
//   as loaded: a box read along its rows is a K-major operand, down its
//   columns an MN-major one, and an accumulator packed to bf16 pairs is
//   the register A operand of the next product, so nothing is transposed
//   or staged through shared memory.
//   - dkdv_wgmma: a block holds 128 keys of K and V (64 per warpgroup) and
//     streams the 64-row Q and dO tiles of the g query heads, with their
//     lse and D, through the ring. Each warpgroup computes S^T = K Q^T and
//     dP^T = V dO^T (both K-major), P^T = exp2(S^T scale log2 e - lse
//     log2 e) and dS^T = P^T o (dP^T - D) in registers (lse and D by
//     column), then dV += P^T dO and dK += dS^T Q from registers (dO and Q
//     MN-major). dK and dV stay in registers over the whole walk and are
//     stored once. Registers bound this pass: at hd 128 a thread holds dK
//     and dV (128 f32) beside S^T and dP^T (64). So the block has no
//     producer: its 256 threads may hold 255 registers each (ptxas gives
//     the consumers 240 at hd 128 and keeps nothing in local memory), and
//     warp 0 issues the ring's loads itself, one stage ahead: the Q and dO
//     boxes by TMA and the tile's lse and D by cp.async, all completing on
//     the stage's barrier. (A producer warpgroup handing its registers to
//     the consumers with setmaxnreg, 24 / 240, left ptxas short at hd 128:
//     it spilled and issued the wgmma one at a time.)
//   - dq_wgmma: the forward's tile loop (attend_wgmma.cuh) with its
//     producer warp: a block holds 128 query rows of Q and dO and streams
//     64-key K / V tiles; S = Q K^T, dP = dO V^T, dS in registers, dQ +=
//     dS K (K MN-major).
//   Causal: whole tiles that no row sees are skipped, only the tiles the
//   diagonal cuts and the ragged tiles are masked, and the heaviest blocks
//   go first. With a q_offset that is not a multiple of 64 the diagonal
//   cuts two query tiles of a warpgroup's keys in dkdv (and two key tiles
//   of its rows in dq); each is masked element by element. A
//   query row past Sq arrives as zeros (its Q, dO, lse and D), so in dkdv
//   its dS and its share of P^T dO are 0, and dq does not store it; a key
//   past Sk is masked in dq and only reaches dK / dV rows that are not
//   stored. P^T and dS^T (dS) are rounded to bf16 for their products, as
//   the forward rounds P for P V.
// * simt (f32, other widths): 32-row tiles staged as f32 and CUDA-core
//   FMAs, so f32 gradients stay exact for the f32 models and checks.
//
// Not done: one fused pass whose dQ goes through atomics (FlashAttention-3)
// is not deterministic; an ordered f32 reduction of dQ across key blocks
// (a semaphore per query tile) would save the recomputation, later.
#include "hopper.cuh"
#include "paged_common.cuh"  // to_float, store, allow_smem

namespace repro_flash_bwd {

using repro_paged::allow_smem;
using repro_paged::store;
using repro_paged::to_float;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, causal, q_offset;
  float scale;
};

// ------------------------------------------------------------------ delta
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Dims d) {
  // one warp per (b, i, h) row of o; delta is [B, H, Sq]
  const int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)d.B * d.Sq * d.H) return;
  const T* op = o + row * d.hd;
  const T* gp = dout + row * d.hd;
  float s = 0.f;
  for (int c = lane; c < d.hd; c += 32)
    s = fmaf(to_float(op[c]), to_float(gp[c]), s);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % d.H);
    const int64_t bi = row / d.H;
    delta[((bi / d.Sq) * d.H + h) * d.Sq + bi % d.Sq] = s;
  }
}

// visible(i, j): key j of query i under the forward's mask, both in range
__device__ __forceinline__ bool visible(const Dims& d, int i, int j) {
  return i < d.Sq && j < d.Sk && (!d.causal || j <= i + d.q_offset);
}

// ------------------------------------------------------------------- simt
constexpr int kSt = 32;   // query and key rows per tile
constexpr int kSld = 33;  // row stride of the [32][32] score tiles

// Stages `n` of 32 rows of a [.., rows, heads, hd] tensor (row stride
// `stride` elements) as f32 rows of hd + 1 words; rows past n are zeros.
template <typename T>
__device__ void stage_rows(float* dst, const T* __restrict__ src,
                           int64_t stride, int n, int hd) {
  for (int i = threadIdx.x; i < kSt * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dst[r * (hd + 1) + c] = r < n ? to_float(src[r * stride + c]) : 0.f;
  }
}

// P (into p) and dS (into ds) for the [32][32] tile of query rows q0.. and
// keys k0..: the two products are recomputed from the staged rows.
__device__ void simt_scores(const Dims& d, const float* Qs, const float* dOs,
                            const float* Ks, const float* Vs,
                            const float* sl, const float* sd, int q0, int k0,
                            float* p, float* ds) {
  const int ld = d.hd + 1;
  for (int e = threadIdx.x; e < kSt * kSt; e += kThreads) {
    const int r = e / kSt, c = e % kSt;
    float s = 0.f, dp = 0.f;
    for (int x = 0; x < d.hd; ++x) {
      s = fmaf(Qs[r * ld + x], Ks[c * ld + x], s);
      dp = fmaf(dOs[r * ld + x], Vs[c * ld + x], dp);
    }
    const float pv =
        visible(d, q0 + r, k0 + c) ? expf(s * d.scale - sl[r]) : 0.f;
    if (p != nullptr) p[r * kSld + c] = pv;
    ds[r * kSld + c] = pv * (dp - sd[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_simt(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, Dims d) {
  extern __shared__ float sm[];
  const int hd = d.hd, ld = hd + 1, g = d.H / d.Hkv;
  float *Ks = sm, *Vs = Ks + kSt * ld, *Qs = Vs + kSt * ld,
        *dOs = Qs + kSt * ld, *P = dOs + kSt * ld, *dS = P + kSt * kSld,
        *dK = dS + kSt * kSld, *dV = dK + kSt * hd, *sl = dV + kSt * hd,
        *sd = sl + kSt;
  const int k0 = blockIdx.x * kSt, kvh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kSt, d.Sk - k0);
  const int64_t kstride = (int64_t)d.Hkv * hd, qstride = (int64_t)d.H * hd;
  const int64_t koff = (((int64_t)b * d.Sk + k0) * d.Hkv + kvh) * hd;
  stage_rows(Ks, k + koff, kstride, nk, hd);
  stage_rows(Vs, v + koff, kstride, nk, hd);
  for (int i = threadIdx.x; i < kSt * hd; i += kThreads) dK[i] = dV[i] = 0.f;
  // the first query row that sees key k0
  const int q_first = d.causal ? max(0, k0 - d.q_offset) : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int q0 = q_first; q0 < d.Sq; q0 += kSt) {
      const int nq = min(kSt, d.Sq - q0);
      __syncthreads();  // the last tile's readers are done
      const int64_t qoff = (((int64_t)b * d.Sq + q0) * d.H + h) * hd;
      stage_rows(Qs, q + qoff, qstride, nq, hd);
      stage_rows(dOs, dout + qoff, qstride, nq, hd);
      if (threadIdx.x < kSt) {
        const int r = threadIdx.x;
        const int64_t at = ((int64_t)b * d.H + h) * d.Sq + q0 + r;
        sl[r] = r < nq ? lse[at] : 0.f;
        sd[r] = r < nq ? delta[at] : 0.f;
      }
      __syncthreads();
      simt_scores(d, Qs, dOs, Ks, Vs, sl, sd, q0, k0, P, dS);
      __syncthreads();
      for (int e = threadIdx.x; e < kSt * hd; e += kThreads) {
        const int c = e / hd, x = e - c * hd;
        float av = dV[e], ak = dK[e];
        for (int r = 0; r < kSt; ++r) {
          av = fmaf(P[r * kSld + c], dOs[r * ld + x], av);
          ak = fmaf(dS[r * kSld + c], Qs[r * ld + x], ak);
        }
        dV[e] = av;
        dK[e] = ak;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nk * hd; e += kThreads) {
    const int c = e / hd, x = e - c * hd;
    store(dk + koff + c * kstride + x, dK[e] * d.scale);
    store(dv + koff + c * kstride + x, dV[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_simt(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, Dims d) {
  extern __shared__ float sm[];
  const int hd = d.hd, ld = hd + 1;
  float *Qs = sm, *dOs = Qs + kSt * ld, *Ks = dOs + kSt * ld,
        *Vs = Ks + kSt * ld, *dS = Vs + kSt * ld, *dQ = dS + kSt * kSld,
        *sl = dQ + kSt * hd, *sd = sl + kSt;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSt;  // most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (d.H / d.Hkv);
  const int nq = min(kSt, d.Sq - q0);
  const int64_t kstride = (int64_t)d.Hkv * hd, qstride = (int64_t)d.H * hd;
  const int64_t qoff = (((int64_t)b * d.Sq + q0) * d.H + h) * hd;
  stage_rows(Qs, q + qoff, qstride, nq, hd);
  stage_rows(dOs, dout + qoff, qstride, nq, hd);
  for (int i = threadIdx.x; i < kSt * hd; i += kThreads) dQ[i] = 0.f;
  if (threadIdx.x < kSt) {
    const int r = threadIdx.x;
    const int64_t at = ((int64_t)b * d.H + h) * d.Sq + q0 + r;
    sl[r] = r < nq ? lse[at] : 0.f;
    sd[r] = r < nq ? delta[at] : 0.f;
  }
  // keys up to the last row's position (plus the offset) when causal
  const int k_end = d.causal ? min(q0 + nq + d.q_offset, d.Sk) : d.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kSt) {
    const int nk = min(kSt, d.Sk - k0);
    __syncthreads();
    const int64_t koff = (((int64_t)b * d.Sk + k0) * d.Hkv + kvh) * hd;
    stage_rows(Ks, k + koff, kstride, nk, hd);
    stage_rows(Vs, v + koff, kstride, nk, hd);
    __syncthreads();
    simt_scores(d, Qs, dOs, Ks, Vs, sl, sd, q0, k0, nullptr, dS);
    __syncthreads();
    for (int e = threadIdx.x; e < kSt * hd; e += kThreads) {
      const int r = e / hd, x = e - r * hd;
      float a = dQ[e];
      for (int c = 0; c < kSt; ++c)
        a = fmaf(dS[r * kSld + c], Ks[c * ld + x], a);
      dQ[e] = a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * hd; e += kThreads) {
    const int r = e / hd, x = e - r * hd;
    store(dq + qoff + r * qstride + x, dQ[e] * d.scale);
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, const Dims& d,
                cudaStream_t st) {
  const size_t ld = d.hd + 1;
  const size_t smem_kv = 4 * (4 * kSt * ld + 2 * kSt * kSld +
                              2 * (size_t)kSt * d.hd + 2 * kSt);
  const size_t smem_q = 4 * (4 * kSt * ld + kSt * kSld +
                             (size_t)kSt * d.hd + 2 * kSt);
  cudaError_t err = allow_smem(dkdv_simt<T>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq_simt<T>, smem_q);
  if (err != cudaSuccess) return (int)err;
  dkdv_simt<T><<<dim3((d.Sk + kSt - 1) / kSt, d.Hkv, d.B), kThreads, smem_kv,
                 st>>>((const T*)q, (const T*)k, (const T*)v,
                       (const T*)dout, lse, delta, (T*)dk, (T*)dv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_simt<T><<<dim3((d.Sq + kSt - 1) / kSt, d.H, d.B), kThreads, smem_q,
               st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                     lse, delta, (T*)dq, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ wgmma
using bf16 = __nv_bfloat16;
using namespace repro_hopper;

constexpr int kTile = 64;         // rows of a streamed tile and of a warpgroup
constexpr int kStages = 2;        // ring depth of both passes
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kQThreads = kConsumers + 32;    // dq: + a producer warp
constexpr float kLog2e = 1.4426950408889634f;

// A float2 of shared memory, read where it stands: the compiler may not
// hoist it across the wgmma asm around it and keep it live there.
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(smem_u32(p)));
  return v;
}

// Four bytes from global to shared memory with cp.async, the first n of
// them read (n = 0: zeros).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's pending count is raised first, so its count at init need
// not include it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// dkdv's shared memory: the block's 128 keys of K and of V (one [128][64]
// box per 64 columns), then per ring stage a [64][hd] Q tile and a dO tile
// (one [64][64] box per 64 columns), then per stage the tile's 64 lse and
// 64 D, then the barriers.
template <int HD>
struct DkdvLayout {
  static constexpr int kHalves = HD / 64;
  static constexpr int kKvBytes = 2 * kTile * HD * 2;   // K (or V)
  static constexpr int kRowBytes = kTile * HD * 2;      // a Q (or dO) tile
  static constexpr int kStageBytes = 2 * kRowBytes;     // Q, then dO
  static constexpr int kBars = 2 * kStages + 1;         // full, empty, kv
  static constexpr size_t kSmem = 1024 /* alignment slack */ +
                                  2 * kKvBytes + kStages * kStageBytes +
                                  kStages * 2 * kTile * 4 + 8 * kBars;
};

// dq's: the block's 128 rows of Q and of dO ([128][64] boxes), then per
// ring stage a [64][hd] K tile and a V tile, then the barriers.
template <int HD>
struct DqLayout {
  static constexpr int kHalves = HD / 64;
  static constexpr int kRowsBytes = 2 * kTile * HD * 2;  // Q (or dO)
  static constexpr int kTileBytes = kTile * HD * 2;      // a K (or V) tile
  static constexpr int kBars = 2 * kStages + 1;          // full, empty, q
  static constexpr size_t kSmem = 1024 + 2 * kRowsBytes +
                                  2 * kStages * kTileBytes + 8 * kBars;
};

// Issues ring tile tt of dkdv's walk into stage tt % kStages, by one warp
// of the consumers: once both warpgroups have released the stage, each lane
// copies two rows' lse and D with cp.async (rows past Sq zero-filled; their
// Q and dO arrive as zeros, so P (dP - D) and P^T dO vanish there), the
// copies completing on the stage's full barrier, then lane 0 adds the TMA
// boxes of the tile's Q and dO.
template <int HD>
__device__ __forceinline__ void dkdv_issue(
    int tt, const CUtensorMap* tq, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Dims& d, uint32_t sring, uint32_t srow, uint32_t full0,
    uint32_t empty0, int b, int kvh, int g, int q_first, int n_qt, int lane) {
  using L = DkdvLayout<HD>;
  const int s = tt % kStages;
  const int h = kvh * g + tt / n_qt;
  const int q0 = q_first + (tt % n_qt) * kTile;
  mbar_wait(empty0 + 8 * s, ((tt / kStages) & 1) ^ 1);
  const float* lrow = lse + ((int64_t)b * d.H + h) * d.Sq;
  const float* drow = delta + ((int64_t)b * d.H + h) * d.Sq;
  const uint32_t sl = srow + s * 2 * kTile * 4;
#pragma unroll
  for (int r = lane; r < kTile; r += 32) {
    const int row = min(q0 + r, d.Sq - 1);
    const int n = q0 + r < d.Sq ? 4 : 0;
    cp_async4(sl + 4 * r, lrow + row, n);
    cp_async4(sl + 4 * (kTile + r), drow + row, n);
  }
  cp_async_arrive(full0 + 8 * s);
  __syncwarp();  // every lane's copies are on the barrier before it can flip
  if (lane == 0) {
    mbar_expect_tx(full0 + 8 * s, L::kStageBytes);
    const uint32_t qd = sring + s * L::kStageBytes;
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c) {
      tma_load(qd + c * kBoxBytes, tq, full0 + 8 * s, h * HD + c * 64, q0, b);
      tma_load(qd + L::kRowBytes + c * kBoxBytes, tdo, full0 + 8 * s,
               h * HD + c * 64, q0, b);
    }
  }
}

// Pass 1: one block per (128-key tile, kv head, sequence), the key tiles
// with the most queries first; two warpgroups and no producer, so that
// every thread may hold 255 registers. tq/tdo map q/dout as [B, Sq, H * hd],
// tk/tv k/v as [B, Sk, Hkv * hd], every box 64 rows.
template <int HD>
__global__ void __launch_bounds__(kConsumers, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Dims d) {
  using L = DkdvLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sk = smem_u32(base), sv = sk + L::kKvBytes;
  const uint32_t sring = sv + L::kKvBytes;
  // stage s: lse at [128 s], D at [128 s + 64]
  float* srow = reinterpret_cast<float*>(base + 2 * L::kKvBytes +
                                         kStages * L::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(srow + kStages * 2 * kTile);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const uint32_t kvbar = full0 + 16 * kStages;

  const int nbh = d.B * d.Hkv, g = d.H / d.Hkv;
  const int k0 = (blockIdx.x / nbh) * 2 * kTile;
  const int b = (blockIdx.x % nbh) / d.Hkv, kvh = blockIdx.x % d.Hkv;
  // query tiles from the first row that sees key k0, for each of the g
  // query heads that read kv head kvh
  const int q_first = d.causal ? max(0, k0 - d.q_offset) : 0;
  const int n_qt = d.Sq > q_first ? (d.Sq - q_first + kTile - 1) / kTile : 0;
  const int n_t = g * n_qt;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // lane 0's arrival, its bytes, copies
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one per warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // warpgroup wg owns keys kw .. kw + 63; warp 0 also issues the loads
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int rl = 16 * (t128 / 32) + lane / 4;  // the thread's keys: rl, rl + 8
  const int col0 = 2 * (lane % 4);
  const int kw = k0 + kTile * wg;
  const uint32_t ka = sk + kTile * wg * kSwzRow;
  const uint32_t va = sv + kTile * wg * kSwzRow;
  const uint32_t srow_a = smem_u32(srow);
  const float scale_log2 = d.scale * kLog2e;

  if (warp == 0 && n_t > 0) {
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::kKvBytes);
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t off = c * 2 * kBoxBytes + half * kBoxBytes;
          tma_load(sk + off, &tk, kvbar, kvh * HD + c * 64,
                   k0 + half * kTile, b);
          tma_load(sv + off, &tv, kvbar, kvh * HD + c * 64,
                   k0 + half * kTile, b);
        }
    }
    for (int tt = 0; tt < kStages - 1 && tt < n_t; ++tt)
      dkdv_issue<HD>(tt, &tq, &tdo, lse, delta, d, sring, srow_a, full0,
                     empty0, b, kvh, g, q_first, n_qt, lane);
  }

  float acc_k[L::kHalves][32], acc_v[L::kHalves][32];
#pragma unroll
  for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  if (n_t > 0) mbar_wait(kvbar, 0);
  for (int t = 0; t < n_t; ++t) {
    // the tile kStages - 1 ahead goes into the stage tile t - 1 used
    if (warp == 0 && t + kStages - 1 < n_t)
      dkdv_issue<HD>(t + kStages - 1, &tq, &tdo, lse, delta, d, sring,
                     srow_a, full0, empty0, b, kvh, g, q_first, n_qt, lane);
    const int s = t % kStages;
    const int q0 = q_first + (t % n_qt) * kTile;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    // causal: a query tile that sees none of this warpgroup's keys adds
    // nothing
    if (!d.causal || q0 + kTile + d.q_offset > kw) {
      const uint32_t qd = sring + s * L::kStageBytes;
      const uint32_t dod = qd + L::kRowBytes;
      const float* sl = srow + s * 2 * kTile;
      // S^T = K Q^T and dP^T = V dO^T, keys down the rows, queries across
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      pin(st);
      pin(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the row
        wgmma_ss(st, sw128_desc(ka + (kk / 4) * 2 * kTile * kSwzRow + off),
                 sw128_desc(qd + (kk / 4) * kTile * kSwzRow + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dpt, sw128_desc(va + (kk / 4) * 2 * kTile * kSwzRow + off),
                 sw128_desc(dod + (kk / 4) * kTile * kSwzRow + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T may still be running
      pin(st);
      // P^T = exp2(S^T scale log2 e - lse log2 e), in place. Register e
      // holds key rl + 8 ((e >> 1) & 1) and query 8 (e >> 2) + col0 +
      // (e & 1) of the tile; on a tile the causal diagonal cuts (its last
      // key past its first query's, kw + 63 > q0 + q_offset) a key past
      // the query's is masked: at q_offset 0 the one tile q0 == kw. Keys
      // past Sk (zeros from TMA) only reach dK and dV rows that are never
      // stored.
      const int shift = q0 + d.q_offset - kw;  // key less query, at the edge
      const bool diag = d.causal && shift < kTile - 1;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float2 l = lds2(sl + 8 * (e >> 2) + col0);
        const float p =
            exp2f(st[e] * scale_log2 - ((e & 1) ? l.y : l.x) * kLog2e);
        st[e] = diag && rl + 8 * ((e >> 1) & 1) >
                            shift + 8 * (e >> 2) + col0 + (e & 1)
                    ? 0.f
                    : p;
      }
      wgmma_wait<0>();
      pin(dpt);
      // P^T and dS^T = P^T o (dP^T - D) (D by column), packed to bf16 A
      // fragments in one sweep, so S^T and dP^T die as they are read
      uint32_t pa[16], dsa[16];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 dd = lds2(sl + kTile + 8 * (e >> 2) + col0);
        pa[e / 2] = pack_bf16(st[e], st[e + 1]);
        dsa[e / 2] = pack_bf16(st[e] * (dpt[e] - dd.x),
                               st[e + 1] * (dpt[e + 1] - dd.y));
      }
      // dV += P^T dO and dK += dS^T Q, dO and Q as MN-major B
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) {
        pin(acc_v[c]);
        pin(acc_k[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j)
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c) {
          wgmma_rs(acc_v[c], pa + 4 * j,
                   sw128_desc(dod + c * kTile * kSwzRow + j * 16 * kSwzRow));
          wgmma_rs(acc_k[c], dsa + 4 * j,
                   sw128_desc(qd + c * kTile * kSwzRow + j * 16 * kSwzRow));
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) {
        pin(acc_v[c]);
        pin(acc_k[c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // dK (times scale) and dV, rows past Sk not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + rl + 8 * i;
    if (key >= d.Sk) continue;
    const int64_t off = (((int64_t)b * d.Sk + key) * d.Hkv + kvh) * HD;
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int e = 4 * nb + 2 * i, x = c * 64 + 8 * nb + col0;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + x) =
            __floats2bfloat162_rn(acc_k[c][e] * d.scale,
                                  acc_k[c][e + 1] * d.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + x) =
            __floats2bfloat162_rn(acc_v[c][e], acc_v[c][e + 1]);
      }
  }
}

// Pass 2: one block per (128-query tile, head, sequence), the tiles with
// the most keys (the last, when causal) first.
template <int HD>
__global__ void __launch_bounds__(kQThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, Dims d) {
  using L = DqLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_u32(base), sdo = sq + L::kRowsBytes;
  const uint32_t sring = sdo + L::kRowsBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + 2 * L::kRowsBytes + 2 * kStages * L::kTileBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;

  const int nqt = (d.Sq + 2 * kTile - 1) / (2 * kTile);
  const int bh = blockIdx.x % (d.B * d.H);
  const int q0 = (nqt - 1 - blockIdx.x / (d.B * d.H)) * 2 * kTile;
  const int b = bh / d.H, h = bh % d.H, kvh = h / (d.H / d.Hkv);
  const int n_kt =
      ((d.causal ? min(q0 + 2 * kTile + d.q_offset, d.Sk) : d.Sk) + kTile -
       1) / kTile;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ---- producer: one thread
    if (lane != 0) return;
    mbar_expect_tx(qbar, 2 * L::kRowsBytes);
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t off = c * 2 * kBoxBytes + half * kBoxBytes;
        tma_load(sq + off, &tq, qbar, h * HD + c * 64, q0 + half * kTile, b);
        tma_load(sdo + off, &tdo, qbar, h * HD + c * 64, q0 + half * kTile,
                 b);
      }
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
      const uint32_t kd = sring + 2 * s * L::kTileBytes;
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) {
        tma_load(kd + c * kBoxBytes, &tk, full0 + 8 * s, kvh * HD + c * 64,
                 t * kTile, b);
        tma_load(kd + L::kTileBytes + c * kBoxBytes, &tv, full0 + 8 * s,
                 kvh * HD + c * 64, t * kTile, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows qw .. qw + 63
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int rl = 16 * (t128 / 32) + lane / 4;  // the thread's rows rl, rl + 8
  const int col0 = 2 * (lane % 4);
  const int qw = q0 + kTile * wg;
  const uint32_t qa = sq + kTile * wg * kSwzRow, doa = sdo + kTile * wg * kSwzRow;
  const float scale_log2 = d.scale * kLog2e;
  // per row: lse * log2 e and D (0 past Sq: such a row is not stored), and
  // the last key it sees, less col0
  float l2[2], dd[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + rl + 8 * i;
    const int64_t at = ((int64_t)b * d.H + h) * d.Sq + row;
    l2[i] = row < d.Sq ? lse[at] * kLog2e : 0.f;
    dd[i] = row < d.Sq ? delta[at] : 0.f;
    lim[i] = (d.causal ? min(row + d.q_offset, d.Sk - 1) : d.Sk - 1) - col0;
  }
  // the last key that any row of the warpgroup sees, and that all do
  const int wg_last =
      d.causal ? min(qw + kTile - 1 + d.q_offset, d.Sk - 1) : d.Sk - 1;
  const int wg_all = d.causal ? min(qw + d.q_offset, d.Sk - 1) : d.Sk - 1;

  float acc[L::kHalves][32];
#pragma unroll
  for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages, k0 = t * kTile;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    if (k0 <= wg_last) {
      const uint32_t kd = sring + 2 * s * L::kTileBytes;
      const uint32_t vd = kd + L::kTileBytes;
      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      pin(sc);
      pin(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(qa + (kk / 4) * 2 * kTile * kSwzRow + off),
                 sw128_desc(kd + (kk / 4) * kTile * kSwzRow + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dp, sw128_desc(doa + (kk / 4) * 2 * kTile * kSwzRow + off),
                 sw128_desc(vd + (kk / 4) * kTile * kSwzRow + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      pin(sc);
      // P = exp2(S scale log2 e - lse log2 e); register e holds row
      // rl + 8 ((e >> 1) & 1), key k0 + col0 + 8 (e >> 2) + (e & 1). Only
      // a tile past a row's last key (the causal diagonal, or past Sk)
      // is masked.
      const bool edge = k0 + kTile - 1 > wg_all;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float p = exp2f(sc[e] * scale_log2 - l2[i]);
        sc[e] = edge && 8 * (e >> 2) + (e & 1) > lim[i] - k0 ? 0.f : p;
      }
      wgmma_wait<0>();
      pin(dp);
      uint32_t dsa[16];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = (e >> 1) & 1;
        dsa[e / 2] = pack_bf16(sc[e] * (dp[e] - dd[i]),
                               sc[e + 1] * (dp[e + 1] - dd[i]));
      }
      // dQ += dS K, K as MN-major B
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) pin(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j)
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          wgmma_rs(acc[c], dsa + 4 * j,
                   sw128_desc(kd + c * kTile * kSwzRow + j * 16 * kSwzRow));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) pin(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + rl + 8 * i;
    if (row >= d.Sq) continue;
    bf16* out = dq + (((int64_t)b * d.Sq + row) * d.H + h) * HD;
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int e = 4 * nb + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(out + c * 64 + 8 * nb + col0) =
            __floats2bfloat162_rn(acc[c][e] * d.scale,
                                  acc[c][e + 1] * d.scale);
      }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, const Dims& d,
                 cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, enc, q, d.B, d.Sq, d.H * HD, kTile) ||
      !tensor_map(&tk, enc, k, d.B, d.Sk, d.Hkv * HD, kTile) ||
      !tensor_map(&tv, enc, v, d.B, d.Sk, d.Hkv * HD, kTile) ||
      !tensor_map(&tdo, enc, dout, d.B, d.Sq, d.H * HD, kTile))
    return (int)cudaErrorInvalidValue;
  const size_t smem_kv = DkdvLayout<HD>::kSmem, smem_q = DqLayout<HD>::kSmem;
  cudaError_t err = allow_smem(dkdv_wgmma<HD>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq_wgmma<HD>, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (d.Sk + 2 * kTile - 1) / (2 * kTile);
  dkdv_wgmma<HD><<<d.B * d.Hkv * key_tiles, kConsumers, smem_kv, st>>>(
      tq, tk, tv, tdo, lse, delta, (bf16*)dk, (bf16*)dv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int query_tiles = (d.Sq + 2 * kTile - 1) / (2 * kTile);
  dq_wgmma<HD><<<d.B * d.H * query_tiles, kQThreads, smem_q, st>>>(
      tq, tk, tv, tdo, lse, delta, (bf16*)dq, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, const Dims& d,
                 cudaStream_t st) {
  const int64_t rows = (int64_t)d.B * d.Sq * d.H;
  delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                    st>>>((const T*)o, (const T*)dout, delta, d);
  return (int)cudaGetLastError();
}

}  // namespace repro_flash_bwd

// 1 when (dtype, hd) takes the wgmma variant, 0 for the simt one.
extern "C" int repro_flash_attention_bwd_variant(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. q/o/dout/dq [B, Sq, H, hd]; k/v/dk/dv
// [B, Sk, Hkv, hd]; lse (the forward's) and delta (scratch the kernel
// fills) [B, H, Sq] float32; every pointer 16-byte aligned, hd <= 128.
// causal: 0 or 1. q_offset >= 0: query i sees keys j <= i + q_offset when
// causal, as in the forward. scale is the score scale, hd ** -0.5. Returns
// the first failed launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int Hkv, int hd, int causal,
    int q_offset, float scale, void* stream) {
  using namespace repro_flash_bwd;
  const cudaStream_t st = (cudaStream_t)stream;
  const Dims d{B, Sq, Sk, H, Hkv, hd, causal, q_offset, scale};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  int err = dtype == 0 ? launch_delta<float>(o, dout, delta, d, st)
                       : launch_delta<__nv_bfloat16>(o, dout, delta, d, st);
  if (err != 0) return err;
  if (repro_flash_attention_bwd_variant(dtype, hd)) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
    return launch_wgmma<128>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
  return launch_simt<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    d, st);
}
