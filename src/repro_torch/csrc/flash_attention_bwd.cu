// The backward of dense softmax attention (flash_attention.cu) for Hopper
// (sm_90a): given q [B, Sq, H, hd], k/v [B, Sk, Hkv, hd], the forward's
// output o and row log-sum-exp lse [B, H, Sq] (f32, natural log, scaled
// scores), and the output's gradient dout, it writes dq, dk and dv in the
// I/O dtype, f32 inside. The mask is the forward's: causal top-left aligned
// (query i sees keys j <= i) or none, any Sq and Sk, GQA by h // (H / Hkv).
//
// The reference has no backward kernel: it differentiates its jnp
// blockwise attention (repro/models/layers.py::blockwise_attention) with
// JAX autodiff, saving nothing of size S^2. This is FlashAttention-2's
// backward, which saves nothing of that size either:
//
// 1. delta_kernel: D_i = rowsum(dO_i * O_i) (f32, [B, H, Sq]);
// 2. dkdv_*: one block per (key tile, kv head, sequence) walks the query
//    tiles of every query head that reads the kv head (from the key tile's
//    first row on, when causal), recomputes P = exp(S * scale - lse) and
//    dS = P * (dO V^T - D), and accumulates dV += P^T dO and
//    dK += dS^T Q (times scale at the end);
// 3. dq_*: one block per (query tile, head, sequence) walks the key tiles
//    it can see and accumulates dQ += dS K (times scale).
//
// Every output element is summed by one block in a fixed order, with no
// atomics, so two runs give the same bits.
//
// Bound on the H100: the five products, 10 * hd flops per visible (query,
// key) pair and head (this design does seven: S and dO V^T are recomputed
// in both passes); the bytes of q, k, v, o, dout, lse and the three
// gradients are small beside them at training lengths. Two variants by
// (dtype, hd), the forward's rule:
//
// * mma (bf16, hd 64 or 128): 64-row query and key tiles in shared memory,
//   the products on the tensor cores through warp-level wmma (bf16 in, f32
//   accumulators), P and dS rounded to bf16 for their products (as the
//   forward rounds P for P V); the gradient being summed stays in registers.
// * simt (f32, other widths): 32-row tiles staged as f32 and CUDA-core
//   FMAs, so f32 gradients stay exact for the f32 models and checks.
//
// A wgmma/TMA redesign (the forward's attend_wgmma.cuh loop) is later work.
#include <mma.h>

#include "paged_common.cuh"  // to_float, store, allow_smem

namespace repro_flash_bwd {

using repro_paged::allow_smem;
using repro_paged::store;
using repro_paged::to_float;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, causal;
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
  return i < d.Sq && j < d.Sk && (!d.causal || j <= i);
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
  // the first query tile with a row that sees key k0
  const int q_first = d.causal ? k0 : 0;
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
  // keys up to the last row's position when causal
  const int k_end = d.causal ? min(q0 + nq, d.Sk) : d.Sk;
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

// -------------------------------------------------------------------- mma
using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <class Layout>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout>;
template <class Layout>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, Layout>;

constexpr int kMt = 64;        // query and key rows per tile
constexpr int kFld = kMt + 4;  // row stride of the f32 [64][64] tiles
constexpr int kPld = kMt + 8;  // row stride of the bf16 [64][64] tiles

// Shared-memory layout of the mma kernels (bytes), for head width HD:
// four bf16 row tiles [64][HD + 8] (Q, dO, K, V), two f32 score tiles
// [64][68] (S, then dO V^T; reused to stage the result), two bf16 tiles
// [64][72] (P and dS), and the 64 rows' lse and D.
template <int HD>
struct MmaLayout {
  static constexpr int kTld = HD + 8;
  static constexpr int kRowTile = kMt * kTld * 2;
  static constexpr int kScore = kMt * kFld * 4;
  static constexpr int kProb = kMt * kPld * 2;
  static constexpr int kOld = HD + 4;  // f32 staging of a [64][HD] result
  static constexpr size_t kSmem =
      128 /* alignment slack */ + 4 * kRowTile + 2 * kScore + 2 * kProb +
      2 * 4 * kMt;
  static_assert(kMt * kOld * 4 <= 2 * kScore, "result staging fits");
};

// Loads up to 64 rows of HD bf16 (row stride `stride` elements) with
// 16-byte vectors; rows past n are zeros.
template <int HD>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                          int64_t stride, int n) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < kMt * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c * 8) = val;
  }
}

// S = Q K^T and dP = dO V^T for the [64][64] tile (each warp two 16 x 16
// tiles of each), into the f32 tiles S and dP.
template <int HD>
__device__ void mma_scores(const bf16* Qs, const bf16* dOs, const bf16* Ks,
                           const bf16* Vs, float* S, float* dP, int warp) {
  constexpr int ld = HD + 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = warp + kWarps * j, tr = t / 4, tc = t % 4;
    FragC s, dp;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(dp, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragA<wmma::row_major> a;
      FragB<wmma::col_major> bt;  // element (x, key) at K[key][x]: K^T
      wmma::load_matrix_sync(a, Qs + tr * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(bt, Ks + tc * 16 * ld + kk * 16, ld);
      wmma::mma_sync(s, a, bt, s);
      wmma::load_matrix_sync(a, dOs + tr * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(bt, Vs + tc * 16 * ld + kk * 16, ld);
      wmma::mma_sync(dp, a, bt, dp);
    }
    wmma::store_matrix_sync(S + tr * 16 * kFld + tc * 16, s, kFld,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dP + tr * 16 * kFld + tc * 16, dp, kFld,
                            wmma::mem_row_major);
  }
}

// P = exp(S * scale - lse) under the mask and dS = P * (dP - D), rounded
// to bf16 (P only where p is not null).
__device__ void mma_probs(const Dims& d, const float* S, const float* dP,
                          const float* sl, const float* sd, int q0, int k0,
                          bf16* p, bf16* ds) {
  for (int e = threadIdx.x; e < kMt * kMt; e += kThreads) {
    const int r = e / kMt, c = e % kMt;
    const float pv = visible(d, q0 + r, k0 + c)
                         ? expf(S[r * kFld + c] * d.scale - sl[r])
                         : 0.f;
    if (p != nullptr) p[r * kPld + c] = __float2bfloat16(pv);
    ds[r * kPld + c] = __float2bfloat16(pv * (dP[r * kFld + c] - sd[r]));
  }
}

// Writes the warps' [64][HD] f32 result (times mul) through the staging
// tile as up to n rows of bf16, row stride `stride`.
template <int HD>
__device__ void write_result(FragC (&acc)[HD / 32], float mul, float* stage,
                             bf16* __restrict__ dst, int64_t stride, int n,
                             int warp) {
  constexpr int ld = HD + 4;
  __syncthreads();  // the staging tile's last readers are done
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) {
    const int t = warp + kWarps * j, tr = t / (HD / 16), tc = t % (HD / 16);
#pragma unroll
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= mul;
    wmma::store_matrix_sync(stage + tr * 16 * ld + tc * 16, acc[j], ld,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD;
    dst[r * stride + c] = __float2bfloat16(stage[r * ld + c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d) {
  using L = MmaLayout<HD>;
  constexpr int ld = L::kTld;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  bf16 *Ks = (bf16*)base, *Vs = Ks + kMt * ld, *Qs = Vs + kMt * ld,
       *dOs = Qs + kMt * ld;
  float *S = (float*)(dOs + kMt * ld), *dP = S + kMt * kFld;
  bf16 *P = (bf16*)(dP + kMt * kFld), *dS = P + kMt * kPld;
  float *sl = (float*)(dS + kMt * kPld), *sd = sl + kMt;
  const int warp = threadIdx.x / 32, g = d.H / d.Hkv;
  const int k0 = blockIdx.x * kMt, kvh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kMt, d.Sk - k0);
  const int64_t kstride = (int64_t)d.Hkv * HD, qstride = (int64_t)d.H * HD;
  const int64_t koff = (((int64_t)b * d.Sk + k0) * d.Hkv + kvh) * HD;
  load_rows<HD>(Ks, k + koff, kstride, nk);
  load_rows<HD>(Vs, v + koff, kstride, nk);
  // warp w sums the 16 x 16 tiles w, w + 8, ... of dK and dV [64][HD]
  FragC acc_k[HD / 32], acc_v[HD / 32];
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) {
    wmma::fill_fragment(acc_k[j], 0.f);
    wmma::fill_fragment(acc_v[j], 0.f);
  }
  const int q_first = d.causal ? k0 : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int q0 = q_first; q0 < d.Sq; q0 += kMt) {
      const int nq = min(kMt, d.Sq - q0);
      __syncthreads();
      const int64_t qoff = (((int64_t)b * d.Sq + q0) * d.H + h) * HD;
      load_rows<HD>(Qs, q + qoff, qstride, nq);
      load_rows<HD>(dOs, dout + qoff, qstride, nq);
      if (threadIdx.x < kMt) {
        const int r = threadIdx.x;
        const int64_t at = ((int64_t)b * d.H + h) * d.Sq + q0 + r;
        sl[r] = r < nq ? lse[at] : 0.f;
        sd[r] = r < nq ? delta[at] : 0.f;
      }
      __syncthreads();
      mma_scores<HD>(Qs, dOs, Ks, Vs, S, dP, warp);
      __syncthreads();
      mma_probs(d, S, dP, sl, sd, q0, k0, P, dS);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        const int t = warp + kWarps * j, tr = t / (HD / 16),
                  tc = t % (HD / 16);
#pragma unroll
        for (int kk = 0; kk < kMt / 16; ++kk) {
          // element (key, row) at P[row][key]: P^T, likewise dS^T
          FragA<wmma::col_major> a;
          FragB<wmma::row_major> bm;
          wmma::load_matrix_sync(a, P + kk * 16 * kPld + tr * 16, kPld);
          wmma::load_matrix_sync(bm, dOs + kk * 16 * ld + tc * 16, ld);
          wmma::mma_sync(acc_v[j], a, bm, acc_v[j]);
          wmma::load_matrix_sync(a, dS + kk * 16 * kPld + tr * 16, kPld);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * ld + tc * 16, ld);
          wmma::mma_sync(acc_k[j], a, bm, acc_k[j]);
        }
      }
    }
  }
  write_result<HD>(acc_v, 1.f, S, dv + koff, kstride, nk, warp);
  write_result<HD>(acc_k, d.scale, S, dk + koff, kstride, nk, warp);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, Dims d) {
  using L = MmaLayout<HD>;
  constexpr int ld = L::kTld;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  bf16 *Qs = (bf16*)base, *dOs = Qs + kMt * ld, *Ks = dOs + kMt * ld,
       *Vs = Ks + kMt * ld;
  float *S = (float*)(Vs + kMt * ld), *dP = S + kMt * kFld;
  bf16* dS = (bf16*)(dP + kMt * kFld);
  float *sl = (float*)(dS + kMt * kPld), *sd = sl + kMt;
  const int warp = threadIdx.x / 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMt;  // most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (d.H / d.Hkv);
  const int nq = min(kMt, d.Sq - q0);
  const int64_t kstride = (int64_t)d.Hkv * HD, qstride = (int64_t)d.H * HD;
  const int64_t qoff = (((int64_t)b * d.Sq + q0) * d.H + h) * HD;
  load_rows<HD>(Qs, q + qoff, qstride, nq);
  load_rows<HD>(dOs, dout + qoff, qstride, nq);
  if (threadIdx.x < kMt) {
    const int r = threadIdx.x;
    const int64_t at = ((int64_t)b * d.H + h) * d.Sq + q0 + r;
    sl[r] = r < nq ? lse[at] : 0.f;
    sd[r] = r < nq ? delta[at] : 0.f;
  }
  FragC acc[HD / 32];
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) wmma::fill_fragment(acc[j], 0.f);
  const int k_end = d.causal ? min(q0 + nq, d.Sk) : d.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kMt) {
    const int nk = min(kMt, d.Sk - k0);
    __syncthreads();
    const int64_t koff = (((int64_t)b * d.Sk + k0) * d.Hkv + kvh) * HD;
    load_rows<HD>(Ks, k + koff, kstride, nk);
    load_rows<HD>(Vs, v + koff, kstride, nk);
    __syncthreads();
    mma_scores<HD>(Qs, dOs, Ks, Vs, S, dP, warp);
    __syncthreads();
    mma_probs(d, S, dP, sl, sd, q0, k0, nullptr, dS);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) {
      const int t = warp + kWarps * j, tr = t / (HD / 16), tc = t % (HD / 16);
#pragma unroll
      for (int kk = 0; kk < kMt / 16; ++kk) {
        FragA<wmma::row_major> a;
        FragB<wmma::row_major> bm;
        wmma::load_matrix_sync(a, dS + tr * 16 * kPld + kk * 16, kPld);
        wmma::load_matrix_sync(bm, Ks + kk * 16 * ld + tc * 16, ld);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
  }
  write_result<HD>(acc, d.scale, S, dq + qoff, qstride, nq, warp);
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, const Dims& d, cudaStream_t st) {
  const size_t smem = MmaLayout<HD>::kSmem;
  cudaError_t err = allow_smem(dkdv_mma<HD>, smem);
  if (err == cudaSuccess) err = allow_smem(dq_mma<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dkdv_mma<HD><<<dim3((d.Sk + kMt - 1) / kMt, d.Hkv, d.B), kThreads, smem,
                 st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                       (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv,
                       d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_mma<HD><<<dim3((d.Sq + kMt - 1) / kMt, d.H, d.B), kThreads, smem,
               st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                     (const bf16*)dout, lse, delta, (bf16*)dq, d);
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

// 1 when (dtype, hd) takes the mma variant, 0 for the simt one.
extern "C" int repro_flash_attention_bwd_variant(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. q/o/dout/dq [B, Sq, H, hd]; k/v/dk/dv
// [B, Sk, Hkv, hd]; lse (the forward's) and delta (scratch the kernel
// fills) [B, H, Sq] float32; every pointer 16-byte aligned, hd <= 128.
// causal: 0 or 1. scale is the score scale, hd ** -0.5. Returns the first
// failed launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int Hkv, int hd, int causal,
    float scale, void* stream) {
  using namespace repro_flash_bwd;
  const cudaStream_t st = (cudaStream_t)stream;
  const Dims d{B, Sq, Sk, H, Hkv, hd, causal, scale};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int err = dtype == 0 ? launch_delta<float>(o, dout, delta, d, st)
                       : launch_delta<__nv_bfloat16>(o, dout, delta, d, st);
  if (err != 0) return err;
  if (repro_flash_attention_bwd_variant(dtype, hd)) {
    if (hd == 64)
      return launch_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
    return launch_mma<128>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, dout, lse, delta, dq, dk, dv, d, st);
  return launch_simt<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    d, st);
}
