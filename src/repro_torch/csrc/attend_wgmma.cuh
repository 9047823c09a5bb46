// The wgmma attention tile loop shared by flash_attention.cu (dense K/V) and
// chunk_prefill.cu (K/V in pages through a block table), bf16 with head
// widths of 64 or 128.
//
// A block owns 128 query rows of one (sequence, query head): two consumer
// warpgroups of 64 rows and one producer warp. The producer loads the
// block's Q once and K/V tiles of 64 keys into a 2-stage ring with TMA
// (128-byte swizzle, the layout wgmma reads; completion on mbarriers) and
// refills a stage as soon as both warpgroups release it. Each warpgroup
// computes S = Q K^T with wgmma m64n64k16 (bf16 in, f32 in registers),
// masks only the tiles that reach past its rows' smallest position or past
// the keys there are, runs the online softmax in registers with exp2 and
// the scale folded in, converts P to bf16 in registers (the Pallas kernels'
// p.astype(v.dtype)) and feeds it as the A operand of the P V wgmma, V read
// from shared memory as an MN-major operand. Tiles past a warpgroup's
// largest position are skipped, and the grid issues the last query tiles
// (most keys when causal) first so the tail of the grid is short.
//
// Two things differ between the kernels, and a source type supplies them:
// * where a row's position comes from (stage, k_len, pos, bounds): its
//   index plus a query offset (flash, causal and top-left aligned at 0),
//   computed, or
//   positions[b, row] (the chunk), staged in shared memory and reduced
//   there; a row sees key j when j <= its position and j < kv_len();
// * where a K/V tile comes from (tile_arg, load): one box per 64 columns of
//   a dense [B, Sk, Hkv * hd] map, or one box per page of a
//   [n_rows, page, Hkv * hd] map of the layer slice, the page's plane row
//   read from the block table one tile ahead.
// The number of key tiles is the block's largest position plus one, found
// on the device (no host sync).
//
// Given a non-null `lse` ([B, H, Sq] f32), each row also writes the natural
// log of its softmax denominator in the scaled-score domain, m + log(l)
// (the row max and sum are kept in log2 units, so m * ln 2): what the
// backward kernel recomputes P from. The store is the only difference, so a
// null `lse` leaves every output bit as it was.
#pragma once

#include <climits>

#include "hopper.cuh"
#include "paged_common.cuh"  // kNegInf, allow_smem

namespace repro_attend {

using namespace repro_hopper;
using repro_paged::kNegInf;

constexpr int kBM = 128;          // query rows per block (2 warpgroups)
constexpr int kBN = 64;           // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 32;  // + one producer warp

template <int HD>
struct WgLayout {
  static constexpr int kHalves = HD / 64;  // 64-column swizzled boxes
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or V tile
  static constexpr int kBars = 2 * kStages + 1;    // full, empty, q
  static constexpr size_t kSmem = 1024 /* alignment slack */ + kQBytes +
                                  2 * kStages * kTileBytes + 8 * kBars +
                                  4 * kBM /* row positions */;
};

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Contiguous K/V: tensor maps over [B, Sk, Hkv * hd]. Row positions are
// row indices plus q_off (causal: a context-parallel rank's queries are
// rows q_off .. of the keys' sequence) or Sk - 1 (every key visible),
// computed, not staged.
struct DenseKV {
  int Sk, causal, q_off;

  __device__ int kv_len() const { return Sk; }
  __device__ void stage(int*, int, int, int) const {}
  __device__ int k_len(const int*, int q0, int) const {
    return causal ? min(q0 + kBM + q_off, Sk) : Sk;
  }
  __device__ int pos(const int*, int q0, int r) const {
    return causal ? q0 + r + q_off : Sk - 1;
  }
  __device__ void bounds(const int*, int q0, int wg, int, int& lo,
                         int& hi) const {
    lo = pos(nullptr, q0, 64 * wg);
    hi = pos(nullptr, q0, 64 * wg + 63);
  }
  __device__ int tile_arg(int, int, int, int) const { return 0; }
  template <int HD>
  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv, int b,
                       int kvh, int t, int /*arg*/, uint32_t kd, uint32_t vd,
                       uint32_t bar, int lane) const {
    if (lane != 0) return;
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load(kd + c * kBN * kSwzRow, tk, bar, kvh * HD + c * 64, t * kBN,
               b);
      tma_load(vd + c * kBN * kSwzRow, tv, bar, kvh * HD + c * 64, t * kBN,
               b);
    }
  }
};

// K/V in pages of `page` tokens (8, 16, 32 or 64: a whole number of 8-row
// swizzle atoms, so the page boxes stack into one tile's layout): tensor
// maps over the layer slice [n_rows, page, Hkv * hd]; sequence b's page i
// is plane row block_table[b, i].
struct PagedKV {
  const int32_t* positions;  // [B, C]
  const int32_t* bt;         // [B, W]
  int C, W, page, n_rows;

  __device__ int kv_len() const { return W * page; }
  // thread r < 128 stages row q0 + r's position; rows past C see nothing
  __device__ void stage(int* spos, int b, int q0, int r) const {
    spos[r] = q0 + r < C ? positions[(int64_t)b * C + q0 + r] : -1;
  }
  // keys the block's rows can see: up to their largest position
  __device__ int k_len(const int* spos, int, int lane) const {
    return min(warp_max(max(max(spos[lane], spos[lane + 32]),
                            max(spos[lane + 64], spos[lane + 96]))) + 1,
               kv_len());
  }
  __device__ int pos(const int* spos, int, int r) const { return spos[r]; }
  // warpgroup wg's smallest position over rows < C, and its largest
  __device__ void bounds(const int* spos, int, int wg, int lane, int& lo,
                         int& hi) const {
    const int a = spos[64 * wg + lane], c = spos[64 * wg + 32 + lane];
    hi = warp_max(max(a, c));
    lo = warp_min(min(a < 0 ? INT_MAX : a, c < 0 ? INT_MAX : c));
  }
  // The plane row of lane `lane`'s page of tile t. A page at or past the
  // visible length (or past the table) is aimed at row n_rows, past the
  // map's edge: TMA fills it with zeros, so no stale bits reach P V, and
  // every tile still delivers the same number of bytes.
  __device__ int tile_arg(int b, int t, int k_len, int lane) const {
    const int per_tile = kBN / page;
    const int i = t * per_tile + lane;
    if (lane >= per_tile || i >= W || i * page >= k_len) return n_rows;
    return bt[(int64_t)b * W + i];
  }
  template <int HD>
  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv, int,
                       int kvh, int, int row, uint32_t kd, uint32_t vd,
                       uint32_t bar, int lane) const {
    if (lane >= kBN / page) return;
    const uint32_t off = lane * page * kSwzRow;
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load(kd + c * kBN * kSwzRow + off, tk, bar, kvh * HD + c * 64, 0,
               row);
      tma_load(vd + c * kBN * kSwzRow + off, tv, bar, kvh * HD + c * 64, 0,
               row);
    }
  }
};

// tq maps q as [B, Sq, H * HD] in boxes of 128 rows; out is [B, Sq, H, HD].
template <int HD, class Src>
__global__ void __launch_bounds__(kWgThreads, 1)
    attend_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int B, int Sq, int H,
                        int Hkv, float scale_log2, const Src src) {
  using L = WgLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_u32(base);
  const uint32_t skv = sq + L::kQBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + L::kQBytes + 2 * kStages *
                                                          L::kTileBytes);
  int* spos = reinterpret_cast<int*>(bars + L::kBars);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;

  // the last query tiles (most keys when causal) first
  const int nqt = (Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nqt - 1 - blockIdx.x / (B * H)) * kBM;
  const int b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  if (threadIdx.x < kBM) src.stage(spos, b, q0, threadIdx.x);
  __syncthreads();
  const int kv_len = src.kv_len();
  const int k_len = src.k_len(spos, q0, lane);
  const int n_kt = (k_len + kBN - 1) / kBN;

  if (threadIdx.x >= kConsumers) {  // ---- producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load(sq + c * kBM * kSwzRow, &tq, qbar, h * HD + c * 64, q0, b);
    }
    int arg = src.tile_arg(b, 0, k_len, lane);
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      const int next = src.tile_arg(b, t + 1, k_len, lane);  // read ahead
      mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
      __syncwarp();
      const uint32_t kd = skv + 2 * s * L::kTileBytes;
      src.template load<HD>(&tk, &tv, b, kvh, t, arg, kd, kd + L::kTileBytes,
                            full0 + 8 * s, lane);
      arg = next;
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int rl = 64 * wg + 16 * (t128 / 32) + lane / 4;  // and rl + 8
  const int row0 = q0 + rl;
  const int col0 = 2 * (lane % 4);
  const int pos[2] = {src.pos(spos, q0, rl), src.pos(spos, q0, rl + 8)};
  int wg_min, wg_max;  // the warpgroup's smallest and largest positions
  src.bounds(spos, q0, wg, lane, wg_min, wg_max);
  const uint32_t qa = sq + 64 * wg * kSwzRow;

  float o[L::kHalves][32];
#pragma unroll
  for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages, k0 = t * kBN;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    // a tile wholly past this warpgroup's positions adds nothing
    if (k0 <= wg_max) {
      const uint32_t kd = skv + 2 * s * L::kTileBytes;
      const uint32_t vd = kd + L::kTileBytes;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the row
        wgmma_ss(sc, sw128_desc(qa + (kk / 4) * kBM * kSwzRow + off),
                 sw128_desc(kd + (kk / 4) * kBN * kSwzRow + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin(sc);

      // online softmax in registers, in log2 units
      const bool edge = k0 + kBN > kv_len || k0 + kBN - 1 > wg_min;
      // register e holds key k0 + col0 + 8 (e >> 2) + (e & 1); row i sees
      // keys up to k0 + col0 + lim[i]
      const int lim[2] = {min(pos[0], kv_len - 1) - k0 - col0,
                          min(pos[1], kv_len - 1) - k0 - col0};
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        float x = sc[e] * scale_log2;
        if (edge && 8 * (e >> 2) + (e & 1) > lim[i]) x = kNegInf;
        sc[e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      uint32_t pa[16];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = (e >> 1) & 1;
        const float p0 = exp2f(sc[e] - m[i]), p1 = exp2f(sc[e + 1] - m[i]);
        l[i] += p0 + p1;
        pa[e / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];

#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) pin(o[c]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j)
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c)
          wgmma_rs(o[c], pa + 4 * j,
                   sw128_desc(vd + c * kBN * kSwzRow + j * 16 * kSwzRow));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < L::kHalves; ++c) pin(o[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // l was summed over this thread's columns: add the row's other 3 threads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && col0 == 0)
      lse[((int64_t)b * H + h) * Sq + row] =
          m[i] * 0.6931471805599453f + logf(den);
    __nv_bfloat16* orow = out + (((int64_t)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int e = 4 * nb + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * nb + col0) =
            __floats2bfloat162_rn(o[c][e] / den, o[c][e + 1] / den);
      }
  }
}

// Launches the loop over tq (q as [B, Sq, H * HD], boxes of 128 rows) and
// the source's K/V maps; `scale` is the score scale, hd ** -0.5; `lse` the
// optional row log-sum-exp output, null when not wanted.
template <int HD, class Src>
int launch_attend(const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, void* out, float* lse, int B, int Sq,
                  int H, int Hkv, float scale, const Src& src,
                  cudaStream_t stream) {
  const size_t smem = WgLayout<HD>::kSmem;
  cudaError_t err =
      repro_paged::allow_smem(attend_wgmma_kernel<HD, Src>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * H * ((Sq + kBM - 1) / kBM);
  attend_wgmma_kernel<HD, Src><<<blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, B, Sq, H, Hkv,
      scale * 1.4426950408889634f, src);
  return (int)cudaGetLastError();
}

}  // namespace repro_attend
