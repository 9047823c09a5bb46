// Paged decode attention for Hopper (sm_90a), split over the sequence
// (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention, body _paged_kernel): one query token per sequence
// attends to its KV pages through a block table, GQA-grouped so K/V are
// never repeated, f32 online softmax, positions >= seq_len masked,
// seq_len clamped to >= 1 and to W * page, and an optional k_new/v_new row
// spliced in at position seq_len - 1 (bitwise equal to scattering it
// first).
//
// Optionally each (sequence, query head) row's log-sum-exp, lse [B, H]
// f32: the row max plus the log of the row sum of its scaled scores, which
// the combine holds. Asked for it, the kernel clamps seq_len to >= 0
// instead: a lane of length 0 writes empty partials only, an output of 0
// and a log-sum-exp of -inf. That is a rank of a sequence-split cache that
// holds none of the lane's positions; the ranks' outputs are then merged
// by their log-sum-exps (exp(lse - max) weighs the empty one 0). Not asked
// for it, nothing changes: no store, the same clamp, the same bits.
//
// Bound on the H100: the bytes of K/V read (2 * seq_len * hd values per
// sequence and kv head); a decode query does 2 flops per byte, so tensor
// cores bring nothing and the design keeps the memory system busy:
//
// * The grid is (B, Hkv, n_split): split z owns positions
//   [z * span, (z + 1) * span) of its sequence, span a whole number of
//   32-position tiles. The caller derives (n_split, span) from the shapes
//   alone (B, Hkv, W, page), never from seq_lens, which live on the device.
//   A split whose span starts at or past seq_len writes an empty partial
//   (m = -inf, l = 0) and exits.
// * K/V rows (hd contiguous values of one kv head) arrive by 16-byte
//   cp.async into a 3-stage ring in shared memory, rows padded by 16 bytes
//   so the 32 lanes scoring 32 positions hit distinct banks; the next two
//   tiles are in flight while this one is scored. The block copies its
//   span's block-table entries to shared memory first, so no copy waits on
//   a global read of its address. One warp per query
//   row: lane t scores position t (f32 dot), the warp folds the tile into
//   the row's f32 online softmax, then each lane accumulates its columns of
//   p V. The spliced position is copied from k_new/v_new instead of its
//   page, and nothing else changes, so the result is bitwise that of a
//   scatter.
// * Each split writes f32 partials (acc[g][hd], m[g], l[g]) to scratch; a
//   combine kernel, one block per (sequence, query head), merges the splits
//   in split order, one split included. No atomics: the result is
//   deterministic.
#include "paged_common.cuh"

namespace repro_paged {

constexpr int kSplitTile = 32;  // positions per tile: one per lane
constexpr int kDecStages = 3;   // K/V ring depth
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxCols = 8;  // hd / 32 columns per lane, hd <= 256

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// f32 dot of one 16-byte chunk of a staged K row with q[0 .. 16 / sizeof(T))
__device__ __forceinline__ float dot16(const float* k16, const float* q,
                                       float acc) {
  const float4 k = *reinterpret_cast<const float4*>(k16);
  const float4 x = *reinterpret_cast<const float4*>(q);
  acc = fmaf(x.x, k.x, acc);
  acc = fmaf(x.y, k.y, acc);
  acc = fmaf(x.z, k.z, acc);
  return fmaf(x.w, k.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* k16,
                                       const float* q, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k16);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 x0 = *reinterpret_cast<const float4*>(q);
  const float4 x1 = *reinterpret_cast<const float4*>(q + 4);
  const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 kf = __bfloat1622float2(k2[i]);
    acc = fmaf(xs[2 * i], kf.x, acc);
    acc = fmaf(xs[2 * i + 1], kf.y, acc);
  }
  return acc;
}

// f32 dot of a staged K row with a query row, in `chunks` 16-byte chunks
// over four independent partial sums.
template <typename T>
__device__ __forceinline__ float dot_row(const T* k, const float* q,
                                         int chunks) {
  constexpr int E = 16 / sizeof(T);
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  int c = 0;
  for (; c + 4 <= chunks; c += 4) {
    d0 = dot16(k + c * E, q + c * E, d0);
    d1 = dot16(k + (c + 1) * E, q + (c + 1) * E, d1);
    d2 = dot16(k + (c + 2) * E, q + (c + 2) * E, d2);
    d3 = dot16(k + (c + 3) * E, q + (c + 3) * E, d3);
  }
  for (; c < chunks; ++c) d0 = dot16(k + c * E, q + c * E, d0);
  return (d0 + d1) + (d2 + d3);
}

// Block-table entries one span reads: its first and last position's pages
// and every page between.
inline int span_pages(int span, int page) { return (span - 1) / page + 2; }

inline size_t split_smem_bytes(int g, int hd, int esize, int span,
                               int page) {
  const size_t pitch = (size_t)hd * esize + 16;
  return kDecStages * 2 * kSplitTile * pitch +
         4 * (2 * (size_t)g * hd + 2 * g + span_pages(span, page));
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
    paged_attention_split_kernel(
        const T* __restrict__ q, const T* __restrict__ kp,
        const T* __restrict__ vp, const int32_t* __restrict__ block_table,
        const int32_t* __restrict__ seq_lens, const T* __restrict__ k_new,
        const T* __restrict__ v_new, float* __restrict__ acc_out,
        float* __restrict__ ml_out, int H, int Hkv, int hd, int page, int W,
        int span, int min_len, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, z = blockIdx.z;
  const int nz = gridDim.z, g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // clamp >= min_len (1: idle slots; 0 with the log-sum-exp) and to the
  // block table's reach
  const int seq_len = min(max(seq_lens[b], min_len), W * page);
  const int t_begin = z * span, t_end = min(t_begin + span, seq_len);
  const int64_t part = ((int64_t)(b * Hkv + kvh) * nz + z) * g;  // row 0
  if (t_begin >= t_end) {
    for (int r = tid; r < g; r += kDecThreads) {
      ml_out[2 * (part + r)] = -INFINITY;
      ml_out[2 * (part + r) + 1] = 0.f;
    }
    return;
  }

  const int row_bytes = hd * (int)sizeof(T), pitch = row_bytes + 16;
  const int chunks = row_bytes / 16;
  uint8_t* ring = smem;  // [stage][K, V][kSplitTile][pitch]
  float* s_q = reinterpret_cast<float*>(smem + kDecStages * 2 * kSplitTile *
                                                   pitch);
  float* s_acc = s_q + g * hd;
  float* s_m = s_acc + g * hd;
  float* s_l = s_m + g;
  int32_t* s_bt = reinterpret_cast<int32_t*>(s_l + g);  // from page p_begin

  const int64_t head0 = (int64_t)b * H + (int64_t)kvh * g;  // g heads
  for (int i = tid; i < g * hd; i += kDecThreads) {
    s_q[i] = to_float(q[head0 * hd + i]);
    s_acc[i] = 0.f;
  }
  for (int r = tid; r < g; r += kDecThreads) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }

  const int p_begin = t_begin / page;
  for (int i = tid; i <= (t_end - 1) / page - p_begin; i += kDecThreads)
    s_bt[i] = block_table[(int64_t)b * W + p_begin + i];
  __syncthreads();

  const int64_t tok_bytes = (int64_t)Hkv * hd * sizeof(T);
  const int64_t row_bytes_plane = (int64_t)page * tok_bytes;
  const int splice = k_new != nullptr ? seq_len - 1 : -1;
  const int64_t new_off = ((int64_t)b * Hkv + kvh) * hd;
  const uint8_t* kbase = reinterpret_cast<const uint8_t*>(kp + kvh * hd);
  const uint8_t* vbase = reinterpret_cast<const uint8_t*>(vp + kvh * hd);

  // positions [t0, t0 + n) of tile `it` into ring stage it % kDecStages;
  // K and V rows of a position share their offset
  auto load = [&](int it) {
    const int t0 = t_begin + it * kSplitTile;
    const int n = min(kSplitTile, t_end - t0);
    uint8_t* kd = ring + (it % kDecStages) * 2 * kSplitTile * pitch;
    for (int i = tid; i < n * chunks; i += kDecThreads) {
      const int t = i / chunks, c = i - t * chunks, pos = t0 + t;
      const uint8_t *ksrc, *vsrc;
      if (pos == splice) {
        ksrc = reinterpret_cast<const uint8_t*>(k_new + new_off);
        vsrc = reinterpret_cast<const uint8_t*>(v_new + new_off);
      } else {
        const int64_t off = s_bt[pos / page - p_begin] * row_bytes_plane +
                            (pos % page) * tok_bytes;
        ksrc = kbase + off;
        vsrc = vbase + off;
      }
      cp_async16(kd + t * pitch + c * 16, ksrc + c * 16);
      cp_async16(kd + (kSplitTile + t) * pitch + c * 16, vsrc + c * 16);
    }
  };

  const int n_tiles = (t_end - t_begin + kSplitTile - 1) / kSplitTile;
  for (int it = 0; it < kDecStages - 1; ++it) {
    if (it < n_tiles) load(it);
    cp_async_commit();  // empty groups past the last tile keep the count
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kSplitTile;
    const int n = min(kSplitTile, t_end - t0);
    cp_async_wait1();  // this thread's copies of tile `it` have landed
    __syncthreads();   // everyone's have, and tile it - 1 is consumed
    if (it + kDecStages - 1 < n_tiles) load(it + kDecStages - 1);
    cp_async_commit();
    const uint8_t* ks = ring + (it % kDecStages) * 2 * kSplitTile * pitch;
    const uint8_t* vs = ks + kSplitTile * pitch;
    for (int r = warp; r < g; r += kDecWarps) {
      const float* qr = s_q + r * hd;
      float x = kNegInf;
      if (lane < n)
        x = dot_row(reinterpret_cast<const T*>(ks + lane * pitch), qr,
                    chunks) *
            scale;
      float mx = x;
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float e = lane < n ? expf(x - m_new) : 0.f;
      float sum = e;
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_prev - m_new);
      // p V for this lane's columns d = 32 k + lane
      float a[kMaxCols];
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) a[k] = 0.f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float pt = __shfl_sync(0xffffffffu, e, t);
        const T* vrow = reinterpret_cast<const T*>(vs + t * pitch);
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int d = 32 * k + lane;
          if (d < hd) a[k] = fmaf(pt, to_float(vrow[d]), a[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        const int d = 32 * k + lane;
        if (d < hd) s_acc[r * hd + d] = s_acc[r * hd + d] * alpha + a[k];
      }
      __syncwarp();  // every lane has read s_m[r] before lane 0 moves it
      if (lane == 0) {
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < g * hd; i += kDecThreads) acc_out[part * hd + i] =
      s_acc[i];
  for (int r = tid; r < g; r += kDecThreads) {
    ml_out[2 * (part + r)] = s_m[r];
    ml_out[2 * (part + r) + 1] = s_l[r];
  }
}

// Merges the n_split partials of one query head of a sequence, in split
// order. The block reads the splits' (m, l) into shared memory at once, one
// thread folds them into the weights exp(m_z - M) and the denominator, and
// each thread then sums its columns over the non-empty splits, which are a
// prefix (split z is empty when z * span >= seq_len). With `lse` it also
// writes the row's M + log(L): -inf where every split is empty.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
    paged_attention_combine_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ ml,
                                   T* __restrict__ out,
                                   float* __restrict__ lse, int H, int Hkv,
                                   int hd, int nz) {
  extern __shared__ float s_w[];  // [nz] m, then weights; [nz] l
  __shared__ float s_den;
  __shared__ int s_used;
  const int b = blockIdx.x, h = blockIdx.y, g = H / Hkv;
  const int kvh = h / g, r = h % g;
  // partial of split z: row (b * Hkv + kvh) * nz * g + z * g + r
  const int64_t row0 = (int64_t)(b * Hkv + kvh) * nz * g + r;
  float* s_l = s_w + nz;
  for (int z = threadIdx.x; z < nz; z += kDecThreads) {
    s_w[z] = ml[2 * (row0 + (int64_t)z * g)];
    s_l[z] = ml[2 * (row0 + (int64_t)z * g) + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int used = 0;
    while (used < nz && s_w[used] != -INFINITY) ++used;
    float M = -INFINITY;
    for (int z = 0; z < used; ++z) M = fmaxf(M, s_w[z]);
    float L = 0.f;
    for (int z = 0; z < used; ++z) {
      const float w = expf(s_w[z] - M);
      s_w[z] = w;
      L = fmaf(s_l[z], w, L);
    }
    s_den = fmaxf(L, 1e-30f);
    s_used = used;
    if (lse != nullptr)
      lse[(int64_t)b * H + h] = used ? M + logf(L) : -INFINITY;
  }
  __syncthreads();
  const int used = s_used;
  for (int d = threadIdx.x; d < hd; d += kDecThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int z = 0; z < used; ++z)
      o = fmaf(acc[(row0 + (int64_t)z * g) * hd + d], s_w[z], o);
    store(out + ((int64_t)b * H + h) * hd + d, o / s_den);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* seq_lens, const void* k_new, const void* v_new,
           void* out, float* lse, void* acc, void* ml, int B, int H,
           int Hkv, int hd, int page, int W, int n_split, int span,
           float scale, cudaStream_t stream) {
  if (n_split < 1 || span % kSplitTile != 0 || (int64_t)n_split * span <
      (int64_t)W * page || hd > 32 * kMaxCols || (hd * sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(H / Hkv, hd, sizeof(T), span, page);
  cudaError_t err = allow_smem(paged_attention_split_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_split_kernel<T>
      <<<dim3(B, Hkv, n_split), kDecThreads, smem, stream>>>(
          (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)bt,
          (const int32_t*)seq_lens, (const T*)k_new, (const T*)v_new,
          (float*)acc, (float*)ml, H, Hkv, hd, page, W, span,
          lse != nullptr ? 0 : 1, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem = 2 * 4 * (size_t)n_split;
  err = allow_smem(paged_attention_combine_kernel<T>, csmem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_combine_kernel<T>
      <<<dim3(B, H), kDecThreads, csmem, stream>>>(
          (const float*)acc, (const float*)ml, (T*)out, lse, H, Hkv, hd,
          n_split);
  return (int)cudaGetLastError();
}

}  // namespace repro_paged

// dtype: 0 = float32, 1 = bfloat16. k_new/v_new may be null (no splice).
// lse: [B, H] float32 row log-sum-exp output (seq_lens then clamped to
// >= 0), or null (clamped to >= 1).
// (n_split, span) is the split plan; acc [B, Hkv, n_split, g, hd] and
// ml [B, Hkv, n_split, g, 2] are f32 scratch for the partials. Every float
// pointer is 16-byte aligned and hd * sizeof(dtype) a multiple of 16. scale is the score scale,
// hd ** -0.5. Returns the first failed launch's cudaError_t (0 on success).
extern "C" int repro_paged_attention(int dtype, const void* q, const void* kp,
                                     const void* vp, const void* block_table,
                                     const void* seq_lens, const void* k_new,
                                     const void* v_new, void* out,
                                     float* lse, void* acc, void* ml, int B,
                                     int H, int Hkv, int hd,
                                     int page, int W, int n_split, int span,
                                     float scale, void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, block_table, seq_lens, k_new, v_new, out,
                         lse, acc, ml, B, H, Hkv, hd, page, W, n_split, span,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, block_table, seq_lens, k_new,
                                 v_new, out, lse, acc, ml, B, H, Hkv, hd,
                                 page, W, n_split, span, scale, st);
  return (int)cudaErrorInvalidValue;
}
