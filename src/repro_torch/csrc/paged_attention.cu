// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention, body _paged_kernel): one query token per sequence
// attends to its KV pages through a block table, GQA-grouped so K/V are
// never repeated, f32 online softmax, positions >= seq_len masked,
// seq_len clamped to >= 1, and an optional k_new/v_new row spliced in at
// position seq_len - 1 (bitwise equal to scattering it first).
//
// Design: one block per (sequence, kv head). The block reads its own
// block-table row and seq_len (no scalar prefetch), keeps the g query heads
// of its kv head and their m/l/acc in shared memory, and walks the used
// positions in tiles of 32 (paged_common.cuh). The layer slice of the
// [L, rows, page, Hkv, hd] plane is read in place from its base pointer.
//
// Bound on the H100: the bytes of K/V read (2 * seq_len * hd values per
// sequence and kv head), since a decode query does 2 flops per byte. This
// first version uses B * Hkv blocks and no split over the sequence, so a
// small batch leaves most SMs idle; split-K is later work.
#include "paged_common.cuh"

namespace repro_paged {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int32_t* __restrict__ block_table,
                           const int32_t* __restrict__ seq_lens,
                           const T* __restrict__ k_new,
                           const T* __restrict__ v_new, T* __restrict__ out,
                           int H, int Hkv, int hd, int page, int W,
                           float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, g = H / Hkv;
  const Smem s = carve(smem, g, hd);
  // clamp >= 1 (idle slots) and to the block table's reach
  const int seq_len = min(max(seq_lens[b], 1), W * page);
  const int64_t head0 = (int64_t)b * H + (int64_t)kvh * g;  // g heads
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    s.q[i] = to_float(q[head0 * hd + i]);
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
    s.pos[r] = seq_len - 1;
  }
  __syncthreads();
  const int64_t tok_stride = (int64_t)Hkv * hd;
  const int64_t row_stride = (int64_t)page * tok_stride;
  const int64_t new_off = ((int64_t)b * Hkv + kvh) * hd;
  const bool splice = k_new != nullptr;
  const PagedAddr addr{block_table + (int64_t)b * W, page, row_stride,
                       tok_stride};
  attend<T>(s, g, hd, scale, seq_len, kp + (int64_t)kvh * hd,
            vp + (int64_t)kvh * hd, addr, splice ? seq_len - 1 : -1,
            splice ? k_new + new_off : nullptr,
            splice ? v_new + new_off : nullptr);
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x)
    store(out + head0 * hd + i, s.acc[i] / fmaxf(s.l[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* seq_lens, const void* k_new, const void* v_new,
           void* out, int B, int H, int Hkv, int hd, int page, int W,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, hd);
  cudaError_t err = allow_smem(paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)bt,
      (const int32_t*)seq_lens, (const T*)k_new, (const T*)v_new, (T*)out,
      H, Hkv, hd, page, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro_paged

// dtype: 0 = float32, 1 = bfloat16. k_new/v_new may be null (no splice).
// scale is the score scale, hd ** -0.5.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_paged_attention(int dtype, const void* q, const void* kp,
                                     const void* vp, const void* block_table,
                                     const void* seq_lens, const void* k_new,
                                     const void* v_new, void* out, int B,
                                     int H, int Hkv, int hd, int page, int W,
                                     float scale, void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, block_table, seq_lens, k_new, v_new,
                         out, B, H, Hkv, hd, page, W, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, block_table, seq_lens, k_new,
                                 v_new, out, B, H, Hkv, hd, page, W, scale, st);
  return (int)cudaErrorInvalidValue;
}
