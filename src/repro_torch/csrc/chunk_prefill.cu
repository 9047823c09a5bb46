// Chunked-prefill attention over the paged KV arena for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/chunk_prefill.py
// (chunk_prefill_attention, body _chunk_kernel): a fixed-width chunk of C
// query tokens per sequence attends to everything already written to its
// pages (earlier chunks and its own K/V, scattered in by the caller) under
// a causal mask on absolute positions. GQA rows are regrouped per kv head
// as [C * g] (row c * g + j is head kvh * g + j of token c), so K/V are
// never repeated. Pad columns repeat position 0 and stay finite: key 0 is
// always visible to them.
//
// Design: one block per (sequence, kv head, tile of 32 of the C * g rows).
// The block walks key positions up to the largest position among its own
// rows plus one — the Pallas kernel's max(positions) + 1 narrowed to the
// tile; the keys it skips are masked for every row of the tile, so the
// result is the same — in tiles of 32 (paged_common.cuh), reading the
// layer slice of the [L, rows, page, Hkv, hd] plane in place.
//
// Bound on the H100: the chunk's score and value products (4 * C * H * hd
// flops per visible key), which the f32 CUDA-core loop here runs far below
// the tensor cores' rate; the bytes of K/V read are small beside them.
// A wgmma/TMA tile loop is later work.
#include "paged_common.cuh"

namespace repro_paged {

constexpr int kRows = 32;  // query rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_prefill_kernel(const T* __restrict__ q,
                         const int32_t* __restrict__ positions,
                         const T* __restrict__ kp, const T* __restrict__ vp,
                         const int32_t* __restrict__ block_table,
                         T* __restrict__ out, int C, int H, int Hkv, int hd,
                         int page, int W, float scale) {
  extern __shared__ float smem[];
  __shared__ int k_len;
  const int b = blockIdx.x, kvh = blockIdx.y, g = H / Hkv;
  const int r0 = blockIdx.z * kRows;
  const int R = min(kRows, C * g - r0);
  const Smem s = carve(smem, kRows, hd);
  // row r of the tile is token c = (r0 + r) / g, head kvh * g + (r0 + r) % g
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd, row = r0 + r;
    const int64_t head = ((int64_t)b * C + row / g) * H + kvh * g + row % g;
    s.q[i] = to_float(q[head * hd + d]);
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
    s.pos[r] = positions[(int64_t)b * C + (r0 + r) / g];
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // visible length of this tile: max position + 1
    int mx = threadIdx.x < R ? s.pos[threadIdx.x] : 0;
    for (int o = 16; o; o >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x == 0) k_len = min(mx + 1, W * page);
  }
  __syncthreads();
  const int64_t tok_stride = (int64_t)Hkv * hd;
  const int64_t row_stride = (int64_t)page * tok_stride;
  const PagedAddr addr{block_table + (int64_t)b * W, page, row_stride,
                       tok_stride};
  attend<T>(s, R, hd, scale, k_len, kp + (int64_t)kvh * hd,
            vp + (int64_t)kvh * hd, addr);
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd, row = r0 + r;
    const int64_t head = ((int64_t)b * C + row / g) * H + kvh * g + row % g;
    store(out + head * hd + d, s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* positions, const void* kp,
           const void* vp, const void* bt, void* out, int B, int C, int H,
           int Hkv, int hd, int page, int W, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kRows, hd);
  cudaError_t err = allow_smem(chunk_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (C * (H / Hkv) + kRows - 1) / kRows;
  chunk_prefill_kernel<T><<<dim3(B, Hkv, tiles), kThreads, smem, stream>>>(
      (const T*)q, (const int32_t*)positions, (const T*)kp, (const T*)vp,
      (const int32_t*)bt, (T*)out, C, H, Hkv, hd, page, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro_paged

// dtype: 0 = float32, 1 = bfloat16. scale is the score scale, hd ** -0.5.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_chunk_prefill_attention(
    int dtype, const void* q, const void* positions, const void* kp,
    const void* vp, const void* block_table, void* out, int B, int C, int H,
    int Hkv, int hd, int page, int W, float scale, void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, positions, kp, vp, block_table, out, B, C, H,
                         Hkv, hd, page, W, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, positions, kp, vp, block_table, out, B,
                                 C, H, Hkv, hd, page, W, scale, st);
  return (int)cudaErrorInvalidValue;
}
