// Chunked-prefill attention over the paged KV arena for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/chunk_prefill.py
// (chunk_prefill_attention, body _chunk_kernel): a fixed-width chunk of C
// query tokens per sequence attends to everything already written to its
// pages (earlier chunks and its own K/V, scattered in by the caller) under
// a causal mask on absolute positions. Pad columns repeat position 0 and
// stay finite: key 0 is always visible to them. Both variants read the
// layer slice of the [L, rows, page, Hkv, hd] plane in place and walk key
// positions only up to the largest position among their rows plus one —
// the Pallas kernel's max(positions) + 1 narrowed to the block; the keys
// skipped are masked for every row of the block, so the result is the
// same.
//
// Bound on the H100: the chunk's score and value products (4 * C * H * hd
// flops per visible key); the bytes of K/V read are small beside them. Only
// the tensor cores reach that rate, so the launcher picks between two
// variants by (dtype, hd, page) alone:
//
// * wgmma (bf16, hd 64 or 128, page 8, 16, 32 or 64): flash's tile loop
//   (attend_wgmma.cuh) with paged K/V. One block per (sequence, query head,
//   128 chunk rows); a K/V tile of 64 keys is 64 / page TMA boxes, one per
//   page, over a 3-D map of the layer slice [n_rows, page, Hkv * hd]. A
//   page is a whole number of 8-row swizzle atoms, so the boxes stack into
//   the same layout as one dense box. The producer reads each tile's plane
//   rows from the block table one tile ahead; pages past the visible length
//   are aimed past the map's edge and arrive as zeros. Row positions come
//   from `positions`, staged in shared memory, so the visible length, the
//   tiles a warpgroup skips and those it masks are all decided on the
//   device (no host read of positions).
// * simt (f32, other widths and pages): the CUDA-core tile loop of
//   paged_common.cuh. One block per (sequence, kv head, tile of 32 of the
//   C * g rows), rows regrouped per kv head as [C * g] (row c * g + j is
//   head kvh * g + j of token c), so K/V are never repeated; f32 products
//   stay exact.
#include "attend_wgmma.cuh"
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

template <int HD>
int launch_wgmma(const void* q, const void* positions, const void* kp,
                 const void* vp, const void* bt, void* out, int B, int C,
                 int H, int Hkv, int page, int W, int n_rows, float scale,
                 cudaStream_t stream) {
  using namespace repro_attend;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, enc, q, B, C, H * HD, kBM) ||
      !tensor_map(&tk, enc, kp, n_rows, page, Hkv * HD, page) ||
      !tensor_map(&tv, enc, vp, n_rows, page, Hkv * HD, page))
    return (int)cudaErrorInvalidValue;
  const PagedKV src{(const int32_t*)positions, (const int32_t*)bt, C, W,
                    page, n_rows};
  return launch_attend<HD>(tq, tk, tv, out, nullptr, B, C, H, Hkv, scale,
                           src, stream);
}

}  // namespace repro_paged

// 1 when (dtype, hd, page) takes the wgmma variant, 0 for the simt one.
extern "C" int repro_chunk_prefill_variant(int dtype, int hd, int page) {
  return dtype == 1 && (hd == 64 || hd == 128) &&
                 (page == 8 || page == 16 || page == 32 || page == 64)
             ? 1
             : 0;
}

// dtype: 0 = float32, 1 = bfloat16. n_rows is the plane's row count (the
// pages' first dimension). scale is the score scale, hd ** -0.5. The wgmma
// variant takes q, the pages and out 16-byte aligned. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_chunk_prefill_attention(
    int dtype, const void* q, const void* positions, const void* kp,
    const void* vp, const void* block_table, void* out, int B, int C, int H,
    int Hkv, int hd, int page, int W, int n_rows, float scale, void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (repro_chunk_prefill_variant(dtype, hd, page)) {
    if (hd == 64)
      return launch_wgmma<64>(q, positions, kp, vp, block_table, out, B, C,
                              H, Hkv, page, W, n_rows, scale, st);
    return launch_wgmma<128>(q, positions, kp, vp, block_table, out, B, C, H,
                             Hkv, page, W, n_rows, scale, st);
  }
  if (dtype == 0)
    return launch<float>(q, positions, kp, vp, block_table, out, B, C, H,
                         Hkv, hd, page, W, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, positions, kp, vp, block_table, out, B,
                                 C, H, Hkv, hd, page, W, scale, st);
  return (int)cudaErrorInvalidValue;
}
