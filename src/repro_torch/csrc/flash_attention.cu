// Dense (contiguous K/V) softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel): q [B, Sq, H, hd] attends to
// k/v [B, Sk, Hkv, hd], causal (query i sees keys j <= i, top-left
// aligned) or not, GQA by h // (H / Hkv) so K/V are never repeated, f32
// online softmax, tiles above the diagonal skipped. The Pallas kernel
// asserts Sq % bq == 0 and Sk % bk == 0; here any lengths are taken and the
// ragged last tile is masked instead.
//
// Bound on the H100: the score and value products, 4 * hd flops per
// visible (query, key) pair and head; the bytes of q/k/v/out are small
// beside them at prompt lengths. Only the tensor cores reach that rate, so
// the launcher picks between two variants by (dtype, hd) alone:
//
// * wgmma (bf16, hd 64 or 128): the FlashAttention-3-shaped tile loop of
//   attend_wgmma.cuh with dense K/V (3-D tensor maps over
//   [B, S, heads * hd]; keys past Sk arrive as zeros and are masked), a
//   row's position its index when causal: only the diagonal and the
//   ragged last tile are masked, and tiles above a warpgroup's diagonal
//   are skipped.
// * simt (f32, other widths): the CUDA-core tile loop of the paged kernels
//   (paged_common.cuh), addressed contiguously. One block per (sequence,
//   kv head, tile of 32 of the Sq * g query rows), rows regrouped per kv
//   head as row c * g + j = head kvh * g + j of token c. It keeps f32
//   products exact (TF32 would not), for the f32 models and checks.
//
// Both variants optionally write each row's log-sum-exp, lse [B, H, Sq]
// f32: the natural log of the softmax denominator in the scaled-score
// domain (row max plus log of the row sum), which the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from. Training
// passes it; serving passes null and its outputs are unchanged.
#include "attend_wgmma.cuh"
#include "paged_common.cuh"

namespace repro_paged {

// ------------------------------------------------------------------ simt
constexpr int kRows = 32;  // query rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H,
                           int Hkv, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, g = H / Hkv;
  const int r0 = blockIdx.z * kRows;
  const int R = min(kRows, Sq * g - r0);
  const Smem s = carve(smem, kRows, hd);
  // row r of the tile is token c = (r0 + r) / g, head kvh * g + (r0 + r) % g
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd, row = r0 + r;
    const int64_t head = ((int64_t)b * Sq + row / g) * H + kvh * g + row % g;
    s.q[i] = to_float(q[head * hd + d]);
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
    s.pos[r] = causal ? (r0 + r) / g : Sk - 1;
  }
  __syncthreads();
  // rows ascend by token, so the last row sees the most keys
  const int k_len = causal ? min((r0 + R - 1) / g + 1, Sk) : Sk;
  const int64_t tok_stride = (int64_t)Hkv * hd;
  const int64_t seq_off = (int64_t)b * Sk * tok_stride + (int64_t)kvh * hd;
  attend<T>(s, R, hd, scale, k_len, k + seq_off, v + seq_off,
            DenseAddr{tok_stride});
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd, row = r0 + r;
    const int64_t head = ((int64_t)b * Sq + row / g) * H + kvh * g + row % g;
    store(out + head * hd + d, s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
  if (lse == nullptr) return;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int row = r0 + r;
    lse[((int64_t)b * H + kvh * g + row % g) * Sq + row / g] =
        s.m[r] + logf(fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int Hkv, int hd,
                int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kRows, hd);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Sq * (H / Hkv) + kRows - 1) / kRows;
  flash_attention_kernel<T><<<dim3(B, Hkv, tiles), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq, Sk, H, Hkv,
      hd, causal, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- wgmma
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Sk, int H, int Hkv,
                 int causal, float scale, cudaStream_t stream) {
  using namespace repro_attend;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, enc, q, B, Sq, H * HD, kBM) ||
      !tensor_map(&tk, enc, k, B, Sk, Hkv * HD, kBN) ||
      !tensor_map(&tv, enc, v, B, Sk, Hkv * HD, kBN))
    return (int)cudaErrorInvalidValue;
  return launch_attend<HD>(tq, tk, tv, out, lse, B, Sq, H, Hkv, scale,
                           DenseKV{Sk, causal}, stream);
}

}  // namespace repro_paged

// 1 when (dtype, hd) takes the wgmma variant, 0 for the simt one.
extern "C" int repro_flash_attention_variant(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1. scale is the score
// scale, hd ** -0.5. q/k/v/out 16-byte aligned. lse: [B, H, Sq] float32
// row log-sum-exp output, or null. Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int Sq, int Sk, int H, int Hkv,
                                     int hd, int causal, float scale,
                                     void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (repro_flash_attention_variant(dtype, hd)) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal,
                              scale, st);
    return launch_wgmma<128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal,
                             scale, st);
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, hd,
                              causal, scale, st);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, Hkv,
                                      hd, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
