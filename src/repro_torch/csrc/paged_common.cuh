// Shared CUDA-core tile loop of the prefill attention kernels (the simt
// variants of chunk_prefill.cu and flash_attention.cu); every kernel takes
// its dtype helpers and shared-memory opt-in.
//
// A block owns R query rows that all read one sequence's keys of one kv
// head. Keys are walked in tiles of kTile positions; an address functor
// maps position t to its offset: through a block table for the chunk
// kernel (plane row block_table[t / page], offset t % page), t times the
// token stride for contiguous K/V. Each tile is staged in shared memory
// as f32, scored against the R rows, and folded into an f32 online softmax
// (running max m, running sum l and the accumulator acc, all in shared
// memory). A key is visible to a row when
// its position is <= the row's position; masked scores take -1e30, the
// Pallas kernels' constant.
//
// Plain C++ on CUDA cores, f32 throughout: the tiles are staged with
// scalar loads and scored with fmaf, so a long chunk is bound by this f32
// arithmetic, far below the tensor cores' bf16 rate. The bf16 variants of
// flash and of the chunk kernel (attend_wgmma.cuh) and the split decode
// kernel do not use it; the f32 paths and the widths the wgmma loop does
// not take keep it: their products stay exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_paged {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;      // key positions per tile: one per lane
constexpr int kThreads = 256;  // threads per block (8 warps)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared-memory layout, in 4-byte words, for R rows of width hd.
struct Smem {
  float* q;      // [R][hd]
  float* acc;    // [R][hd]
  float* k;      // [kTile][hd + 1]: padded so a warp scoring 32 keys at one
                 // d hits 32 banks
  float* v;      // [kTile][hd]
  float* p;      // [R][kTile] scores, then probabilities
  float* m;      // [R] running max
  float* l;      // [R] running sum
  float* alpha;  // [R] rescale of the current tile
  int* pos;      // [R] absolute position of each row
};

inline size_t smem_bytes(int R, int hd) {
  return 4 * (2 * (size_t)R * hd + (size_t)kTile * (hd + 1) +
              (size_t)kTile * hd + (size_t)R * kTile + 4 * (size_t)R);
}

__device__ inline Smem carve(float* base, int R, int hd) {
  Smem s;
  s.q = base;
  s.acc = s.q + R * hd;
  s.k = s.acc + R * hd;
  s.v = s.k + kTile * (hd + 1);
  s.p = s.v + kTile * hd;
  s.m = s.p + R * kTile;
  s.l = s.m + R;
  s.alpha = s.l + R;
  s.pos = reinterpret_cast<int*>(s.alpha + R);
  return s;
}

// Position t of a sequence in the paged plane: row bt[t / page], offset
// t % page (bt is this sequence's block-table row).
struct PagedAddr {
  const int32_t* bt;
  int page;
  int64_t row_stride, tok_stride;
  __device__ __forceinline__ int64_t operator()(int t) const {
    return (int64_t)bt[t / page] * row_stride +
           (int64_t)(t % page) * tok_stride;
  }
};

// Position t of a contiguous [S, Hkv, hd] sequence.
struct DenseAddr {
  int64_t tok_stride;
  __device__ __forceinline__ int64_t operator()(int t) const {
    return (int64_t)t * tok_stride;
  }
};

// Folds key positions [0, k_len) into the R rows' online softmax. On entry
// s.q, s.pos, s.m (= kNegInf), s.l (= 0) and s.acc (= 0) are set and
// synchronised. kp/vp point at this kv head's first element of position 0's
// addressing origin (for the paged plane: plane row 0 of the layer slice,
// plus kvh * hd); addr(t) is position t's offset from there.
template <typename T, typename Addr>
__device__ void attend(const Smem& s, int R, int hd, float scale, int k_len,
                       const T* __restrict__ kp, const T* __restrict__ vp,
                       Addr addr) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  for (int t0 = 0; t0 < k_len; t0 += kTile) {
    const int n = min(kTile, k_len - t0);
    // 1. stage K/V of n positions (consecutive threads, consecutive d)
    for (int i = tid; i < n * hd; i += nthr) {
      const int t = i / hd, d = i - t * hd;
      const int64_t off = addr(t0 + t) + d;
      s.k[t * (hd + 1) + d] = to_float(kp[off]);
      s.v[t * hd + d] = to_float(vp[off]);
    }
    __syncthreads();
    // 2. scores [R][n]
    for (int i = tid; i < R * n; i += nthr) {
      const int r = i / n, t = i - r * n;
      const float* qr = s.q + r * hd;
      const float* kr = s.k + t * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      s.p[r * kTile + t] = (t0 + t <= s.pos[r]) ? dot * scale : kNegInf;
    }
    __syncthreads();
    // 3. online softmax, one warp per row, one key per lane
    for (int r = warp; r < R; r += nwarp) {
      const float x = lane < n ? s.p[r * kTile + lane] : kNegInf;
      float mx = x;
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float e = lane < n ? expf(x - m_new) : 0.f;
      float sum = e;
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s.p[r * kTile + lane] = e;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + p @ V
    for (int i = tid; i < R * hd; i += nthr) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = s.p + r * kTile;
      float a = s.acc[i] * s.alpha[r];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], s.v[t * hd + d], a);
      s.acc[i] = a;
    }
    __syncthreads();
  }
}

// Raises the block's dynamic shared-memory limit past the 48 KB default
// when a launch needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro_paged
