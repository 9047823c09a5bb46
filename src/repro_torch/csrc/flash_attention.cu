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
// * wgmma (bf16, hd 64 or 128): a FlashAttention-3-shaped tile loop. A
//   block owns 128 query rows of one (sequence, query head): two consumer
//   warpgroups of 64 rows and one producer warp. The producer loads the
//   block's Q once and K/V tiles of 64 keys into a 2-stage ring with TMA
//   (3-D tensor maps over [B, S, heads * hd], 128-byte swizzle, the layout
//   wgmma reads; keys past Sk arrive as zeros), completion on mbarriers,
//   and refills a stage as soon as both warpgroups release it. Each
//   warpgroup computes S = Q K^T with wgmma m64n64k16 (bf16 in, f32 in
//   registers), masks only the diagonal and the ragged last tile with
//   -1e30, runs the online softmax in registers with exp2 and the scale
//   folded in, converts P to bf16 in registers (the Pallas kernel's
//   p.astype(v.dtype)) and feeds it as the A operand of the P V wgmma, V
//   read from shared memory as an MN-major operand. Tiles above a
//   warpgroup's diagonal are skipped, and the grid issues the last (most
//   expensive) causal query tiles first so the tail of the grid is short.
// * simt (f32, other widths): the CUDA-core tile loop of the paged kernels
//   (paged_common.cuh), addressed contiguously. One block per (sequence,
//   kv head, tile of 32 of the Sq * g query rows), rows regrouped per kv
//   head as row c * g + j = head kvh * g + j of token c. It keeps f32
//   products exact (TF32 would not), for the f32 models and checks.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda
#include "paged_common.cuh"

namespace repro_paged {

// ------------------------------------------------------------------ simt
constexpr int kRows = 32;  // query rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int Hkv, int hd, int causal,
                           float scale) {
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
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int H, int Hkv, int hd, int causal,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kRows, hd);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Sq * (H / Hkv) + kRows - 1) / kRows;
  flash_attention_kernel<T><<<dim3(B, Hkv, tiles), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, Hkv, hd,
      causal, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- wgmma
constexpr int kBM = 128;          // query rows per block (2 warpgroups)
constexpr int kBN = 64;           // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 32;  // + one producer warp
constexpr int kSwzRow = 128;      // bytes per swizzled row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose base
// is 1024-byte aligned (plus a k offset inside the 128-byte row). Both
// strides are 1024 B, one swizzle atom of 8 rows: the stride between 8-row
// groups (the only one a K-major tile or a 64-wide MN-major tile uses).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
struct WgLayout {
  static constexpr int kHalves = HD / 64;  // 64-column swizzled blocks
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or V tile
  static constexpr int kBars = 2 * kStages + 1;    // full, empty, q
  static constexpr size_t kSmem =
      1024 /* alignment slack */ + kQBytes + 2 * kStages * kTileBytes +
      8 * kBars;
};

// Accumulator layout of a wgmma m64nN tile (and of S, P): thread t of the
// warpgroup holds, for each 8-column block nb, registers 4 nb + 2 i + j at
// row 16 (t / 32) + (t % 32) / 4 + 8 i, column 8 nb + 2 (t % 4) + j. The
// registers of S for keys 16 j .. 16 j + 15 are, in order, the A fragment
// of the P V product's k-step j.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ out, int B,
                                 int Sq, int Sk, int H, int Hkv, int causal,
                                 float scale_log2) {
  using L = WgLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_u32(base);
  const uint32_t skv = sq + L::kQBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + L::kQBytes + 2 * kStages *
                                                          L::kTileBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;

  // the last query tiles (most keys when causal) first
  const int nqt = (Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nqt - 1 - blockIdx.x / (B * H)) * kBM;
  const int b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int k_len = causal ? min(q0 + kBM, Sk) : Sk;
  const int n_kt = (k_len + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ---- producer warp: one thread loads
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load(sq + c * kBM * kSwzRow, &tq, qbar, h * HD + c * 64, q0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
        const uint32_t kd = skv + 2 * s * L::kTileBytes;
        for (int c = 0; c < L::kHalves; ++c) {
          tma_load(kd + c * kBN * kSwzRow, &tk, full0 + 8 * s,
                   kvh * HD + c * 64, t * kBN, b);
          tma_load(kd + L::kTileBytes + c * kBN * kSwzRow, &tv,
                   full0 + 8 * s, kvh * HD + c * 64, t * kBN, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * (t128 / 32) + lane / 4;  // and +8
  const int col0 = 2 * (lane % 4);
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
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= q0 + 64 * wg + 63) {
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
      const bool edge =
          k0 + kBN > Sk || (causal && k0 + kBN - 1 > q0 + 64 * wg);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        float x = sc[e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * (e >> 2) + col0 + (e & 1);
          if (key >= Sk || (causal && key > row0 + 8 * i)) x = kNegInf;
        }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, rows, cols] tensor as boxes of [1, box_rows, 64] with the
// 128-byte swizzle; elements past the tensor's edge load as zeros.
static bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                       int batch, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int Hkv, int causal,
                 float scale, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, enc, q, B, Sq, H * HD, kBM) ||
      !tensor_map(&tk, enc, k, B, Sk, Hkv * HD, kBN) ||
      !tensor_map(&tv, enc, v, B, Sk, Hkv * HD, kBN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = WgLayout<HD>::kSmem;
  cudaError_t err = allow_smem(flash_attention_wgmma_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * H * ((Sq + kBM - 1) / kBM);
  flash_attention_wgmma_kernel<HD><<<blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, B, Sq, Sk, H, Hkv, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace repro_paged

// 1 when (dtype, hd) takes the wgmma variant, 0 for the simt one.
extern "C" int repro_flash_attention_variant(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1. scale is the score
// scale, hd ** -0.5. q/k/v/out 16-byte aligned. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int Hkv, int hd,
                                     int causal, float scale, void* stream) {
  using namespace repro_paged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (repro_flash_attention_variant(dtype, hd)) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                              st);
    return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                             st);
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, causal,
                              scale, st);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd,
                                      causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
