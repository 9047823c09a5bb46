// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py (ssd_chunk,
// body _ssd_kernel). Per head, the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ,  y_t = C_t . h_t
// is computed chunk by chunk: within a chunk the output is the masked
// quadratic term (C B^T o L) (x dt) with L[q][k] = exp(cs_q - cs_k) for
// k <= q (cs the inclusive cumsum of dt A), plus the carried state's term
// exp(cs_q) C_q . state; then the state moves to the chunk's end. Inputs:
// x [B, S, H, P] and B/C [B, S, H, N] (head-broadcast) in one dtype, dt
// [B, S, H] (post-softplus) and A [H] (negative) in f32. Outputs: y like x,
// and the final state [B, H, N, P] in f32, which the Pallas kernel keeps in
// VMEM scratch and drops (the engine needs it for decode). The chunk
// length Q is fixed (at most 64) and the last chunk is ragged, where the
// Pallas kernel shrinks Q to the largest divisor of S: the same function
// up to rounding, without a prime S degrading to Q = 1. Scores above the
// diagonal are set to 0 without evaluating exp (cs_q - cs_k > 0 there and
// exp could overflow; inf * 0 is NaN).
//
// Bound on the H100: the bytes of x, B, C, y (B and C head-broadcast) at
// prompt lengths. One block per (sequence, head) walks the chunks in order
// with the state resident (the TPU's sequential grid axis becomes this
// loop, and no state goes through device memory between chunks): for one
// prompt that is 80 blocks on 132 SMs, each a chain of dependent chunks.
// The launcher picks between two variants by (dtype, N, P, Q) alone:
//
// * wgmma (bf16, N and P 64 or 128, Q = 64): one producer warp, one y
//   warpgroup and one state warpgroup per 64 columns of P. The producer
//   loads each chunk's C, B [64][N] and x [64][P] with TMA into a 2-stage
//   ring (128-byte swizzle, 64-column boxes, rows past S as zeros), reads
//   dt, and writes the chunk's cumsum of dt A (a warp scan, in log2
//   units), the decay-to-end weights w_k = dt_k exp(cs_end - cs_k) and
//   exp(cs) into the stage; padded rows carry dt = 0, so their weight is
//   0, their decay 1, and cs_end is the last real row's. All products run
//   on wgmma m64n64k16 (bf16 operands, f32 sums):
//     state warpgroup:  state^T = exp(cs_end) state^T + (x o w)^T B
//                       ((x o w)^T from registers, B MN-major), the state
//                       transposed, [64 p][N], kept as f32 accumulators
//                       and written in bf16 to a 2-buffer ring in shared
//                       memory after each chunk;
//     y warpgroup:      G = C B^T (C and B K-major),
//                       y = exp(cs_q) C state (the ring's previous state,
//                       a K-major operand),
//                       y += (G o L o dt) x (from registers; x MN-major).
//   The two run side by side, the state warpgroup up to one chunk ahead,
//   so a chunk costs the longer of the two chains, not their sum.
//   G o L o dt and x o w are f32 values; each goes in as two bf16
//   operands, hi = bf16(v) and lo = bf16(v - hi), into the same
//   accumulator, so the state keeps f32 accuracy (one bf16 rounding of
//   x o w alone leaves ~2e-3 of the state's magnitude) and y little more
//   than its output rounding.
// * simt (f32, other widths and chunk lengths): the CUDA-core loop. The f32
//   state [N][P] lives in shared memory; each chunk's B, C, x * dt, the
//   cumsum and the masked score matrix G [Q][Q] are staged there as f32,
//   and the state update runs only after the whole chunk's y is written.
#include "hopper.cuh"
#include "paged_common.cuh"  // to_float, store, allow_smem, kThreads

namespace repro_ssd {

// ------------------------------------------------------------------ simt
using repro_paged::allow_smem;
using repro_paged::kThreads;
using repro_paged::store;
using repro_paged::to_float;

constexpr int kMaxChunk = 64;

// Shared memory, in floats: state [N][P], B and C [Q][N + 1] (padded so a
// warp reading 32 rows at one column hits 32 banks), x * dt [Q][P],
// G [Q][Q + 1], cumsum [Q], dt then decay-to-end [Q].
inline size_t smem_bytes(int Q, int N, int P) {
  return 4 * ((size_t)N * P + 2 * (size_t)Q * (N + 1) + (size_t)Q * P +
              (size_t)Q * (Q + 1) + 2 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, T* __restrict__ y,
                     float* __restrict__ state_out, int S, int H, int P,
                     int N, int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NB = N + 1, QG = Q + 1;
  float* st = smem;             // [N][P]
  float* sb = st + N * P;       // [Q][NB]
  float* sc = sb + Q * NB;      // [Q][NB]
  float* sx = sc + Q * NB;      // [Q][P]  x * dt
  float* sg = sx + Q * P;       // [Q][QG] masked, decayed C B^T
  float* cs = sg + Q * QG;      // [Q]     inclusive cumsum of dt * A
  float* sd = cs + Q;           // [Q]     dt, then exp(cs_end - cs_k)
  const float a = A[h];
  const int64_t x_tok = (int64_t)H * P, bc_tok = (int64_t)H * N;
  for (int i = tid; i < N * P; i += nthr) st[i] = 0.f;
  for (int c0 = 0; c0 < S; c0 += Q) {
    const int n = min(Q, S - c0);
    const int64_t tok0 = (int64_t)b * S + c0;
    // 1. stage dt, then the cumsum, B, C and x * dt
    for (int t = tid; t < n; t += nthr) sd[t] = dt[(tok0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < n; ++t) {
        acc += sd[t] * a;
        cs[t] = acc;
      }
    }
    for (int i = tid; i < n * N; i += nthr) {
      const int t = i / N, j = i - t * N;
      const int64_t off = (tok0 + t) * bc_tok + (int64_t)h * N + j;
      sb[t * NB + j] = to_float(Bm[off]);
      sc[t * NB + j] = to_float(Cm[off]);
    }
    for (int i = tid; i < n * P; i += nthr) {
      const int t = i / P, p = i - t * P;
      sx[i] = to_float(x[(tok0 + t) * x_tok + (int64_t)h * P + p]) * sd[t];
    }
    __syncthreads();
    // 2. G[q][k] = (C_q . B_k) exp(cs_q - cs_k) for k <= q, 0 above the
    //    diagonal (masked before exp)
    for (int i = tid; i < n * n; i += nthr) {
      const int q = i / n, k = i - q * n;
      float g = 0.f;
      if (k <= q) {
        const float* cq = sc + q * NB;
        const float* bk = sb + k * NB;
        float dot = 0.f;
        for (int j = 0; j < N; ++j) dot = fmaf(cq[j], bk[j], dot);
        g = dot * expf(cs[q] - cs[k]);
      }
      sg[q * QG + k] = g;
    }
    __syncthreads();
    // 3. y[q][p] = sum_{k<=q} G[q][k] xdt[k][p]
    //            + exp(cs_q) sum_j C[q][j] state[j][p]
    for (int i = tid; i < n * P; i += nthr) {
      const int q = i / P, p = i - q * P;
      const float* gq = sg + q * QG;
      float intra = 0.f;
      for (int k = 0; k <= q; ++k) intra = fmaf(gq[k], sx[k * P + p], intra);
      const float* cq = sc + q * NB;
      float inter = 0.f;
      for (int j = 0; j < N; ++j) inter = fmaf(cq[j], st[j * P + p], inter);
      store(y + (tok0 + q) * x_tok + (int64_t)h * P + p,
            intra + expf(cs[q]) * inter);
    }
    for (int t = tid; t < n; t += nthr) sd[t] = expf(cs[n - 1] - cs[t]);
    __syncthreads();
    // 4. state = exp(cs_end) state + sum_k exp(cs_end - cs_k) B_k^T xdt_k
    const float e_end = expf(cs[n - 1]);
    for (int i = tid; i < N * P; i += nthr) {
      const int j = i / P, p = i - j * P;
      float acc = 0.f;
      for (int k = 0; k < n; ++k)
        acc = fmaf(sb[k * NB + j] * sd[k], sx[k * P + p], acc);
      st[i] = st[i] * e_end + acc;
    }
    __syncthreads();
  }
  float* so = state_out + ((int64_t)b * H + h) * N * P;
  for (int i = tid; i < N * P; i += nthr) so[i] = st[i];
}

template <typename T>
int launch_simt(const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, void* y, void* state_out,
                int B, int S, int H, int P, int N, int Q,
                cudaStream_t stream) {
  if (Q < 1 || Q > kMaxChunk) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, N, P);
  const cudaError_t err = allow_smem(ssd_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)state_out, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- wgmma
using namespace repro_hopper;

constexpr int kQ = 64;        // chunk length of the wgmma variant
constexpr int kStages = 2;    // chunk ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Per token of a stage: dt, the cumsum of dt A in log2 units, the weight
// w = dt exp(cs_end - cs) and exp(cs); then one more for exp(cs_end).
constexpr int kScalBytes = (kQ + 1) * 16;

template <int N, int P>
struct SsdLayout {
  static constexpr int kNH = N / 64;  // 64-column boxes of C and B
  static constexpr int kWG = P / 64;  // 64-column slices of x, y, state
  // one y warpgroup, one state warpgroup per slice, one producer warp
  static constexpr int kConsumers = (1 + kWG) * 128;
  static constexpr int kThreads = kConsumers + 32;
  // one stage: C boxes, B boxes, x boxes (one per slice)
  static constexpr int kTile = (2 * kNH + kWG) * kBoxBytes;
  static constexpr int kState = kWG * kNH * kBoxBytes;  // bf16 state^T
  static constexpr int kBars = 2 * kStages + 4;  // full, empty, state ring
  static constexpr size_t kSmem = 1024 /* alignment slack */ +
                                  kStages * kTile + 2 * kState +
                                  kStages * kScalBytes + 8 * kBars;
};

// v0, v1 (adjacent columns) as two bf16 pairs whose sum is v to ~2^-17.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// The state ring: buffer j holds the bf16 state after chunks t = j mod 2
// (buffer 1 first holds the zero state of chunk 0); the state warpgroups
// fill it (sfull) and the y warpgroup frees it after its y = C state
// product of chunk t + 1 (sempty).
template <int N, int P>
__global__ void __launch_bounds__(SsdLayout<N, P>::kThreads, 1)
    ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tc,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tx,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           __nv_bfloat16* __restrict__ y,
                           float* __restrict__ state_out, int S, int H) {
  using L = SsdLayout<N, P>;
  constexpr int kNH = L::kNH, kWG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles = smem_u32(base);  // stage s at s * kTile
  uint8_t* ring = base + kStages * L::kTile;  // buffer j at j * kState
  float4* scal = reinterpret_cast<float4*>(ring + 2 * L::kState);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 2 * L::kState +
                                  kStages * kScalBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const uint32_t sfull0 = empty0 + 8 * kStages, sempty0 = sfull0 + 16;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int n_chunks = (S + kQ - 1) / kQ;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA's bytes + 32 lanes' dt
      mbar_init(empty0 + 8 * s, L::kConsumers / 32);  // every consumer warp
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(sfull0 + 8 * j, kWG * 128);  // every state thread
      mbar_init(sempty0 + 8 * j, 4);         // the y warps
    }
    mbar_init_fence();
  }
  // ring buffer 1 starts as the zero state the first chunk's y reads
  for (int i = threadIdx.x; i < L::kState / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(ring + L::kState)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {  // ---- producer warp
    const float a = A[h] * kLog2e;
    const int64_t tok0 = (int64_t)b * S;
    for (int t = 0; t < n_chunks; ++t) {
      const int s = t % kStages, c0 = t * kQ;
      // this lane's two tokens; past S, dt = 0: weight 0, decay 1
      const int k = 2 * lane;
      const float d0 = c0 + k < S ? dt[(tok0 + c0 + k) * H + h] : 0.f;
      const float d1 = c0 + k + 1 < S ? dt[(tok0 + c0 + k + 1) * H + h] : 0.f;
      mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t ct = tiles + s * L::kTile;
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, L::kTile);
        for (int c = 0; c < kNH; ++c) {
          tma_load(ct + c * kBoxBytes, &tc, bar, h * N + c * 64, c0, b);
          tma_load(ct + (kNH + c) * kBoxBytes, &tb, bar, h * N + c * 64, c0,
                   b);
        }
        for (int w = 0; w < kWG; ++w)
          tma_load(ct + (2 * kNH + w) * kBoxBytes, &tx, bar, h * P + w * 64,
                   c0, b);
      }
      // inclusive cumsum of dt A (log2 units) over the chunk: a scan of
      // token pairs
      const float a0 = d0 * a, a1 = d1 * a;
      float inc = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const float cs0 = inc - a1, cs1 = inc;
      const float cend = __shfl_sync(0xffffffffu, inc, 31);
      float4* sc = scal + s * (kQ + 1);
      sc[k] = make_float4(d0, cs0, d0 * fast_exp2(cend - cs0),
                          fast_exp2(cs0));
      sc[k + 1] = make_float4(d1, cs1, d1 * fast_exp2(cend - cs1),
                              fast_exp2(cs1));
      if (lane == 0) sc[kQ].x = fast_exp2(cend);
      mbar_arrive(full0 + 8 * s);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int r0 = 16 * (t128 / 32) + lane / 4;  // accumulator rows r0, r0 + 8
  const int col0 = 2 * (lane % 4);
  // byte offsets of (row r0 + 8 i, column 8 nb + col0) in a swizzled box
  // are acc_off + 1024 i + ((nb ^ (r0 % 8)) << 4)
  const int acc_off = r0 * kSwzRow + col0 * 2, acc_sw = r0 % 8;

  if (wg == 0) {  // ---- y warpgroup: every 64-column slice of y
    // the last chunk's y in bf16, stored while the next chunk's first
    // products run
    uint32_t ypk[kWG][16];
    int c_prev = 0, n_prev = 0;
    auto store_y = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = r0 + 8 * i;
        if (q >= n_prev) continue;
        __nv_bfloat16* yrow =
            y + (((int64_t)b * S + c_prev + q) * H + h) * P + col0;
#pragma unroll
        for (int w = 0; w < kWG; ++w)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            *reinterpret_cast<uint32_t*>(yrow + 64 * w + 8 * nb) =
                ypk[w][2 * nb + i];
      }
    };
    for (int t = 0; t < n_chunks; ++t) {
      const int s = t % kStages, c0 = t * kQ;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);
      const uint32_t ct = tiles + s * L::kTile;  // C, then B, then x
      const uint32_t bt = ct + kNH * kBoxBytes;
      const uint32_t xt = bt + kNH * kBoxBytes;
      const float4* sc = scal + s * (kQ + 1);

      // 1. G = C B^T (one group), then y = C state with the state after
      //    chunk t - 1 (a second group), from ring buffer (t - 1) % 2
      float g[32], yv[kWG][32];
#pragma unroll
      for (int e = 0; e < 32; ++e) g[e] = 0.f;
      pin(g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(g, sw128_desc(ct + off), sw128_desc(bt + off), kk > 0);
      }
      wgmma_commit();
      const int j = (t + 1) & 1;  // (t - 1) % 2
      if (t > 0) mbar_wait(sfull0 + 8 * j, ((t - 1) >> 1) & 1);
      const uint32_t sd = smem_u32(ring) + j * L::kState;
#pragma unroll
      for (int e = 0; e < 32; ++e)
#pragma unroll
        for (int w = 0; w < kWG; ++w) yv[w][e] = 0.f;
#pragma unroll
      for (int w = 0; w < kWG; ++w) pin(yv[w]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
#pragma unroll
        for (int w = 0; w < kWG; ++w)
          wgmma_ss(yv[w], sw128_desc(ct + off),
                   sw128_desc(sd + w * kNH * kBoxBytes + off), kk > 0);
      }
      wgmma_commit();
      store_y();  // the previous chunk's rows, under the products
      wgmma_wait<1>();
      pin(g);

      // 2. G o L o dt below the diagonal (masked before exp), split hi + lo
      float csq[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) csq[i] = sc[r0 + 8 * i].y;
      uint32_t gh[16], gl[16];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int k = 8 * nb + col0;  // and k + 1
        const float4 k0 = sc[k], k1 = sc[k + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = r0 + 8 * i, e = 4 * nb + 2 * i;
          const float v0 =
              k <= q ? g[e] * fast_exp2(csq[i] - k0.y) * k0.x : 0.f;
          const float v1 =
              k + 1 <= q ? g[e + 1] * fast_exp2(csq[i] - k1.y) * k1.x : 0.f;
          split_bf16(v0, v1, gh[e / 2], gl[e / 2]);
        }
      }
      wgmma_wait0();
#pragma unroll
      for (int w = 0; w < kWG; ++w) pin(yv[w]);
      __syncwarp();  // the state buffer is read
      if (lane == 0) mbar_arrive(sempty0 + 8 * j);
      // y's rows times exp(cs_q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float eq = sc[r0 + 8 * i].w;
#pragma unroll
        for (int w = 0; w < kWG; ++w)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            yv[w][4 * nb + 2 * i] *= eq;
            yv[w][4 * nb + 2 * i + 1] *= eq;
          }
      }

      // 3. y += (G o L o dt) x, hi and lo parts
#pragma unroll
      for (int w = 0; w < kWG; ++w) pin(yv[w]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kQ / 16; ++jj)
#pragma unroll
        for (int w = 0; w < kWG; ++w) {
          const uint64_t xd =
              sw128_desc(xt + w * kBoxBytes + jj * 16 * kSwzRow);
          wgmma_rs(yv[w], gh + 4 * jj, xd);
          wgmma_rs(yv[w], gl + 4 * jj, xd);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int w = 0; w < kWG; ++w) pin(yv[w]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int w = 0; w < kWG; ++w)
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          ypk[w][e / 2] = pack_bf16(yv[w][e], yv[w][e + 1]);
      c_prev = c0;
      n_prev = min(kQ, S - c0);
    }
    store_y();
    return;
  }

  // ---- state warpgroup of slice w: state^T [p = 64 w + row][n], f32
  const int w = wg - 1;
  float st[kNH][32];
#pragma unroll
  for (int c = 0; c < kNH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) st[c][e] = 0.f;
  // x [64 k][64 p] in shared memory: (k = 8 nb + col0 + jj, p = r0 + 8 i)
  // lies at 1024 nb + x_off[i][jj]
  int x_off[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      x_off[i][jj] = swz128_offset(col0 + jj, r0 + 8 * i);

  for (int t = 0; t < n_chunks; ++t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t bt = tiles + s * L::kTile + kNH * kBoxBytes;  // B
    const uint8_t* xs = base + s * L::kTile + (2 * kNH + w) * kBoxBytes;
    const float4* sc = scal + s * (kQ + 1);

    // (x o w)^T [p][k] as the A operand, split hi + lo; the decay
    uint32_t xh[16], xl[16];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int k = 8 * nb + col0;
      const float w0 = sc[k].z, w1 = sc[k + 1].z;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* xr = xs + 1024 * nb;
        const float x0 = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(xr + x_off[i][0]));
        const float x1 = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(xr + x_off[i][1]));
        split_bf16(x0 * w0, x1 * w1, xh[2 * nb + i], xl[2 * nb + i]);
      }
    }
    const float e_end = sc[kQ].x;
#pragma unroll
    for (int c = 0; c < kNH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) st[c][e] *= e_end;

    // state^T = exp(cs_end) state^T + (x o w)^T B, hi and lo parts
#pragma unroll
    for (int c = 0; c < kNH; ++c) pin(st[c]);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kQ / 16; ++jj)
#pragma unroll
      for (int c = 0; c < kNH; ++c) {
        const uint64_t bd = sw128_desc(bt + c * kBoxBytes + jj * 16 * kSwzRow);
        wgmma_rs(st[c], xh + 4 * jj, bd);
        wgmma_rs(st[c], xl + 4 * jj, bd);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < kNH; ++c) pin(st[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    // the state in bf16 into ring buffer t % 2, for the y warpgroup's
    // chunk t + 1, once the y warpgroup's chunk t - 1 has read what the
    // buffer held: buffer 1 is freed at chunks 0, 2, 4, ... (the zero
    // state, then states 1, 3, ...), buffer 0 at chunks 1, 3, ...
    if (t + 1 < n_chunks) {
      const int j = t & 1;
      mbar_wait(sempty0 + 8 * j, ((t >> 1) & 1) ^ (j ^ 1));
      uint8_t* sb = ring + j * L::kState + w * kNH * kBoxBytes;
#pragma unroll
      for (int c = 0; c < kNH; ++c)
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          *reinterpret_cast<uint32_t*>(
              sb + c * kBoxBytes + acc_off + 1024 * ((e >> 1) & 1) +
              (((e >> 2) ^ acc_sw) << 4)) = pack_bf16(st[c][e], st[c][e + 1]);
      fence_async_smem();
      mbar_arrive(sfull0 + 8 * j);
    }
  }

  // the final state, [N][P] in f32
  float* so = state_out + ((int64_t)b * H + h) * N * P;
#pragma unroll
  for (int c = 0; c < kNH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int p = 64 * w + r0 + 8 * ((e >> 1) & 1);
      const int nn = 64 * c + 8 * (e >> 2) + col0 + (e & 1);
      so[(int64_t)nn * P + p] = st[c][e];
    }
}

template <int N, int P>
int launch_wgmma(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* state_out,
                 int B, int S, int H, cudaStream_t stream) {
  using L = SsdLayout<N, P>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tc, tb, tx;
  if (!tensor_map(&tc, enc, Cm, B, S, H * N, kQ) ||
      !tensor_map(&tb, enc, Bm, B, S, H * N, kQ) ||
      !tensor_map(&tx, enc, x, B, S, H * P, kQ))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(ssd_chunk_wgmma_kernel<N, P>, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_wgmma_kernel<N, P><<<B * H, L::kThreads, L::kSmem, stream>>>(
      tc, tb, tx, (const float*)dt, (const float*)A, (__nv_bfloat16*)y,
      (float*)state_out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace repro_ssd

// 1 when (dtype, N, P, Q) takes the wgmma variant, 0 for the simt one.
extern "C" int repro_ssd_chunk_variant(int dtype, int N, int P, int Q) {
  return dtype == 1 && (N == 64 || N == 128) && (P == 64 || P == 128) &&
                 Q == repro_ssd::kQ
             ? 1
             : 0;
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are float32.
// Q is the chunk length, 1..64. The wgmma variant takes x, B, C and y
// 16-byte aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_ssd_chunk(int dtype, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* state_out, int B, int S, int H,
                               int P, int N, int Q, void* stream) {
  using namespace repro_ssd;
  const cudaStream_t st = (cudaStream_t)stream;
  if (repro_ssd_chunk_variant(dtype, N, P, Q)) {
    if (N == 64 && P == 64)
      return launch_wgmma<64, 64>(x, dt, A, Bm, Cm, y, state_out, B, S, H,
                                  st);
    if (N == 64)
      return launch_wgmma<64, 128>(x, dt, A, Bm, Cm, y, state_out, B, S, H,
                                   st);
    if (P == 64)
      return launch_wgmma<128, 64>(x, dt, A, Bm, Cm, y, state_out, B, S, H,
                                   st);
    return launch_wgmma<128, 128>(x, dt, A, Bm, Cm, y, state_out, B, S, H,
                                  st);
  }
  if (dtype == 0)
    return launch_simt<float>(x, dt, A, Bm, Cm, y, state_out, B, S, H, P, N,
                              Q, st);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_out, B, S,
                                      H, P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
