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
// VMEM scratch and drops (the engine needs it for decode).
//
// Design: one block per (sequence, head), walking the chunks in order with
// the f32 state [N][P] resident in shared memory (the TPU's sequential grid
// axis becomes this loop). Each chunk's B, C, x * dt, the cumsum and the
// masked score matrix G [Q][Q] are staged in shared memory as f32. The
// chunk length Q is fixed (at most 64) and the last chunk is ragged, where
// the Pallas kernel shrinks Q to the largest divisor of S: the same
// function up to rounding, without a prime S degrading to Q = 1. Scores
// above the diagonal are set to 0 without evaluating exp (cs_q - cs_k > 0
// there and exp would overflow; inf * 0 is NaN). The state update runs only
// after the whole chunk's y is written.
//
// Bound on the H100: the bytes of x, B, C, y (B and C head-broadcast) at
// prompt lengths; this f32 CUDA-core version with B * H blocks (80 for one
// mamba2-2.7b prompt, fewer than the 132 SMs) runs well above it. Tensor
// cores, a head split over more blocks and pipelined loads are later work.
#include "paged_common.cuh"  // to_float, store, allow_smem, kThreads

namespace repro_ssd {

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
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state_out, int B, int S, int H,
           int P, int N, int Q, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxChunk) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, N, P);
  const cudaError_t err = allow_smem(ssd_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)state_out, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace repro_ssd

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are float32.
// Q is the chunk length, 1..64. Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_ssd_chunk(int dtype, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* state_out, int B, int S, int H,
                               int P, int N, int Q, void* stream) {
  using namespace repro_ssd;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state_out, B, S, H, P, N, Q,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_out, B, S, H, P,
                                 N, Q, st);
  return (int)cudaErrorInvalidValue;
}
