// The backward of the Mamba2 SSD chunked scan (ssd_chunk.cu) for Hopper
// (sm_90a): given the forward's inputs x [B, S, H, P], dt [B, S, H] f32
// (post-softplus), A [H] f32 (negative), B/C [B, S, H, N] (head-broadcast),
// the output's gradient dy [B, S, H, P] and, optionally, the final state's
// gradient dstate [B, H, N, P] f32, it writes dx, dB, dC in the I/O dtype and
// ddt [B, S, H], dA [H] in f32, f32 inside.
//
// The reference has no backward kernel: it differentiates its jnp chunked
// scan (repro/models/mamba2.py::_ssd_chunk_scan) with JAX autodiff. This is
// the gradient of the function ssd_chunk.cu computes, with its chunking
// (chunks of Q <= 64 tokens, the last one ragged). Per (sequence, head) and
// chunk, with cs the inclusive cumsum of dt A inside the chunk, xdt = dt x,
// G = C B^T, L[q][k] = exp(cs_q - cs_k) for k <= q, M = G o L, s_in and
// s_out the states at the chunk's start and end, and ds_out the gradient
// reaching s_out (the next chunk's ds_in; dstate after the last chunk):
//
//   ds_in   = exp(cs_end) ds_out + sum_q exp(cs_q) C_q (x) dy_q
//   dxdt_k  = sum_q M[q][k] dy_q + exp(cs_end - cs_k) ds_out^T B_k
//   dM      = dy xdt^T (k <= q),  dG = dM o L
//   dC_q    = sum_k dG[q][k] B_k + exp(cs_q) s_in dy_q
//   dB_k    = sum_q dG[q][k] C_q + exp(cs_end - cs_k) ds_out xdt_k
//   dcs     = rowsum(dM o M) - colsum(dM o M) + exp(cs_q) C_q . s_in dy_q
//             - w_k, plus sum_k w_k + exp(cs_end) <s_in, ds_out> at the
//             last row, with w_k = exp(cs_end - cs_k) <B_k (x) xdt_k, ds_out>
//   da      = the reverse cumsum of dcs;  ddt = da A + dxdt . x;
//   dx      = dt dxdt;  dA = sum over sequences and tokens of da dt.
//
// Every exponent is <= 0 (exp is evaluated only for k <= q; dt >= 0 and
// A < 0), so nothing overflows where the reference's autodiff multiplies a
// masked 0 by an overflowed exp (ROADMAP, "Fixed or repaired").
//
// Four kernels, each deterministic (every output element is summed in a
// fixed order; no atomics):
//
// 1. increments_kernel, one block per (head, chunk, sequence): the chunk's
//    contribution to the state, sum_k exp(cs_end - cs_k) dt_k B_k (x) x_k,
//    and to the state's gradient, sum_q exp(cs_q) C_q (x) dy_q, and its
//    decay exp(cs_end); f32 [B, n_chunks, H, N, P] and [B, n_chunks, H].
// 2. scan_kernel, one thread per state element, sequence and direction:
//    walks the chunks and turns the increments in place into each
//    chunk's s_in (forward) and ds_out (backward, from dstate or zeros):
//    s_in[c + 1] = decay[c] s_in[c] + inc[c], ds_out[c - 1] = decay[c]
//    ds_out[c] + dinc[c]. The forward kernel keeps its state on chip and
//    writes none; this recomputes it.
// 3. chunk_kernel, one block per (head, chunk, sequence): every gradient of
//    its chunk from the chunk's inputs, s_in and ds_out, and its share of dA
//    in [B, n_chunks, H].
// 4. dA_kernel: dA[h], the shares summed in a fixed order.
//
// Bound on the H100: the bytes of x, B, C, dy, dt and the gradients; the
// products of kernels 1 and 3 (about 4.7 M multiply-adds per 64-token
// chunk and head at N 128, P 64, the masked squares taken whole) run on
// CUDA cores in f32, so this design is bound by that f32 arithmetic and
// by the chunk states' round trips through device memory, about twice the
// inputs' and outputs' bytes at mamba2-2.7b's shapes. Each product is a
// shared-memory tile loop: a thread sums a few rows by a few columns of
// the output in registers, its columns interleaved with its warp's so that
// one load instruction reads 32 consecutive words; the tiles are padded by
// one word so that a column walk hits 32 banks.
#include "paged_common.cuh"  // to_float, store, allow_smem

namespace repro_ssd_bwd {

using repro_paged::allow_smem;
using repro_paged::store;
using repro_paged::to_float;

constexpr int kMaxChunk = 64;
constexpr int kThreads = 512;      // the chunk-parallel kernels' blocks
constexpr int kScanThreads = 256;
constexpr int kScanAhead = 8;      // chunks of the scan loaded at once
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr unsigned kFull = 0xffffffffu;

// out[m][n] = sum_k a(m, k) b(k, n) for m < M, n < Nc, handed to
// epi(m, n, sum). Of NT threads, GN = min(Nc, 32) go across and
// GM = NT / GN down; a thread sums rows tm + i * GM (i < TM) and columns
// tn + j * GN (j < TN), so M <= TM * GM and Nc <= TN * 32.
template <int NT, int TM, int TN, typename FA, typename FB, typename FE>
__device__ __forceinline__ void tile_gemm(int M, int Nc, int K, FA a, FB b,
                                          FE epi) {
  const int GN = Nc < 32 ? Nc : 32;
  const int GM = NT / GN;
  const int tn = threadIdx.x % GN, tm = threadIdx.x / GN;
  if (tm >= GM) return;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tm + i * GM;
      av[i] = m < M ? a(m, k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tn + j * GN;
      bv[j] = n < Nc ? b(k, n) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tm + i * GM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tn + j * GN;
      if (n < Nc) epi(m, n, acc[i][j]);
    }
  }
}

// tile_gemm with the fewest rows and columns a thread needs for (M, Nc),
// up to TMAX and TNMAX.
template <int NT, int TMAX, int TNMAX, typename FA, typename FB, typename FE>
__device__ __forceinline__ void gemm(int M, int Nc, int K, FA a, FB b,
                                     FE epi) {
  const int GN = Nc < 32 ? Nc : 32;
  const int rows = (M + NT / GN - 1) / (NT / GN);
  const int cols = (Nc + 31) / 32;
  if constexpr (TMAX >= 8) {
    if (rows > 4) {
      if constexpr (TNMAX >= 4)
        if (cols > 2) return tile_gemm<NT, 8, 4>(M, Nc, K, a, b, epi);
      if constexpr (TNMAX >= 2)
        if (cols > 1) return tile_gemm<NT, 8, 2>(M, Nc, K, a, b, epi);
      return tile_gemm<NT, 8, 1>(M, Nc, K, a, b, epi);
    }
  }
  if constexpr (TMAX >= 4) {
    if (rows > 2) {
      if constexpr (TNMAX >= 4)
        if (cols > 2) return tile_gemm<NT, 4, 4>(M, Nc, K, a, b, epi);
      if constexpr (TNMAX >= 2)
        if (cols > 1) return tile_gemm<NT, 4, 2>(M, Nc, K, a, b, epi);
      return tile_gemm<NT, 4, 1>(M, Nc, K, a, b, epi);
    }
  }
  if constexpr (TNMAX >= 4)
    if (cols > 2) return tile_gemm<NT, 2, 4>(M, Nc, K, a, b, epi);
  if constexpr (TNMAX >= 2)
    if (cols > 1) return tile_gemm<NT, 2, 2>(M, Nc, K, a, b, epi);
  tile_gemm<NT, 2, 1>(M, Nc, K, a, b, epi);
}

// put(t, j, load(t, j)) for t < rows, j < cols (cols <= NT): thread
// (ty, tx) = (tid / cols, tid % cols) takes rows ty, ty + NT / cols, ...,
// and issues U rows' loads before their stores.
template <int NT, int U, typename FL, typename FP>
__device__ __forceinline__ void stage(int rows, int cols, FL load, FP put) {
  const int step = NT / cols;
  const int ty = threadIdx.x / cols, tx = threadIdx.x - ty * cols;
  if (ty >= step) return;
  for (int t0 = ty; t0 < rows; t0 += U * step) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * step;
      v[u] = t < rows ? load(t, tx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * step;
      if (t < rows) put(t, tx, v[u]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// out(r, sum_{i < len} f(r, i)) for r < rows: one warp per row, each lane
// summing i = lane, lane + 32, ..., then the warp's sum in a fixed tree.
template <int NT, typename F, typename FO>
__device__ __forceinline__ void row_sums(int rows, int len, F f, FO out) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NT / 32) {
    float s = 0.f;
    for (int i = lane; i < len; i += 32) s += f(r, i);
    s = warp_sum(s);
    if (lane == 0) out(r, s);
  }
}

struct Dims {
  int B, S, H, P, N, Q, nc;
  int NB, PB, QB;  // padded row lengths of the shared tiles
};

__host__ __device__ inline Dims make_dims(int B, int S, int H, int P, int N,
                                          int Q) {
  return Dims{B, S, H, P, N, Q, (S + Q - 1) / Q, N + 1, P + 1, Q + 1};
}

// Shared memory of increments_kernel, in floats: B, C [Q][NB]; x, dy
// [Q][PB]; the cumsum, dt and the two weights [Q].
inline size_t increments_smem(const Dims& d) {
  return 4 * (2 * (size_t)d.Q * d.NB + 2 * (size_t)d.Q * d.PB +
              4 * (size_t)d.Q);
}

// Shared memory of chunk_kernel, in floats: B, C, W [Q][NB]; x, dy, dxdt
// [Q][PB]; the state [N][PB]; M, dG [Q][QB]; ten [Q] vectors and one per
// warp.
inline size_t chunk_smem(const Dims& d) {
  return 4 * (3 * (size_t)d.Q * d.NB + 3 * (size_t)d.Q * d.PB +
              (size_t)d.N * d.PB + 2 * (size_t)d.Q * d.QB + 10 * (size_t)d.Q +
              kThreads / 32);
}

// dt of a chunk's n tokens into sd, then the inclusive cumsum of dt A into
// cs (warp 0: a shuffle scan of each half, the second half plus the first's
// total). Ends synchronised.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             int64_t tok0, int H, int h,
                                             float a, int n, float* sd,
                                             float* cs) {
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    sd[t] = dt[(tok0 + t) * H + h];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    float v0 = l < n ? sd[l] * a : 0.f;
    float v1 = l + 32 < n ? sd[l + 32] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t0 = __shfl_up_sync(kFull, v0, o);
      const float t1 = __shfl_up_sync(kFull, v1, o);
      if (l >= o) {
        v0 += t0;
        v1 += t1;
      }
    }
    v1 += __shfl_sync(kFull, v0, 31);
    if (l < n) cs[l] = v0;
    if (l + 32 < n) cs[l + 32] = v1;
  }
  __syncthreads();
}

// The chunk's increments of the state and of its gradient, and its decay.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    increments_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const T* __restrict__ dy,
                      float* __restrict__ inc, float* __restrict__ dinc,
                      float* __restrict__ decay, Dims d) {
  constexpr int NT = kThreads;
  extern __shared__ float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int N = d.N, P = d.P, NB = d.NB, PB = d.PB, Q = d.Q;
  float* sb = smem;            // [Q][NB] exp(cs_end - cs_k) dt_k B_k
  float* sc = sb + Q * NB;     // [Q][NB] exp(cs_q) C_q
  float* sx = sc + Q * NB;     // [Q][PB] x
  float* sy = sx + Q * PB;     // [Q][PB] dy
  float* cs = sy + Q * PB;     // [Q]
  float* sd = cs + Q;          // [Q] dt
  float* wb = sd + Q;          // [Q]
  float* wc = wb + Q;          // [Q]
  const int c0 = c * Q, n = min(Q, d.S - c0);
  const int64_t tok0 = (int64_t)b * d.S + c0;
  const int64_t x_tok = (int64_t)d.H * P, bc_tok = (int64_t)d.H * N;
  const int64_t s_off = (((int64_t)b * d.nc + c) * d.H + h) * N * P;
  chunk_cumsum(dt, tok0, d.H, h, A[h], n, sd, cs);
  const float cs_end = cs[n - 1];
  for (int t = threadIdx.x; t < n; t += NT) {
    wb[t] = sd[t] * expf(cs_end - cs[t]);
    wc[t] = expf(cs[t]);
  }
  if (threadIdx.x == 0) decay[((int64_t)b * d.nc + c) * d.H + h] =
      expf(cs_end);
  __syncthreads();
  const T* xc = x + tok0 * x_tok + (int64_t)h * P;
  const T* yc = dy + tok0 * x_tok + (int64_t)h * P;
  const T* bc = Bm + tok0 * bc_tok + (int64_t)h * N;
  const T* cc = Cm + tok0 * bc_tok + (int64_t)h * N;
  stage<NT, 4>(
      n, N, [&](int t, int j) { return to_float(bc[t * bc_tok + j]); },
      [&](int t, int j, float v) { sb[t * NB + j] = wb[t] * v; });
  stage<NT, 4>(
      n, N, [&](int t, int j) { return to_float(cc[t * bc_tok + j]); },
      [&](int t, int j, float v) { sc[t * NB + j] = wc[t] * v; });
  stage<NT, 4>(
      n, P, [&](int t, int p) { return to_float(xc[t * x_tok + p]); },
      [&](int t, int p, float v) { sx[t * PB + p] = v; });
  stage<NT, 4>(
      n, P, [&](int t, int p) { return to_float(yc[t * x_tok + p]); },
      [&](int t, int p, float v) { sy[t * PB + p] = v; });
  __syncthreads();
  gemm<NT, 8, 4>(
      N, P, n, [&](int j, int k) { return sb[k * NB + j]; },
      [&](int k, int p) { return sx[k * PB + p]; },
      [&](int j, int p, float v) { inc[s_off + j * P + p] = v; });
  gemm<NT, 8, 4>(
      N, P, n, [&](int j, int q) { return sc[q * NB + j]; },
      [&](int q, int p) { return sy[q * PB + p]; },
      [&](int j, int p, float v) { dinc[s_off + j * P + p] = v; });
}

// In place, per (sequence, head) and state element: the increments become
// s_in (blockIdx.y 0, walking forward) or ds_out (1, walking backward from
// dstate). A thread loads kScanAhead chunks' values before it walks them.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(float* __restrict__ states, float* __restrict__ dstates,
                const float* __restrict__ decay,
                const float* __restrict__ dstate, Dims d) {
  const int64_t NP = (int64_t)d.N * d.P;
  const int64_t g = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (g >= (int64_t)d.B * d.H * NP) return;
  const int64_t i = g % NP, bh = g / NP;
  const int b = (int)(bh / d.H), h = (int)(bh % d.H);
  const bool fwd = blockIdx.y == 0;
  float* buf = fwd ? states : dstates;
  float s = (!fwd && dstate) ? dstate[bh * NP + i] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kScanAhead) {
    float t[kScanAhead], e[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const int it = c0 + u;
      const int c = fwd ? it : d.nc - 1 - it;
      const int64_t bc = (int64_t)b * d.nc + c;
      t[u] = it < d.nc ? buf[(bc * d.H + h) * NP + i] : 0.f;
      e[u] = it < d.nc ? decay[bc * d.H + h] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const int it = c0 + u;
      if (it >= d.nc) break;
      const int c = fwd ? it : d.nc - 1 - it;
      buf[(((int64_t)b * d.nc + c) * d.H + h) * NP + i] = s;
      s = fmaf(e[u], s, t[u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const T* __restrict__ dy,
                 const float* __restrict__ states,
                 const float* __restrict__ dstates, T* __restrict__ dx,
                 float* __restrict__ ddt, T* __restrict__ dB,
                 T* __restrict__ dC, float* __restrict__ dA_part, Dims d) {
  constexpr int NT = kThreads;
  extern __shared__ float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int N = d.N, P = d.P, NB = d.NB, PB = d.PB, QB = d.QB, Q = d.Q;
  float* sb = smem;            // [Q][NB] B
  float* sc = sb + Q * NB;     // [Q][NB] C
  float* sw = sc + Q * NB;     // [Q][NB] s_in dy, then dG^T C
  float* sx = sw + Q * NB;     // [Q][PB] x
  float* sy = sx + Q * PB;     // [Q][PB] dy
  float* sz = sy + Q * PB;     // [Q][PB] M^T dy, then the ds_out term
  float* st = sz + Q * PB;     // [N][PB] s_in, then ds_out
  float* sm = st + N * PB;     // [Q][QB] M
  float* sg = sm + Q * QB;     // [Q][QB] dM, then dG
  float* cs = sg + Q * QB;     // [Q] cumsum of dt A
  float* sd = cs + Q;          // [Q] dt
  float* eq = sd + Q;          // [Q] exp(cs_q)
  float* de = eq + Q;          // [Q] exp(cs_end - cs_k)
  float* rsum = de + Q;        // [Q] row sums of dM o M
  float* csum = rsum + Q;      // [Q] column sums of dM o M
  float* inter = csum + Q;     // [Q] exp(cs_q) C_q . s_in dy_q
  float* r1 = inter + Q;       // [Q] (M^T dy)_k . x_k
  float* r2 = r1 + Q;          // [Q] (the ds_out term)_k . x_k
  float* dcs = r2 + Q;         // [Q]
  float* red = dcs + Q;        // [NT / 32]
  const int c0 = c * Q, n = min(Q, d.S - c0);
  const int64_t tok0 = (int64_t)b * d.S + c0;
  const int64_t x_tok = (int64_t)d.H * P, bc_tok = (int64_t)d.H * N;
  const int64_t s_off = (((int64_t)b * d.nc + c) * d.H + h) * N * P;
  const float a = A[h];
  const T* xc = x + tok0 * x_tok + (int64_t)h * P;
  const T* yc = dy + tok0 * x_tok + (int64_t)h * P;
  const T* bc = Bm + tok0 * bc_tok + (int64_t)h * N;
  const T* cc = Cm + tok0 * bc_tok + (int64_t)h * N;

  // 1. stage the chunk: dt and its cumsum, B, C, x, dy, s_in
  chunk_cumsum(dt, tok0, d.H, h, a, n, sd, cs);
  const float cs_end = cs[n - 1];
  for (int t = tid; t < n; t += NT) {
    eq[t] = expf(cs[t]);
    de[t] = expf(cs_end - cs[t]);
  }
  stage<NT, 4>(
      n, N, [&](int t, int j) { return to_float(bc[t * bc_tok + j]); },
      [&](int t, int j, float v) { sb[t * NB + j] = v; });
  stage<NT, 4>(
      n, N, [&](int t, int j) { return to_float(cc[t * bc_tok + j]); },
      [&](int t, int j, float v) { sc[t * NB + j] = v; });
  stage<NT, 4>(
      n, P, [&](int t, int p) { return to_float(xc[t * x_tok + p]); },
      [&](int t, int p, float v) { sx[t * PB + p] = v; });
  stage<NT, 4>(
      n, P, [&](int t, int p) { return to_float(yc[t * x_tok + p]); },
      [&](int t, int p, float v) { sy[t * PB + p] = v; });
  stage<NT, 8>(
      N, P, [&](int j, int p) { return states[s_off + j * P + p]; },
      [&](int j, int p, float v) { st[j * PB + p] = v; });
  __syncthreads();

  // 2. W = dy s_in^T [n][N]; M = (C B^T) o L; dM = dy xdt^T (k <= q)
  gemm<NT, 4, 4>(
      n, N, P, [&](int q, int p) { return sy[q * PB + p]; },
      [&](int p, int j) { return st[j * PB + p]; },
      [&](int q, int j, float v) { sw[q * NB + j] = v; });
  gemm<NT, 4, 2>(
      n, n, N, [&](int q, int j) { return sc[q * NB + j]; },
      [&](int j, int k) { return sb[k * NB + j]; },
      [&](int q, int k, float v) {
        sm[q * QB + k] = k <= q ? v * expf(cs[q] - cs[k]) : 0.f;
      });
  gemm<NT, 4, 2>(
      n, n, P, [&](int q, int p) { return sy[q * PB + p]; },
      [&](int p, int k) { return sx[k * PB + p]; },
      [&](int q, int k, float v) {
        sg[q * QB + k] = k <= q ? v * sd[k] : 0.f;
      });
  __syncthreads();

  // 3. the row and column sums of dM o M, the s_in term of dcs; then dG
  row_sums<NT>(
      n, n, [&](int q, int k) { return sg[q * QB + k] * sm[q * QB + k]; },
      [&](int q, float s) { rsum[q] = s; });
  row_sums<NT>(
      n, n, [&](int k, int q) { return sg[q * QB + k] * sm[q * QB + k]; },
      [&](int k, float s) { csum[k] = s; });
  row_sums<NT>(
      n, N, [&](int q, int j) { return sc[q * NB + j] * sw[q * NB + j]; },
      [&](int q, float s) { inter[q] = eq[q] * s; });
  __syncthreads();
  for (int i = tid; i < n * n; i += NT) {
    const int q = i / n, k = i - q * n;
    if (k <= q) sg[q * QB + k] *= expf(cs[q] - cs[k]);
  }
  __syncthreads();

  // 4. dC = dG B + exp(cs_q) W (out); then W = dG^T C; Z = M^T dy
  T* dC_c = dC + tok0 * bc_tok + (int64_t)h * N;
  gemm<NT, 4, 4>(
      n, N, n, [&](int q, int k) { return sg[q * QB + k]; },
      [&](int k, int j) { return sb[k * NB + j]; },
      [&](int q, int j, float v) {
        store(dC_c + q * bc_tok + j, fmaf(eq[q], sw[q * NB + j], v));
      });
  gemm<NT, 4, 4>(
      n, P, n, [&](int k, int q) { return sm[q * QB + k]; },
      [&](int q, int p) { return sy[q * PB + p]; },
      [&](int k, int p, float v) { sz[k * PB + p] = v; });
  __syncthreads();
  gemm<NT, 4, 4>(
      n, N, n, [&](int k, int q) { return sg[q * QB + k]; },
      [&](int q, int j) { return sc[q * NB + j]; },
      [&](int k, int j, float v) { sw[k * NB + j] = v; });
  row_sums<NT>(
      n, P, [&](int k, int p) { return sz[k * PB + p] * sx[k * PB + p]; },
      [&](int k, float s) { r1[k] = s; });
  __syncthreads();

  // 5. the state becomes ds_out, and <s_in, ds_out>
  float dot = 0.f;
  stage<NT, 8>(
      N, P, [&](int j, int p) { return dstates[s_off + j * P + p]; },
      [&](int j, int p, float g) {
        dot = fmaf(st[j * PB + p], g, dot);
        st[j * PB + p] = g;
      });
  dot = warp_sum(dot);
  if ((tid & 31) == 0) red[tid >> 5] = dot;
  __syncthreads();

  // 6. with e_k = exp(cs_end - cs_k): dxdt = Z + e_k B ds_out, dx = dt dxdt
  //    (out), Z = the second term; dB = W + e_k dt_k x ds_out^T (out)
  T* dx_c = dx + tok0 * x_tok + (int64_t)h * P;
  T* dB_c = dB + tok0 * bc_tok + (int64_t)h * N;
  gemm<NT, 4, 4>(
      n, P, N, [&](int k, int j) { return sb[k * NB + j]; },
      [&](int j, int p) { return st[j * PB + p]; },
      [&](int k, int p, float v) {
        const float e = de[k] * v;
        store(dx_c + k * x_tok + p, sd[k] * (sz[k * PB + p] + e));
        sz[k * PB + p] = e;
      });
  gemm<NT, 4, 4>(
      n, N, P, [&](int k, int p) { return sx[k * PB + p]; },
      [&](int p, int j) { return st[j * PB + p]; },
      [&](int k, int j, float v) {
        store(dB_c + k * bc_tok + j, fmaf(de[k] * sd[k], v, sw[k * NB + j]));
      });
  __syncthreads();
  row_sums<NT>(
      n, P, [&](int k, int p) { return sz[k * PB + p] * sx[k * PB + p]; },
      [&](int k, float s) { r2[k] = s; });
  __syncthreads();

  // 7. dcs, its reverse cumsum da, ddt (out) and this chunk's share of dA
  if (tid == 0) {
    float s_in_ds = 0.f;
    for (int i = 0; i < NT / 32; ++i) s_in_ds += red[i];
    float w_sum = 0.f;
    for (int k = 0; k < n; ++k) {
      const float w = sd[k] * r2[k];  // exp(cs_end - cs_k) <B_k (x) xdt_k, ds>
      dcs[k] = rsum[k] - csum[k] + inter[k] - w;
      w_sum += w;
    }
    dcs[n - 1] += w_sum + expf(cs_end) * s_in_ds;
    float da = 0.f, dA_sum = 0.f;
    for (int t = n - 1; t >= 0; --t) {
      da += dcs[t];
      ddt[(tok0 + t) * d.H + h] = da * a + r1[t] + r2[t];
      dA_sum = fmaf(da, sd[t], dA_sum);
    }
    dA_part[((int64_t)b * d.nc + c) * d.H + h] = dA_sum;
  }
}

// dA[h] = the chunks' shares summed over sequences and chunks in order.
__global__ void dA_kernel(const float* __restrict__ part,
                          float* __restrict__ dA, int BC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += part[(int64_t)i * H + h];
  dA[h] = s;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* dstate, void* dx,
           void* ddt, void* dA, void* dB, void* dC, void* states,
           void* dstates, void* decay, void* dA_part, const Dims& d,
           cudaStream_t stream) {
  const size_t s1 = increments_smem(d), s3 = chunk_smem(d);
  if (s1 > kMaxSmem || s3 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(increments_kernel<T>, s1);
  if (err == cudaSuccess) err = allow_smem(chunk_kernel<T>, s3);
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(d.H, d.nc, d.B);
  increments_kernel<T><<<chunks, kThreads, s1, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const T*)dy, (float*)states, (float*)dstates,
      (float*)decay, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n_elems = (int64_t)d.B * d.H * d.N * d.P;
  scan_kernel<<<dim3((unsigned)((n_elems + kScanThreads - 1) / kScanThreads),
                     2),
                kScanThreads, 0, stream>>>((float*)states, (float*)dstates,
                                           (const float*)decay,
                                           (const float*)dstate, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chunk_kernel<T><<<chunks, kThreads, s3, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const T*)dy, (const float*)states,
      (const float*)dstates, (T*)dx, (float*)ddt, (T*)dB, (T*)dC,
      (float*)dA_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dA_kernel<<<(d.H + 127) / 128, 128, 0, stream>>>(
      (const float*)dA_part, (float*)dA, d.B * d.nc, d.H);
  return (int)cudaGetLastError();
}

}  // namespace repro_ssd_bwd

// Shared memory the larger of the two main kernels needs at (N, P, Q), in
// bytes; the launcher refuses shapes above a block's 232,448.
extern "C" long long repro_ssd_chunk_bwd_smem(int N, int P, int Q) {
  using namespace repro_ssd_bwd;
  const Dims d = make_dims(1, Q, 1, P, N, Q);
  const size_t a = increments_smem(d), b = chunk_smem(d);
  return (long long)(a > b ? a : b);
}

// dtype (of x, B, C, dy and dx, dB, dC): 0 = float32, 1 = bfloat16; dt, A,
// dstate, ddt, dA and the scratch are float32. dstate may be null (a zero
// final-state gradient). states and dstates are scratch of [B, n_chunks, H,
// N, P] floats, decay and dA_part of [B, n_chunks, H], n_chunks =
// ceil(S / Q). Q is
// the forward's chunk length, 1..64; N, P <= 128 within the shared-memory
// limit. Returns the first failed launch's cudaError_t (0 on success).
extern "C" int repro_ssd_chunk_bwd(int dtype, const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* dy,
                                   const void* dstate, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* states,
                                   void* dstates, void* decay, void* dA_part,
                                   int B, int S,
                                   int H, int P, int N, int Q, void* stream) {
  using namespace repro_ssd_bwd;
  if (Q < 1 || Q > kMaxChunk || N < 1 || N > 128 || P < 1 || P > 128 ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, S, H, P, N, Q);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC,
                         states, dstates, decay, dA_part, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                 dB, dC, states, dstates, decay, dA_part, d,
                                 st);
  return (int)cudaErrorInvalidValue;
}
