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
// Two variants by (dtype, N, P, Q), the forward's rule; each is
// deterministic (every output element is summed in a fixed order; no atomic
// carries a sum):
//
// * wgmma (bf16, N and P 64 or 128, Q = 64): three launches on the
//   forward's Hopper building blocks (hopper.cuh: TMA boxes of 64 rows by 64
//   columns with the 128-byte swizzle, m64n64k16 wgmma with f32
//   accumulators). Every product has one operand exact in bf16 (a
//   TMA-loaded B, C, x or dy); an f32 operand goes in as two bf16 operands,
//   hi = bf16(v) and lo = bf16(v - hi), into the same accumulator (the
//   forward's split_bf16, ~2^-17 of an element).
//   1. states_wgmma, one 128-thread block per (sequence, head, chunk) but
//      the last: the chunk's increment inc^T = (x o w)^T B [P][N] (the
//      forward's state product), then the forward chain
//      s_in[c + 1] = exp(cs_end) s_in[c] + inc, f32 [P][N] per chunk in
//      device memory; s_in[0] = 0 is not stored.
//   2. chunk_wgmma, one 256-thread block per (sequence, head, chunk), in
//      reverse chunk order. Warpgroup 0 (queries down the rows): dinc^T =
//      (dy o e_q)^T C; the backward chain ds_in[c] = exp(cs_end) ds_out[c] +
//      dinc into ds_out[c - 1] (ds_out of the last chunk: dstate or zero),
//      ds_out[c] staged as bf16 hi and lo tiles in shared memory; G = C B^T
//      and dy x^T, M, dM, dG = dM o L (split) and the row sums of dM o M;
//      then s_in[c] staged into the same tiles (once warpgroup 1 is done
//      with ds_out), W = dy s_in^T, dC = exp(cs_q) W + dG B (out).
//      Warpgroup 1 (keys down the rows, so M^T and dG^T are register A
//      operands with no transpose): G^T = B C^T and x dy^T, M^T (split)
//      and the column sums; Z = exp(cs_end - cs_k) B ds_out, dxdt = Z +
//      M^T dy, dx = dt dxdt (out); the two squares again for dG^T (split),
//      so that M^T's and dG^T's fragments are never live together; dB =
//      w_k x ds_out^T + dG^T C (out), 64 columns of N at a time. Then one
//      warp: dcs, its reverse cumsum, ddt (out) and the chunk's share of
//      dA.
//   3. dA_kernel: dA[h], the shares summed in a fixed order.
//   The chains run chunk-parallel: a block takes its chunk from an ordered
//   ticket (an atomic counter read when the block starts, as CUB's
//   decoupled look-back takes its tile), so a block only ever waits for a
//   chunk whose block took an earlier ticket and is therefore running. A
//   block publishes its state with a release store of a flag after its
//   writes and a fence; its successor reads the flag with acquire
//   semantics, then the state through L2. No increment and no scan pass go
//   through device memory: per chunk, s_in is written once and read twice
//   (the next chunk's chain link, then this chunk's gradients), ds_out
//   written once and read once, about 1.8 times the inputs' and outputs'
//   bytes at mamba2-2.7b's shapes. Neither those bytes nor the tensor
//   cores bound this variant, nor the chains (the blocks find their
//   predecessor's state published): each chunk_wgmma block's latency does,
//   its steps one after another (the TMA loads, the chain's state through
//   L2, s_in from device memory, the products and the stores between
//   them), with two blocks a multiprocessor at P 64 to overlap them. That
//   caps a thread at 128 registers, and ptxas spills some.
// * simt (f32, other widths and chunk lengths), four kernels in f32 on CUDA
//   cores:
//   1. increments_kernel, one block per (head, chunk, sequence): the
//      chunk's contribution to the state, sum_k exp(cs_end - cs_k) dt_k
//      B_k (x) x_k, and to the state's gradient, sum_q exp(cs_q) C_q (x)
//      dy_q, and its decay exp(cs_end); f32 [B, n_chunks, H, N, P] and
//      [B, n_chunks, H].
//   2. scan_kernel, one thread per state element, sequence and direction:
//      walks the chunks and turns the increments in place into each
//      chunk's s_in (forward) and ds_out (backward, from dstate or zeros):
//      s_in[c + 1] = decay[c] s_in[c] + inc[c], ds_out[c - 1] = decay[c]
//      ds_out[c] + dinc[c].
//   3. chunk_kernel, one block per (head, chunk, sequence): every gradient
//      of its chunk from the chunk's inputs, s_in and ds_out, and its share
//      of dA in [B, n_chunks, H].
//   4. dA_kernel, as above.
//   Bound by its f32 arithmetic (about 4.7 M multiply-adds per 64-token
//   chunk and head at N 128, P 64, the masked squares taken whole) and by
//   the chunk states' round trips through device memory. Each product is a
//   shared-memory tile loop: a thread sums a few rows by a few columns of
//   the output in registers, its columns interleaved with its warp's so
//   that one load instruction reads 32 consecutive words; the tiles are
//   padded by one word so that a column walk hits 32 banks.
//
// The forward kernel keeps its state on chip and writes none; both
// variants recompute it. The bound on the H100 is the bytes of x, B, C,
// dy, dt and the gradients.
#include "hopper.cuh"
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
int launch_simt(const void* x, const void* dt, const void* A, const void* Bm,
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

// ----------------------------------------------------------------- wgmma
using namespace repro_hopper;
using bf16 = __nv_bfloat16;

constexpr int kQ = 64;  // chunk length of the wgmma variant
constexpr float kLog2e = 1.4426950408889634f;

// Per chunk: its tokens' scalars, the per-token sums the two warpgroups
// hand to the last step, and the block's ticket.
struct Scal {
  float dt[kQ];  // dt, 0 past S: weight 0, decay 1
  float cs[kQ];  // inclusive cumsum of dt A, log2 units
  float eq[kQ];  // exp(cs_q)
  float de[kQ];  // exp(cs_end - cs_k)
  float w[kQ];   // dt_k exp(cs_end - cs_k)
  float rsum[kQ], csum[kQ];  // row and column sums of dM o M
  float inter[kQ];           // exp(cs_q) C_q . s_in dy_q
  float r2[kQ];              // Z_k . x_k
  float r12[kQ];             // dxdt_k . x_k
  float red[4];              // warpgroup 0's <s_in, ds_out>, by warp
  float e_end;               // exp(cs_end)
  int ticket;
};

template <int N, int P>
struct BwdLayout {
  static constexpr int kNH = N / 64;  // 64-column boxes of B and C
  static constexpr int kWG = P / 64;  // 64-column boxes of x and dy
  static constexpr int kBC = kNH * kBoxBytes;        // one B or C tile
  static constexpr int kXY = kWG * kBoxBytes;        // one x or dy tile
  static constexpr int kState = kWG * kNH * kBoxBytes;  // bf16 [P][N]
  // states_wgmma: B, x, the scalars, one barrier
  static constexpr size_t kStatesSmem = 1024 /* alignment slack */ + kBC +
                                        kXY + sizeof(Scal) + 8;
  // chunk_wgmma: C, B, x, dy, a state's hi and lo tiles, the scalars, two
  // barriers
  static constexpr size_t kChunkSmem = 1024 + 2 * kBC + 2 * kXY +
                                       2 * kState + sizeof(Scal) + 16;
  // two chunk blocks a streaming multiprocessor at P 64 (128 registers a
  // thread), one at P 128
  static constexpr int kMinBlocks = P == 64 ? 2 : 1;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~uintptr_t(1023));
}

// v0, v1 (adjacent columns) as two bf16 pairs whose sum is v to ~2^-17
// (ssd_chunk.cu's split_bf16).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Named barriers of chunk_wgmma (0 is __syncthreads): 1 warpgroup 0 alone;
// 2 "ds_out staged" (warpgroup 0 arrives, 1 waits); 3 "ds_out read"
// (warpgroup 1 arrives, 0 waits).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One thread: spin until another block has published `flag` (acquire),
// trapping after ~2^26 polls (seconds) rather than hanging the card; then a
// fence, so that the caller's barrier orders its threads' reads after it.
__device__ __forceinline__ void wait_flag(const unsigned* flag) {
  for (uint32_t tries = 0;; ++tries) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
    if (v) break;
    if (tries == (1u << 26)) __trap();
    __nanosleep(32);
  }
  __threadfence();
}

// One thread, after every writer's __threadfence and a barrier: publish.
__device__ __forceinline__ void set_flag(unsigned* flag) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(1u)
               : "memory");
}

// Warp 0: dt of the chunk's n tokens (0 past them) and the scalars derived
// from it into s (a scan of token pairs, as the forward's producer).
__device__ __forceinline__ void chunk_scalars(const float* __restrict__ dt,
                                              int64_t tok0, int n, int H,
                                              int h, float a_log2, Scal* s) {
  const int lane = threadIdx.x % 32, k = 2 * lane;
  const float d0 = k < n ? dt[(tok0 + k) * H + h] : 0.f;
  const float d1 = k + 1 < n ? dt[(tok0 + k + 1) * H + h] : 0.f;
  const float a1 = d1 * a_log2;
  float inc = d0 * a_log2 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  const float cs[2] = {inc - a1, inc}, dd[2] = {d0, d1};
  const float cend = __shfl_sync(kFull, inc, 31);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float de = fast_exp2(cend - cs[j]);
    s->dt[k + j] = dd[j];
    s->cs[k + j] = cs[j];
    s->eq[k + j] = fast_exp2(cs[j]);
    s->de[k + j] = de;
    s->w[k + j] = dd[j] * de;
  }
  if (lane == 0) s->e_end = fast_exp2(cend);
}

// The sum of v over the four lanes that hold one accumulator row, in a
// fixed tree.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Thread geometry of a warpgroup's m64n64 accumulator (hopper.cuh): rows r0
// and r0 + 8, columns 8 nb + col0 (+1); the byte offset of (row r0 + 8 i,
// column 8 nb + col0) in a swizzled box is off + 1024 i + ((nb ^ sw) << 4).
struct Frag {
  int r0, col0, off, sw;
  __device__ explicit Frag(int t128) {
    const int lane = t128 % 32;
    r0 = 16 * (t128 / 32) + lane / 4;
    col0 = 2 * (lane % 4);
    off = r0 * kSwzRow + col0 * 2;
    sw = r0 % 8;
  }
  __device__ int at(int nb, int i) const {
    return off + 1024 * i + ((nb ^ sw) << 4);
  }
};

// A^T [64 p][64 t] of a [64 t][64 p] bf16 box (x or dy), each column t
// scaled by scale[t], as split register A fragments: (t = 8 nb + col0 + jj,
// p = r0 + 8 i) lies at 1024 nb + swz128_offset(col0 + jj, r0 + 8 i).
__device__ __forceinline__ void transposed_frags(const uint8_t* box,
                                                 const float* scale,
                                                 const Frag& f, uint32_t* hi,
                                                 uint32_t* lo) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int t = 8 * nb + f.col0;
    const float s0 = scale[t], s1 = scale[t + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r = box + 1024 * nb;
      const float v0 = __bfloat162float(*reinterpret_cast<const bf16*>(
          r + swz128_offset(f.col0, f.r0 + 8 * i)));
      const float v1 = __bfloat162float(*reinterpret_cast<const bf16*>(
          r + swz128_offset(f.col0 + 1, f.r0 + 8 * i)));
      split_bf16(v0 * s0, v1 * s1, hi[2 * nb + i], lo[2 * nb + i]);
    }
  }
}

// acc[cb] (+)= A^T B over the chunk's 64 tokens: the register A fragments
// (hi and lo) against the [64 t][N] tile at tile, MN-major.
template <int kNH>
__device__ __forceinline__ void state_product(float (&acc)[kNH][32],
                                              const uint32_t* hi,
                                              const uint32_t* lo,
                                              uint32_t tile) {
#pragma unroll
  for (int cb = 0; cb < kNH; ++cb) pin(acc[cb]);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < kQ / 16; ++jj)
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb) {
      const uint64_t bd =
          sw128_desc(tile + cb * kBoxBytes + jj * 16 * kSwzRow);
      wgmma_rs(acc[cb], hi + 4 * jj, bd);
      wgmma_rs(acc[cb], lo + 4 * jj, bd);
    }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int cb = 0; cb < kNH; ++cb) pin(acc[cb]);
}

// acc = A B^T over K = 64 kb columns: A [64][K] and B [64][K] tiles of kb
// boxes, both K-major.
template <int kb>
__device__ __forceinline__ void square_product(float (&acc)[32], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * kb; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(acc, sw128_desc(a + off), sw128_desc(b + off), kk > 0);
  }
}

// The state of chunk (b, c, h) in the wgmma variant's scratch: f32 [P][N].
template <int N, int P>
__device__ __forceinline__ int64_t state_at(const Dims& d, int b, int c,
                                            int h) {
  return (((int64_t)b * d.nc + c) * d.H + h) * (int64_t)N * P;
}

// (p, n) of accumulator register pair e of box (w, cb), its byte offset in
// a bf16 [P][N] state tile.
struct StatePos {
  int p, n, smem;
};
template <int kNH>
__device__ __forceinline__ StatePos state_pos(const Frag& f, int w, int cb,
                                              int e) {
  const int i = (e >> 1) & 1, nb = e >> 2;
  return StatePos{64 * w + f.r0 + 8 * i, 64 * cb + 8 * nb + f.col0,
                  (w * kNH + cb) * kBoxBytes + f.at(nb, i)};
}

// 1. The forward chain: one block per (sequence, head, chunk c < n_chunks -
// 1) in ticket order (chunk-major). tb/tx map B/x as [B, S, H * N or P].
template <int N, int P>
__global__ void __launch_bounds__(128)
    states_wgmma(const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tx,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ states, unsigned* __restrict__ flags,
                 unsigned* __restrict__ ticket, Dims d) {
  using L = BwdLayout<N, P>;
  constexpr int kNH = L::kNH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t bt = smem_u32(base), xt = bt + L::kBC;
  Scal* sc = reinterpret_cast<Scal*>(base + L::kBC + L::kXY);
  const uint32_t bar = smem_u32(sc + 1);
  if (threadIdx.x == 0) {
    sc->ticket = (int)atomicAdd(ticket, 1u);
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int nbh = d.B * d.H, t = sc->ticket;
  const int c = t / nbh, bh = t % nbh, b = bh / d.H, h = bh % d.H;
  const int c0 = c * kQ;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, L::kBC + L::kXY);
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb)
      tma_load(bt + cb * kBoxBytes, &tb, bar, h * N + cb * 64, c0, b);
#pragma unroll
    for (int w = 0; w < L::kWG; ++w)
      tma_load(xt + w * kBoxBytes, &tx, bar, h * P + w * 64, c0, b);
  }
  if (threadIdx.x < 32)
    chunk_scalars(dt, (int64_t)b * d.S + c0, min(kQ, d.S - c0), d.H, h,
                  A[h] * kLog2e, sc);
  __syncthreads();
  mbar_wait(bar, 0);
  const Frag f(threadIdx.x);
  const float e_end = sc->e_end;
  const float* prev = states + state_at<N, P>(d, b, c, h);
  float* next = states + state_at<N, P>(d, b, c + 1, h);
#pragma unroll 1
  for (int w = 0; w < L::kWG; ++w) {
    // inc^T [p][n] = (x o w)^T B for this warpgroup's 64 columns of x
    uint32_t xh[16], xl[16];
    transposed_frags(base + L::kBC + w * kBoxBytes, sc->w, f, xh, xl);
    float acc[kNH][32];
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;
    state_product<kNH>(acc, xh, xl, bt);
    if (w == 0 && c > 0) {  // s_in[c], published by chunk c - 1's block
      if (threadIdx.x == 0) wait_flag(&flags[(int64_t)bh * d.nc + c]);
      __syncthreads();
    }
    // s_in[c] loaded a box at a time before any store (the two share one
    // buffer, so the compiler may not move a load above a store)
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb) {
      float2 s[16];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const StatePos sp = state_pos<kNH>(f, w, cb, e);
        s[e / 2] = c > 0 ? __ldcg(reinterpret_cast<const float2*>(
                               prev + (int64_t)sp.p * N + sp.n))
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const StatePos sp = state_pos<kNH>(f, w, cb, e);
        __stcg(reinterpret_cast<float2*>(next + (int64_t)sp.p * N + sp.n),
               make_float2(fmaf(e_end, s[e / 2].x, acc[cb][e]),
                           fmaf(e_end, s[e / 2].y, acc[cb][e + 1])));
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) set_flag(&flags[(int64_t)bh * d.nc + c + 1]);
}

// 2. The backward chain and every gradient of a chunk: one block per
// (sequence, head, chunk) in ticket order, the last chunk first.
template <int N, int P>
__global__ void __launch_bounds__(256, BwdLayout<N, P>::kMinBlocks)
    chunk_wgmma(const __grid_constant__ CUtensorMap tc,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tdy,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ states,
                float* __restrict__ dstates,
                const float* __restrict__ dstate, bf16* __restrict__ dx,
                float* __restrict__ ddt, bf16* __restrict__ dB,
                bf16* __restrict__ dC, float* __restrict__ dA_part,
                unsigned* __restrict__ flags, unsigned* __restrict__ ticket,
                Dims d) {
  using L = BwdLayout<N, P>;
  constexpr int kNH = L::kNH, kWG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  // C, B, x, dy, then the staged state's hi and lo tiles
  uint8_t* cg = base;
  uint8_t* bg = cg + L::kBC;
  uint8_t* xg = bg + L::kBC;
  uint8_t* yg = xg + L::kXY;
  const uint32_t ct = smem_u32(cg), bt = smem_u32(bg), xt = smem_u32(xg),
                 yt = smem_u32(yg);
  uint8_t* shg = yg + L::kXY;
  uint8_t* slg = shg + L::kState;
  const uint32_t sh = smem_u32(shg), sl = smem_u32(slg);
  Scal* sc = reinterpret_cast<Scal*>(slg + L::kState);
  const uint32_t bar0 = smem_u32(sc + 1), bar1 = bar0 + 8;  // C, dy; B, x
  if (threadIdx.x == 0) {
    sc->ticket = (int)atomicAdd(ticket, 1u);
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int nbh = d.B * d.H, t = sc->ticket;
  const int c = d.nc - 1 - t / nbh, bh = t % nbh, b = bh / d.H,
            h = bh % d.H;
  const int c0 = c * kQ, n = min(kQ, d.S - c0);
  const int64_t tok0 = (int64_t)b * d.S + c0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar0, L::kBC + L::kXY);
    mbar_expect_tx(bar1, L::kBC + L::kXY);
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb)
      tma_load(ct + cb * kBoxBytes, &tc, bar0, h * N + cb * 64, c0, b);
#pragma unroll
    for (int w = 0; w < kWG; ++w)
      tma_load(yt + w * kBoxBytes, &tdy, bar0, h * P + w * 64, c0, b);
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb)
      tma_load(bt + cb * kBoxBytes, &tb, bar1, h * N + cb * 64, c0, b);
#pragma unroll
    for (int w = 0; w < kWG; ++w)
      tma_load(xt + w * kBoxBytes, &tx, bar1, h * P + w * 64, c0, b);
  }
  const float a = A[h];
  if (threadIdx.x < 32) chunk_scalars(dt, tok0, n, d.H, h, a * kLog2e, sc);
  __syncthreads();
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const Frag f(t128);
  const int64_t here = state_at<N, P>(d, b, c, h);
  const float e_end = sc->e_end;

  if (wg == 0) {  // ---- queries down the rows
    mbar_wait(bar0, 0);
#pragma unroll 1
    for (int w = 0; w < kWG; ++w) {
      // dinc^T [p][n] = (dy o e_q)^T C for 64 columns of dy, a box of
      // C at a time
      uint32_t yh[16], yl[16];
      transposed_frags(yg + w * kBoxBytes, sc->eq, f, yh, yl);
#pragma unroll 1
      for (int cb = 0; cb < kNH; ++cb) {
        float acc[1][32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[0][e] = 0.f;
        state_product<1>(acc, yh, yl, ct + cb * kBoxBytes);
        if (w == 0 && cb == 0 && c + 1 < d.nc) {
          // ds_out[c], from chunk c + 1's block
          if (t128 == 0) wait_flag(&flags[(int64_t)bh * d.nc + c]);
          bar_sync(1, 128);
        }
        // ds_in[c] = exp(cs_end) ds_out[c] + dinc into ds_out[c - 1];
        // ds_out staged, split, for warpgroup 1
#pragma unroll
        for (int e0 = 0; e0 < 32; e0 += 16) {
          // half a box's loads before any store, as in states_wgmma
          float2 g[8];
#pragma unroll
          for (int e = e0; e < e0 + 16; e += 2) {
            const StatePos sp = state_pos<kNH>(f, w, cb, e);
            g[(e - e0) / 2] = make_float2(0.f, 0.f);
            if (c + 1 < d.nc) {
              g[(e - e0) / 2] = __ldcg(reinterpret_cast<const float2*>(
                  dstates + here + (int64_t)sp.p * N + sp.n));
            } else if (dstate != nullptr) {
              const float* ds = dstate + (int64_t)bh * N * P;
              g[(e - e0) / 2] =
                  make_float2(ds[(int64_t)sp.n * P + sp.p],
                              ds[(int64_t)(sp.n + 1) * P + sp.p]);
            }
          }
#pragma unroll
          for (int e = e0; e < e0 + 16; e += 2) {
            const StatePos sp = state_pos<kNH>(f, w, cb, e);
            const float2 v = g[(e - e0) / 2];
            if (c > 0)
              __stcg(reinterpret_cast<float2*>(
                         dstates + state_at<N, P>(d, b, c - 1, h) +
                         (int64_t)sp.p * N + sp.n),
                     make_float2(fmaf(e_end, v.x, acc[0][e]),
                                 fmaf(e_end, v.y, acc[0][e + 1])));
            uint32_t hi, lo;
            split_bf16(v.x, v.y, hi, lo);
            *reinterpret_cast<uint32_t*>(shg + sp.smem) = hi;
            *reinterpret_cast<uint32_t*>(slg + sp.smem) = lo;
          }
        }
      }
    }
    fence_async_smem();
    if (c > 0) {
      __threadfence();
      bar_sync(1, 128);
      if (t128 == 0) set_flag(&flags[(int64_t)bh * d.nc + c - 1]);
    }
    bar_arrive(2, 256);  // ds_out staged

    // G = C B^T and dy x^T: (q = r0 + 8 i, k = 8 nb + col0 + j)
    mbar_wait(bar1, 0);
    float g[32], yx[32];
    pin(g);
    pin(yx);
    wgmma_fence();
    square_product<kNH>(g, ct, bt);
    square_product<kWG>(yx, yt, xt);
    wgmma_commit();
    wgmma_wait0();
    pin(g);
    pin(yx);
    // M = G o L, dM = dy xdt^T (k <= q), dG = dM o L split; rows of dM o M
    uint32_t gh[16], gl[16];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int k = 8 * nb + f.col0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = f.r0 + 8 * i, e = 4 * nb + 2 * i;
        const float csq = sc->cs[q];
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = 0.f;
          if (k + j <= q) {
            const float l = fast_exp2(csq - sc->cs[k + j]);
            const float dm = yx[e + j] * sc->dt[k + j];
            rs[i] = fmaf(dm, g[e + j] * l, rs[i]);
            v[j] = dm * l;
          }
        }
        split_bf16(v[0], v[1], gh[2 * nb + i], gl[2 * nb + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float s = quad_sum(rs[i]);
      if (f.col0 == 0) sc->rsum[f.r0 + 8 * i] = s;
    }

    // s_in[c] into the state tiles once warpgroup 1 has read ds_out;
    // <s_in, ds_out> from ds_out's hi + lo
    bar_sync(3, 256);
    float dot = 0.f;
#pragma unroll 1
    for (int w = 0; w < kWG; ++w)
#pragma unroll
      for (int cb = 0; cb < kNH; ++cb) {
        float2 sv[16];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const StatePos sp = state_pos<kNH>(f, w, cb, e);
          sv[e / 2] = c > 0 ? __ldg(reinterpret_cast<const float2*>(
                                  states + here + (int64_t)sp.p * N + sp.n))
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const StatePos sp = state_pos<kNH>(f, w, cb, e);
          const float2 s = sv[e / 2];
          uint32_t* hp = reinterpret_cast<uint32_t*>(shg + sp.smem);
          uint32_t* lp = reinterpret_cast<uint32_t*>(slg + sp.smem);
          const float2 gh2 = unpack_bf16(*hp), gl2 = unpack_bf16(*lp);
          dot = fmaf(s.x, gh2.x + gl2.x, dot);
          dot = fmaf(s.y, gh2.y + gl2.y, dot);
          split_bf16(s.x, s.y, *hp, *lp);
        }
      }
    fence_async_smem();
    bar_sync(1, 128);

    // per 64 columns n of C: W = dy s_in^T [q][n] (s_in^T MN-major), its
    // share of inter = exp(cs_q) C_q . W_q, and dC = exp(cs_q) W + dG B
    float it[2] = {0.f, 0.f};
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb) {
      float wa[1][32];
      pin(wa[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint32_t off =
            ((kk / 4) * kNH + cb) * kBoxBytes + (kk % 4) * 16 * kSwzRow;
        const uint64_t ad =
            sw128_desc(yt + (kk / 4) * kBoxBytes + (kk % 4) * 32);
        wgmma_ss_mn(wa[0], ad, sw128_desc(sh + off), kk > 0);
        wgmma_ss_mn(wa[0], ad, sw128_desc(sl + off), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      pin(wa[0]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float eq = sc->eq[f.r0 + 8 * i];
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int e = 4 * nb + 2 * i;
          const float2 cv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              cg + cb * kBoxBytes + f.at(nb, i)));
          it[i] = fmaf(cv.x, wa[0][e], it[i]);
          it[i] = fmaf(cv.y, wa[0][e + 1], it[i]);
          wa[0][e] *= eq;
          wa[0][e + 1] *= eq;
        }
      }
      state_product<1>(wa, gh, gl, bt + cb * kBoxBytes);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = f.r0 + 8 * i;
        if (q >= n) continue;
        bf16* row = dC + ((tok0 + q) * d.H + h) * N + 64 * cb + f.col0;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * nb) =
              __floats2bfloat162_rn(wa[0][4 * nb + 2 * i],
                                    wa[0][4 * nb + 2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = f.r0 + 8 * i;
      const float s = quad_sum(it[i]);
      if (f.col0 == 0) sc->inter[q] = sc->eq[q] * s;
    }
    dot = warp_sum(dot);
    if (t128 % 32 == 0) sc->red[t128 / 32] = dot;
  } else {  // ---- keys down the rows: (k = r0 + 8 i, q = 8 nb + col0 + j)
    mbar_wait(bar0, 0);
    mbar_wait(bar1, 0);
    float gt[32], xy[32];
    pin(gt);
    pin(xy);
    wgmma_fence();
    square_product<kNH>(gt, bt, ct);
    square_product<kWG>(xy, xt, yt);
    wgmma_commit();
    wgmma_wait0();
    pin(gt);
    pin(xy);
    // M^T split; the columns of dM o M (dG^T comes later, from the squares
    // computed again, so that the two sets of fragments are never live
    // together)
    uint32_t mh[16], ml[16];
    float cs_[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int q = 8 * nb + f.col0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = f.r0 + 8 * i, e = 4 * nb + 2 * i;
        const float csk = sc->cs[k], dtk = sc->dt[k];
        float m[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          m[j] = 0.f;
          if (k <= q + j) {
            m[j] = gt[e + j] * fast_exp2(sc->cs[q + j] - csk);
            cs_[i] = fmaf(xy[e + j] * dtk, m[j], cs_[i]);
          }
        }
        split_bf16(m[0], m[1], mh[2 * nb + i], ml[2 * nb + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float s = quad_sum(cs_[i]);
      if (f.col0 == 0) sc->csum[f.r0 + 8 * i] = s;
    }

    bar_sync(2, 256);  // ds_out staged
    // Z = exp(cs_end - cs_k) B ds_out [k][p] (ds_out K-major), Z . x
    float z[kWG][32];
#pragma unroll
    for (int w = 0; w < kWG; ++w) pin(z[w]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t ad =
          sw128_desc(bt + (kk / 4) * kBoxBytes + (kk % 4) * 32);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
        const uint32_t off =
            (w * kNH + kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(z[w], ad, sw128_desc(sh + off), kk > 0);
        wgmma_ss(z[w], ad, sw128_desc(sl + off), 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int w = 0; w < kWG; ++w) pin(z[w]);
    float r2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float de = sc->de[f.r0 + 8 * i];
#pragma unroll
      for (int w = 0; w < kWG; ++w)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int e = 4 * nb + 2 * i;
          const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              xg + w * kBoxBytes + f.at(nb, i)));
          z[w][e] *= de;
          z[w][e + 1] *= de;
          r2[i] = fmaf(z[w][e], xv.x, r2[i]);
          r2[i] = fmaf(z[w][e + 1], xv.y, r2[i]);
        }
    }
    // dxdt = Z + M^T dy (dy MN-major)
#pragma unroll
    for (int w = 0; w < kWG; ++w) pin(z[w]);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kQ / 16; ++jj)
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
        const uint64_t bd =
            sw128_desc(yt + w * kBoxBytes + jj * 16 * kSwzRow);
        wgmma_rs(z[w], mh + 4 * jj, bd);
        wgmma_rs(z[w], ml + 4 * jj, bd);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int w = 0; w < kWG; ++w) pin(z[w]);
    // dx = dt dxdt (out); dxdt . x
    float r12[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = f.r0 + 8 * i;
      const float dtk = sc->dt[k];
      bf16* row = dx + ((tok0 + k) * d.H + h) * P + f.col0;
#pragma unroll
      for (int w = 0; w < kWG; ++w)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int e = 4 * nb + 2 * i;
          const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              xg + w * kBoxBytes + f.at(nb, i)));
          r12[i] = fmaf(z[w][e], xv.x, r12[i]);
          r12[i] = fmaf(z[w][e + 1], xv.y, r12[i]);
          if (k < n)
            *reinterpret_cast<__nv_bfloat162*>(row + 64 * w + 8 * nb) =
                __floats2bfloat162_rn(dtk * z[w][e], dtk * z[w][e + 1]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float s2 = quad_sum(r2[i]), s12 = quad_sum(r12[i]);
      if (f.col0 == 0) {
        sc->r2[f.r0 + 8 * i] = s2;
        sc->r12[f.r0 + 8 * i] = s12;
      }
    }
    // the squares again, and dG^T = dM^T o L^T split
    pin(gt);
    pin(xy);
    wgmma_fence();
    square_product<kNH>(gt, bt, ct);
    square_product<kWG>(xy, xt, yt);
    wgmma_commit();
    wgmma_wait0();
    pin(gt);
    pin(xy);
    uint32_t dh[16], dl[16];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int q = 8 * nb + f.col0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = f.r0 + 8 * i, e = 4 * nb + 2 * i;
        const float csk = sc->cs[k], dtk = sc->dt[k];
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = k <= q + j
                     ? xy[e + j] * dtk * fast_exp2(sc->cs[q + j] - csk)
                     : 0.f;
        split_bf16(v[0], v[1], dh[2 * nb + i], dl[2 * nb + i]);
      }
    }
    // per 64 columns n: dB = w_k x ds_out^T + dG^T C [k][n] (ds_out^T and
    // C MN-major)
#pragma unroll
    for (int cb = 0; cb < kNH; ++cb) {
      float db[1][32];
      pin(db[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint32_t off =
            ((kk / 4) * kNH + cb) * kBoxBytes + (kk % 4) * 16 * kSwzRow;
        const uint64_t ad =
            sw128_desc(xt + (kk / 4) * kBoxBytes + (kk % 4) * 32);
        wgmma_ss_mn(db[0], ad, sw128_desc(sh + off), kk > 0);
        wgmma_ss_mn(db[0], ad, sw128_desc(sl + off), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      pin(db[0]);
      if (cb == kNH - 1) bar_arrive(3, 256);  // ds_out read
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float wk = sc->w[f.r0 + 8 * i];
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          db[0][4 * nb + 2 * i] *= wk;
          db[0][4 * nb + 2 * i + 1] *= wk;
        }
      }
      state_product<1>(db, dh, dl, ct + cb * kBoxBytes);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = f.r0 + 8 * i;
        if (k >= n) continue;
        bf16* row = dB + ((tok0 + k) * d.H + h) * N + 64 * cb + f.col0;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * nb) =
              __floats2bfloat162_rn(db[0][4 * nb + 2 * i],
                                    db[0][4 * nb + 2 * i + 1]);
      }
    }
  }
  __syncthreads();

  // dcs, its reverse cumsum da, ddt (out) and this chunk's share of dA:
  // warp 0, two tokens a lane (rows past n are 0 throughout)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, k = 2 * lane;
    const float dot = ((sc->red[0] + sc->red[1]) + sc->red[2]) + sc->red[3];
    float v[2], wsum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float wv = sc->dt[k + j] * sc->r2[k + j];
      v[j] = sc->rsum[k + j] - sc->csum[k + j] + sc->inter[k + j] - wv;
      wsum += wv;
    }
    wsum = warp_sum(wsum);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (k + j == n - 1) v[j] += wsum + e_end * dot;
    // suffix sums over the lanes' pairs
    float suf = v[0] + v[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(kFull, suf, o);
      if (lane + o < 32) suf += u;
    }
    const float da[2] = {suf, suf - v[0]};
    float share = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (k + j < n) ddt[(tok0 + k + j) * d.H + h] = da[j] * a + sc->r12[k + j];
      share = fmaf(da[j], sc->dt[k + j], share);
    }
    share = warp_sum(share);
    if (lane == 0) dA_part[((int64_t)b * d.nc + c) * d.H + h] = share;
  }
}

template <int N, int P>
int launch_wgmma(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* dy,
                 const void* dstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* states, void* dstates, void* dA_part,
                 void* flags, const Dims& d, cudaStream_t stream) {
  using L = BwdLayout<N, P>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tc, tb, tx, tdy;
  if (!tensor_map(&tc, enc, Cm, d.B, d.S, d.H * N, kQ) ||
      !tensor_map(&tb, enc, Bm, d.B, d.S, d.H * N, kQ) ||
      !tensor_map(&tx, enc, x, d.B, d.S, d.H * P, kQ) ||
      !tensor_map(&tdy, enc, dy, d.B, d.S, d.H * P, kQ))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(states_wgmma<N, P>, L::kStatesSmem);
  if (err == cudaSuccess) err = allow_smem(chunk_wgmma<N, P>, L::kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  // flags: the two tickets, then s_in's and ds_out's, [B, H, n_chunks] each
  unsigned* fl = (unsigned*)flags;
  const int64_t n_blocks = (int64_t)d.B * d.H * d.nc;
  if (d.nc > 1) {
    states_wgmma<N, P><<<(unsigned)(n_blocks - d.B * d.H), 128,
                         L::kStatesSmem, stream>>>(
        tb, tx, (const float*)dt, (const float*)A, (float*)states, fl + 2,
        fl, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  chunk_wgmma<N, P><<<(unsigned)n_blocks, 256, L::kChunkSmem, stream>>>(
      tc, tb, tx, tdy, (const float*)dt, (const float*)A,
      (const float*)states, (float*)dstates, (const float*)dstate, (bf16*)dx,
      (float*)ddt, (bf16*)dB, (bf16*)dC, (float*)dA_part,
      fl + 2 + n_blocks, fl + 1, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dA_kernel<<<(d.H + 127) / 128, 128, 0, stream>>>(
      (const float*)dA_part, (float*)dA, d.B * d.nc, d.H);
  return (int)cudaGetLastError();
}

}  // namespace repro_ssd_bwd

// 1 when (dtype, N, P, Q) takes the wgmma variant, 0 for the simt one: the
// forward's rule (ssd_chunk.cu's repro_ssd_chunk_variant).
extern "C" int repro_ssd_chunk_bwd_variant(int dtype, int N, int P, int Q) {
  return dtype == 1 && (N == 64 || N == 128) && (P == 64 || P == 128) &&
                 Q == repro_ssd_bwd::kQ
             ? 1
             : 0;
}

// Shared memory the largest block of the variant taken at (dtype, N, P, Q)
// needs, in bytes; the launcher refuses shapes above a block's 232,448.
extern "C" long long repro_ssd_chunk_bwd_smem(int dtype, int N, int P,
                                              int Q) {
  using namespace repro_ssd_bwd;
  if (repro_ssd_chunk_bwd_variant(dtype, N, P, Q)) {
    if (N == 64 && P == 64) return (long long)BwdLayout<64, 64>::kChunkSmem;
    if (N == 64) return (long long)BwdLayout<64, 128>::kChunkSmem;
    if (P == 64) return (long long)BwdLayout<128, 64>::kChunkSmem;
    return (long long)BwdLayout<128, 128>::kChunkSmem;
  }
  const Dims d = make_dims(1, Q, 1, P, N, Q);
  const size_t a = increments_smem(d), b = chunk_smem(d);
  return (long long)(a > b ? a : b);
}

// dtype (of x, B, C, dy and dx, dB, dC): 0 = float32, 1 = bfloat16; dt, A,
// dstate, ddt, dA and the scratch are float32. dstate may be null (a zero
// final-state gradient). states and dstates are scratch of [B, n_chunks, H,
// N, P] floats, decay and dA_part of [B, n_chunks, H], n_chunks =
// ceil(S / Q); flags (the wgmma variant's, else unused) 2 + 2 B H n_chunks
// zeroed 32-bit words. Q is the forward's chunk length, 1..64; N, P <= 128
// within the shared-memory limit. The wgmma variant takes x, B, C and dy
// 16-byte aligned. Returns the first failed launch's cudaError_t (0 on
// success).
extern "C" int repro_ssd_chunk_bwd(int dtype, const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* dy,
                                   const void* dstate, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* states,
                                   void* dstates, void* decay, void* dA_part,
                                   void* flags, int B, int S, int H, int P,
                                   int N, int Q, void* stream) {
  using namespace repro_ssd_bwd;
  if (Q < 1 || Q > kMaxChunk || N < 1 || N > 128 || P < 1 || P > 128 ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, S, H, P, N, Q);
  const cudaStream_t st = (cudaStream_t)stream;
  if (repro_ssd_chunk_bwd_variant(dtype, N, P, Q)) {
    if (flags == nullptr) return (int)cudaErrorInvalidValue;
    if (N == 64 && P == 64)
      return launch_wgmma<64, 64>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                  dB, dC, states, dstates, dA_part, flags, d,
                                  st);
    if (N == 64)
      return launch_wgmma<64, 128>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                   dB, dC, states, dstates, dA_part, flags,
                                   d, st);
    if (P == 64)
      return launch_wgmma<128, 64>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                   dB, dC, states, dstates, dA_part, flags,
                                   d, st);
    return launch_wgmma<128, 128>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                  dB, dC, states, dstates, dA_part, flags, d,
                                  st);
  }
  if (dtype == 0)
    return launch_simt<float>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB,
                              dC, states, dstates, decay, dA_part, d, st);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt,
                                      dA, dB, dC, states, dstates, decay,
                                      dA_part, d, st);
  return (int)cudaErrorInvalidValue;
}
