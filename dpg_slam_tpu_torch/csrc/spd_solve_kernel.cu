// Batched SPD solve X = H^-1 B, Cholesky factorization and both triangular
// solves — the Hopper port of kernel K2, dpg_slam_tpu/ops/schur_pallas.py::
// _kernel (schur_pallas.py:247; the panel-blocked _eliminate_blocked with
// _chol_inv_tile), wrapped there by spd_solve_pallas.
//
// What it computes: for each of S systems, H (n, n) float32 symmetric
// positive definite and B (n, m), the X with H X = B. Padded slots carry
// identity rows and need no special case. Pivots are clamped as in the TPU
// kernel: L[j][j]^-1 = rsqrt(max(d, 1e-30)). FP32 FMA on the CUDA cores;
// no TF32, no fast math.
//
// The factorization is right-looking, one p-wide panel at a time, in place
// in a workspace of S * n * n floats (lower triangle):
//   1. the (p, p) diagonal tile is factored in shared memory (p steps of a
//      column scale and a rank-1 update, two barriers a step);
//   2. the panel below it is solved against the tile's factor, one thread
//      per row, the row in registers (column form: the row form's FMAs in
//      its order);
//   3. the trailing lower triangle is updated from the panel:
//      A[i][c] -= sum_k P[i][k] P[c][k], k ascending, c <= i.
// It runs in one of two layouts, chosen by ops/schur_cuda.py::launch_plan:
//   * single: one CTA per system does all three (spd_solve_kernel). The
//     trailing update has each warp own 4 rows x 128 columns and each
//     thread a 4 x 4 register tile, reading the panel from shared memory
//     with a padded stride (p + 1).
//   * multi, for large n: two launches per panel from spd_solve_launch, on
//     the caller's stream. chol_panel_kernel: every CTA factors the
//     diagonal tile (the same code on the same input, so the same bits),
//     then solves its kPanelRows rows of the panel. chol_trailing_kernel:
//     one CTA per 64 x 64 tile of the trailing lower triangle. Each output
//     element's sums run in the same order as in the single layout, so the
//     workspace ends with the same factor to the bit. Then
//     spd_solve_kernel runs in solve-only mode on the factored workspace.
// The solves run in chunks of cw right-hand-side columns held in shared
// memory, panel by panel (forward: diagonal block, then the rows below;
// backward: the panel from the rows below, then the diagonal block):
//   * m >= 32: one thread per column in the diagonal blocks, and all
//     threads over (row, column) pairs in the off-diagonal updates, which
//     read A from the L2-resident workspace.
//   * m < 32: one warp per column in the diagonal blocks, each lane holding
//     two of the block's rows in registers and taking x[j] by shuffle from
//     its owner (forward: the same FMAs in the same order as the row form;
//     backward: column form, x[j] subtracted from the rows above it as
//     soon as it is final). The off-diagonal updates stage kStageRows rows
//     of the panel's columns through shared memory with coalesced loads
//     and keep each sum's order.
//
// What bounds it on the H100: the diagonal tiles, one after another. Each
// is p steps of a column scale and a rank-1 update with two barriers, on
// one SM, and the multi layout's n / p panel launches each wait for one
// (at n = 768 the panel launches take ~0.6 ms of its ~0.95 ms). Next come the
// gaps between its 2 n / p launches, and the substitutions' dependent FMA
// chains. The O(n^3) trailing update, bound by shared-memory issue (8
// loads per 16 FMAs), is spread over up to 66 CTAs at n = 768 in the multi
// layout; in the single layout it runs on one SM per system.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kPivotFloor = 1e-30f;
constexpr int kStageRows = 256;  // rows of A per staged tile in the m < 32 solves
constexpr int kMaxOut = 8;       // backward outputs a thread holds there: p * w <= 64 * 31
constexpr int kPanelRows = 256;  // panel rows one CTA of chol_panel_kernel solves
constexpr int kTile = 64;        // rows and columns of a chol_trailing_kernel tile

// Factor the (pw, pw) tile D (row stride ps) in place; inv[j] = 1 / L[j][j].
// The rank-1 update gives each warp rows and each lane columns, so no
// thread divides to find its element.
__device__ __forceinline__ void factor_tile(float* D, float* inv, int pw, int ps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < pw; ++j) {
    const float d = D[j * ps + j];
    const float iv = rsqrtf(fmaxf(d, kPivotFloor));
    for (int i = j + 1 + tid; i < pw; i += kThreads) D[i * ps + j] *= iv;
    __syncthreads();
    if (tid == 0) {
      D[j * ps + j] = d * iv;
      inv[j] = iv;
    }
    for (int i = j + 1 + warp; i < pw; i += kWarps) {
      const float lij = D[i * ps + j];
      for (int c = j + 1 + lane; c <= i; c += 32) D[i * ps + c] -= lij * D[c * ps + j];
    }
    __syncthreads();
  }
}

// Panel rows: x L_D^T = a for each of `rows` rows of P (stride ps), one
// thread per row. Column form with the row in registers: once x[c] is
// final, x[j] -= D[j][c] x[c] for every j > c, so each x[j] takes the row
// form's FMAs (c ascending) in the same order, and the FMAs of one step are
// independent of each other where the row form chains them all.
template <int PW>
__device__ __forceinline__ void solve_panel_rows_fixed(float* P, const float* D, const float* inv,
                                                       int rows, int ps) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    float* row = P + i * ps;
    float x[PW];
#pragma unroll
    for (int j = 0; j < PW; ++j) x[j] = row[j];
#pragma unroll
    for (int c = 0; c < PW; ++c) {
      x[c] *= inv[c];
#pragma unroll
      for (int j = c + 1; j < PW; ++j) x[j] -= D[j * ps + c] * x[c];
    }
#pragma unroll
    for (int j = 0; j < PW; ++j) row[j] = x[j];
  }
}

// A panel with rows below it is p wide, and p is 64, 32 or 16 then
// (launch_shape in ops/schur_cuda.py; p = n < 64 leaves no rows below).
__device__ __forceinline__ void solve_panel_rows(float* P, const float* D, const float* inv,
                                                 int rows, int pw, int ps) {
  switch (pw) {
    case 64: return solve_panel_rows_fixed<64>(P, D, inv, rows, ps);
    case 32: return solve_panel_rows_fixed<32>(P, D, inv, rows, ps);
    case 16: return solve_panel_rows_fixed<16>(P, D, inv, rows, ps);
  }
}

// Copy `rows` rows of the pw <= 64 columns at A (row stride n) into S
// (stride ps): each thread one column of every fourth row, 8 loads in
// flight.
__device__ __forceinline__ void load_rows(float* S, const float* A, int n, int rows, int pw, int ps) {
  const int c = threadIdx.x & 63;
  if (c >= pw) return;
#pragma unroll 8
  for (int i = threadIdx.x >> 6; i < rows; i += kThreads / 64) S[i * ps + c] = A[(size_t)i * n + c];
}

// The inverse copy, S into A.
__device__ __forceinline__ void store_rows(float* A, const float* S, int n, int rows, int pw, int ps) {
  const int c = threadIdx.x & 63;
  if (c >= pw) return;
#pragma unroll 8
  for (int i = threadIdx.x >> 6; i < rows; i += kThreads / 64) A[(size_t)i * n + c] = S[i * ps + c];
}

// Copy the (pw, pw) tile at A (row stride n) into D (row stride ps).
__device__ __forceinline__ void load_tile(float* D, const float* A, int n, int pw, int ps) {
  load_rows(D, A, n, pw, pw, ps);
}

// L_D y = x for one right-hand-side column by one warp: x[i * cw] is row i
// of the diagonal block, each lane holds rows lane and lane + 32 (pw <= 64)
// in registers. Column form: once x[j] is final, every row below it takes
// x[i] -= D[i][j] x[j]; each row gets the row form's FMAs in its order.
__device__ __forceinline__ void diag_forward(float* x, int cw, const float* D, const float* inv,
                                             int pw, int ps) {
  const int i0 = threadIdx.x & 31, i1 = i0 + 32;
  float r0 = i0 < pw ? x[i0 * cw] : 0.f;
  float r1 = i1 < pw ? x[i1 * cw] : 0.f;
  for (int j = 0; j < pw; ++j) {
    const float xj = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j & 31) * inv[j];
    if (i0 == j) r0 = xj;
    if (i1 == j) r1 = xj;
    if (i0 > j && i0 < pw) r0 -= D[i0 * ps + j] * xj;
    if (i1 > j && i1 < pw) r1 -= D[i1 * ps + j] * xj;
  }
  if (i0 < pw) x[i0 * cw] = r0;
  if (i1 < pw) x[i1 * cw] = r1;
}

// L_D^T x = y for one column by one warp, column form from the last row up:
// once x[j] is final, every row above it takes x[i] -= D[j][i] x[j].
__device__ __forceinline__ void diag_backward(float* x, int cw, const float* D, const float* inv,
                                              int pw, int ps) {
  const int i0 = threadIdx.x & 31, i1 = i0 + 32;
  float r0 = i0 < pw ? x[i0 * cw] : 0.f;
  float r1 = i1 < pw ? x[i1 * cw] : 0.f;
  for (int j = pw - 1; j >= 0; --j) {
    const float xj = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j & 31) * inv[j];
    if (i0 == j) r0 = xj;
    if (i1 == j) r1 = xj;
    if (i0 < j) r0 -= D[j * ps + i0] * xj;
    if (i1 < j) r1 -= D[j * ps + i1] * xj;
  }
  if (i0 < pw) x[i0 * cw] = r0;
  if (i1 < pw) x[i1 * cw] = r1;
}

// Forward and backward solves of w < 32 columns held in Xc (n x cw), with
// A's panel columns staged through S (kStageRows x ps).
__device__ __forceinline__ void solve_few_columns(const float* A, float* Xc, float* D, float* S,
                                                  const float* inv, int n, int p, int ps, int cw,
                                                  int w) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // L Y = B.
  for (int k0 = 0; k0 < n; k0 += p) {
    const int pw = min(p, n - k0);
    const int t0 = k0 + pw;
    load_tile(D, A + (size_t)k0 * n + k0, n, pw, ps);
    __syncthreads();
    for (int col = warp; col < w; col += kWarps) diag_forward(Xc + k0 * cw + col, cw, D, inv + k0, pw, ps);
    __syncthreads();
    for (int t = t0; t < n; t += kStageRows) {
      const int rows = min(kStageRows, n - t);
      load_rows(S, A + (size_t)t * n + k0, n, rows, pw, ps);
      __syncthreads();
      for (int e = tid; e < rows * w; e += kThreads) {
        const int i = e / w, col = e % w;
        const float* si = S + i * ps;
        float acc = 0.f;
        for (int c = 0; c < pw; ++c) acc += si[c] * Xc[(k0 + c) * cw + col];
        Xc[(t + i) * cw + col] -= acc;
      }
      __syncthreads();
    }
  }
  // L^T X = Y, from the last panel up.
  for (int k0 = ((n - 1) / p) * p; k0 >= 0; k0 -= p) {
    const int pw = min(p, n - k0);
    const int t0 = k0 + pw;
    const int outs = pw * w;
    float acc[kMaxOut];
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;
    for (int t = t0; t < n; t += kStageRows) {
      const int rows = min(kStageRows, n - t);
      load_rows(S, A + (size_t)t * n + k0, n, rows, pw, ps);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMaxOut; ++u) {
        const int e = tid + u * kThreads;
        if (e < outs) {
          const int c = e / w, col = e % w;
          for (int i = 0; i < rows; ++i) acc[u] += S[i * ps + c] * Xc[(t + i) * cw + col];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int e = tid + u * kThreads;
      if (e < outs) Xc[(k0 + e / w) * cw + e % w] -= acc[u];
    }
    load_tile(D, A + (size_t)k0 * n + k0, n, pw, ps);
    __syncthreads();
    for (int col = warp; col < w; col += kWarps) diag_backward(Xc + k0 * cw + col, cw, D, inv + k0, pw, ps);
    __syncthreads();
  }
}

// One CTA per system. factored = 0: copy H to the workspace and factor it
// (the single layout); factored = 1: the workspace already holds the factor
// and inv_g its reciprocal pivots (the multi layout). Then the solves.
__global__ void __launch_bounds__(kThreads) spd_solve_kernel(
    const float* __restrict__ H, const float* __restrict__ B, float* __restrict__ X,
    float* __restrict__ work, const float* __restrict__ inv_g, int n, int m, int p, int cw,
    int small, int factored) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ps = p + 1;                  // padded row stride of the tiles
  float* inv = smem;                     // n: 1 / L[j][j]
  float* D = inv + n;                    // p x ps: diagonal tile
  float* big = D + p * ps;               // panel (n - p) x ps, or n x cw columns (+ staging)

  const size_t s = blockIdx.x;
  const float* Hs = H + s * n * n;
  float* A = work + s * n * n;
  const float* Bs = B + s * n * m;
  float* Xs = X + s * n * m;

  if (factored) {
    for (int e = tid; e < n; e += kThreads) inv[e] = inv_g[s * n + e];
  } else {
    for (int e = tid; e < n * n; e += kThreads) A[e] = Hs[e];
    __syncthreads();

    // ---- factorization, one panel at a time.
    for (int k0 = 0; k0 < n; k0 += p) {
      const int pw = min(p, n - k0);
      const int t0 = k0 + pw;
      const int r = n - t0;
      load_tile(D, A + (size_t)k0 * n + k0, n, pw, ps);
      __syncthreads();
      factor_tile(D, inv + k0, pw, ps);
      for (int e = tid; e < pw * pw; e += kThreads) {
        const int i = e / pw, c = e % pw;
        if (c <= i) A[(size_t)(k0 + i) * n + k0 + c] = D[i * ps + c];
      }
      if (r == 0) break;

      float* P = big;
      load_rows(P, A + (size_t)t0 * n + k0, n, r, pw, ps);
      __syncthreads();
      solve_panel_rows(P, D, inv + k0, r, pw, ps);
      __syncthreads();
      store_rows(A + (size_t)t0 * n + k0, P, n, r, pw, ps);
      // Trailing lower triangle: A[t0 + i][t0 + c] -= P[i] . P[c], c <= i.
      for (int g = warp; g * 4 < r; g += kWarps) {
        const int i0 = g * 4;
        const int last = min(i0 + 3, r - 1);
        int ia[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) ia[u] = min(i0 + u, r - 1) * ps;
        for (int jb = 0; jb <= last; jb += 128) {
          int ib[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) ib[v] = min(jb + lane + 32 * v, r - 1) * ps;
          float acc[4][4] = {};
          for (int c = 0; c < pw; ++c) {
            float a[4], b[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = P[ia[u] + c];
#pragma unroll
            for (int v = 0; v < 4; ++v) b[v] = P[ib[v] + c];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u;
            if (i >= r) continue;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int c = jb + lane + 32 * v;
              if (c <= i) A[(size_t)(t0 + i) * n + t0 + c] -= acc[u][v];
            }
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- forward and backward solves, cw right-hand sides at a time.
  float* Xc = big;
  const int last_k0 = ((n - 1) / p) * p;
  for (int c0 = 0; c0 < m; c0 += cw) {
    const int w = min(cw, m - c0);
    for (int e = tid; e < n * w; e += kThreads) {
      const int i = e / w, col = e % w;
      Xc[i * cw + col] = Bs[(size_t)i * m + c0 + col];
    }
    if (small) {
      solve_few_columns(A, Xc, D, Xc + n * cw, inv, n, p, ps, cw, w);
    } else {
      // L Y = B.
      for (int k0 = 0; k0 < n; k0 += p) {
        const int pw = min(p, n - k0);
        const int t0 = k0 + pw;
        for (int e = tid; e < pw * pw; e += kThreads) {
          const int i = e / pw, c = e % pw;
          D[i * ps + c] = A[(size_t)(k0 + i) * n + k0 + c];
        }
        __syncthreads();
        for (int col = tid; col < w; col += kThreads) {
          for (int j = 0; j < pw; ++j) {
            float acc = Xc[(k0 + j) * cw + col];
            for (int c = 0; c < j; ++c) acc -= D[j * ps + c] * Xc[(k0 + c) * cw + col];
            Xc[(k0 + j) * cw + col] = acc * inv[k0 + j];
          }
        }
        __syncthreads();
        for (int e = tid; e < (n - t0) * w; e += kThreads) {
          const int i = t0 + e / w, col = e % w;
          const float* li = A + (size_t)i * n + k0;
          float acc = 0.f;
          for (int c = 0; c < pw; ++c) acc += li[c] * Xc[(k0 + c) * cw + col];
          Xc[i * cw + col] -= acc;
        }
        __syncthreads();
      }
      // L^T X = Y, from the last panel up.
      for (int k0 = last_k0; k0 >= 0; k0 -= p) {
        const int pw = min(p, n - k0);
        const int t0 = k0 + pw;
        for (int e = tid; e < pw * w; e += kThreads) {
          const int c = e / w, col = e % w;
          float acc = 0.f;
          for (int i = t0; i < n; ++i) acc += A[(size_t)i * n + k0 + c] * Xc[i * cw + col];
          Xc[(k0 + c) * cw + col] -= acc;
        }
        for (int e = tid; e < pw * pw; e += kThreads) {
          const int i = e / pw, c = e % pw;
          D[i * ps + c] = A[(size_t)(k0 + i) * n + k0 + c];
        }
        __syncthreads();
        for (int col = tid; col < w; col += kThreads) {
          for (int j = pw - 1; j >= 0; --j) {
            float acc = Xc[(k0 + j) * cw + col];
            for (int c = j + 1; c < pw; ++c) acc -= D[c * ps + j] * Xc[(k0 + c) * cw + col];
            Xc[(k0 + j) * cw + col] = acc * inv[k0 + j];
          }
        }
        __syncthreads();
      }
    }
    for (int e = tid; e < n * w; e += kThreads) {
      const int i = e / w, col = e % w;
      Xs[(size_t)i * m + c0 + col] = Xc[i * cw + col];
    }
    __syncthreads();
  }
}

// Multi layout, panel k0 (grid: row blocks x systems). Every CTA factors
// the diagonal tile; CTA 0 stores the reciprocal pivots and the factored
// tile. The other CTAs read the unfactored tile from A in this launch, so
// the factor goes to dfac (S x p x p) and the trailing launch copies it in;
// the last panel, which has no rows below and one CTA, writes A directly.
// Then each CTA solves its kPanelRows rows of the panel.
__global__ void __launch_bounds__(kThreads) chol_panel_kernel(
    float* __restrict__ work, float* __restrict__ inv_g, float* __restrict__ dfac, int n, int p,
    int k0) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int ps = p + 1;
  float* inv = smem;       // p
  float* D = inv + p;      // p x ps
  float* P = D + p * ps;   // kPanelRows x ps
  const size_t s = blockIdx.y;
  float* A = work + s * n * n;
  const int pw = min(p, n - k0);
  const int t0 = k0 + pw;
  const int r = n - t0;

  load_tile(D, A + (size_t)k0 * n + k0, n, pw, ps);
  __syncthreads();
  factor_tile(D, inv, pw, ps);
  if (blockIdx.x == 0) {
    for (int j = tid; j < pw; j += kThreads) inv_g[s * n + k0 + j] = inv[j];
    float* dst = r == 0 ? A + (size_t)k0 * n + k0 : dfac + s * p * p;
    const int ld = r == 0 ? n : p;
    for (int e = tid; e < pw * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      if (c <= i) dst[(size_t)i * ld + c] = D[i * ps + c];
    }
  }
  const int i0 = blockIdx.x * kPanelRows;
  const int rows = min(kPanelRows, r - i0);
  if (rows <= 0) return;
  float* Ab = A + (size_t)(t0 + i0) * n + k0;
  load_rows(P, Ab, n, rows, pw, ps);
  __syncthreads();
  solve_panel_rows(P, D, inv, rows, pw, ps);
  __syncthreads();
  store_rows(Ab, P, n, rows, pw, ps);
}

// Multi layout, trailing update of panel k0 (a full panel: pw = p), one CTA
// per kTile x kTile tile (bi, bj), bj <= bi, of the trailing lower triangle
// (grid: tiles x systems): A[i][c] -= sum_k P[i][k] P[c][k], k ascending,
// c <= i, as in the single layout. Each thread holds a 4 x 4 register tile
// (rows 4 ty + u, columns tx + 16 v); the padded stride keeps the column
// loads on distinct banks. CTA 0 also copies the panel's factored diagonal
// tile from dfac into A.
__global__ void __launch_bounds__(kThreads) chol_trailing_kernel(
    float* __restrict__ work, const float* __restrict__ dfac, int n, int p, int k0) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int ps = p + 1;
  const size_t s = blockIdx.y;
  float* A = work + s * n * n;
  const int t0 = k0 + p;
  const int r = n - t0;

  if (blockIdx.x == 0) {
    const float* src = dfac + s * p * p;
    for (int e = tid; e < p * p; e += kThreads) {
      const int i = e / p, c = e % p;
      if (c <= i) A[(size_t)(k0 + i) * n + k0 + c] = src[e];
    }
  }
  const int q = blockIdx.x;
  int bi = static_cast<int>((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
  while (bi * (bi + 1) / 2 > q) --bi;
  const int ri = bi * kTile, rj = (q - bi * (bi + 1) / 2) * kTile;

  float* Pi = smem;              // kTile x ps: panel rows of the tile's rows
  float* Pj = Pi + kTile * ps;   // kTile x ps: panel rows of its columns
  // Rows past r are left unset: their sums are never stored.
  load_rows(Pi, A + (size_t)(t0 + ri) * n + k0, n, min(kTile, r - ri), p, ps);
  load_rows(Pj, A + (size_t)(t0 + rj) * n + k0, n, min(kTile, r - rj), p, ps);
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  for (int c = 0; c < p; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = Pi[(4 * ty + u) * ps + c];
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = Pj[(tx + 16 * v) * ps + c];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ri + 4 * ty + u;
    if (i >= r) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = rj + tx + 16 * v;
      if (c <= i) A[(size_t)(t0 + i) * n + t0 + c] -= acc[u][v];
    }
  }
}

// Shared memory of spd_solve_kernel in bytes (ops/schur_cuda.py sizes p
// and cw by the same formula): the panel only when it factors, the
// staging tile only for m < 32.
long long smem_bytes(int n, int p, int cw, int small, int factor) {
  const long long ps = p + 1;
  const long long panel = factor ? (n - p) * ps : 0;
  const long long cols = static_cast<long long>(n) * cw + (small ? kStageRows * ps : 0);
  return 4LL * (n + p * ps + (panel > cols ? panel : cols));
}

int set_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

}  // namespace

// Plain C entry point (bound with ctypes). Issues every launch on `stream`,
// does not synchronise, and returns the first nonzero cudaError_t. multi = 0:
// one spd_solve_kernel launch. multi = 1: the workspace copy, then per panel
// chol_panel_kernel and (below the last) chol_trailing_kernel, then
// spd_solve_kernel in solve-only mode; inv (S x n) and dfac (S x p x p) are
// its scratch.
extern "C" int spd_solve_launch(const float* H, const float* B, float* X, float* work, float* inv,
                                float* dfac, int S, int n, int m, int p, int cw, int small,
                                int multi, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = 0;
  if (multi) {
    err = static_cast<int>(cudaMemcpyAsync(work, H, sizeof(float) * S * n * n,
                                           cudaMemcpyDeviceToDevice, stream));
    if (err) return err;
    const long long panel_smem = 4LL * (p + (p + 1LL) * (p + kPanelRows));
    const long long tile_smem = 4LL * 2 * kTile * (p + 1LL);
    if ((err = set_smem(reinterpret_cast<const void*>(chol_panel_kernel), panel_smem))) return err;
    if ((err = set_smem(reinterpret_cast<const void*>(chol_trailing_kernel), tile_smem))) return err;
    for (int k0 = 0; k0 < n; k0 += p) {
      const int r = n - k0 - (n - k0 < p ? n - k0 : p);
      const int blocks = r > 0 ? (r + kPanelRows - 1) / kPanelRows : 1;
      chol_panel_kernel<<<dim3(blocks, S), kThreads, static_cast<size_t>(panel_smem), stream>>>(
          work, inv, dfac, n, p, k0);
      if ((err = static_cast<int>(cudaGetLastError()))) return err;
      if (r > 0) {
        const int nt = (r + kTile - 1) / kTile;
        chol_trailing_kernel<<<dim3(nt * (nt + 1) / 2, S), kThreads, static_cast<size_t>(tile_smem),
                               stream>>>(work, dfac, n, p, k0);
        if ((err = static_cast<int>(cudaGetLastError()))) return err;
      }
    }
  }
  const long long smem = smem_bytes(n, p, cw, small, !multi);
  if ((err = set_smem(reinterpret_cast<const void*>(spd_solve_kernel), smem))) return err;
  spd_solve_kernel<<<S, kThreads, static_cast<size_t>(smem), stream>>>(
      H, B, X, work, inv, n, m, p, cw, small, multi);
  return static_cast<int>(cudaGetLastError());
}
