// Batched SPD solve X = H^-1 B, Cholesky factorization and both triangular
// solves in one kernel — the Hopper port of kernel K2,
// dpg_slam_tpu/ops/schur_pallas.py::_kernel (schur_pallas.py:247; the
// panel-blocked _eliminate_blocked with _chol_inv_tile), wrapped there by
// spd_solve_pallas.
//
// What it computes: for each of S systems, H (n, n) float32 symmetric
// positive definite and B (n, m), the X with H X = B. Padded slots carry
// identity rows and need no special case. Pivots are clamped as in the TPU
// kernel: L[j][j]^-1 = rsqrt(max(d, 1e-30)). FP32 FMA on the CUDA cores;
// no TF32, no fast math.
//
// Layout: one CTA per system (blockIdx.x). The wrapper hands in a
// workspace of S * n * n floats; H is copied there and factored in place
// (lower triangle), right-looking, one p-wide panel at a time:
//   1. the (p, p) diagonal tile is factored in shared memory (p steps of a
//      column scale and a rank-1 update, two barriers a step);
//   2. the panel below it is loaded into shared memory and solved against
//      the tile's factor, one thread per row;
//   3. the trailing lower triangle is updated from the panel in shared
//      memory: each warp owns 4 rows x 128 columns, each thread a 4 x 4
//      register tile, reading the panel with a padded stride (p + 1), so the
//      column loads of a warp hit 32 distinct banks and the row loads are
//      broadcasts.
// The solves then run in chunks of cw right-hand-side columns held in
// shared memory: per panel, the diagonal block is solved one thread per
// column, and the rest of the rows are updated by all threads (forward:
// rows below; backward: the panel from the rows below). With m = 1 the
// row updates give one row (forward) or one panel column (backward) to a
// thread, so every thread works in each sweep.
//
// What bounds it on the H100: one CTA per system puts S of 132 SMs to work
// (1 for the dense LM solve, 4 for the Schur reoptimize at 4 shards), so
// the card's FP32 peak is far away. Per SM it is bound by shared-memory
// issue in the trailing update (8 loads per 16 FMAs) and by the barriers
// of the serial column steps (2 n for the factorization). The design keeps
// every operand of the O(n^3) and O(n^2 m) loops in shared memory and
// touches the L2-resident workspace (2.4 MB at n = 768) once per element
// per panel. Spreading one system over several CTAs (a cluster sharing
// the panel through distributed shared memory) is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kPivotFloor = 1e-30f;

__global__ void __launch_bounds__(kThreads) spd_solve_kernel(
    const float* __restrict__ H, const float* __restrict__ B, float* __restrict__ X,
    float* __restrict__ work, int n, int m, int p, int cw) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ps = p + 1;                  // padded row stride of the tiles
  float* inv = smem;                     // n: 1 / L[j][j]
  float* D = inv + n;                    // p x ps: diagonal tile
  float* big = D + p * ps;               // panel (n - p) x ps, or n x cw columns

  const size_t s = blockIdx.x;
  const float* Hs = H + s * n * n;
  float* A = work + s * n * n;
  const float* Bs = B + s * n * m;
  float* Xs = X + s * n * m;

  for (int e = tid; e < n * n; e += kThreads) A[e] = Hs[e];
  __syncthreads();

  // ---- factorization, one panel at a time.
  for (int k0 = 0; k0 < n; k0 += p) {
    const int pw = min(p, n - k0);
    const int t0 = k0 + pw;
    const int r = n - t0;
    for (int e = tid; e < pw * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      D[i * ps + c] = A[(size_t)(k0 + i) * n + k0 + c];
    }
    __syncthreads();
    for (int j = 0; j < pw; ++j) {
      const float d = D[j * ps + j];
      const float iv = rsqrtf(fmaxf(d, kPivotFloor));
      for (int i = j + 1 + tid; i < pw; i += kThreads) D[i * ps + j] *= iv;
      __syncthreads();
      if (tid == 0) {
        D[j * ps + j] = d * iv;
        inv[k0 + j] = iv;
      }
      const int w = pw - j - 1;
      for (int e = tid; e < w * w; e += kThreads) {
        const int i = j + 1 + e / w, c = j + 1 + e % w;
        if (c <= i) D[i * ps + c] -= D[i * ps + j] * D[c * ps + j];
      }
      __syncthreads();
    }
    for (int e = tid; e < pw * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      if (c <= i) A[(size_t)(k0 + i) * n + k0 + c] = D[i * ps + c];
    }
    if (r == 0) break;

    float* P = big;
    for (int e = tid; e < r * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      P[i * ps + c] = A[(size_t)(t0 + i) * n + k0 + c];
    }
    __syncthreads();
    // Panel rows: x L_D^T = a, forward substitution along the row.
    for (int i = tid; i < r; i += kThreads) {
      float* row = P + i * ps;
      for (int j = 0; j < pw; ++j) {
        float acc = row[j];
        for (int c = 0; c < j; ++c) acc -= row[c] * D[j * ps + c];
        row[j] = acc * inv[k0 + j];
      }
    }
    __syncthreads();
    for (int e = tid; e < r * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      A[(size_t)(t0 + i) * n + k0 + c] = P[i * ps + c];
    }
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
    for (int e = tid; e < n * w; e += kThreads) {
      const int i = e / w, col = e % w;
      Xs[(size_t)i * m + c0 + col] = Xc[i * cw + col];
    }
    __syncthreads();
  }
}

// Shared memory the launch needs, in bytes (ops/schur_cuda.py sizes p and
// cw by the same formula).
long long smem_bytes(int n, int p, int cw) {
  const long long panel = static_cast<long long>(n - p) * (p + 1);
  const long long cols = static_cast<long long>(n) * cw;
  return 4LL * (n + static_cast<long long>(p) * (p + 1) + (panel > cols ? panel : cols));
}

}  // namespace

extern "C" int spd_solve_launch(const float* H, const float* B, float* X, float* work,
                                int S, int n, int m, int p, int cw, void* stream) {
  const long long smem = smem_bytes(n, p, cw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spd_solve_kernel<<<S, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      H, B, X, work, n, m, p, cw);
  return static_cast<int>(cudaGetLastError());
}
