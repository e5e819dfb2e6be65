// Batched point-to-line ICP, the whole iteration loop in one kernel —
// the Hopper port of kernel K1, dpg_slam_tpu/ops/icp_pallas.py::_kernel
// (+ _finish_iteration), launched there by _run_kernel.
//
// What it computes per pair (the Pallas kernel's iteration): transform the
// source by (tx, ty, th); squared distances to every target; tie-inclusive
// nearest target (d2 <= rowmin, tied matches are averaged); gate at
// max_corr * multiplier with the multiplier annealed linearly to 1 over
// anneal_iters; optional reciprocal test (d2 <= colmin[j]); averaged
// matched target points and normals; point-to-line residuals; 3x3 normal
// equations with trace-relative damping (damping * tr / 3); cofactor solve;
// step; angle wrap; per-pair freeze (step^2 <= eps, or the fitness stalls;
// annealing pairs are held through their schedule).
//
// Exit: each pair exits on its own (the TPU kernel exits per block of 8
// pairs), so its `iters` column counts only its own iterations. A frozen
// pair takes no further steps; one final pass then evaluates its match
// count, fitness and damped H (and, in Censi mode, the 8 Censi sums) at the
// final transform and the fine gate. These statistics therefore do not
// depend on which other pairs share the launch; the plain version
// (ops/icp.py) evaluates them the same way.
//
// Layout: one CTA per pair. The source side (x, y, mask and the moved
// x, y: 5 * Ps floats) and the target side (x, y, normal x, y and the
// col-min array: 5 * Pt floats) sit in shared memory: 10 KB at
// Ps = Pt = 256, 46 KB at Ps = 256 against Pt = 2,048 (the DPG local
// registration). Threads stride over points, so neither count is tied to
// blockDim.
// d2 is recomputed in each sweep (col-min, row-min, accumulate) instead of
// storing Ps x Pt values.
//
// What bounds it on the H100: at B = 9 (one keyframe's 1 + K pairs) 9 of
// 132 SMs hold a CTA and the run is latency-bound on the per-iteration
// barriers and the single-thread 3x3 solve; at B ~ 1.7k (the compacted
// reoptimize sweep) it is bound by instruction issue of the three Ps x Pt
// sweeps per iteration (~10 flops per (i, j) in each). Shared-memory reads
// in the sweeps are warp-uniform broadcasts, so there are no bank conflicts.
//
// Numerics: d2 comes from one helper with explicit round-to-nearest
// intrinsics, so nvcc cannot contract it into FMAs differently in the three
// sweeps — the match test compares d2 <= rowmin for equality. The angle
// wrap uses rintf (round half to even, as jnp.round). No fast math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOutCols = 24;
constexpr int kSums = 11;   // H00 H01 H02 H11 H12 H22 g0 g1 g2 ncorr sum(w*nn_d2)
constexpr int kCensi = 8;   // n su_x su_y htt q_tt srv1 srv2 p_tt
constexpr int kAll = kSums + kCensi;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 1e12f;

__device__ __forceinline__ float sqdist(float ax, float ay, float bx, float by) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of the first n of N per-thread partials; the totals land
// in out[0..n) (shared), visible to every thread after the call.
template <int N>
__device__ __forceinline__ void block_sums(float (&part)[N], int n, float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      const float v = warp_sum(part[k]);
      if (lane == 0) red[warp * N + k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * N + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

struct Pair {
  const float *sx, *sy, *tx, *ty, *nx, *ny, *sm;  // shared input planes
  float *mx, *my, *colmin;                          // shared scratch
  int Ps, Pt;
  bool reciprocal;
};

// Moved source into shared memory; col-min per target when reciprocal.
__device__ __forceinline__ void transform_and_colmin(const Pair& p, float c, float s,
                                                     float ptx, float pty) {
  for (int i = threadIdx.x; i < p.Ps; i += kThreads) {
    p.mx[i] = __fadd_rn(__fsub_rn(__fmul_rn(c, p.sx[i]), __fmul_rn(s, p.sy[i])), ptx);
    p.my[i] = __fadd_rn(__fadd_rn(__fmul_rn(s, p.sx[i]), __fmul_rn(c, p.sy[i])), pty);
  }
  __syncthreads();
  if (p.reciprocal) {
    for (int j = threadIdx.x; j < p.Pt; j += kThreads) {
      const float x = p.tx[j], y = p.ty[j];
      float m = INFINITY;
      for (int i = 0; i < p.Ps; ++i) m = fminf(m, sqdist(p.mx[i], p.my[i], x, y));
      p.colmin[j] = m;
    }
    __syncthreads();
  }
}

struct Match {
  float rowmin, cnt, qx, qy, qnx, qny, wf;
};

// Row-min of source i, then its matches' count and averaged target
// coordinates and normals; wf = 1 when it has a match and is valid.
__device__ __forceinline__ Match match_point(const Pair& p, int i, float gate_sq) {
  const float x = p.mx[i], y = p.my[i];
  Match m;
  m.rowmin = INFINITY;
  for (int j = 0; j < p.Pt; ++j) m.rowmin = fminf(m.rowmin, sqdist(x, y, p.tx[j], p.ty[j]));
  float cnt = 0.f, sx = 0.f, sy = 0.f, snx = 0.f, sny = 0.f;
  for (int j = 0; j < p.Pt; ++j) {
    const float d2 = sqdist(x, y, p.tx[j], p.ty[j]);
    if (d2 <= m.rowmin && d2 <= gate_sq && (!p.reciprocal || d2 <= p.colmin[j])) {
      cnt += 1.f;
      sx += p.tx[j];
      sy += p.ty[j];
      snx += p.nx[j];
      sny += p.ny[j];
    }
  }
  const float inv = 1.f / fmaxf(cnt, 1.f);
  m.cnt = cnt;
  m.qx = sx * inv;
  m.qy = sy * inv;
  m.qnx = snx * inv;
  m.qny = sny * inv;
  m.wf = (cnt > 0.f && p.sm[i] > 0.5f) ? 1.f : 0.f;
  return m;
}

// Point-to-line normal-equation terms of source i (the Pallas kernel's
// _finish_iteration reductions) added to part[0..kSums).
template <int N>
__device__ __forceinline__ void add_p2l_terms(const Pair& p, int i, const Match& m,
                                              float ptx, float pty, float (&part)[N]) {
  const float ex = p.mx[i] - m.qx;
  const float ey = p.my[i] - m.qy;
  const float r = m.qnx * ex + m.qny * ey;
  const float drx = -(p.my[i] - pty);
  const float dry = p.mx[i] - ptx;
  const float nd = m.qnx * drx + m.qny * dry;
  const float wf = m.wf;
  part[0] += wf * m.qnx * m.qnx;
  part[1] += wf * m.qnx * m.qny;
  part[2] += wf * m.qnx * nd;
  part[3] += wf * m.qny * m.qny;
  part[4] += wf * m.qny * nd;
  part[5] += wf * nd * nd;
  part[6] += wf * m.qnx * r;
  part[7] += wf * m.qny * r;
  part[8] += wf * nd * r;
  part[9] += wf;
  part[10] += wf * m.rowmin;
}

// Censi sandwich accumulators of source i at transform (ftx, fty, c, s),
// point-to-point residuals (ops/icp.censi_sums), added to part[kSums..).
__device__ __forceinline__ void add_censi_terms(const Pair& p, int i, const Match& m,
                                                float ftx, float fty, float c, float s,
                                                float (&part)[kAll]) {
  const float wf = m.wf;
  const float rx = (p.mx[i] - m.qx) * wf;
  const float ry = (p.my[i] - m.qy) * wf;
  const float rpx = p.mx[i] - ftx;
  const float rpy = p.my[i] - fty;
  const float ux = -rpy * wf;
  const float uy = rpx * wf;
  const float uu = ux * ux + uy * uy;
  const float v1 = c * ux + s * uy - s * rx + c * ry;
  const float v2 = -s * ux + c * uy - c * rx - s * ry;
  float* q = part + kSums;
  q[0] += wf;
  q[1] += ux;
  q[2] += uy;
  q[3] += uu - rx * rpx - ry * rpy;
  q[4] += uu;
  q[5] += c * v1 - s * v2;
  q[6] += s * v1 + c * v2;
  q[7] += v1 * v1 + v2 * v2;
}

__global__ void __launch_bounds__(kThreads) icp_p2l_kernel(
    const float* __restrict__ src_planes,  // (3, B, Ps): src x/y (masked at -1e4), src mask
    const float* __restrict__ tgt_planes,  // (4, B, Pt): tgt x/y (masked at +1e4), normal x/y
    const float* __restrict__ seeds,       // (B, 4): tx, ty, th, gate multiplier
    float* __restrict__ out,               // (B, 24)
    int B, int Ps, int Pt, int max_iterations, int anneal_iters, float max_corr,
    int reciprocal, float epsilon, float damping, int censi,
    float error_delta_rel_tol) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps * kAll];
  __shared__ float tot[kAll];
  // Carry, written by thread 0 and read by all after a barrier:
  // tx ty th active fitness
  __shared__ float st[5];

  Pair p;
  float* sm_src = smem;            // sx sy sm, then mx my
  float* sm_tgt = smem + 5 * Ps;   // tx ty nx ny, then colmin
  p.sx = sm_src;
  p.sy = p.sx + Ps;
  p.sm = p.sy + Ps;
  p.mx = sm_src + 3 * Ps;
  p.my = p.mx + Ps;
  p.tx = sm_tgt;
  p.ty = p.tx + Pt;
  p.nx = p.ty + Pt;
  p.ny = p.nx + Pt;
  p.colmin = sm_tgt + 4 * Pt;
  p.Ps = Ps;
  p.Pt = Pt;
  p.reciprocal = reciprocal != 0;

  const int b = blockIdx.x;
  const size_t splane = static_cast<size_t>(B) * Ps, tplane = static_cast<size_t>(B) * Pt;
  const float* sbase = src_planes + static_cast<size_t>(b) * Ps;
  const float* tbase = tgt_planes + static_cast<size_t>(b) * Pt;
  for (int k = 0; k < 3; ++k)
    for (int i = threadIdx.x; i < Ps; i += kThreads) sm_src[k * Ps + i] = sbase[k * splane + i];
  for (int k = 0; k < 4; ++k)
    for (int j = threadIdx.x; j < Pt; j += kThreads) sm_tgt[k * Pt + j] = tbase[k * tplane + j];
  const float gate_mult = seeds[b * 4 + 3];
  if (threadIdx.x == 0) {
    st[0] = seeds[b * 4 + 0];
    st[1] = seeds[b * 4 + 1];
    st[2] = seeds[b * 4 + 2];
    st[3] = 1.f;
    st[4] = kBig;  // first fitness carry: iteration 0 never stalls
  }
  __syncthreads();

  int it = 0;
  for (; it < max_iterations && st[3] > 0.5f; ++it) {
    const float ptx = st[0], pty = st[1], pth = st[2];
    const float prog = fmaxf(0.f, 1.f - static_cast<float>(it) / static_cast<float>(anneal_iters));
    const float mult = __fadd_rn(1.f, __fmul_rn(__fsub_rn(gate_mult, 1.f), prog));
    const float gate = __fmul_rn(max_corr, mult);
    transform_and_colmin(p, cosf(pth), sinf(pth), ptx, pty);

    float part[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) part[k] = 0.f;
    for (int i = threadIdx.x; i < Ps; i += kThreads)
      add_p2l_terms(p, i, match_point(p, i, __fmul_rn(gate, gate)), ptx, pty, part);
    block_sums(part, kSums, red, tot);

    if (threadIdx.x == 0) {
      const float n_corr = tot[9];
      const float new_fitness = tot[10] / fmaxf(n_corr, 1.f);
      const float tr = (tot[0] + tot[3] + tot[5]) / 3.f;
      const float lam = damping * fmaxf(tr, 1e-12f);
      const float a00 = tot[0] + lam, a11 = tot[3] + lam, a22 = tot[5] + lam;
      const float a01 = tot[1], a02 = tot[2], a12 = tot[4];
      const float c00 = a11 * a22 - a12 * a12;
      const float c01 = a02 * a12 - a01 * a22;
      const float c02 = a01 * a12 - a02 * a11;
      const float c11 = a00 * a22 - a02 * a02;
      const float c12 = a01 * a02 - a00 * a12;
      const float c22 = a00 * a11 - a01 * a01;
      const float det = a00 * c00 + a01 * c01 + a02 * c02;
      const bool solvable = n_corr >= 3.f && fabsf(det) > 1e-20f;
      const float inv_det = solvable ? 1.f / det : 0.f;
      const float g0 = tot[6], g1 = tot[7], g2 = tot[8];
      const float stepx = -((c00 * g0 + c01 * g1 + c02 * g2) * inv_det);
      const float stepy = -((c01 * g0 + c11 * g1 + c12 * g2) * inv_det);
      const float stept = -((c02 * g0 + c12 * g1 + c22 * g2) * inv_det);
      float th = pth + stept;
      th = th - kTwoPi * rintf(th / kTwoPi);
      const float step_sq = stepx * stepx + stepy * stepy + stept * stept;
      bool moving = step_sq > epsilon;
      if (error_delta_rel_tol > 0.f) {
        const bool stalled =
            fabsf(st[4] - new_fitness) <= error_delta_rel_tol * fmaxf(new_fitness, 1e-12f);
        moving = moving && !stalled;
      }
      const bool annealing = gate_mult > 1.f && it < anneal_iters;
      st[0] = ptx + stepx;
      st[1] = pty + stepy;
      st[2] = th;
      st[3] = (moving || annealing) ? 1.f : 0.f;
      st[4] = new_fitness;
    }
    __syncthreads();
  }

  // Final pass at the final transform and the fine gate: the exit
  // statistics, and the Censi sums in Censi mode.
  const float ftx = st[0], fty = st[1], fth = st[2];
  const float c = cosf(fth), s = sinf(fth);
  transform_and_colmin(p, c, s, ftx, fty);
  float part[kAll];
#pragma unroll
  for (int k = 0; k < kAll; ++k) part[k] = 0.f;
  for (int i = threadIdx.x; i < Ps; i += kThreads) {
    const Match m = match_point(p, i, __fmul_rn(max_corr, max_corr));
    add_p2l_terms(p, i, m, ftx, fty, part);
    if (censi) add_censi_terms(p, i, m, ftx, fty, c, s, part);
  }
  block_sums(part, censi ? kAll : kSums, red, tot);

  if (threadIdx.x == 0) {
    const float n_corr = tot[9];
    const float lam = damping * fmaxf((tot[0] + tot[3] + tot[5]) / 3.f, 1e-12f);
    float* o = out + static_cast<size_t>(b) * kOutCols;
    o[0] = ftx; o[1] = fty; o[2] = fth;
    o[3] = n_corr;
    o[4] = tot[10] / fmaxf(n_corr, 1.f);
    o[5] = tot[0] + lam; o[6] = tot[1]; o[7] = tot[2];
    o[8] = tot[3] + lam; o[9] = tot[4]; o[10] = tot[5] + lam;
    o[11] = static_cast<float>(it);
    for (int k = 0; k < kCensi; ++k) o[12 + k] = censi ? tot[kSums + k] : 0.f;
    o[20] = 0.f; o[21] = 0.f; o[22] = 0.f; o[23] = 0.f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, returns cudaGetLastError() of the launch.
extern "C" int icp_p2l_launch(const float* src_planes, const float* tgt_planes,
                              const float* seeds, float* out,
                              int B, int Ps, int Pt, int max_iterations, int anneal_iters,
                              float max_corr, int reciprocal, float epsilon,
                              float damping, int censi, float error_delta_rel_tol,
                              void* stream) {
  const size_t smem = static_cast<size_t>(5) * (Ps + Pt) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        icp_p2l_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  icp_p2l_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src_planes, tgt_planes, seeds, out, B, Ps, Pt, max_iterations, anneal_iters, max_corr, reciprocal,
      epsilon, damping, censi, error_delta_rel_tol);
  return static_cast<int>(cudaGetLastError());
}
