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
// Two sweeps per iteration over sources x targets, d2 recomputed in each
// instead of storing Ps x Pt values, four targets (or sources) a step from
// 128-bit shared loads, with no branch inside:
//   * col-min (reciprocal mode only): one thread per target, min over the
//     sources;
//   * one fused row-min and match sweep: one thread per (source, target
//     slice) keeps the running min m, the first j at it and the
//     second-smallest distance. When the minimum is unique (the second is
//     larger) its target alone is the match, and its values are the sums
//     (count, x, y, normal x, normal y); an exact tie at the minimum inside
//     the gate rescans the slice from that j for the tied targets. The
//     sums are left folds from 0 over the tied targets in ascending j that
//     pass the gate and the reciprocal test, exactly what a row-min sweep
//     followed by a match sweep gives. The sums are not kept inside the
//     sweep (reset at each new minimum): across a warp's 32 sources some
//     lane finds a new minimum in almost every step, so the warp would take
//     that branch almost always.
//
// Two layouts of one pair, chosen by ops/icp_cuda.py::launch_plan:
//   * C = 1, one 256-thread CTA per pair. Threads stride over sources, each
//     sweeping all targets. At a batch that fills the card (the ~1.7k-pair
//     reoptimize sweep) this is bound by instruction issue of the two
//     sweeps: ~6 instructions per point pair in the col-min, ~10 in the
//     match sweep (the distance, then min, max, min and a select for the
//     running min, the second-smallest and the index), where three sweeps
//     took ~34. Targets sit in shared memory as float2.
//   * C in {2, 4, 8}: one pair over a thread-block cluster of C CTAs. At a
//     small batch (a keyframe's 9 pairs, the DPG local registration's 8)
//     one CTA per pair leaves most SMs idle and each busy SM issue-bound
//     on a whole pair; the cluster gives each SM 1/C of the pair. Every
//     CTA holds all targets; CTA r owns sources r*256/C .. (r+1)*256/C - 1
//     (Ps <= 256). Its 256 threads are its 256/C source slots times C
//     contiguous target slices (thread = slice * 256/C + slot), so slice 0
//     is warps 0 .. 8/C - 1 holding the C = 1 layout's sources in its lane
//     order. Col-min: each CTA stores its partial over its own sources into
//     every CTA of the cluster (distributed shared memory), and after a
//     cluster barrier each takes the min of the C partials. Match: slice 0's
//     thread combines its source's C slice results (M = min of the slice
//     minima; the sums of the slices whose minimum equals M, in slice
//     order, from 0). Sums over
//     sources: slice 0's warps reduce as the C = 1 warps do, each CTA
//     stores its 8/C warp partials into every CTA, and after a second
//     cluster barrier every CTA adds all 8 in warp order from 0, solves the
//     3x3 system and takes the same step: every CTA leaves the loop at the
//     same iteration. Rank 0 writes the output row. Storing into the other
//     CTAs before a barrier, rather than reading from them after it, keeps
//     the remote latency off the critical path. Here the bound is the
//     fixed cost of each iteration: two cluster barriers, the serial 3x3
//     solve and the exchanges, against sweeps of 1/C of the pair.
//
// Both layouts give the same (B, 24) rows to the bit. Min is exact, and
// each layout sums over sources in the same order. The slice combination
// reproduces the single sweep's left fold unless three or more distinct
// targets tie exactly in d2 for one source and fall into two or more
// slices; masked points sit at -/+1e4, where their ties fail the gate.
//
// Barriers and buffers of the cluster layout: the col-min partials are
// stored before barrier 1 and read between barriers 1 and 2; a CTA stores
// the next iteration's only after barrier 2, which every CTA reaches after
// its reads, so one buffer suffices. The warp partials are stored before
// barrier 2 and read after it; without the col-min (reciprocal off) no
// other cluster barrier separates those reads from the next iteration's
// stores, so they alternate between two buffers by iteration parity: the
// stores of iteration it + 2 follow barrier 2 of iteration it + 1, which
// every CTA reaches only after its reads of iteration it. No third barrier
// is needed. One cluster barrier after the input load makes sure every CTA
// of the cluster runs before anything is stored into it; none is needed
// before exit, since after the last barrier 2 no CTA touches another's
// shared memory.
//
// Numerics: d2 comes from one helper with explicit round-to-nearest
// intrinsics, so nvcc cannot contract it into FMAs differently in the two
// sweeps — the reciprocal test compares d2 <= colmin[j], and a tie is
// d2 == m. The per-source terms write every rounding out (__fmaf_rn,
// __fmul_rn), so the rows do not depend on how nvcc contracts the code
// around them: with plain expressions, a change elsewhere in the kernel
// moved the Censi sums by an ulp. The angle wrap uses rintf (round half
// to even, as jnp.round). No fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOutCols = 24;
constexpr int kSums = 11;   // H00 H01 H02 H11 H12 H22 g0 g1 g2 ncorr sum(w*nn_d2)
constexpr int kCensi = 8;   // n su_x su_y htt q_tt srv1 srv2 p_tt
constexpr int kAll = kSums + kCensi;
constexpr int kTie = 6;     // per-slice results: m cnt sx sy snx sny
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBig = 1e12f;

// Phase clocks, compiled in only with -DICP_PHASE_CLOCKS
// (tools/k1_phase_clocks.py): thread 0 of each CTA adds the SM clocks
// since its previous mark to the phase it closes; block 0's sums are read
// back with icp_phase_clocks. Phases: 0 transform (and cos, sin), 1 own
// col-min, 2 barrier 1, 3 col-min combine, 4 match and terms, 5 warp sums,
// 6 barrier 2, 7 totals, 8 3x3 solve.
constexpr int kPhases = 9;
#ifdef ICP_PHASE_CLOCKS
__shared__ unsigned long long phase_clk[kPhases + 1];  // [kPhases]: the last mark
__device__ unsigned long long phase_clk_out[kPhases];
#define PHASE(k)                                                   \
  do {                                                             \
    if (threadIdx.x == 0) {                                        \
      const unsigned long long now = clock64();                    \
      phase_clk[k] += now - phase_clk[kPhases];                    \
      phase_clk[kPhases] = now;                                    \
    }                                                              \
  } while (0)
#else
#define PHASE(k) ((void)0)
#endif

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

template <int C>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// `p` (a shared buffer of this CTA) in the shared memory of cluster rank r.
template <int C>
__device__ __forceinline__ float* at_rank(float* p, int r) {
  if constexpr (C == 1) {
    return p;
  } else {
    return cg::this_cluster().map_shared_rank(p, r);
  }
}

// Sums over sources: slice 0's warps (8 / C of them) reduce their
// per-thread partials and store them, as the pair's warps
// rank * 8 / C .., into `red` of every CTA of the cluster; after a cluster
// barrier the first n threads of every CTA add the pair's 8 warp partials
// in warp order from 0, as one CTA of 8 warps does. Totals land in
// out[0..n) (shared), visible to every thread after the call.
template <int C, int N>
__device__ __forceinline__ void pair_sums(float (&part)[N], int n, int rank, float* red, float* out) {
  constexpr int kSliceWarps = kWarps / C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp < kSliceWarps) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < n) {
        const float v = __shfl_sync(0xffffffffu, warp_sum(part[k]), 0);
        if (lane < C) at_rank<C>(red, lane)[(rank * kSliceWarps + warp) * N + k] = v;
      }
    }
  }
  PHASE(5);
  cluster_barrier<C>();
  PHASE(6);
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * N + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
  PHASE(7);
}

struct Pair {
  const float *sx, *sy, *sm;  // this CTA's sources (shared)
  float2* mxy;                // its moved sources (shared scratch)
  const float2 *txy, *nxy;    // all targets and their normals (shared)
  float *colmin, *partial;    // col-min, and every rank's partial col-min (C x Pt, C > 1)
  int rank, ns, Pt;           // cluster rank, this CTA's source count, target count
  bool reciprocal;
};

// Moved sources into shared memory; col-min per target when reciprocal:
// over this CTA's sources, stored as this rank's partial into every CTA of
// the cluster, then over the C partials.
template <int C>
__device__ __forceinline__ void transform_and_colmin(const Pair& p, float c, float s,
                                                     float ptx, float pty) {
  for (int i = threadIdx.x; i < p.ns; i += kThreads) {
    p.mxy[i] = make_float2(__fadd_rn(__fsub_rn(__fmul_rn(c, p.sx[i]), __fmul_rn(s, p.sy[i])), ptx),
                           __fadd_rn(__fadd_rn(__fmul_rn(s, p.sx[i]), __fmul_rn(c, p.sy[i])), pty));
  }
  __syncthreads();
  PHASE(0);
  if (p.reciprocal) {
    const int ns4 = p.ns & ~3;
    for (int j = threadIdx.x; j < p.Pt; j += kThreads) {
      const float2 t = p.txy[j];
      float m = INFINITY;
      for (int i = 0; i < ns4; i += 4) {  // 4 independent distances a step
        const float4 a = *reinterpret_cast<const float4*>(p.mxy + i);
        const float4 b = *reinterpret_cast<const float4*>(p.mxy + i + 2);
        m = fminf(m, fminf(fminf(sqdist(a.x, a.y, t.x, t.y), sqdist(a.z, a.w, t.x, t.y)),
                           fminf(sqdist(b.x, b.y, t.x, t.y), sqdist(b.z, b.w, t.x, t.y))));
      }
      for (int i = ns4; i < p.ns; ++i) m = fminf(m, sqdist(p.mxy[i].x, p.mxy[i].y, t.x, t.y));
      if constexpr (C == 1) {
        p.colmin[j] = m;
      } else {
#pragma unroll
        for (int r = 0; r < C; ++r) at_rank<C>(p.partial, r)[p.rank * p.Pt + j] = m;
      }
    }
    PHASE(1);
    if constexpr (C > 1) {
      cluster_barrier<C>();  // barrier 1: every partial is stored
      PHASE(2);
      for (int j = threadIdx.x; j < p.Pt; j += kThreads) {
        float m = INFINITY;
#pragma unroll
        for (int r = 0; r < C; ++r) m = fminf(m, p.partial[r * p.Pt + j]);
        p.colmin[j] = m;
      }
    }
    __syncthreads();
    PHASE(3);
  }
}

// One source's matches in targets [j0, j1): its row-min m and the sums of
// the targets at m that pass the gate and the reciprocal test (count, x,
// y, normal x, normal y), each a left fold from 0 in ascending j.
struct Ties {
  float m, cnt, sx, sy, snx, sny;
};

// The sweep keeps the running min m, the first j at it and the
// second-smallest distance m2, branch-free, four targets a step (two
// 128-bit loads, four independent distances; j0 a multiple of 4). After
// it, m2 > m means one target at the minimum, whose values are the sums;
// m2 == m inside the gate (an exact tie, rare on real scans) rescans the
// range for the tied targets.
__device__ __forceinline__ Ties match_range(const Pair& p, float2 q, int j0, int j1, float gate_sq) {
  float m = INFINITY, m2 = INFINITY;
  int jm = j0;
  auto step = [&](float d, int j) {
    jm = d < m ? j : jm;
    m2 = fminf(m2, fmaxf(m, d));
    m = fminf(m, d);
  };
  int j = j0;
  for (; j + 4 <= j1; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p.txy + j);
    const float4 b = *reinterpret_cast<const float4*>(p.txy + j + 2);
    const float d0 = sqdist(q.x, q.y, a.x, a.y), d1 = sqdist(q.x, q.y, a.z, a.w);
    const float d2 = sqdist(q.x, q.y, b.x, b.y), d3 = sqdist(q.x, q.y, b.z, b.w);
    step(d0, j);
    step(d1, j + 1);
    step(d2, j + 2);
    step(d3, j + 3);
  }
  for (; j < j1; ++j) step(sqdist(q.x, q.y, p.txy[j].x, p.txy[j].y), j);

  Ties r{m, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!(m <= gate_sq)) return r;
  auto add = [&](float d, int k) {
    if (!p.reciprocal || d <= p.colmin[k]) {
      r.cnt = __fadd_rn(r.cnt, 1.f);
      r.sx = __fadd_rn(r.sx, p.txy[k].x);
      r.sy = __fadd_rn(r.sy, p.txy[k].y);
      r.snx = __fadd_rn(r.snx, p.nxy[k].x);
      r.sny = __fadd_rn(r.sny, p.nxy[k].y);
    }
  };
  if (m2 > m) {
    add(m, jm);
  } else {
    for (int k = jm; k < j1; ++k) {
      const float d = sqdist(q.x, q.y, p.txy[k].x, p.txy[k].y);
      if (d == m) add(d, k);
    }
  }
  return r;
}

struct Match {
  float rowmin, qx, qy, qnx, qny, wf;
};

// A source's match: its row-min, averaged target coordinates and normals;
// wf = 1 when it has a match and is valid.
__device__ __forceinline__ Match make_match(const Ties& t, float valid) {
  Match m;
  m.rowmin = t.m;
  const float inv = __frcp_rn(fmaxf(t.cnt, 1.f));
  m.qx = __fmul_rn(t.sx, inv);
  m.qy = __fmul_rn(t.sy, inv);
  m.qnx = __fmul_rn(t.snx, inv);
  m.qny = __fmul_rn(t.sny, inv);
  m.wf = (t.cnt > 0.f && valid > 0.5f) ? 1.f : 0.f;
  return m;
}

// Point-to-line normal-equation terms of a source moved to (mx, my) (the
// Pallas kernel's _finish_iteration reductions) added to part[0..kSums),
// and in Censi mode its Censi sandwich accumulators at transform
// (ptx, pty, c, s), point-to-point residuals (ops/icp.censi_sums), added
// to part[kSums..). Every rounding is written out, so both layouts, and
// any change of the code around them, keep the same results.
template <int N>
__device__ __forceinline__ void add_terms(float mx, float my, const Match& m, float ptx, float pty,
                                          bool censi, float c, float s, float (&part)[N]) {
  const float wf = m.wf;
  const float ex = __fsub_rn(mx, m.qx), ey = __fsub_rn(my, m.qy);
  const float rpx = __fsub_rn(mx, ptx), rpy = __fsub_rn(my, pty);
  const float r = __fmaf_rn(m.qnx, ex, __fmul_rn(m.qny, ey));       // n . (p - q)
  const float nd = __fmaf_rn(m.qny, rpx, -__fmul_rn(m.qnx, rpy));   // n . d(p)/d(theta)
  const float wx = __fmul_rn(m.qnx, wf), wy = __fmul_rn(m.qny, wf), wd = __fmul_rn(nd, wf);
  part[0] = __fmaf_rn(m.qnx, wx, part[0]);
  part[1] = __fmaf_rn(m.qny, wx, part[1]);
  part[2] = __fmaf_rn(nd, wx, part[2]);
  part[3] = __fmaf_rn(m.qny, wy, part[3]);
  part[4] = __fmaf_rn(nd, wy, part[4]);
  part[5] = __fmaf_rn(nd, wd, part[5]);
  part[6] = __fmaf_rn(r, wx, part[6]);
  part[7] = __fmaf_rn(r, wy, part[7]);
  part[8] = __fmaf_rn(r, wd, part[8]);
  part[9] = __fadd_rn(part[9], wf);
  part[10] = __fmaf_rn(wf, m.rowmin, part[10]);
  if constexpr (N == kAll) {
    if (censi) {
      const float a = __fmul_rn(rpy, wf), uy = __fmul_rn(rpx, wf);  // u = (-a, uy)
      const float rx = __fmul_rn(ex, wf), ry = __fmul_rn(ey, wf);
      const float uu = __fmaf_rn(uy, uy, __fmul_rn(a, a));
      const float v1 = __fmaf_rn(ry, c, __fmaf_rn(rx, -s, __fmaf_rn(uy, s, -__fmul_rn(a, c))));
      const float v2 = __fmaf_rn(ry, -s, __fmaf_rn(rx, -c, __fmaf_rn(uy, c, __fmul_rn(a, s))));
      float* q = part + kSums;
      q[0] = __fadd_rn(q[0], wf);
      q[1] = __fsub_rn(q[1], a);
      q[2] = __fadd_rn(q[2], uy);
      q[3] = __fadd_rn(q[3], __fmaf_rn(-rpy, ry, __fmaf_rn(-rpx, rx, uu)));
      q[4] = __fadd_rn(q[4], uu);
      q[5] = __fadd_rn(q[5], __fmaf_rn(v1, c, -__fmul_rn(v2, s)));
      q[6] = __fadd_rn(q[6], __fmaf_rn(v1, s, __fmul_rn(v2, c)));
      q[7] = __fadd_rn(q[7], __fmaf_rn(v1, v1, __fmul_rn(v2, v2)));
    }
  }
}

// Each source's match at the current moved sources, its terms added to
// part (and the Censi terms when `censi`). C = 1: threads stride over the
// sources, each sweeping all targets. C > 1: thread (slice, slot) sweeps
// its slice for the slot's source; slice 0's thread combines the slices.
template <int C, int N>
__device__ __forceinline__ void match_sources(const Pair& p, float gate_sq, float ptx, float pty,
                                              bool censi, float c, float s, float* tie,
                                              float (&part)[N]) {
  if constexpr (C == 1) {
    for (int i = threadIdx.x; i < p.ns; i += kThreads) {
      const float2 q = p.mxy[i];
      add_terms(q.x, q.y, make_match(match_range(p, q, 0, p.Pt, gate_sq), p.sm[i]), ptx, pty, censi, c, s, part);
    }
  } else {
    constexpr int kSlots = kThreads / C;
    const int slot = threadIdx.x % kSlots;
    const int slice = threadIdx.x / kSlots;
    Ties t{INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f};
    // Slice bounds on multiples of 4 (the last slice ends at Pt).
    const int j0 = (slice * p.Pt / C) & ~3;
    const int j1 = slice == C - 1 ? p.Pt : ((slice + 1) * p.Pt / C) & ~3;
    if (slot < p.ns) t = match_range(p, p.mxy[slot], j0, j1, gate_sq);
    if (slice > 0) {
      tie[0 * kThreads + threadIdx.x] = t.m;
      tie[1 * kThreads + threadIdx.x] = t.cnt;
      tie[2 * kThreads + threadIdx.x] = t.sx;
      tie[3 * kThreads + threadIdx.x] = t.sy;
      tie[4 * kThreads + threadIdx.x] = t.snx;
      tie[5 * kThreads + threadIdx.x] = t.sny;
    }
    __syncthreads();
    if (slice == 0 && slot < p.ns) {
      float M = t.m;
#pragma unroll
      for (int r = 1; r < C; ++r) M = fminf(M, tie[r * kSlots + slot]);
      Ties all{M, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int k = r * kSlots + slot;
        const bool at_min = r == 0 ? t.m == M : tie[k] == M;
        if (at_min) {
          all.cnt += r == 0 ? t.cnt : tie[1 * kThreads + k];
          all.sx += r == 0 ? t.sx : tie[2 * kThreads + k];
          all.sy += r == 0 ? t.sy : tie[3 * kThreads + k];
          all.snx += r == 0 ? t.snx : tie[4 * kThreads + k];
          all.sny += r == 0 ? t.sny : tie[5 * kThreads + k];
        }
      }
      const float2 q = p.mxy[slot];
      add_terms(q.x, q.y, make_match(all, p.sm[slot]), ptx, pty, censi, c, s, part);
    }
  }
  PHASE(4);
}

template <int C>
__global__ void __launch_bounds__(kThreads) icp_p2l_kernel(
    const float* __restrict__ src_planes,  // (3, B, Ps): src x/y (masked at -1e4), src mask
    const float* __restrict__ tgt_planes,  // (4, B, Pt): tgt x/y (masked at +1e4), normal x/y
    const float* __restrict__ seeds,       // (B, 4): tx, ty, th, gate multiplier
    float* __restrict__ out,               // (B, 24)
    int B, int Ps, int Pt, int max_iterations, int anneal_iters, float max_corr,
    int reciprocal, float epsilon, float damping, int censi,
    float error_delta_rel_tol) {
  constexpr int kSlots = kThreads / C;
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kWarps * kAll];  // warp partials, by iteration parity
  __shared__ float tot[kAll];
  // Carry, written by thread 0 and read by all after a barrier:
  // tx ty th active fitness
  __shared__ float st[5];
#ifdef ICP_PHASE_CLOCKS
  if (threadIdx.x == 0) {
    for (int k = 0; k < kPhases; ++k) phase_clk[k] = 0;
    phase_clk[kPhases] = clock64();
  }
#endif

  // Shared layout (floats): txy, nxy (2 Pt each), mxy (2 slots), sx sy sm
  // (slots each), colmin (Pt); C > 1 adds the partial col-mins (C Pt) and
  // the slice results (kTie * kThreads).
  const int b = blockIdx.x / C;
  const int rank = static_cast<int>(blockIdx.x % C);
  const int src0 = rank * kSlots;
  const int slots = C == 1 ? Ps : kSlots;
  Pair p;
  p.txy = reinterpret_cast<float2*>(smem4);
  p.nxy = p.txy + Pt;
  p.mxy = const_cast<float2*>(p.nxy) + Pt;
  float* f = reinterpret_cast<float*>(p.mxy + slots);
  float* sx = f;
  float* sy = sx + slots;
  float* sm = sy + slots;
  p.sx = sx;
  p.sy = sy;
  p.sm = sm;
  p.colmin = sm + slots;
  p.partial = p.colmin + Pt;
  float* tie = p.partial + C * Pt;
  p.rank = rank;
  p.ns = C == 1 ? Ps : max(0, min(Ps - src0, kSlots));
  p.Pt = Pt;
  p.reciprocal = reciprocal != 0;

  const size_t splane = static_cast<size_t>(B) * Ps, tplane = static_cast<size_t>(B) * Pt;
  const float* sbase = src_planes + static_cast<size_t>(b) * Ps + src0;
  const float* tbase = tgt_planes + static_cast<size_t>(b) * Pt;
  for (int i = threadIdx.x; i < p.ns; i += kThreads) {
    sx[i] = sbase[i];
    sy[i] = sbase[splane + i];
    sm[i] = sbase[2 * splane + i];
  }
  float2* txy = const_cast<float2*>(p.txy);
  float2* nxy = const_cast<float2*>(p.nxy);
  for (int j = threadIdx.x; j < Pt; j += kThreads) {
    txy[j] = make_float2(tbase[j], tbase[tplane + j]);
    nxy[j] = make_float2(tbase[2 * tplane + j], tbase[3 * tplane + j]);
  }
  const float gate_mult = seeds[b * 4 + 3];
  if (threadIdx.x == 0) {
    st[0] = seeds[b * 4 + 0];
    st[1] = seeds[b * 4 + 1];
    st[2] = seeds[b * 4 + 2];
    st[3] = 1.f;
    st[4] = kBig;  // first fitness carry: iteration 0 never stalls
  }
  cluster_barrier<C>();  // every CTA of the cluster runs before any stores into it

  int it = 0;
  for (; it < max_iterations && st[3] > 0.5f; ++it) {
    const float ptx = st[0], pty = st[1], pth = st[2];
    const float prog = fmaxf(0.f, 1.f - static_cast<float>(it) / static_cast<float>(anneal_iters));
    const float mult = __fadd_rn(1.f, __fmul_rn(__fsub_rn(gate_mult, 1.f), prog));
    const float gate = __fmul_rn(max_corr, mult);
    transform_and_colmin<C>(p, cosf(pth), sinf(pth), ptx, pty);

    float part[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) part[k] = 0.f;
    match_sources<C>(p, __fmul_rn(gate, gate), ptx, pty, false, 0.f, 0.f, tie, part);
    pair_sums<C>(part, kSums, rank, red[it & 1], tot);  // barrier 2

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
    PHASE(8);
  }

  // Final pass at the final transform and the fine gate: the exit
  // statistics, and the Censi sums in Censi mode.
  const float ftx = st[0], fty = st[1], fth = st[2];
  const float c = cosf(fth), s = sinf(fth);
  transform_and_colmin<C>(p, c, s, ftx, fty);
  float part[kAll];
#pragma unroll
  for (int k = 0; k < kAll; ++k) part[k] = 0.f;
  match_sources<C>(p, __fmul_rn(max_corr, max_corr), ftx, fty, censi != 0, c, s, tie, part);
  pair_sums<C>(part, censi ? kAll : kSums, rank, red[it & 1], tot);

#ifdef ICP_PHASE_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int k = 0; k < kPhases; ++k) phase_clk_out[k] = phase_clk[k];
#endif
  if (threadIdx.x == 0 && src0 == 0) {
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

// Dynamic shared memory of one CTA in bytes (ops/icp_cuda.py::smem_bytes).
size_t smem_bytes(int Ps, int Pt, int C) {
  const size_t slots = C == 1 ? Ps : kThreads / C;
  const size_t extra = C == 1 ? 0 : static_cast<size_t>(C) * Pt + kTie * kThreads;
  return sizeof(float) * (5 * (slots + Pt) + extra);
}

template <int C>
cudaError_t launch(const float* src_planes, const float* tgt_planes, const float* seeds, float* out,
                   int B, int Ps, int Pt, int max_iterations, int anneal_iters, float max_corr,
                   int reciprocal, float epsilon, float damping, int censi,
                   float error_delta_rel_tol, cudaStream_t stream) {
  const size_t smem = smem_bytes(Ps, Pt, C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        icp_p2l_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, icp_p2l_kernel<C>, src_planes, tgt_planes, seeds, out, B, Ps, Pt, max_iterations,
      anneal_iters, max_corr, reciprocal, epsilon, damping, censi, error_delta_rel_tol);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return e != cudaSuccess ? e : last;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches one pair per cluster of
// `cluster` CTAs (1, 2, 4 or 8; > 1 needs Ps <= 256) on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int icp_p2l_launch(const float* src_planes, const float* tgt_planes,
                              const float* seeds, float* out,
                              int B, int Ps, int Pt, int max_iterations, int anneal_iters,
                              float max_corr, int reciprocal, float epsilon,
                              float damping, int censi, float error_delta_rel_tol,
                              int cluster, void* stream) {
  if (cluster != 1 && Ps > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ICP_LAUNCH(C)                                                                         \
  launch<C>(src_planes, tgt_planes, seeds, out, B, Ps, Pt, max_iterations, anneal_iters,      \
            max_corr, reciprocal, epsilon, damping, censi, error_delta_rel_tol, st)
  switch (cluster) {
    case 1: return static_cast<int>(ICP_LAUNCH(1));
    case 2: return static_cast<int>(ICP_LAUNCH(2));
    case 4: return static_cast<int>(ICP_LAUNCH(4));
    case 8: return static_cast<int>(ICP_LAUNCH(8));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ICP_LAUNCH
}

#ifdef ICP_PHASE_CLOCKS
// Block 0's phase clocks of the last launch (kPhases values) into host
// memory `dst`; returns the copy's cudaError_t.
extern "C" int icp_phase_clocks(unsigned long long* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, phase_clk_out, sizeof(phase_clk_out)));
}
#endif
