// Levenberg-Marquardt window BA and PnP, each as ONE launch.
//
// Replaces the TPU megakernels of vio360_tpu/solver/ba_pallas.py:
//   lm_pnp  <- pnp_solve    / _pnp_solve_kernel  (K1: 4 chi2 rounds x LM)
//   lm_ba   <- ba_solve     / _ba_solve_kernel   (K2: whole LM loop)
//           <- ba_iteration / _ba_iter_kernel    (K3: single = 1 iteration)
// Both follow the reference's _lm_iteration / _lm_loop: the same
// residuals, Huber weights and 100-px cut, (c, k) order of the reduced
// system, damping, gauge, retraction, lambda schedule and exits.
//
// What bounds them on this card: the dependency chain of the LM loop,
// not bytes or FLOPs. A window problem is K <= 16 poses x M landmarks
// (K=10, M=2048: ~1 MB of inputs, ~50 MFLOP per iteration), and every
// iteration waits for the previous accept/reject, so the time is
// latency: barriers, reductions and the serial 6K-pivot elimination,
// iteration after iteration. The design keeps the loop on the card (no
// host round trip per iteration), spreads the per-landmark work over
// more SMs and counts barriers:
//
// K2/K3 (ba_kernel): ONE thread-block cluster of C = 16 CTAs (cluster
//   launch, kCluster). Every CTA holds identical copies of the
//   loop state and owns a contiguous range of landmarks. Per iteration:
//   (1) linearize its landmarks, only after an accepted step (W, V,
//       b_l, U, b_p and the cost depend on the state, not on lambda);
//   (2) with lambda: damped V^-1, Y = W V^-1 and its partial Schur
//       product S = sum_m Y_m W_m^T as a dense (6K x 3L)(3L x 6K) tiled
//       product, accumulated in registers -- no atomics;
//   (3) cluster barrier; CTA 0 sums the C partials over distributed
//       shared memory in rank order (so the result, and the iteration
//       count, are the same bits on every run), assembles the damped
//       6K x 6K system and solves it by the reference's unpivoted
//       Gauss-Jordan, held in registers, with one block barrier per pivot;
//   (4) cluster barrier; every CTA reads dx from CTA 0, retracts the
//       poses, back-substitutes and evaluates the trial cost of its
//       landmarks; (5) cluster barrier; every CTA sums the C trial
//       partials in rank order and takes the same accept/reject.
//   Three cluster barriers per iteration; a rejected step skips (1).
// K1 (pnp_kernel): one CTA of 512 threads per PnP problem, B problems in
//   one launch (gridDim.x = B: loop verification and relocalization solve
//   the top verify_top_k candidates together, as the JAX package's vmap
//   over pnp_solve gives B1 a batch grid axis). A CTA reads only its own
//   problem's slices and runs the single-problem arithmetic, so each
//   problem of a batch returns the bits of a launch of it alone. (A
//   cluster barrier would cost more than a problem's K = 1 work; at 1024
//   threads the 64-register cap spills the pass and the solve to local
//   memory.) Every landmark is fixed, so
//   an iteration is one pass at the trial pose that yields the cost AND
//   the 28 normal-equation sums (U, b, cost), reduced in one block
//   reduction; thread 0 holds the loop state, decides accept/reject and
//   solves the damped 6x6 system for the next trial pose. On accept the
//   trial sums are the next linearization; on reject only lambda changes
//   and the stored sums are solved again. Two block barriers per
//   iteration: after the pass, and after thread 0's step.
//
// Scratch (K2/K3, global, from the wrapper): W [M][K][18], V upper and
// b_l [M][9], damped V^-1 [M][9], trial landmarks [3][M].

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "lm_common.cuh"

namespace cg = cooperative_groups;
using namespace lm;

namespace {

constexpr int kBaThreads = 512;
constexpr int kBaWarps = kBaThreads / 32;
// CTAs of the K2/K3 cluster: 16 (non-portable) ran 3x faster than the
// portable 8 on the H100 at K = 10, M = 2048 (PERF.md).
constexpr int kCluster = 16;
constexpr int kGjRows = 6;  // Gauss-Jordan rows per warp: 6K <= 96 over 16 warps
constexpr int kGjCols = 4;  // Gauss-Jordan columns per lane: 6K + 1 <= 97 over 32 lanes
constexpr int kPart = 33;  // per-pose partials: U (21 upper), b_p (6), Schur rhs correction (6)
constexpr int kPnpThreads = 512;
constexpr int kPnpWarps = kPnpThreads / 32;

__host__ __device__ int seg_size(int K) {
  int g = 1;
  while (g < K) g <<= 1;
  return g;
}

// ---------------------------------------------------------------------------
// K2 / K3: window BA on one cluster
// ---------------------------------------------------------------------------

struct Ba {
  int K, M, G, n, ld;
  int m0, m1;  // this CTA's landmarks
  LmParams p;
  const float* obs_u;    // [K*M]
  const float* obs_v;    // [K*M]
  const float* wmask;    // [K*M]
  const float* fixedpt;  // [M]
  const float* fm;       // [K] 1 = free pose
  float* wbuf;           // [M*K*18] W blocks
  float* vbl;            // [M*9] V upper (6), b_l (3)
  float* vinv;           // [M*9] damped V^-1
  float* pts[2];         // [3*M] current / trial landmarks
  // shared memory
  float* work;      // union: Y and W chunks [3L][n] x 2 | system [n][n+1] + pivot rows [2][n+1]
  float* spart;     // [n*n] this CTA's sum of Y W^T
  float* part;      // [K*kPart] this CTA's per-pose partials
  float* usum;      // [K*kPart] per-pose sums over the cluster (CTA 0)
  float* wslot;     // [kBaWarps*K*27] per-warp per-pose partials
  float* pose;      // [K*12] current
  float* pose_new;  // [K*12] trial
  float* dx;        // [n]
  float* red;       // [2*kBaWarps]
  float* scal;      // [4] cost, trial cost, landmark step partials
};

__host__ __device__ size_t ba_work_floats(int K, int G) {
  const int n = 6 * K, depth = 3 * (kBaThreads / G);
  const size_t chunks = (size_t)2 * depth * n, gj = (size_t)(n + 2) * (n + 1);
  return chunks > gj ? chunks : gj;
}

size_t ba_smem_floats(int K, int G) {
  const int n = 6 * K;
  return ba_work_floats(K, G) + (size_t)n * n + 2 * K * kPart + kBaWarps * K * 27 + 24 * K + n +
         2 * kBaWarps + 4;
}

__device__ __forceinline__ void carve(Ba& b, float* s) {
  const int K = b.K, n = b.n;
  b.work = s;     s += ba_work_floats(K, b.G);  // first: 16-byte aligned, float2 reads
  b.spart = s;    s += n * n;
  b.part = s;     s += K * kPart;
  b.usum = s;     s += K * kPart;
  b.wslot = s;    s += kBaWarps * K * 27;
  b.pose = s;     s += 12 * K;
  b.pose_new = s; s += 12 * K;
  b.dx = s;       s += n;
  b.red = s;      s += 2 * kBaWarps;
  b.scal = s;
}

// Sums of two values over the block (fixed order); every thread gets them.
__device__ __forceinline__ void block_sum2(float a, float c, float* red, float out[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  c = warp_sum(c);
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[kBaWarps + warp] = c;
  }
  __syncthreads();
  out[0] = 0.0f;
  out[1] = 0.0f;
  for (int w = 0; w < kBaWarps; ++w) {
    out[0] += red[w];
    out[1] += red[kBaWarps + w];
  }
}

// Per-lane per-pose values (lane g of a segment = keyframe g) summed over
// every segment of the CTA in a fixed order -- across the segments of a
// warp by shuffles, then the warp slots in warp order -- into
// part[k*kPart + off + i]. Visible after the caller's next barrier.
template <int N>
__device__ __forceinline__ void pose_reduce(const Ba& b, float (&v)[N], int off) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid % b.G, K = b.K;
  for (int o = b.G; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  __syncthreads();  // the slots' previous readers are done
  if (lane < b.G && g < K) {
#pragma unroll
    for (int i = 0; i < N; ++i) b.wslot[(warp * K + g) * N + i] = v[i];
  }
  __syncthreads();
  for (int i = tid; i < K * N; i += kBaThreads) {
    const int k = i / N, j = i % N;
    float s = 0.0f;
    for (int w = 0; w < kBaWarps; ++w) s += b.wslot[(w * K + k) * N + j];
    b.part[k * kPart + off + j] = s;
  }
}

// (1) Linearize this CTA's landmarks at (pose, pts[cur]): W, V | b_l to
// scratch, U | b_p to part[0..26], the Huber cost sum to scal[0].
__device__ __forceinline__ void linearize(const Ba& b, int cur) {
  const int tid = threadIdx.x, K = b.K, M = b.M, G = b.G;
  const int g = tid % G, seg = tid / G, nseg = kBaThreads / G;
  const bool has_k = g < K;
  const float* P = b.pts[cur];
  float ub[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) ub[i] = 0.0f;
  float cost = 0.0f;
  for (int base = b.m0; base < b.m1; base += nseg) {
    const int m = base + seg;
    const bool valid = m < b.m1;
    float w = 0.0f, du = 0.0f, dv = 0.0f;
    float jp[2][6], jl[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) jp[i][j] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) jl[i][j] = 0.0f;
    }
    if (valid && has_k) {
      const float* pose = b.pose + 12 * g;
      Obs o;
      evaluate(pose, P[m], P[M + m], P[2 * M + m], b.obs_u[g * M + m], b.obs_v[g * M + m], b.p, o);
      const float wm = b.wmask[g * M + m];
      cost += huber_rho(o.c2, b.p.huber_delta) * wm;
      w = irls_weight(o, wm, b.p);
      du = o.du;
      dv = o.dv;
      jacobians(pose, o, b.p, jp, jl);
      int u = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int c = a; c < 6; ++c) ub[u++] += w * (jp[0][a] * jp[0][c] + jp[1][a] * jp[1][c]);
        ub[21 + a] += -(w * (jp[0][a] * du + jp[1][a] * dv));
      }
    }
    // landmark block V (upper 6) and b_l (3), summed over the segment
    float v[9];
    v[0] = w * (jl[0][0] * jl[0][0] + jl[1][0] * jl[1][0]);
    v[1] = w * (jl[0][0] * jl[0][1] + jl[1][0] * jl[1][1]);
    v[2] = w * (jl[0][0] * jl[0][2] + jl[1][0] * jl[1][2]);
    v[3] = w * (jl[0][1] * jl[0][1] + jl[1][1] * jl[1][1]);
    v[4] = w * (jl[0][1] * jl[0][2] + jl[1][1] * jl[1][2]);
    v[5] = w * (jl[0][2] * jl[0][2] + jl[1][2] * jl[1][2]);
#pragma unroll
    for (int d = 0; d < 3; ++d) v[6 + d] = -(w * (jl[0][d] * du + jl[1][d] * dv));
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
    const bool fixed = !valid || b.fixedpt[m] > 0.5f;
    if (!fixed) {
      if (has_k) {
        float* gw = b.wbuf + ((size_t)m * K + g) * 18;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int d = 0; d < 3; ++d) gw[a * 3 + d] = w * (jp[0][a] * jl[0][d] + jp[1][a] * jl[1][d]);
        }
      }
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) b.vbl[(size_t)m * 9 + i] = v[i];
      }
    }
  }
  pose_reduce<27>(b, ub, 0);
  float s[2];
  block_sum2(cost, 0.0f, b.red, s);
  if (tid == 0) b.scal[0] = s[0];
}

// (2) With damping lam: V^-1 to scratch, this CTA's S = sum_m Y_m W_m^T
// to spart and its rhs correction sum_m Y_m b_l to part[27..32].
// Landmarks go by chunks of L = one per segment: each lane writes its
// keyframe's Y and W rows into [3L][n] tiles (depth-major), then the
// CTA multiplies them, each thread owning a 2 x 6 tile of S.
__device__ __forceinline__ void schur(const Ba& b, float lam) {
  const int tid = threadIdx.x, K = b.K, G = b.G, n = b.n;
  const int g = tid % G, seg = tid / G, L = kBaThreads / G, depth = 3 * L;
  const bool has_k = g < K;
  float* Y = b.work;
  float* Wc = b.work + depth * n;
  float rc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rc[i] = 0.0f;
  // each thread owns up to two 2 x 6 tiles of S (3K^2 <= 768 tiles) and
  // keeps them in registers over all chunks
  const int half = n / 2, ntiles = half * K;
  float acc[2][2][6];
#pragma unroll
  for (int tt = 0; tt < 2; ++tt)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[tt][0][c] = acc[tt][1][c] = 0.0f;
  for (int base = b.m0; base < b.m1; base += L) {
    const int m = base + seg;
    const bool fixed = m >= b.m1 || b.fixedpt[m] > 0.5f;
    float vinv[9], bl[3];
    if (!fixed) {
      const float* vb = b.vbl + (size_t)m * 9;
      damped_inverse3(vb, lam, vinv);
      bl[0] = vb[6];
      bl[1] = vb[7];
      bl[2] = vb[8];
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) b.vinv[(size_t)m * 9 + i] = vinv[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) vinv[i] = 0.0f;
      bl[0] = bl[1] = bl[2] = 0.0f;
    }
    if (has_k) {
      float W[18];
      const float* gw = b.wbuf + ((size_t)m * K + g) * 18;
#pragma unroll
      for (int i = 0; i < 18; ++i) W[i] = fixed ? 0.0f : gw[i];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float yv[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) yv[e] = W[a * 3] * vinv[e] + W[a * 3 + 1] * vinv[3 + e] + W[a * 3 + 2] * vinv[6 + e];
        rc[a] += yv[0] * bl[0] + yv[1] * bl[1] + yv[2] * bl[2];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          Y[(3 * seg + d) * n + a * K + g] = yv[d];
          Wc[(3 * seg + d) * n + a * K + g] = W[a * 3 + d];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int t = tid + tt * kBaThreads;
      if (t < ntiles) {
        const int r0 = 2 * (t % half), c0 = 6 * (t / half);
#pragma unroll 4
        for (int j = 0; j < depth; ++j) {
          const float2 a = *reinterpret_cast<const float2*>(Y + j * n + r0);
          const float2* wp = reinterpret_cast<const float2*>(Wc + j * n + c0);
          const float2 w0 = wp[0], w1 = wp[1], w2 = wp[2];
          const float wv[6] = {w0.x, w0.y, w1.x, w1.y, w2.x, w2.y};
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            acc[tt][0][c] += a.x * wv[c];
            acc[tt][1][c] += a.y * wv[c];
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
    const int t = tid + tt * kBaThreads;
    if (t < ntiles) {
      const int r0 = 2 * (t % half), c0 = 6 * (t / half);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        b.spart[r0 * n + c0 + c] = acc[tt][0][c];
        b.spart[(r0 + 1) * n + c0 + c] = acc[tt][1][c];
      }
    }
  }
  pose_reduce<6>(b, rc, 27);
}

// (3a) CTA 0: sum the cluster's partials in rank order and assemble the
// damped reduced system [S | rhs] in (c, k) order with the gauge.
__device__ __forceinline__ void assemble(const Ba& b, float lam, const cg::cluster_group& cluster) {
  const int tid = threadIdx.x, K = b.K, n = b.n, ld = b.ld;
  // Every rank's value is loaded before the first add, so the remote
  // loads are in flight together; the adds go in rank order.
  auto cluster_sum = [&](float* local, int i) {
    float v[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v[r] = cluster.map_shared_rank(local, r)[i];
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += v[r];
    return s;
  };
  for (int i = tid; i < K * kPart; i += kBaThreads) b.usum[i] = cluster_sum(b.part, i);
  __syncthreads();
  float* A0 = b.work;
  for (int i = tid; i < n * n; i += kBaThreads) {
    const int row = i / n, col = i % n;
    const int cc = row / K, k = row % K, ff = col / K, l = col % K;
    float val = -cluster_sum(b.spart, i);
    if (k == l) val += damped_u(b.usum + k * kPart, cc, ff, lam, b.p.diag_damping);
    A0[row * ld + col] = val * b.fm[k] * b.fm[l] + (row == col ? 1.0f - b.fm[k] : 0.0f);
  }
  for (int row = tid; row < n; row += kBaThreads) {
    const int cc = row / K, k = row % K;
    const float* us = b.usum + k * kPart;
    A0[row * ld + n] = (us[21 + cc] - us[27 + cc]) * b.fm[k];
  }
  __syncthreads();
}

// v[i] of a register array at an index that is the same in every lane
// (selects, so the array stays in registers).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float x = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) x = i == k ? v[k] : x;
  return x;
}

// (3b) CTA 0: unpivoted Gauss-Jordan on the assembled system -> dx.
// The system lives in registers: warp w holds rows w, w + 16, ..., lane l
// columns l, l + 32, .... Per pivot i the warp holding row i divides it
// by the pivot and publishes it to shared memory (double-buffered by the
// pivot's parity), one barrier, then every warp updates its rows with the
// pivot column it takes from the lane that holds it and the holder of
// row i replaces it by the published row (the reference's formula per
// entry): one barrier per pivot, and the only shared-memory traffic is
// one row.
__device__ __forceinline__ void gauss_jordan(const Ba& b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = b.n, ld = b.ld;
  const float* A = b.work;
  float* prow = b.work + n * ld;  // [2][ld]
  float a[kGjRows][kGjCols];
#pragma unroll
  for (int q = 0; q < kGjRows; ++q) {
    const int r = warp + kBaWarps * q;
#pragma unroll
    for (int c = 0; c < kGjCols; ++c) {
      const int j = lane + 32 * c;
      a[q][c] = r < n && j < ld ? A[r * ld + j] : 0.0f;
    }
  }
  for (int i = 0; i < n; ++i) {
    const int qi = i / kBaWarps, ci = i / 32, li = i % 32;
    const bool owner = warp == i % kBaWarps;
    float* pr_row = prow + (i & 1) * ld;
    if (owner) {
      float row[kGjCols];
#pragma unroll
      for (int c = 0; c < kGjCols; ++c) {
        float x = a[0][c];
#pragma unroll
        for (int q = 1; q < kGjRows; ++q) x = qi == q ? a[q][c] : x;
        row[c] = x;
      }
      const float piv = __shfl_sync(0xffffffffu, pick(row, ci), li);
#pragma unroll
      for (int c = 0; c < kGjCols; ++c) {
        const int j = lane + 32 * c;
        if (j >= i && j < ld) pr_row[j] = row[c] / piv;
      }
    }
    // the pivot column, taken before this step changes it
    float col[kGjRows];
#pragma unroll
    for (int q = 0; q < kGjRows; ++q) col[q] = __shfl_sync(0xffffffffu, pick(a[q], ci), li);
    __syncthreads();
    // Every held entry is updated: columns < i and padding rows / columns
    // are never read again, so updating them costs FMAs but no compares.
    float pr[kGjCols];
#pragma unroll
    for (int c = 0; c < kGjCols; ++c) {
      const int j = lane + 32 * c;
      pr[c] = j >= i && j < ld ? pr_row[j] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kGjRows; ++q) {
#pragma unroll
      for (int c = 0; c < kGjCols; ++c) a[q][c] -= col[q] * pr[c];
    }
    if (owner) {
#pragma unroll
      for (int q = 0; q < kGjRows; ++q) {
        if (q == qi) {
#pragma unroll
          for (int c = 0; c < kGjCols; ++c) a[q][c] = pr[c];
        }
      }
    }
  }
  const int cn = n / 32, ln = n % 32;
#pragma unroll
  for (int q = 0; q < kGjRows; ++q) {
    const int r = warp + kBaWarps * q;
    if (r < n && lane == ln) b.dx[r] = pick(a[q], cn);
  }
}

// (4) Trial state of this CTA's landmarks: back-substitute dl, write
// pts[1-cur], sum the trial Huber cost and |dl|^2 into scal[1], scal[2].
__device__ __forceinline__ void trial(const Ba& b, int cur) {
  const int tid = threadIdx.x, K = b.K, M = b.M, G = b.G;
  const int g = tid % G, seg = tid / G, nseg = kBaThreads / G;
  const bool has_k = g < K;
  const float* P = b.pts[cur];
  float* Pn = b.pts[1 - cur];
  float new_acc = 0.0f, step_l = 0.0f;
  for (int base = b.m0; base < b.m1; base += nseg) {
    const int m = base + seg;
    const bool valid = m < b.m1;
    const bool fixed = !valid || b.fixedpt[m] > 0.5f;
    float s[3] = {0.0f, 0.0f, 0.0f};
    if (!fixed && has_k) {
      const float* wk = b.wbuf + ((size_t)m * K + g) * 18;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float sk = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a) sk += wk[a * 3 + d] * b.dx[a * K + g];
        s[d] = sk;
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < 3; ++d) s[d] += __shfl_xor_sync(0xffffffffu, s[d], off);
    }
    if (valid) {
      float dl[3] = {0.0f, 0.0f, 0.0f};
      if (!fixed) {
        const float* vi = b.vinv + (size_t)m * 9;
        const float* vb = b.vbl + (size_t)m * 9;
        const float tmp[3] = {vb[6] - s[0], vb[7] - s[1], vb[8] - s[2]};
#pragma unroll
        for (int d = 0; d < 3; ++d) dl[d] = vi[3 * d] * tmp[0] + vi[3 * d + 1] * tmp[1] + vi[3 * d + 2] * tmp[2];
      }
      const float px = P[m] + dl[0], py = P[M + m] + dl[1], pz = P[2 * M + m] + dl[2];
      if (g == 0) {
        Pn[m] = px;
        Pn[M + m] = py;
        Pn[2 * M + m] = pz;
        step_l += dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2];
      }
      if (has_k) {
        Obs o;
        evaluate(b.pose_new + 12 * g, px, py, pz, b.obs_u[g * M + m], b.obs_v[g * M + m], b.p, o);
        new_acc += huber_rho(o.c2, b.p.huber_delta) * b.wmask[g * M + m];
      }
    }
  }
  float out[2];
  block_sum2(new_acc, step_l, b.red, out);
  if (tid == 0) {
    b.scal[1] = out[0];
    b.scal[2] = out[1];
  }
}

// Sum of scal[i] over the cluster in rank order (same bits in every CTA).
__device__ __forceinline__ float cluster_scalar(const Ba& b, int i, const cg::cluster_group& cluster) {
  float s = 0.0f;
  for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(b.scal, r)[i];
  return s;
}

__global__ void __launch_bounds__(kBaThreads, 1)
ba_kernel(const float* pose_in, const float* pts_in, const float* obs_u, const float* obs_v,
          const float* wmask, const float* fixedpt, const float* fm, float* pose_out,
          float* pts_out, float* out_scal, float* scratch, int K, int M, LmParams p, int single) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  Ba b;
  b.K = K; b.M = M; b.G = seg_size(K); b.n = 6 * K; b.ld = 6 * K + 1; b.p = p;
  const int per = (M + kCluster - 1) / kCluster;
  b.m0 = min(M, rank * per);
  b.m1 = min(M, b.m0 + per);
  b.obs_u = obs_u; b.obs_v = obs_v; b.wmask = wmask; b.fixedpt = fixedpt; b.fm = fm;
  b.wbuf = scratch;
  b.vbl = b.wbuf + (size_t)M * K * 18;
  b.vinv = b.vbl + (size_t)M * 9;
  b.pts[0] = pts_out;
  b.pts[1] = b.vinv + (size_t)M * 9;
  carve(b, smem);
  for (int d = 0; d < 3; ++d)
    for (int m = b.m0 + tid; m < b.m1; m += kBaThreads) pts_out[d * M + m] = pts_in[d * M + m];
  for (int i = tid; i < 12 * K; i += kBaThreads) b.pose[i] = pose_in[i];
  __syncthreads();

  int cur = 0, it = 0;
  const int max_it = single ? 1 : p.max_iterations;
  float lam = p.lam0, cur_cost = 0.0f, cost = 0.0f;
  bool relin = true, done = false;
  while (it < max_it && !done) {
    if (relin) linearize(b, cur);
    schur(b, lam);
    cluster.sync();  // partials visible to CTA 0
    if (relin) cur_cost = 0.5f * cluster_scalar(b, 0, cluster);
    if (rank == 0) {
      assemble(b, lam, cluster);
      gauss_jordan(b);
    }
    cluster.sync();  // dx visible
    if (rank != 0) {
      const float* dx0 = cluster.map_shared_rank(b.dx, 0);
      for (int r = tid; r < b.n; r += kBaThreads) b.dx[r] = dx0[r];
    }
    __syncthreads();
    if (tid < K) {
      const float rho[3] = {b.dx[tid], b.dx[K + tid], b.dx[2 * K + tid]};
      const float wv[3] = {b.dx[3 * K + tid], b.dx[4 * K + tid], b.dx[5 * K + tid]};
      retract(b.pose + 12 * tid, rho, wv, b.pose_new + 12 * tid);
    }
    __syncthreads();
    trial(b, cur);
    cluster.sync();  // trial partials visible
    const float new_cost = 0.5f * cluster_scalar(b, 1, cluster);
    float step_x = 0.0f;
    for (int r = 0; r < b.n; ++r) step_x += b.dx[r] * b.dx[r];
    const float step = step_x + cluster_scalar(b, 2, cluster);
    if (single) {
      if (rank == 0) {
        for (int i = tid; i < 12 * K; i += kBaThreads) pose_out[i] = b.pose_new[i];
        if (tid == 0) { out_scal[0] = cur_cost; out_scal[1] = new_cost; out_scal[2] = step; out_scal[3] = 0.0f; }
      }
      for (int d = 0; d < 3; ++d)
        for (int m = b.m0 + tid; m < b.m1; m += kBaThreads) pts_out[d * M + m] = b.pts[1][d * M + m];
      break;
    }
    const bool accept = new_cost < cur_cost;
    if (accept) {
      for (int i = tid; i < 12 * K; i += kBaThreads) b.pose[i] = b.pose_new[i];
      cur = 1 - cur;
    }
    lam = accept ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 4.0f, 1e6f);
    done = (accept && ((step < p.step_tol) || ((cur_cost - new_cost) < p.rel_tol * cur_cost))) || (lam > 1e5f);
    cost = accept ? new_cost : cur_cost;
    relin = accept;
    ++it;
    __syncthreads();
  }
  if (!single) {
    if (rank == 0) {
      for (int i = tid; i < 12 * K; i += kBaThreads) pose_out[i] = b.pose[i];
      if (tid == 0) { out_scal[0] = cost; out_scal[1] = (float)it; out_scal[2] = 0.0f; out_scal[3] = 0.0f; }
    }
    if (cur == 1)
      for (int d = 0; d < 3; ++d)
        for (int m = b.m0 + tid; m < b.m1; m += kBaThreads) pts_out[d * M + m] = b.pts[1][d * M + m];
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// ---------------------------------------------------------------------------
// K1: PnP in one CTA
// ---------------------------------------------------------------------------

// The warp's sums of 32 per-thread values, scattered over its lanes: after
// 16 + 8 + 4 + 2 + 1 shuffles lane l holds the warp's sum of value l (a
// butterfly per value would take 5 x 32), stored to slot[warp][lane].
__device__ __forceinline__ void warp_scatter(float (&v)[32], float (*slot)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool upper = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  slot[threadIdx.x >> 5][lane] = v[0];
}

// Lane l of warp 0, after the barrier that follows warp_scatter: the
// block's sum of value l, over the warps in order.
__device__ __forceinline__ float slot_sum(const float (*slot)[32]) {
  const int lane = threadIdx.x & 31;
  float x[kPnpWarps];
#pragma unroll
  for (int w = 0; w < kPnpWarps; ++w) x[w] = slot[w][lane];
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kPnpWarps; ++w) s += x[w];
  return s;
}

// One pass over this thread's landmarks at `pose`: U (upper 21), b (6)
// and the Huber cost (before the 1/2) into v[0..27]; v[28..31] stay 0.
__device__ __forceinline__ void pnp_accumulate(const float* pose, const float* pts, const float* obs,
                                               const unsigned char* active, const unsigned char* outlier,
                                               int M, const LmParams& p, float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.0f;
  for (int m = threadIdx.x; m < M; m += kPnpThreads) {
    const float wm = active[m] && !outlier[m] ? 1.0f : 0.0f;
    Obs o;
    evaluate(pose, pts[3 * m], pts[3 * m + 1], pts[3 * m + 2], obs[2 * m], obs[2 * m + 1], p, o);
    v[27] += huber_rho(o.c2, p.huber_delta) * wm;
    const float w = irls_weight(o, wm, p);
    float jp[2][6], jl[2][3];
    jacobians(pose, o, p, jp, jl);
    int u = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) v[u++] += w * (jp[0][a] * jp[0][c] + jp[1][a] * jp[1][c]);
      v[21 + a] += -(w * (jp[0][a] * o.du + jp[1][a] * o.dv));
    }
  }
}

// Thread 0: the damped 6x6 system of sums s by the reference's unpivoted
// Gauss-Jordan in registers, then the retraction of pose into pose_new;
// returns |dx|^2.
__device__ float pnp_step(const float* s, const float* pose, float lam, int diag_damping, float* pose_new) {
  float a[6][7];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int f = 0; f < 6; ++f) a[c][f] = damped_u(s, c, f, lam, diag_damping);
    a[c][6] = s[21 + c];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float piv = a[i][i];
    float pr[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) pr[j] = a[i][j] / piv;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r == i) continue;
      const float col = a[r][i];
#pragma unroll
      for (int j = 0; j < 7; ++j) a[r][j] -= col * pr[j];
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) a[i][j] = pr[j];
  }
  const float rho[3] = {a[0][6], a[1][6], a[2][6]};
  const float wv[3] = {a[3][6], a[4][6], a[5][6]};
  retract(pose, rho, wv, pose_new);
  float step = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) step += a[c][6] * a[c][6];
  return step;
}

// Per LM iteration: every thread evaluates its landmarks at the trial pose
// and scatters its warp's 28 sums (barrier 1); warp 0 sums the slots and
// thread 0, which alone holds the loop state (lambda, cost, iteration,
// which pose buffer is accepted), takes the accept/reject and solves the
// next step into the other pose buffer (barrier 2). pose[b] and sums[b]
// belong together: the sums are the linearization at that pose.
__global__ void __launch_bounds__(kPnpThreads, 1)
pnp_kernel(const float* r_in, const float* t_in, const float* pts, const float* obs,
           const unsigned char* active, const unsigned char* marg, float* r_out, float* t_out,
           unsigned char* outlier, float* cost_out, int* counts, int M, LmParams p) {
  // this CTA's problem of the batch
  const size_t b = blockIdx.x;
  r_in += 9 * b;
  t_in += 3 * b;
  pts += 3 * M * b;
  obs += 2 * M * b;
  active += M * b;
  marg += M * b;
  r_out += 9 * b;
  t_out += 3 * b;
  outlier += M * b;
  cost_out += b;
  counts += 3 * b;
  __shared__ float pose[2][12];
  __shared__ float sums[2][32];
  __shared__ float slot[kPnpWarps][32];
  __shared__ int ctl[3];  // pose buffer of the next pass, done, accepted buffer
  const int tid = threadIdx.x;
  for (int m = tid; m < M; m += kPnpThreads) outlier[m] = 0;
  // loop state, live in thread 0
  int cb = 0, it = 0, total_it = 0;
  float lam = p.lam0, cur = 0.0f, step = 0.0f;
  float final_cost = 0.0f, n_inl = 0.0f, n_out = 0.0f;
  float v[32];
  int acc = 0;  // every thread's copy of the accepted pose buffer
  for (int round = 0; round < p.rounds; ++round) {
    if (tid < 12) pose[0][tid] = tid < 9 ? r_in[tid] : t_in[tid - 9];
    __syncthreads();
    int nb = 0;
    acc = 0;
    for (bool first = true;; first = false) {
      pnp_accumulate(pose[nb], pts, obs, active, outlier, M, p, v);
      warp_scatter(v, slot);
      __syncthreads();
      if (tid < 32) {
        sums[nb][tid] = slot_sum(slot);
        __syncwarp();
        if (tid == 0) {
          bool done;
          if (first) {  // round start: the linearization at the initial pose
            cb = 0;
            cur = 0.5f * sums[0][27];
            lam = p.lam0;
            it = 0;
            done = it >= p.max_iterations;
          } else {
            const float nw = 0.5f * sums[nb][27];
            const bool accept = nw < cur;
            if (accept) cb = nb;  // the trial pass is the next linearization
            lam = accept ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 4.0f, 1e6f);
            done = (accept && ((step < p.step_tol) || ((cur - nw) < p.rel_tol * cur))) || (lam > 1e5f);
            if (accept) cur = nw;
            ++it;
            done = done || it >= p.max_iterations;
          }
          // after a reject the stored sums of pose[cb] are solved again
          if (!done) step = pnp_step(sums[cb], pose[cb], lam, p.diag_damping, pose[1 - cb]);
          else total_it += it;
          ctl[0] = 1 - cb;
          ctl[1] = done;
          ctl[2] = cb;
        }
      }
      __syncthreads();
      nb = ctl[0];
      acc = ctl[2];
      if (ctl[1]) break;
    }
    // chi2 classification at the solution (raw wrapped residuals);
    // marginalized landmarks are never outliers
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
    for (int m = tid; m < M; m += kPnpThreads) {
      Obs o;
      evaluate(pose[acc], pts[3 * m], pts[3 * m + 1], pts[3 * m + 2], obs[2 * m], obs[2 * m + 1], p, o);
      const bool out = active[m] && !marg[m] && o.c2 > p.chi2_threshold;
      outlier[m] = out;
      const float inl = active[m] && !out ? 1.0f : 0.0f;
      v[0] += inl;
      v[1] += inl * o.c2;
      v[2] += out ? 1.0f : 0.0f;
    }
    warp_scatter(v, slot);
    __syncthreads();
    if (tid < 32) {
      sums[0][tid] = slot_sum(slot);  // pose[0] is rewritten below, sums[0] with it
      __syncwarp();
      if (tid == 0) {
        n_inl = sums[0][0];
        final_cost = sums[0][1] / fmaxf(n_inl, 1.0f);
        n_out = sums[0][2];
      }
    }
    __syncthreads();  // pose[acc] read before the next round rewrites pose[0]
  }
  if (tid < 12) {
    const float x = p.rounds > 0 ? pose[acc][tid] : tid < 9 ? r_in[tid] : t_in[tid - 9];
    if (tid < 9) r_out[tid] = x;
    else t_out[tid - 9] = x;
  }
  if (tid == 0) {
    *cost_out = final_cost;
    counts[0] = (int)n_inl;
    counts[1] = (int)n_out;
    counts[2] = total_it;
  }
}

cudaLaunchConfig_t ba_config(int K, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kBaThreads, 1, 1);
  cfg.dynamicSmemBytes = ba_smem_floats(K, seg_size(K)) * sizeof(float);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes, set once for the largest shape (K = kMaxK),
// then how many clusters at K fit on the card at once (0: the cluster
// cannot launch).
cudaError_t ba_fit(int K, cudaStream_t stream, int* max_clusters) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute((const void*)ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(ba_smem_floats(kMaxK, seg_size(kMaxK)) * sizeof(float)));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute((const void*)ba_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ba_config(K, stream, attr);
  return cudaOccupancyMaxActiveClusters(max_clusters, (void*)ba_kernel, &cfg);
}

}  // namespace

extern "C" {

// K2 (single = 0) and K3 (single = 1): one cluster of kCluster CTAs.
// scratch: M*K*18 + M*9 + M*9 + 3*M floats.
int lm_ba(const float* pose_in, const float* pts_in, const float* obs_u, const float* obs_v,
          const float* wmask, const float* fixedpt, const float* fm, float* pose_out,
          float* pts_out, float* out_scal, float* scratch, int K, int M, const LmParams* p,
          int single, void* stream) {
  if (K < 1 || K > kMaxK || M < 1) return (int)cudaErrorInvalidValue;
  static int fits[kMaxK + 1];  // max active clusters + 1 per K; 0 = not asked yet
  if (fits[K] == 0) {
    int max_clusters = 0;
    const cudaError_t e = ba_fit(K, (cudaStream_t)stream, &max_clusters);
    if (e != cudaSuccess) return (int)e;
    fits[K] = max_clusters + 1;
  }
  if (fits[K] < 2) return (int)cudaErrorLaunchOutOfResources;  // the cluster does not fit
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ba_config(K, (cudaStream_t)stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ba_kernel, pose_in, pts_in, obs_u, obs_v, wmask, fixedpt,
                                           fm, pose_out, pts_out, out_scal, scratch, K, M, *p, single);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape of lm_ba: CTAs per cluster, dynamic shared memory per
// CTA (bytes) and how many clusters of that shape fit on the card.
int lm_ba_info(int K, int* cluster_ctas, int* smem_bytes, int* max_clusters) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  *cluster_ctas = kCluster;
  *smem_bytes = (int)(ba_smem_floats(K, seg_size(K)) * sizeof(float));
  return (int)ba_fit(K, 0, max_clusters);
}

// K1 over B independent problems sharing one LmParams, one CTA each.
// Inputs: r [B][9], t [B][3], points [B][M][3], observations [B][M][2],
// active and marginalized [B][M] bytes; outputs: r, t, outlier bytes
// [B][M], the final mean inlier chi2 [B], counts [B][3] = (inliers,
// outliers, LM iterations).
int lm_pnp(const float* r_in, const float* t_in, const float* pts, const float* obs,
           const unsigned char* active, const unsigned char* marg, float* r_out, float* t_out,
           unsigned char* outlier, float* cost_out, int* counts, int M, int B, const LmParams* p,
           void* stream) {
  if (M < 1 || B < 1) return (int)cudaErrorInvalidValue;
  pnp_kernel<<<B, kPnpThreads, 0, (cudaStream_t)stream>>>(r_in, t_in, pts, obs, active, marg, r_out, t_out,
                                                          outlier, cost_out, counts, M, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
