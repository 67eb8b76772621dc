// Levenberg-Marquardt window BA and PnP, each as ONE launch.
//
// Replaces the TPU megakernels of vio360_tpu/solver/ba_pallas.py:
//   lm_pnp  <- pnp_solve    / _pnp_solve_kernel  (K1: 4 chi2 rounds x LM)
//   lm_ba   <- ba_solve     / _ba_solve_kernel   (K2: whole LM loop)
//           <- ba_iteration / _ba_iter_kernel    (K3: single = 1 iteration)
// The K=1 PnP and the K<=16 window are the same LM iteration (the
// reference's _lm_iteration), written once below.
//
// What bounds it on this card: latency, not bytes or FLOPs. One problem
// is K<=10 poses x M=2048 landmarks (~1 MB of inputs, ~10 MFLOP per
// iteration), far too small to fill 132 SMs, and every LM iteration
// depends on the previous one. A launch per iteration would pay a
// launch plus a host sync each time.
//
// What the design does about it: one thread block of 512 threads owns
// the whole problem and runs the whole LM loop (and PnP's chi2 rounds)
// inside the launch, with accept/reject decided from shared memory, so
// there is no host round trip per iteration. Landmarks are processed
// by segments of G = next_pow2(K) lanes, one lane per keyframe: per-pose
// normal blocks (U, b_p) and the Schur right-hand-side correction stay
// in registers and are reduced once per iteration; the 3x3 landmark
// blocks are reduced with warp shuffles; the Schur cross terms
// -W V^-1 W^T of each landmark go to a 6K x 6K system in shared memory
// with shared atomics, skipping keyframes that do not observe it. The
// reduced system is solved by the same unpivoted Gauss-Jordan in (c, k)
// unknown order as the TPU kernel, then landmarks are back-substituted
// and the trial state evaluated. atan2/asin use the TPU kernel's cephes
// polynomials so the kernel and its plain version agree closely.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 16;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;
constexpr float kPi2 = 1.5707963267948966f;
constexpr float kPi4 = 0.7853981633974483f;
constexpr float kMaxPixelError = 100.0f;
constexpr int kPart = 33;  // per-pose partials: U (21 upper), b_p (6), rhs correction (6)

}  // namespace

// Layout shared with vio360_tpu_torch/solver/ba_cuda.py::_LmParams.
struct LmParams {
  float width, height, cu, cv;
  float huber_delta, inv_s2, lam0, step_tol;
  float rel_tol, chi2_threshold;
  float rcb[9];
  float tcb[3];
  int diag_damping;
  int max_iterations;
  int rounds;
};

namespace {

struct Ctx {
  int K, M, G;
  LmParams p;
  const float* obs_u;    // [K*M]
  const float* obs_v;    // [K*M]
  const float* wmask;    // [K*M]
  const float* fixedpt;  // [M]; nullptr = every landmark fixed (PnP)
  const float* fm;       // [K] 1 = free pose
  float* wbuf;           // [M*K*18] W blocks for back-substitution
  float* vib;            // [M*12] V^-1 (9) and b_l (3)
  float* pts[2];         // [3*M] current / trial landmark buffers
  // shared memory
  float* aug;            // n x (n+1)
  float* prow;           // n+1
  float* colv;           // n
  float* dx;             // n
  float* pose;           // K*12 current
  float* pose_new;       // K*12 trial
  float* part;           // nwarps*K*kPart
  float* usum;           // K*kPart
  float* red;            // 64
  float* seg;            // nseg*2*K*18 (W, W V^-1) or nullptr
};

__device__ __forceinline__ float atan01(float x) {
  const bool red = x > 0.4142135623730951f;
  const float xr = red ? (x - 1.0f) / (x + 1.0f) : x;
  const float z = xr * xr;
  const float y =
      (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
       3.33329491539e-1f) * z * xr + xr;
  return red ? kPi4 + y : y;
}

__device__ __forceinline__ float atan2p(float a, float b) {
  const float aa = fabsf(a), ab = fabsf(b);
  const float q = fminf(aa, ab) / fmaxf(fmaxf(aa, ab), 1e-30f);
  float at = atan01(q);
  at = aa > ab ? kPi2 - at : at;
  at = b < 0.0f ? kPi - at : at;
  return a < 0.0f ? -at : at;
}

struct Obs {
  float pb[3], pc[3], du, dv, c2;
};

// ERP reprojection of one landmark in one keyframe (pose rows r00..r22, t).
__device__ __forceinline__ void evaluate(const float* pose, float px, float py, float pz,
                                         float ou, float ov, const LmParams& p, Obs& o) {
  const float dx = px - pose[9], dy = py - pose[10], dz = pz - pose[11];
#pragma unroll
  for (int i = 0; i < 3; ++i) o.pb[i] = pose[i] * dx + pose[3 + i] * dy + pose[6 + i] * dz;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.pc[i] = p.rcb[3 * i] * o.pb[0] + p.rcb[3 * i + 1] * o.pb[1] + p.rcb[3 * i + 2] * o.pb[2] + p.tcb[i];
  const float x = o.pc[0], y = o.pc[1], z = o.pc[2];
  const float theta = atan2p(x, z);
  const float phi = -atan2p(y, sqrtf(fmaxf(x * x + z * z, 1e-24f)));
  const float proj_u = p.width * (0.5f + theta / kTwoPi);
  const float proj_v = p.height * (0.5f - phi / kPi);
  float du = ou - proj_u;
  du = du - p.width * rintf(du / p.width);
  const float dv = ov - proj_v;
  o.du = du;
  o.dv = dv;
  o.c2 = (du * du + dv * dv) * p.inv_s2;
}

__device__ __forceinline__ float huber_rho(float c2, float delta) {
  const float d2 = delta * delta;
  return c2 <= d2 ? c2 : 2.0f * delta * sqrtf(fmaxf(c2, 1e-20f)) - d2;
}

// Residual-sign Jacobians: pose [2][6] = [d/d rho | d/d phi], landmark [2][3].
__device__ __forceinline__ void jacobians(const float* pose, const Obs& o, const LmParams& p,
                                          float jp[2][6], float jl[2][3]) {
  const float x = o.pc[0], y = o.pc[1], z = o.pc[2];
  const float xz_sq = fmaxf(x * x + z * z, 1e-12f);
  const float l_sq = fmaxf(x * x + y * y + z * z, 1e-12f);
  const float xz = sqrtf(xz_sq);
  float jpc[2][3];
  jpc[0][0] = -(p.cu * z / xz_sq);
  jpc[0][1] = 0.0f;
  jpc[0][2] = -(-p.cu * x / xz_sq);
  jpc[1][0] = -(-p.cv * x * y / (l_sq * xz));
  jpc[1][1] = -(p.cv * xz / l_sq);
  jpc[1][2] = -(-p.cv * y * z / (l_sq * xz));
  const float* pb = o.pb;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float rh[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float jt = -(jpc[i][0] * p.rcb[j] + jpc[i][1] * p.rcb[3 + j] + jpc[i][2] * p.rcb[6 + j]);
      jp[i][j] = jt;
      rh[j] = -jt;
    }
    jp[i][3] = rh[1] * pb[2] + rh[2] * (-pb[1]);
    jp[i][4] = rh[0] * (-pb[2]) + rh[2] * pb[0];
    jp[i][5] = rh[0] * pb[1] + rh[1] * (-pb[0]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      jl[i][j] = rh[0] * pose[3 * j] + rh[1] * pose[3 * j + 1] + rh[2] * pose[3 * j + 2];
  }
}

__device__ __forceinline__ int usym(int c, int f) {  // upper-triangle index of a 6x6
  if (c > f) { const int t = c; c = f; f = t; }
  return c * 6 - (c * (c - 1)) / 2 + (f - c);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Deterministic block sum: every thread returns the same value.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// One LM iteration from (ctx.pose, ctx.pts[cur]) with damping lam:
// writes the trial state to ctx.pose_new / ctx.pts[1-cur] and returns
// (cur_cost, new_cost, step_sq) in out[0..2] (same value in every thread).
__device__ void lm_iteration(const Ctx& c, int cur, float lam, float out[3]) {
  const int K = c.K, M = c.M, G = c.G;
  const int n = 6 * K, ld = n + 1;
  const int tid = threadIdx.x, bs = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid % G, seg = tid / G, nseg = bs / G;
  const int seg_in_warp = lane / G;
  const unsigned seg_bits = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  const unsigned segmask = seg_bits << (seg_in_warp * G);
  const bool has_k = g < K;
  const bool all_fixed = c.fixedpt == nullptr;
  const float delta = c.p.huber_delta, d2 = delta * delta, inv_s2 = c.p.inv_s2;
  const float* P = c.pts[cur];

  for (int i = tid; i < n * ld; i += bs) c.aug[i] = 0.0f;
  __syncthreads();

  // ---- linearize: per-pose sums in registers, per-landmark Schur ----
  float U[21], bp[6], rc[6];
#pragma unroll
  for (int i = 0; i < 21; ++i) U[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) { bp[i] = 0.0f; rc[i] = 0.0f; }
  float cost_acc = 0.0f;
  const int iters = (M + nseg - 1) / nseg;
  for (int it = 0; it < iters; ++it) {
    const int m = it * nseg + seg;
    const bool valid_m = m < M;
    float w = 0.0f, du = 0.0f, dv = 0.0f;
    float jp[2][6], jl[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) jp[i][j] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) jl[i][j] = 0.0f;
    }
    if (valid_m && has_k) {
      const float* pose = c.pose + 12 * g;
      Obs o;
      evaluate(pose, P[m], P[M + m], P[2 * M + m], c.obs_u[g * M + m], c.obs_v[g * M + m], c.p, o);
      const float wm = c.wmask[g * M + m];
      cost_acc += huber_rho(o.c2, delta) * wm;
      const float wh = (o.c2 <= d2 ? 1.0f : delta / sqrtf(fmaxf(o.c2, 1e-20f))) * inv_s2;
      const bool big = fabsf(o.du) > kMaxPixelError || fabsf(o.dv) > kMaxPixelError;
      w = big ? 0.0f : wh * wm;
      du = o.du;
      dv = o.dv;
      jacobians(pose, o, c.p, jp, jl);
      int u = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) U[u++] += w * (jp[0][a] * jp[0][b] + jp[1][a] * jp[1][b]);
        bp[a] += -(w * (jp[0][a] * du + jp[1][a] * dv));
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
    const bool fixed = all_fixed || !valid_m || c.fixedpt[m] > 0.5f;
    if (!fixed) {
      const float dmp = (lam / 3.0f) * (v[0] + v[3] + v[5]) + 1e-8f;
      const float vd[3][3] = {{v[0] + dmp, v[1], v[2]}, {v[1], v[3] + dmp, v[4]}, {v[2], v[4], v[5] + dmp}};
      float co[3][3];
      co[0][0] = vd[1][1] * vd[2][2] - vd[1][2] * vd[2][1];
      co[0][1] = vd[0][2] * vd[2][1] - vd[0][1] * vd[2][2];
      co[0][2] = vd[0][1] * vd[1][2] - vd[0][2] * vd[1][1];
      co[1][0] = vd[1][2] * vd[2][0] - vd[1][0] * vd[2][2];
      co[1][1] = vd[0][0] * vd[2][2] - vd[0][2] * vd[2][0];
      co[1][2] = vd[0][2] * vd[1][0] - vd[0][0] * vd[1][2];
      co[2][0] = vd[1][0] * vd[2][1] - vd[1][1] * vd[2][0];
      co[2][1] = vd[0][1] * vd[2][0] - vd[0][0] * vd[2][1];
      co[2][2] = vd[0][0] * vd[1][1] - vd[0][1] * vd[1][0];
      const float det = vd[0][0] * co[0][0] + vd[0][1] * co[1][0] + vd[0][2] * co[2][0];
      const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1.0f);
      float vinv[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) vinv[i] = co[i / 3][i % 3] * inv_det;
      float* sW = c.seg + (size_t)seg * 2 * K * 18;
      float* sWV = sW + K * 18;
      if (has_k) {
        float W[18], WV[18];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int d = 0; d < 3; ++d) W[a * 3 + d] = w * (jp[0][a] * jl[0][d] + jp[1][a] * jl[1][d]);
#pragma unroll
          for (int e = 0; e < 3; ++e)
            WV[a * 3 + e] = W[a * 3] * vinv[e] + W[a * 3 + 1] * vinv[3 + e] + W[a * 3 + 2] * vinv[6 + e];
          rc[a] += WV[a * 3] * v[6] + WV[a * 3 + 1] * v[7] + WV[a * 3 + 2] * v[8];
        }
        float* gw = c.wbuf + ((size_t)m * K + g) * 18;
#pragma unroll
        for (int i = 0; i < 18; ++i) {
          sW[g * 18 + i] = W[i];
          sWV[g * 18 + i] = WV[i];
          gw[i] = W[i];
        }
      }
      if (g == 0) {
        float* vb = c.vib + (size_t)m * 12;
#pragma unroll
        for (int i = 0; i < 9; ++i) vb[i] = vinv[i];
        vb[9] = v[6];
        vb[10] = v[7];
        vb[11] = v[8];
      }
      // keyframes observing this landmark (W is exactly zero elsewhere)
      const unsigned bal = __ballot_sync(segmask, has_k && w != 0.0f);
      const unsigned obs = (bal >> (seg_in_warp * G)) & seg_bits;
      __syncwarp(segmask);
      int ks[kMaxK];
      int nobs = 0;
      for (int k = 0; k < K; ++k)
        if ((obs >> k) & 1u) ks[nobs++] = k;
      const int per = nobs * 36;
      for (int e = g; e < nobs * per; e += G) {
        const int ka = ks[e / per], rem = e % per;
        const int kb = ks[rem / 36], cc = (rem % 36) / 6, ff = rem % 6;
        const float* wva = sWV + ka * 18 + cc * 3;
        const float* wb = sW + kb * 18 + ff * 3;
        const float s = wva[0] * wb[0] + wva[1] * wb[1] + wva[2] * wb[2];
        atomicAdd(&c.aug[(cc * K + ka) * ld + ff * K + kb], -s);
      }
      __syncwarp(segmask);
    }
  }
  // per-pose partials: reduce across the segments of a warp, one slot per warp
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 21; ++i) U[i] += __shfl_xor_sync(0xffffffffu, U[i], off);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      bp[i] += __shfl_xor_sync(0xffffffffu, bp[i], off);
      rc[i] += __shfl_xor_sync(0xffffffffu, rc[i], off);
    }
  }
  if (seg_in_warp == 0 && has_k) {
    float* dst = c.part + (warp * K + g) * kPart;
#pragma unroll
    for (int i = 0; i < 21; ++i) dst[i] = U[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      dst[21 + i] = bp[i];
      dst[27 + i] = rc[i];
    }
  }
  const float cur_cost = 0.5f * block_sum(cost_acc, c.red);  // syncs: partials visible
  const int nwarps = bs >> 5;
  for (int i = tid; i < K * kPart; i += bs) {
    float s = 0.0f;
    for (int wi = 0; wi < nwarps; ++wi) s += c.part[wi * K * kPart + i];
    c.usum[i] = s;
  }
  __syncthreads();

  // ---- reduced camera system in (c, k) order, damping and gauge ----
  for (int i = tid; i < n * n; i += bs) {
    const int row = i / n, col = i % n;
    const int cc = row / K, k = row % K, ff = col / K, l = col % K;
    float val = c.aug[row * ld + col];
    if (k == l) {
      const float* us = c.usum + k * kPart;
      float ud;
      if (c.p.diag_damping) {
        ud = us[usym(cc, ff)] * (cc == ff ? 1.0f + lam : 1.0f) + (cc == ff ? 1e-10f : 0.0f);
      } else {
        const float tr = us[usym(0, 0)] + us[usym(1, 1)] + us[usym(2, 2)] + us[usym(3, 3)] +
                         us[usym(4, 4)] + us[usym(5, 5)];
        ud = us[usym(cc, ff)] + (cc == ff ? (lam / 6.0f) * tr : 0.0f);
      }
      val += ud;
    }
    val = val * c.fm[k] * c.fm[l] + (row == col ? 1.0f - c.fm[k] : 0.0f);
    c.aug[row * ld + col] = val;
  }
  for (int row = tid; row < n; row += bs) {
    const int cc = row / K, k = row % K;
    const float* us = c.usum + k * kPart;
    c.aug[row * ld + n] = (us[21 + cc] - us[27 + cc]) * c.fm[k];
  }
  __syncthreads();

  // ---- unpivoted Gauss-Jordan on [n, n+1] ----
  for (int i = 0; i < n; ++i) {
    const float piv = c.aug[i * ld + i];
    for (int j = tid; j < ld; j += bs) c.prow[j] = c.aug[i * ld + j] / piv;
    for (int r = tid; r < n; r += bs) c.colv[r] = c.aug[r * ld + i];
    __syncthreads();
    for (int idx = tid; idx < n * ld; idx += bs) {
      const int r = idx / ld, j = idx % ld;
      c.aug[idx] = r == i ? c.prow[j] : c.aug[idx] - c.colv[r] * c.prow[j];
    }
    __syncthreads();
  }
  for (int r = tid; r < n; r += bs) c.dx[r] = c.aug[r * ld + n];
  __syncthreads();

  // ---- landmark back-substitution -> trial points ----
  float step_l = 0.0f;
  float* Pn = c.pts[1 - cur];
  if (!all_fixed) {
    for (int m = tid; m < M; m += bs) {
      float dl[3] = {0.0f, 0.0f, 0.0f};
      if (!(c.fixedpt[m] > 0.5f)) {
        const float* vb = c.vib + (size_t)m * 12;
        float tmp[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float s = 0.0f;
          for (int k = 0; k < K; ++k) {
            const float* wk = c.wbuf + ((size_t)m * K + k) * 18;
            float sk = 0.0f;
#pragma unroll
            for (int a = 0; a < 6; ++a) sk += wk[a * 3 + d] * c.dx[a * K + k];
            s += sk;
          }
          tmp[d] = vb[9 + d] - s;
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) dl[d] = vb[3 * d] * tmp[0] + vb[3 * d + 1] * tmp[1] + vb[3 * d + 2] * tmp[2];
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        Pn[d * M + m] = P[d * M + m] + dl[d];
        step_l += dl[d] * dl[d];
      }
    }
  }

  // ---- retract poses: T_new = T exp([rho, phi]) ----
  if (tid < K) {
    const int k = tid;
    const float rho[3] = {c.dx[0 * K + k], c.dx[1 * K + k], c.dx[2 * K + k]};
    const float wv[3] = {c.dx[3 * K + k], c.dx[4 * K + k], c.dx[5 * K + k]};
    const float th2 = wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2];
    const float th = sqrtf(fmaxf(th2, 1e-30f));
    const bool small = th2 < 1e-10f;
    const float sa = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
    const float sb = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / fmaxf(th2, 1e-30f);
    const float sc = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sinf(th)) / fmaxf(th2 * th, 1e-30f);
    const float hw[3][3] = {{0.0f, -wv[2], wv[1]}, {wv[2], 0.0f, -wv[0]}, {-wv[1], wv[0], 0.0f}};
    float dr[3][3], vm[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float base = i == j ? 1.0f : 0.0f;
        const float k2 = wv[i] * wv[j] - (i == j ? th2 : 0.0f);
        dr[i][j] = base + sa * hw[i][j] + sb * k2;
        vm[i][j] = base + sb * hw[i][j] + sc * k2;
      }
    }
    float dt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) dt[i] = vm[i][0] * rho[0] + vm[i][1] * rho[1] + vm[i][2] * rho[2];
    const float* r = c.pose + 12 * k;
    float* rn = c.pose_new + 12 * k;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rn[3 * i + j] = r[3 * i] * dr[0][j] + r[3 * i + 1] * dr[1][j] + r[3 * i + 2] * dr[2][j];
      rn[9 + i] = r[3 * i] * dt[0] + r[3 * i + 1] * dt[1] + r[3 * i + 2] * dt[2] + r[9 + i];
    }
  }
  float step_x = 0.0f;
  for (int r = tid; r < n; r += bs) step_x += c.dx[r] * c.dx[r];
  __syncthreads();

  // ---- trial evaluation ----
  const float* Pt = all_fixed ? P : Pn;
  float new_acc = 0.0f;
  for (int m = tid; m < M; m += bs) {
    const float px = Pt[m], py = Pt[M + m], pz = Pt[2 * M + m];
    for (int k = 0; k < K; ++k) {
      Obs o;
      evaluate(c.pose_new + 12 * k, px, py, pz, c.obs_u[k * M + m], c.obs_v[k * M + m], c.p, o);
      new_acc += huber_rho(o.c2, delta) * c.wmask[k * M + m];
    }
  }
  const float new_cost = 0.5f * block_sum(new_acc, c.red);
  const float sx = block_sum(step_x, c.red);
  const float sl = block_sum(step_l, c.red);
  out[0] = cur_cost;
  out[1] = new_cost;
  out[2] = sx + sl;
}

// In-kernel LM accept/reject loop (control flow of ba_pallas._lm_loop).
// Every thread holds identical copies of the loop state.
__device__ void lm_loop(const Ctx& c, int& cur, float lam, int max_iterations, float step_tol,
                        float rel_tol, float* cost_out, int* iters_out) {
  int it = 0;
  bool done = false;
  float cost = 0.0f;
  while (it < max_iterations && !done) {
    float o[3];
    lm_iteration(c, cur, lam, o);
    const bool accept = o[1] < o[0];
    if (accept) {
      for (int i = threadIdx.x; i < 12 * c.K; i += blockDim.x) c.pose[i] = c.pose_new[i];
      if (c.fixedpt != nullptr) cur = 1 - cur;
    }
    lam = accept ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 4.0f, 1e6f);
    done = (accept && ((o[2] < step_tol) || ((o[0] - o[1]) < rel_tol * o[0]))) || (lam > 1e5f);
    cost = accept ? o[1] : o[0];
    ++it;
    __syncthreads();
  }
  *cost_out = cost;
  *iters_out = it;
}

__device__ void carve(Ctx& c, float* smem, bool with_seg) {
  const int K = c.K, n = 6 * K;
  const int nwarps = blockDim.x >> 5, nseg = blockDim.x / c.G;
  float* s = smem;
  c.aug = s;      s += n * (n + 1);
  c.prow = s;     s += n + 1;
  c.colv = s;     s += n;
  c.dx = s;       s += n;
  c.pose = s;     s += 12 * K;
  c.pose_new = s; s += 12 * K;
  c.part = s;     s += nwarps * K * kPart;
  c.usum = s;     s += K * kPart;
  c.red = s;      s += 64;
  c.seg = with_seg ? s : nullptr;
  (void)nseg;
}

size_t smem_floats(int K, int G, bool with_seg) {
  const int n = 6 * K, nwarps = kThreads / 32, nseg = kThreads / G;
  size_t f = (size_t)n * (n + 1) + (n + 1) + n + n + 24 * K + nwarps * K * kPart + K * kPart + 64;
  if (with_seg) f += (size_t)nseg * 2 * K * 18;
  return f;
}

int seg_size(int K) {
  int g = 1;
  while (g < K) g <<= 1;
  return g;
}

__global__ void __launch_bounds__(kThreads, 1)
ba_kernel(const float* pose_in, const float* pts_in, const float* obs_u, const float* obs_v,
          const float* wmask, const float* fixedpt, const float* fm, float* pose_out,
          float* pts_out, float* out_scal, float* scratch, int K, int M, int G, LmParams p,
          int single) {
  extern __shared__ float smem[];
  Ctx c;
  c.K = K; c.M = M; c.G = G; c.p = p;
  c.obs_u = obs_u; c.obs_v = obs_v; c.wmask = wmask; c.fixedpt = fixedpt; c.fm = fm;
  c.wbuf = scratch;
  c.vib = scratch + (size_t)M * K * 18;
  c.pts[0] = pts_out;
  c.pts[1] = c.vib + (size_t)M * 12;
  carve(c, smem, true);
  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) pts_out[i] = pts_in[i];
  for (int i = threadIdx.x; i < 12 * K; i += blockDim.x) c.pose[i] = pose_in[i];
  __syncthreads();
  int cur = 0;
  if (single) {
    float o[3];
    lm_iteration(c, cur, p.lam0, o);
    for (int i = threadIdx.x; i < 12 * K; i += blockDim.x) pose_out[i] = c.pose_new[i];
    for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) pts_out[i] = c.pts[1][i];
    if (threadIdx.x == 0) { out_scal[0] = o[0]; out_scal[1] = o[1]; out_scal[2] = o[2]; out_scal[3] = 0.0f; }
    return;
  }
  float cost;
  int iters;
  lm_loop(c, cur, p.lam0, p.max_iterations, p.step_tol, p.rel_tol, &cost, &iters);
  for (int i = threadIdx.x; i < 12 * K; i += blockDim.x) pose_out[i] = c.pose[i];
  if (cur == 1)
    for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) pts_out[i] = c.pts[1][i];
  if (threadIdx.x == 0) { out_scal[0] = cost; out_scal[1] = (float)iters; out_scal[2] = 0.0f; out_scal[3] = 0.0f; }
}

__global__ void __launch_bounds__(kThreads, 1)
pnp_kernel(const float* pose_in, const float* pts, const float* obs_u, const float* obs_v,
           const float* active, const float* marg, float* pose_out, float* outlier,
           float* wmask, float* out_scal, int M, LmParams p) {
  extern __shared__ float smem[];
  Ctx c;
  c.K = 1; c.M = M; c.G = 1; c.p = p;
  c.obs_u = obs_u; c.obs_v = obs_v; c.wmask = wmask; c.fixedpt = nullptr;
  c.wbuf = nullptr; c.vib = nullptr;
  c.pts[0] = const_cast<float*>(pts);
  c.pts[1] = nullptr;
  carve(c, smem, false);
  __shared__ float fm1;
  if (threadIdx.x == 0) fm1 = 1.0f;
  c.fm = &fm1;
  for (int m = threadIdx.x; m < M; m += blockDim.x) outlier[m] = 0.0f;
  float final_cost = 0.0f, n_inl = 0.0f, n_out = 0.0f;
  for (int r = 0; r < p.rounds; ++r) {
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) wmask[m] = active[m] * (1.0f - outlier[m]);
    for (int i = threadIdx.x; i < 12; i += blockDim.x) c.pose[i] = pose_in[i];
    __syncthreads();
    int cur = 0, iters;
    float cost;
    lm_loop(c, cur, p.lam0, p.max_iterations, p.step_tol, p.rel_tol, &cost, &iters);
    // chi2 classification at the solution (raw wrapped residuals)
    float s_cost = 0.0f, s_inl = 0.0f, s_out = 0.0f;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      Obs o;
      evaluate(c.pose, pts[m], pts[M + m], pts[2 * M + m], obs_u[m], obs_v[m], p, o);
      const float out = active[m] * (1.0f - marg[m]) * (o.c2 > p.chi2_threshold ? 1.0f : 0.0f);
      outlier[m] = out;
      const float inl = active[m] * (1.0f - out);
      s_inl += inl;
      s_cost += inl * o.c2;
      s_out += out;
    }
    n_inl = block_sum(s_inl, c.red);
    const float tot = block_sum(s_cost, c.red);
    n_out = block_sum(s_out, c.red);
    final_cost = tot / fmaxf(n_inl, 1.0f);
  }
  for (int i = threadIdx.x; i < 12; i += blockDim.x) pose_out[i] = c.pose[i];
  if (threadIdx.x == 0) { out_scal[0] = final_cost; out_scal[1] = n_inl; out_scal[2] = n_out; out_scal[3] = 0.0f; }
}

int launch_check(cudaError_t e) {
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 (single = 0) and K3 (single = 1). scratch: M*K*18 + M*12 + 3*M floats.
int lm_ba(const float* pose_in, const float* pts_in, const float* obs_u, const float* obs_v,
          const float* wmask, const float* fixedpt, const float* fm, float* pose_out,
          float* pts_out, float* out_scal, float* scratch, int K, int M, const LmParams* p,
          int single, void* stream) {
  if (K < 1 || K > kMaxK || M < 1) return (int)cudaErrorInvalidValue;
  const int G = seg_size(K);
  const size_t smem = smem_floats(K, G, true) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ba_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(pose_in, pts_in, obs_u, obs_v, wmask,
                                                         fixedpt, fm, pose_out, pts_out, out_scal,
                                                         scratch, K, M, G, *p, single);
  return launch_check(cudaSuccess);
}

// K1. wmask: M floats of scratch.
int lm_pnp(const float* pose_in, const float* pts, const float* obs_u, const float* obs_v,
           const float* active, const float* marg, float* pose_out, float* outlier, float* wmask,
           float* out_scal, int M, const LmParams* p, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(1, 1, false) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(pnp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pnp_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(pose_in, pts, obs_u, obs_v, active, marg,
                                                          pose_out, outlier, wmask, out_scal, M, *p);
  return launch_check(cudaSuccess);
}

}  // extern "C"
