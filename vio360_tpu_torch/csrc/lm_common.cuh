// Device functions shared by the LM kernels of lm_solve.cu (K1 PnP,
// K2/K3 window BA): the ERP reprojection with the TPU kernel's cephes
// atan polynomials, the Huber weight, the residual-sign Jacobians and
// the SE(3) right-perturbation retraction, each the arithmetic of
// vio360_tpu/solver/ba_pallas.py (_evaluate_plane, _lm_iteration).
//
// What bounds the kernels that use them is not these functions but the
// dependency chain of the LM loop: every iteration needs the previous
// one's accept/reject. So the functions are written for latency (all
// in registers, no shared or global traffic of their own), and the
// kernels spend their design on how few barriers an iteration needs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lm {

constexpr int kMaxK = 16;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;
constexpr float kPi2 = 1.5707963267948966f;
constexpr float kPi4 = 0.7853981633974483f;
constexpr float kMaxPixelError = 100.0f;

}  // namespace lm

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

namespace lm {

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

// IRLS weight of one observation: Huber x 1/sigma^2 x mask, 0 past the
// 100-px residual cut.
__device__ __forceinline__ float irls_weight(const Obs& o, float wm, const LmParams& p) {
  const float delta = p.huber_delta;
  const float wh = (o.c2 <= delta * delta ? 1.0f : delta / sqrtf(fmaxf(o.c2, 1e-20f))) * p.inv_s2;
  const bool big = fabsf(o.du) > kMaxPixelError || fabsf(o.dv) > kMaxPixelError;
  return big ? 0.0f : wh * wm;
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

// Damped inverse of a landmark's 3x3 block from its upper triangle v[0..5]
// (trace-scaled damping lam/3 tr(V) + 1e-8, cofactor inverse).
__device__ __forceinline__ void damped_inverse3(const float* v, float lam, float vinv[9]) {
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
#pragma unroll
  for (int i = 0; i < 9; ++i) vinv[i] = co[i / 3][i % 3] * inv_det;
}

// Right-perturbation retraction T_new = T exp([rho, phi]) of one pose
// (rows r00..r22, t) into rn.
__device__ __forceinline__ void retract(const float* r, const float rho[3], const float wv[3], float* rn) {
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rn[3 * i + j] = r[3 * i] * dr[0][j] + r[3 * i + 1] * dr[1][j] + r[3 * i + 2] * dr[2][j];
    rn[9 + i] = r[3 * i] * dt[0] + r[3 * i + 1] * dt[1] + r[3 * i + 2] * dt[2] + r[9 + i];
  }
}

__device__ __forceinline__ int usym(int c, int f) {  // upper-triangle index of a 6x6
  if (c > f) { const int t = c; c = f; f = t; }
  return c * 6 - (c * (c - 1)) / 2 + (f - c);
}

// Damped diagonal block entry (c, f) of one pose from its U upper triangle:
// PnP's diagonal damping U (1 + lam) + 1e-10, or BA's trace-scaled lam/6 tr(U).
__device__ __forceinline__ float damped_u(const float* us, int c, int f, float lam, int diag_damping) {
  if (diag_damping) return us[usym(c, f)] * (c == f ? 1.0f + lam : 1.0f) + (c == f ? 1e-10f : 0.0f);
  const float tr = us[usym(0, 0)] + us[usym(1, 1)] + us[usym(2, 2)] + us[usym(3, 3)] +
                   us[usym(4, 4)] + us[usym(5, 5)];
  return us[usym(c, f)] + (c == f ? (lam / 6.0f) * tr : 0.0f);
}

// Butterfly sum over a warp: every lane ends with the same bits
// (a + b == b + a in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace lm
