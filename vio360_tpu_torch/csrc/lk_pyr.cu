// Pyramidal Lucas-Kanade, all levels fused in one launch.
//
// Replaces the TPU kernel vio360_tpu/ops/lk_pallas.py::track
// (_lk_pyr_kernel) and follows the semantics of the XLA reference
// vio360_tpu/ops/lk.py::track_xla: per level, a (2h+1)^2 template and
// its Scharr gradients sampled at the previous-frame position, a
// min-eigenvalue gate, then up to `iters` Gauss-Newton steps with an
// eps exit; positions carried in level-0 coordinates coarse -> fine.
//
// What bounds it on this card: memory latency of the bilinear gathers.
// Per feature and step the window needs 441 x 4 scattered image reads;
// the whole 960x480 pyramid (~2.4 MB x 4 images) sits in L2, so the
// kernel is bound by L1/L2 gather latency, not DRAM bandwidth or FLOPs.
// (On the TPU gathers were scalar-unit bound, which is why production
// LK there was an einsum formulation; on this card a per-feature gather
// kernel is the natural form.)
//
// What the design does about it: one warp per feature, lanes splitting
// the window pixels, warp shuffles reducing G and b. The template and
// its gradients are sampled once per level and held in registers; only
// the J patch is resampled at each step. Horizontal wrap is modular
// indexing (no padded copies); vertical edges clamp as
// ops/sampling.py::bilinear_sample does. 8 features per 256-thread
// block keep many blocks in flight to hide gather latency.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPpl = 31;  // window pixels per lane: ceil(31*31 / 32) for half <= 15
constexpr int kWarpsPerBlock = 8;

}  // namespace

// Layout shared with vio360_tpu_torch/ops/lk_cuda.py::_LevelMeta.
struct LkLevels {
  int n_levels;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long offset[kMaxLevels];
};

namespace {

__device__ __forceinline__ float sample(const float* img, int h, int w, float u, float v) {
  const float u0f = floorf(u), v0f = floorf(v);
  const float au = u - u0f, av = v - v0f;
  int u0 = (int)u0f % w;
  if (u0 < 0) u0 += w;
  const int u1 = u0 + 1 == w ? 0 : u0 + 1;
  const int v0 = min(max((int)v0f, 0), h - 1);
  const int v1 = min(v0 + 1, h - 1);
  const float i00 = __ldg(img + v0 * w + u0), i01 = __ldg(img + v0 * w + u1);
  const float i10 = __ldg(img + v1 * w + u0), i11 = __ldg(img + v1 * w + u1);
  const float top = i00 * (1.0f - au) + i01 * au;
  const float bot = i10 * (1.0f - au) + i11 * au;
  return top * (1.0f - av) + bot * av;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_kernel(const float* pyr_i, const float* pyr_j, const float* grad_x, const float* grad_y,
          const float* uv_prev, const float* uv_guess, const unsigned char* valid_in,
          float* uv_out, unsigned char* status_out, float* err_out, LkLevels L, int n, int half,
          int iters, float eps2, float min_eig_thr) {
  const int feat = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (feat >= n) return;  // whole warp
  const int side = 2 * half + 1, P = side * side;
  const float up = uv_prev[2 * feat], vp = uv_prev[2 * feat + 1];
  float u = uv_guess[2 * feat], v = uv_guess[2 * feat + 1];
  bool status = valid_in[feat] != 0;
  float t[kMaxPpl], tx[kMaxPpl], ty[kMaxPpl];

  for (int lvl = L.n_levels - 1; lvl >= 0; --lvl) {
    if (!status) continue;  // warp-uniform
    const float s = 1.0f / (float)(1 << lvl);
    const int h = L.h[lvl], w = L.w[lvl];
    const float* Ii = pyr_i + L.offset[lvl];
    const float* Ij = pyr_j + L.offset[lvl];
    const float* Gx = grad_x + L.offset[lvl];
    const float* Gy = grad_y + L.offset[lvl];
    const float ui = up * s, vi = vp * s;
    float uj = u * s, vj = v * s;

    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxPpl; ++j) {
      const int p = lane + 32 * j;
      if (p < P) {
        const float du = (float)(p % side - half), dv = (float)(p / side - half);
        t[j] = sample(Ii, h, w, ui + du, vi + dv);
        tx[j] = sample(Gx, h, w, ui + du, vi + dv);
        ty[j] = sample(Gy, h, w, ui + du, vi + dv);
        gxx += tx[j] * tx[j];
        gxy += tx[j] * ty[j];
        gyy += ty[j] * ty[j];
      }
    }
    gxx = warp_sum(gxx);
    gxy = warp_sum(gxy);
    gyy = warp_sum(gyy);
    const float det = gxx * gyy - gxy * gxy;
    const float min_eig =
        0.5f * (gxx + gyy - sqrtf((gxx - gyy) * (gxx - gyy) + 4.0f * gxy * gxy)) / (float)P;
    const bool ok_g = min_eig > min_eig_thr && det > 1e-12f;
    const float safe_det = ok_g ? det : 1.0f;
    const float inv00 = gyy / safe_det, inv01 = -gxy / safe_det, inv11 = gxx / safe_det;
    const bool ok_t = vi >= 0.0f && vi <= (float)h - 1.0f;
    status = status && ok_g && ok_t;

    bool active = status;
    for (int it = 0; it < iters && active; ++it) {
      float b0 = 0.0f, b1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPpl; ++j) {
        const int p = lane + 32 * j;
        if (p < P) {
          const float du = (float)(p % side - half), dv = (float)(p / side - half);
          const float diff = sample(Ij, h, w, uj + du, vj + dv) - t[j];
          b0 += diff * tx[j];
          b1 += diff * ty[j];
        }
      }
      b0 = warp_sum(b0);
      b1 = warp_sum(b1);
      const float ddu = -(inv00 * b0 + inv01 * b1);
      const float ddv = -(inv01 * b0 + inv11 * b1);
      uj += ddu;
      vj += ddv;
      active = ddu * ddu + ddv * ddv >= eps2;
    }
    const bool ok_j = vj >= 0.0f && vj <= (float)h - 1.0f;
    status = status && ok_j && isfinite(uj) && isfinite(vj);
    u = uj / s;
    v = vj / s;
  }

  // diagnostic error: mean |J - I| over the level-0 window
  const float* I0 = pyr_i + L.offset[0];
  const float* J0 = pyr_j + L.offset[0];
  float e = 0.0f;
  for (int p = lane; p < P; p += 32) {
    const float du = (float)(p % side - half), dv = (float)(p / side - half);
    e += fabsf(sample(J0, L.h[0], L.w[0], u + du, v + dv) - sample(I0, L.h[0], L.w[0], up + du, vp + dv));
  }
  e = warp_sum(e);
  if (lane == 0) {
    uv_out[2 * feat] = u;
    uv_out[2 * feat + 1] = v;
    status_out[feat] = status ? 1 : 0;
    err_out[feat] = e / (float)P;
  }
}

}  // namespace

extern "C" int lk_pyr(const float* pyr_i, const float* pyr_j, const float* grad_x,
                      const float* grad_y, const float* uv_prev, const float* uv_guess,
                      const unsigned char* valid_in, float* uv_out, unsigned char* status_out,
                      float* err_out, const LkLevels* levels, int n, int half, int iters,
                      float eps2, float min_eig_thr, void* stream) {
  if (n < 0 || half < 1 || (2 * half + 1) * (2 * half + 1) > 32 * kMaxPpl ||
      levels->n_levels < 1 || levels->n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = kWarpsPerBlock * 32;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pyr_i, pyr_j, grad_x, grad_y, uv_prev,
                                                          uv_guess, valid_in, uv_out, status_out,
                                                          err_out, *levels, n, half, iters, eps2,
                                                          min_eig_thr);
  return (int)cudaGetLastError();
}
