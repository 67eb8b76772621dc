// Pyramidal Lucas-Kanade, all levels fused in one launch (K4).
//
// Replaces the TPU kernel vio360_tpu/ops/lk_pallas.py::track
// (_lk_pyr_kernel) and follows the semantics of the XLA reference
// vio360_tpu/ops/lk.py::track_xla (ops/lk_cuda.py::track_plain here): per
// level, a (2h+1)^2 template and its Scharr gradients at the previous-frame
// position, a min-eigenvalue gate, then up to `iters` Gauss-Newton steps
// with an eps exit; positions carried in level-0 coordinates coarse ->
// fine; horizontal ERP wrap, bilinear_sample's vertical clamp; err = mean
// |J - I| over the level-0 window.
//
// What bounds it on this card: neither bytes nor FLOPs. Both pyramids (~5 MB
// at 960x480, 4 levels) stay in the 50 MB L2, and the least time for their
// bytes or for the f32 operations is a few microseconds. A feature is a
// serial chain of up to levels x iters Gauss-Newton steps, each two
// 441-long f32 dot products and a block reduction whose result decides the
// next step. While ~8 CTAs share an SM the steps are bound by instruction
// issue (every warp repeats the reduction and the update: about half of a
// step's instructions); after that the few features that take several
// times the mean step count run a latency-bound tail (shared-memory loads,
// five shuffle rounds and a barrier per step).
//
// What the design does about it (the TPU kernel's ideas, not its blocks):
// - One CTA of 128 threads per feature, <= ceil(P / 128) window pixels per
//   thread (4 at half = 10), a compile-time count, <= 64 registers: 1024
//   features are one wave of ~8 CTAs (~31 warps) per SM, and every step's
//   chain is 4 pixels long.
// - All pixels of a window share one fractional offset (au, av). Each step
//   stages the (p+1)^2 integer patch of J once in shared memory (cp.async,
//   rows coalesced; column start wrapped into [0, W) once, each column index
//   wrapped by a compare-and-subtract, each row index clamped once) and
//   every pixel re-interpolates with (au, av). The patch is reloaded only
//   when the estimate's integer origin moves (lk_pallas.py's outer/inner
//   ladder); near convergence steps are sub-pixel and reuse it.
// - No gradient images: per level the (p+3)^2 neighbourhood of I is staged
//   once and the integer template and its Scharr x / y (smooth [3 10 3]/16,
//   diff 0.5 [-1 0 1]) are formed from it at the (p+1)^2 integer positions,
//   then interpolated with the shared (au, av) into registers for the
//   level's steps: linear filters commute with bilinear interpolation.
//   The vertical clamp follows bilinear_sample of a gradient image: patch
//   row r is image row clamp(v0 + r), its Scharr reads rows
//   clamp(clamp(v0 + r) +- 1), and window row k interpolates the rows
//   clamp(v0 + k) and clamp(clamp(v0 + k) + 1) of the patch.
// - The per-step sums (b0, b1) reduce by warp shuffles, then the 4 warp
//   partials through shared memory: one __syncthreads per step, partial
//   slots double-buffered by step parity. Every thread sums the partials in
//   the same fixed order and takes the same update, so the loop state is
//   CTA-uniform and two launches return equal results.
// - No tensor cores or TMA: there is nothing to multiply (dot products in
//   f32), and a 22x22 box that wraps at the ERP seam is not a TMA tile. The
//   Hopper resources that matter are occupancy, shared memory and L2.
// - f32 throughout, no fast-math flags.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxHalf = 15;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// 8 resident CTAs per SM (<= 64 registers a thread): 1024 features fit the
// 132 SMs in one wave.
constexpr int kMinCtasPerSm = 8;
constexpr int kMaxPpt = ((2 * kMaxHalf + 1) * (2 * kMaxHalf + 1) + kThreads - 1) / kThreads;
static_assert(kMaxPpt == 8, "lk_pyr instantiates the kernel for 1..8 window pixels a thread");

}  // namespace

// Layout shared with vio360_tpu_torch/ops/lk_cuda.py::_LevelMeta. Level l of
// the previous image starts at pyr + offset[l]; the next image's level l
// follows it at pyr + offset[l] + h[l] * w[l].
struct LkLevels {
  int n_levels;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long offset[kMaxLevels];
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floor of a level coordinate as an int, kept far from overflow (a
// diverged estimate still indexes inside the image: columns wrap, rows clamp)
__device__ __forceinline__ int ifloor(float f) {
  return (int)fminf(fmaxf(f, -1073741824.0f), 1073741824.0f);
}

__device__ __forceinline__ int wrap_start(int x, int w) {
  x %= w;
  return x < 0 ? x + w : x;
}

// dst[r * side + c] = img[clamp(v0 + r)][(u0 + c) mod w] for r, c < side;
// u0 already in [0, w). Warps take rows, lanes columns. The copies are
// asynchronous (cp.async: no registers, every row in flight at once); the
// caller waits with stage_wait() and then a barrier.
__device__ __forceinline__ void stage(const float* __restrict__ img, int h, int w, int u0, int v0,
                                      int side, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = lane; c < side; c += 32) {
    int x = u0 + c;
    while (x >= w) x -= w;  // one compare-and-subtract unless the level is narrower than the box
    for (int r = warp; r < side; r += kWarps) {
      const float* src = img + (long long)min(max(v0 + r, 0), h - 1) * w + x;
      const unsigned dst_s = (unsigned)__cvta_generic_to_shared(dst + r * side + c);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_s), "l"(src) : "memory");
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory offset of the top-left corner of window pixel (k, c) in a
// (side+1)^2 patch staged at rows clamp(v0c + r): window row k interpolates
// patch rows clamp(v0 + k) - v0c and the one below it.
__device__ __forceinline__ int patch_off(int k, int c, int v0, int v0c, int h, int sp) {
  return (min(max(v0 + k, 0), h - 1) - v0c) * sp + c;
}

__device__ __forceinline__ float interp(const float* q, int sp, float au, float av) {
  const float top = q[0] * (1.0f - au) + q[1] * au;
  const float bot = q[sp] * (1.0f - au) + q[sp + 1] * au;
  return top * (1.0f - av) + bot * av;
}

template <int kPpt>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
lk_kernel(const float* __restrict__ pyr, const float* __restrict__ uv_prev,
          const float* __restrict__ uv_guess, const unsigned char* __restrict__ valid_in,
          float* uv_out, unsigned char* status_out, float* err_out, int* work_out, LkLevels L,
          int half, int iters, float eps2, float min_eig_thr) {
  extern __shared__ float smem[];
  __shared__ float part[2][kWarps][2];  // step partials (b0, b1), by step parity
  __shared__ float gpart[kWarps][3];    // template G partials, then err partials

  const int feat = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int side = 2 * half + 1, P = side * side;
  const int sp = side + 1, sn = side + 3;
  float* nb = smem;              // (p+3)^2 neighbourhood of I; aliased by the J patch
  float* ti = smem + sn * sn;    // integer template, Scharr x, Scharr y: (p+1)^2 each
  float* gxi = ti + sp * sp;
  float* gyi = gxi + sp * sp;

  // this thread's window pixels: (row k, column c), pixel p = tid + 128 j
  int pk[kPpt], pc[kPpt];
#pragma unroll
  for (int j = 0; j < kPpt; ++j) {
    const int p = tid + kThreads * j;
    pk[j] = p / side;
    pc[j] = p - pk[j] * side;
  }
  auto live = [&](int j) { return tid + kThreads * j < P; };

  const float up = uv_prev[2 * feat], vp = uv_prev[2 * feat + 1];
  float u = uv_guess[2 * feat], v = uv_guess[2 * feat + 1];
  bool status = valid_in[feat] != 0;
  float t[kPpt], tx[kPpt], ty[kPpt];
  int off[kPpt];
  bool t0_formed = false;  // t[] holds the level-0 template
  int cu0 = INT_MIN, cv0 = INT_MIN;  // integer origin of the staged J patch
  int steps = 0, templates = 0, reloads = 0;

  for (int lvl = L.n_levels - 1; lvl >= 0; --lvl) {
    cu0 = cv0 = INT_MIN;
    if (!status) continue;  // CTA-uniform
    const float s = 1.0f / (float)(1 << lvl);
    const int h = L.h[lvl], w = L.w[lvl];
    const float* Ii = pyr + L.offset[lvl];
    const float* Ij = Ii + (long long)h * w;
    const float ui = up * s, vi = vp * s;
    float uj = u * s, vj = v * s;
    if (!(vi >= 0.0f && vi <= (float)h - 1.0f)) {  // template centre off the image
      status = false;
      continue;
    }

    // ---- template and Scharr gradients at the previous position ----
    const float fu = floorf(ui), fv = floorf(vi);
    const float au = ui - fu, av = vi - fv;
    const int u0 = ifloor(fu) - half, v0 = ifloor(fv) - half;
    const int v0c = min(max(v0, 0), h - 1);
    stage(Ii, h, w, wrap_start(u0 - 1, w), v0c - 1, sn, nb);
    stage_wait();
    __syncthreads();
    for (int e = tid; e < sp * sp; e += kThreads) {
      const int r = e / sp, c = e - r * sp;
      const int R = min(v0c + r, h - 1);
      const float* rm = nb + (R - v0c + 1) * sn + c;               // row R, columns c-1..c+1
      const float* ru = nb + (max(R - 1, 0) - v0c + 1) * sn + c;   // row clamp(R - 1)
      const float* rd = nb + (min(R + 1, h - 1) - v0c + 1) * sn + c;
      constexpr float s0 = 3.0f / 16.0f, s1 = 10.0f / 16.0f, s2 = 3.0f / 16.0f;
      const float sv0 = s0 * ru[0] + s1 * rm[0] + s2 * rd[0];
      const float sv2 = s0 * ru[2] + s1 * rm[2] + s2 * rd[2];
      const float shu = s0 * ru[0] + s1 * ru[1] + s2 * ru[2];
      const float shd = s0 * rd[0] + s1 * rd[1] + s2 * rd[2];
      ti[e] = rm[1];
      gxi[e] = 0.5f * (sv2 - sv0);
      gyi[e] = 0.5f * (shd - shu);
    }
    __syncthreads();
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      if (live(j)) {
        const int o = patch_off(pk[j], pc[j], v0, v0c, h, sp);
        t[j] = interp(ti + o, sp, au, av);
        tx[j] = interp(gxi + o, sp, au, av);
        ty[j] = interp(gyi + o, sp, au, av);
        gxx += tx[j] * tx[j];
        gxy += tx[j] * ty[j];
        gyy += ty[j] * ty[j];
      }
    }
    gxx = warp_sum(gxx);
    gxy = warp_sum(gxy);
    gyy = warp_sum(gyy);
    if (lane == 0) {
      gpart[warp][0] = gxx;
      gpart[warp][1] = gxy;
      gpart[warp][2] = gyy;
    }
    __syncthreads();
    gxx = ((gpart[0][0] + gpart[1][0]) + gpart[2][0]) + gpart[3][0];
    gxy = ((gpart[0][1] + gpart[1][1]) + gpart[2][1]) + gpart[3][1];
    gyy = ((gpart[0][2] + gpart[1][2]) + gpart[2][2]) + gpart[3][2];
    ++templates;
    t0_formed = lvl == 0;

    const float det = gxx * gyy - gxy * gxy;
    const float min_eig =
        0.5f * (gxx + gyy - sqrtf((gxx - gyy) * (gxx - gyy) + 4.0f * gxy * gxy)) / (float)P;
    const bool ok_g = min_eig > min_eig_thr && det > 1e-12f;
    const float safe_det = ok_g ? det : 1.0f;
    const float inv00 = gyy / safe_det, inv01 = -gxy / safe_det, inv11 = gxx / safe_det;
    status = ok_g;

    // ---- Gauss-Newton steps on the cached J patch ----
    bool active = status;
    for (int it = 0; it < iters && active; ++it) {
      const float fuj = floorf(uj), fvj = floorf(vj);
      const int ju0 = ifloor(fuj) - half, jv0 = ifloor(fvj) - half;
      const int jv0c = min(max(jv0, 0), h - 1);
      if (ju0 != cu0 || jv0 != cv0) {  // CTA-uniform; the old patch was last read before the last barrier
        stage(Ij, h, w, wrap_start(ju0, w), jv0c, sp, nb);
#pragma unroll
        for (int j = 0; j < kPpt; ++j) off[j] = patch_off(pk[j], pc[j], jv0, jv0c, h, sp);
        cu0 = ju0;
        cv0 = jv0;
        ++reloads;
        stage_wait();
        __syncthreads();
      }
      const float aju = uj - fuj, ajv = vj - fvj;
      float b0 = 0.0f, b1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kPpt; ++j) {
        if (live(j)) {
          const float diff = interp(nb + off[j], sp, aju, ajv) - t[j];
          b0 += diff * tx[j];
          b1 += diff * ty[j];
        }
      }
      b0 = warp_sum(b0);
      b1 = warp_sum(b1);
      float(*slot)[2] = part[it & 1];
      if (lane == 0) {
        slot[warp][0] = b0;
        slot[warp][1] = b1;
      }
      __syncthreads();
      b0 = ((slot[0][0] + slot[1][0]) + slot[2][0]) + slot[3][0];
      b1 = ((slot[0][1] + slot[1][1]) + slot[2][1]) + slot[3][1];
      const float ddu = -(inv00 * b0 + inv01 * b1);
      const float ddv = -(inv01 * b0 + inv11 * b1);
      uj += ddu;
      vj += ddv;
      active = ddu * ddu + ddv * ddv >= eps2;
      ++steps;
    }
    const bool ok_j = vj >= 0.0f && vj <= (float)h - 1.0f;
    status = status && ok_j && isfinite(uj) && isfinite(vj);
    u = uj / s;
    v = vj / s;
  }

  // ---- err: mean |J(u, v) - I(up, vp)| over the level-0 window ----
  const int h0 = L.h[0], w0 = L.w[0];
  const float* I0 = pyr + L.offset[0];
  const float* J0 = I0 + (long long)h0 * w0;
  const float fu = floorf(u), fv = floorf(v);
  const int ju0 = ifloor(fu) - half, jv0 = ifloor(fv) - half;
  const int jv0c = min(max(jv0, 0), h0 - 1);
  const bool stage_j = ju0 != cu0 || jv0 != cv0;
  if (stage_j) {
    stage(J0, h0, w0, wrap_start(ju0, w0), jv0c, sp, nb);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) off[j] = patch_off(pk[j], pc[j], jv0, jv0c, h0, sp);
  }
  const float fiu = floorf(up), fiv = floorf(vp);
  const int iu0 = ifloor(fiu) - half, iv0 = ifloor(fiv) - half;
  const int iv0c = min(max(iv0, 0), h0 - 1);
  if (!t0_formed) stage(I0, h0, w0, wrap_start(iu0, w0), iv0c, sp, ti);
  if (stage_j || !t0_formed) {
    stage_wait();
    __syncthreads();
  }
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < kPpt; ++j) {
    if (live(j)) {
      const float ti0 =
          t0_formed ? t[j] : interp(ti + patch_off(pk[j], pc[j], iv0, iv0c, h0, sp), sp, up - fiu, vp - fiv);
      e += fabsf(interp(nb + off[j], sp, u - fu, v - fv) - ti0);
    }
  }
  e = warp_sum(e);
  if (lane == 0) gpart[warp][0] = e;
  __syncthreads();
  if (tid == 0) {
    e = ((gpart[0][0] + gpart[1][0]) + gpart[2][0]) + gpart[3][0];
    float uo = up, vo = vp;
    if (status) {  // ops/lk_cuda.py::_finish: u wrapped into [0, W), failures keep uv_prev
      uo = fmodf(u, (float)w0);
      if (uo < 0.0f) uo += (float)w0;
      vo = v;
    }
    uv_out[2 * feat] = uo;
    uv_out[2 * feat + 1] = vo;
    status_out[feat] = status ? 1 : 0;
    err_out[feat] = e / (float)P;
    if (work_out != nullptr) {
      work_out[3 * feat] = steps;
      work_out[3 * feat + 1] = templates;
      work_out[3 * feat + 2] = reloads;
    }
  }
}

template <int kPpt>
int launch(const float* pyr, const float* uv_prev, const float* uv_guess,
           const unsigned char* valid_in, float* uv_out, unsigned char* status_out, float* err_out,
           int* work_out, const LkLevels& L, int n, int half, int iters, float eps2,
           float min_eig_thr, cudaStream_t stream) {
  const int sp = 2 * half + 2, sn = 2 * half + 4;
  const size_t smem = sizeof(float) * (size_t)(sn * sn + 3 * sp * sp);
  lk_kernel<kPpt><<<n, kThreads, smem, stream>>>(pyr, uv_prev, uv_guess, valid_in, uv_out,
                                                 status_out, err_out, work_out, L, half, iters,
                                                 eps2, min_eig_thr);
  return (int)cudaGetLastError();
}

}  // namespace

// work_out: null, or [n, 3] int32 that receives each feature's Gauss-Newton
// steps, templates formed and J patches staged for the steps, summed over the
// levels.
extern "C" int lk_pyr(const float* pyr, const float* uv_prev, const float* uv_guess,
                      const unsigned char* valid_in, float* uv_out, unsigned char* status_out,
                      float* err_out, int* work_out, const LkLevels* levels, int n, int half,
                      int iters, float eps2, float min_eig_thr, void* stream) {
  if (n < 0 || half < 1 || half > kMaxHalf || levels->n_levels < 1 ||
      levels->n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels->n_levels; ++l)
    if (levels->h[l] < 1 || levels->w[l] < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int ppt = ((2 * half + 1) * (2 * half + 1) + kThreads - 1) / kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
#define LK_CASE(k)                                                                              \
  case k:                                                                                       \
    return launch<k>(pyr, uv_prev, uv_guess, valid_in, uv_out, status_out, err_out, work_out,   \
                     *levels, n, half, iters, eps2, min_eig_thr, st);
  switch (ppt) {
    LK_CASE(1)
    LK_CASE(2)
    LK_CASE(3)
    LK_CASE(4)
    LK_CASE(5)
    LK_CASE(6)
    LK_CASE(7)
    LK_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LK_CASE
}
