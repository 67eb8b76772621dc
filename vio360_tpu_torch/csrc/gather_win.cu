// Window-pair gather of the matmul-gather LK, kernel K5.
//
// Replaces the TPU kernel vio360_tpu/ops/gather_pallas.py::
// gather_window_pairs (_kernel), which computes stages 1-2 of
// vio360_tpu/ops/lk_matmul.py::_gather_int_patches:
//   out[f, r, c] = bf16(img)[clamp(v0[f] + r, 0, H-1), b[f]*128 + c]
// for r < g, c < 256, from an f32 image [H, WP] wrap-padded to whole
// 128-column blocks. The f32 -> bf16 rounding (nearest even, as XLA's
// convert) happens here, where the reference rounds its image.
//
// What bounds it on this card: bytes. It is a pure selection: 2 B
// written per output element and 4 B read, with no arithmetic to speak
// of. At 960x480 level 0 (N = 1024, g = 34) it writes 17.8 MB and reads
// rows of a 2.2 MB image that stays in L2.
//
// What the design does about it: the TPU kernel's 8-aligned row slab
// and one-hot row remap exist for Mosaic's sublane alignment; here a
// clamped row is just an address. One warp per (feature, row) copies
// the 256 contiguous columns: each lane reads two float4 (32 B,
// coalesced across the warp) and writes one 16 B vector of 8 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPairCols = 256;  // two 128-column blocks

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_win_kernel(const float* __restrict__ img, const int* __restrict__ v0,
                  const int* __restrict__ b, uint4* __restrict__ out, int n, int g, int h,
                  int wp) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // f * g + r
  const int lane = threadIdx.x & 31;
  if (row >= (long long)n * g) return;  // whole warp
  const int f = (int)(row / g), r = (int)(row - (long long)f * g);
  const int src_row = min(max(__ldg(v0 + f) + r, 0), h - 1);
  // b + 1 must exist; clamping keeps every read inside the image
  const int blk = min(max(__ldg(b + f), 0), wp / 128 - 2);
  const float4* src =
      reinterpret_cast<const float4*>(img + (size_t)src_row * wp + (size_t)blk * 128) + 2 * lane;
  const float4 a = __ldg(src), c = __ldg(src + 1);
  uint4 o;
  o.x = pack_bf16x2(a.x, a.y);
  o.y = pack_bf16x2(a.z, a.w);
  o.z = pack_bf16x2(c.x, c.y);
  o.w = pack_bf16x2(c.z, c.w);
  out[(size_t)row * (kPairCols / 8) + lane] = o;
}

}  // namespace

extern "C" int gather_win(const float* img, const int* v0, const int* b, void* out, int n, int g,
                          int h, int wp, void* stream) {
  if (n < 0 || g < 1 || h < 1 || wp < 2 * 128 || wp % 128 != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long rows = (long long)n * g;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_win_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      img, v0, b, reinterpret_cast<uint4*>(out), n, g, h, wp);
  return (int)cudaGetLastError();
}
