// NCC appearance blocks of every feature of every camera in one launch:
// each feature's (S+1) x (S+1) window goes into shared memory, is shifted
// by the feature's sub-pixel fraction, and is normalized to zero mean and
// unit norm on chip; only the finished block and its valid flag are
// written.
//
// Replaces: the NCC-block use of
// coslam_tpu/ops/patches.py::_extract_windows_pallas (the Pallas TPU
// kernel that cuts the G = S + 1 windows, called from
// coslam_tpu/ops/ncc.py::extract_ncc_blocks_batched) together with that
// function's consumer, frac_shift and _normalize_blocks, which the
// PyTorch port ran as ~40 device activities per call around its window
// launch (ops/ncc.py::extract_ncc_blocks_batched_plain).
//
// Semantics: those of the plain version, which follows the JAX function:
//   origin (x0, y0) = clamp(floor(pos - r), 0, (W - S - 1, H - S - 1));
//   f = clamp(pos - r - origin, 0, 1); raw = the bilinear shift of the
//   window by f, its four weights formed and summed in frac_shift's
//   order; ok = pos >= r and pos <= (W, H) - 1.001 - r (the limits come
//   in as float32, as the plain version compares them); mean, centred
//   values, norm = sqrt(sum of squares); block = centred / max(norm,
//   1e-6); ok &= norm > 1e-3; a block that is not ok is zero.
// The shift is bit-identical to the plain version (each product and sum
// one rounded operation: __fmul_rn / __fadd_rn, no FMA contraction); only
// the order of the two S^2-term sums differs (a warp reduction here), so
// a block agrees to float32 rounding (~1e-7) and `ok` flips only on a
// patch whose norm sits on 1e-3. The variance is the same two-pass form
// (mean first, then the centred sum of squares), not a one-pass formula.
// A position that is NaN, infinite or far off has its origin clamped into
// the image before any read (float-to-int conversions clamp to +-1e9
// first, NaN to -1e9); such a block is not ok and is written as zeros.
//
// Bound: bytes. At N = 1024, r = 5, one camera: the window pixels (at
// most 1024 x 144 x 4 B = 590 KB, less where windows overlap), the
// positions (8 KB), the blocks (1024 x 121 x 4 B = 496 KB) and the flags:
// <= 1.09 MB, 0.33 us at 3.35 TB/s; three times that at three cameras.
// The arithmetic, ~10 flop a block pixel (1.2 MFLOP), is far below.
// Design: one warp per feature, 4 features per block (768 blocks at three
// cameras, 256 at one, over 132 SMs). The warp copies its window row by
// row into its slice of shared memory with asynchronous copies (cp.async:
// every pixel's copy in flight at once, one wait; consecutive lanes on
// consecutive pixels of a row); lane l shifts block
// pixels l, l + 32, ... into registers; two __shfl_xor_sync butterflies
// give the sum and then the centred sum of squares in every lane; the
// lanes write the block's floats in order, so each store instruction of
// the warp covers 128 consecutive bytes. No block barrier, no atomics, no
// scratch in device memory: the window never leaves the chip.
//
// Radii above 7 (any radius the image holds) take a general path: the
// same warp per feature and the same arithmetic in the same order, but
// the block's pixels are recomputed from the window in each of the three
// passes (sum, centred sum of squares, output) instead of kept in
// registers, and the window sits in dynamic shared memory (up to four
// warps a block, as many as the card's opt-in shared memory holds) or,
// where one window does not fit, is read straight from the image in
// device memory (the origin is clamped into the image, so the window is
// the same pixels either way). At a radius the tuned path takes, the
// general path gives the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RADIUS = 7;                      // the tuned path's radii
constexpr int WARPS = 4;                           // features per block
constexpr int MAX_S = 2 * MAX_RADIUS + 1;          // block side
constexpr int MAX_L = MAX_S + 1;                   // window side
constexpr int MAX_PIX = (MAX_S * MAX_S + 31) / 32; // block pixels per lane

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(v) as an int, v clamped to +-1e9 first (NaN to -1e9)
__device__ __forceinline__ int floor_int(float v) {
  return __float2int_rd(fminf(fmaxf(v, -1e9f), 1e9f));
}

// torch.clamp(v, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
ncc_blocks_kernel(const float* __restrict__ imgs,
                  const float* __restrict__ pos, float* __restrict__ blocks,
                  unsigned char* __restrict__ ok_out, int C, int H, int W,
                  int N, int r, float xmax, float ymax) {
  __shared__ float s_wnd[WARPS][MAX_L * MAX_L];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + warp;
  if (f >= C * N) return;               // a whole warp; no block barrier
  const int c = f / N;                  // cameras ride the feature axis
  const int S = 2 * r + 1, L = S + 1, NP = S * S;
  const float fr = (float)r;
  float* wnd = s_wnd[warp];

  const float px = pos[2 * f], py = pos[2 * f + 1];
  const float ex = __fsub_rn(px, fr), ey = __fsub_rn(py, fr);
  const int x0 = clampi(floor_int(ex), 0, W - L);
  const int y0 = clampi(floor_int(ey), 0, H - L);
  const float* img = imgs + (size_t)c * H * W;
  for (int i = lane; i < L * L; i += 32) {    // all copies in flight at once
    const int y = i / L, x = i - y * L;
    __pipeline_memcpy_async(wnd + i, img + (size_t)(y0 + y) * W + x0 + x,
                            sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  // ops/patches.py::frac_shift, one rounded operation at a time
  const float fx = clamp01(__fsub_rn(ex, (float)x0));
  const float fy = clamp01(__fsub_rn(ey, (float)y0));
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  float v[MAX_PIX];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_PIX; ++k) {
    const int p = lane + 32 * k;
    v[k] = 0.f;
    if (p < NP) {
      const float* q = wnd + (p / S) * L + p % S;
      float t = __fmul_rn(q[0], w00);
      t = __fadd_rn(t, __fmul_rn(q[1], w01));
      t = __fadd_rn(t, __fmul_rn(q[L], w10));
      v[k] = __fadd_rn(t, __fmul_rn(q[L + 1], w11));
      s = __fadd_rn(s, v[k]);
    }
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)NP);
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_PIX; ++k) {
    if (lane + 32 * k < NP) {
      v[k] = __fsub_rn(v[k], mean);
      s2 = __fadd_rn(s2, __fmul_rn(v[k], v[k]));
    }
  }
  const float norm = __fsqrt_rn(warp_sum(s2));
  const bool ok = px >= fr && py >= fr && px <= xmax && py <= ymax &&
                  norm > 1e-3f;
  const float den = fmaxf(norm, 1e-6f);
  float* out = blocks + (size_t)f * NP;
#pragma unroll
  for (int k = 0; k < MAX_PIX; ++k) {
    const int p = lane + 32 * k;
    if (p < NP) out[p] = ok ? __fdiv_rn(v[k], den) : 0.f;
  }
  if (lane == 0) ok_out[f] = ok;
}

// The general path (any radius): lane l handles block pixels l, l + 32,
// ... as above, recomputing each pixel's shift in every pass. SHARED: the
// window is copied into this warp's slice of dynamic shared memory;
// otherwise it is read in place from the image.
template <bool SHARED>
__global__ void __launch_bounds__(WARPS * 32)
ncc_blocks_general_kernel(const float* __restrict__ imgs,
                          const float* __restrict__ pos,
                          float* __restrict__ blocks,
                          unsigned char* __restrict__ ok_out, int C, int H,
                          int W, int N, int r, float xmax, float ymax) {
  extern __shared__ float s_dyn[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * warps + warp;
  if (f >= C * N) return;               // a whole warp; no block barrier
  const int c = f / N;
  const int S = 2 * r + 1, L = S + 1, NP = S * S;
  const float fr = (float)r;

  const float px = pos[2 * f], py = pos[2 * f + 1];
  const float ex = __fsub_rn(px, fr), ey = __fsub_rn(py, fr);
  const int x0 = clampi(floor_int(ex), 0, W - L);
  const int y0 = clampi(floor_int(ey), 0, H - L);
  const float* img = imgs + (size_t)c * H * W;
  const float* wnd = img + (size_t)y0 * W + x0;
  int ld = W;
  if (SHARED) {
    float* w = s_dyn + (size_t)warp * L * L;
    for (int i = lane; i < L * L; i += 32) {
      const int y = i / L, x = i - y * L;
      __pipeline_memcpy_async(w + i, wnd + (size_t)y * W + x,
                              sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    wnd = w;
    ld = L;
  }
  const float fx = clamp01(__fsub_rn(ex, (float)x0));
  const float fy = clamp01(__fsub_rn(ey, (float)y0));
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  auto shifted = [&](int p) {
    const float* q = wnd + (size_t)(p / S) * ld + p % S;
    float t = __fmul_rn(q[0], w00);
    t = __fadd_rn(t, __fmul_rn(q[1], w01));
    t = __fadd_rn(t, __fmul_rn(q[ld], w10));
    return __fadd_rn(t, __fmul_rn(q[ld + 1], w11));
  };
  float s = 0.f;
  for (int p = lane; p < NP; p += 32) s = __fadd_rn(s, shifted(p));
  const float mean = __fdiv_rn(warp_sum(s), (float)NP);
  float s2 = 0.f;
  for (int p = lane; p < NP; p += 32) {
    const float v = __fsub_rn(shifted(p), mean);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  const float norm = __fsqrt_rn(warp_sum(s2));
  const bool ok = px >= fr && py >= fr && px <= xmax && py <= ymax &&
                  norm > 1e-3f;
  const float den = fmaxf(norm, 1e-6f);
  float* out = blocks + (size_t)f * NP;
  for (int p = lane; p < NP; p += 32)
    out[p] = ok ? __fdiv_rn(__fsub_rn(shifted(p), mean), den) : 0.f;
  if (lane == 0) ok_out[f] = ok;
}

int launch_general(const float* imgs, const float* pos, float* blocks,
                   unsigned char* ok, int C, int H, int W, int N, int radius,
                   float xmax, float ymax, cudaStream_t stream) {
  const int L = 2 * radius + 2;
  const size_t per_warp = sizeof(float) * (size_t)L * L;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int warps = (int)(per_warp > 0 ? (size_t)optin / per_warp : 0);
  const int features = C * N;
  if (warps >= 1) {
    const int w = warps < WARPS ? warps : WARPS;
    const size_t bytes = per_warp * w;
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(ncc_blocks_general_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    ncc_blocks_general_kernel<true><<<(features + w - 1) / w, w * 32, bytes,
                                      stream>>>(imgs, pos, blocks, ok, C, H,
                                                W, N, radius, xmax, ymax);
  } else {
    ncc_blocks_general_kernel<false><<<(features + WARPS - 1) / WARPS,
                                       WARPS * 32, 0, stream>>>(
        imgs, pos, blocks, ok, C, H, W, N, radius, xmax, ymax);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// imgs: [C, H, W] f32; pos: [C, N, 2] f32 (x, y); outputs blocks
// [C, N, (2 radius + 1)^2] f32 and ok [C, N] bool (one byte each); all
// contiguous. xmax, ymax: the largest in-bounds x and y (W - 1.001 - radius
// and H - 1.001 - radius). Requires radius >= 0 and a window of
// 2 radius + 2 pixels inside the image; radii above 7 take the general
// path. Launches on `stream`; returns cudaGetLastError().
extern "C" int ncc_blocks(const float* imgs, const float* pos, float* blocks,
                          unsigned char* ok, int C, int H, int W, int N,
                          int radius, float xmax, float ymax, void* stream) {
  if (radius < 0 || C < 1 || N < 1 || 2 * radius + 2 > H ||
      2 * radius + 2 > W)
    return (int)cudaErrorInvalidValue;
  if (radius > MAX_RADIUS)
    return launch_general(imgs, pos, blocks, ok, C, H, W, N, radius, xmax,
                          ymax, (cudaStream_t)stream);
  const int features = C * N;
  ncc_blocks_kernel<<<(features + WARPS - 1) / WARPS, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(imgs, pos, blocks, ok, C, H, W,
                                              N, radius, xmax, ymax);
  return (int)cudaGetLastError();
}
