// One pyramid level: 5-tap binomial blur, optionally with its x/y
// derivative-of-Gaussian gradients, for a batch of images [C, H, W] f32.
//
// Replaces: coslam_tpu/ops/pyramid_pallas.py::pyramid_level_pallas (kernel
// body _level_kernel), the Pallas TPU kernel behind build_pyramid.
//
// Semantics: those of coslam_torch/ops/image.py, which the plain PyTorch
// twin (ops/pyramid.py::pyramid_level_plain) runs:
//   sm = hblur(vblur(img))            blur taps [1 4 6 4 1]/16
//   dx = vsmooth(hderiv(sm))          deriv [-1 0 1]/2, smooth [1 2 1]/4
//   dy = hsmooth(vderiv(sm))
// where every separable pass edge-replicates ITS OWN input, i.e. reads its
// input at clamped coordinates. Each pass sums its taps in order with one
// rounded multiply and one rounded add per tap (__fmul_rn/__fadd_rn: no
// FMA contraction), the order the plain version's elementwise ops use, so
// the kernel matches it over the whole image, border frame included. (The
// Pallas kernel differs from this in the outermost 1-px frame of dx/dy: it
// differentiates the edge-replicated image instead of edge-replicating the
// derivative.)
//
// Bound: bytes. Level 0 with derivatives at 480x640 reads 1.2 MB and writes
// 3.7 MB, about 1.5 us at 3.35 TB/s; at ~1.5 flop per byte nothing else
// comes close. Design: each input pixel is read from device memory about
// once per block that needs it (a 32x8 output tile reads a (8+2+4) x
// (32+2+4) neighbourhood through L1), the vertical-blur and blurred tiles
// live in shared memory with a 1-px halo, and each output is written once,
// coalesced along x. At these sizes launch overhead dominates; the
// Mosaic-specific band/roll/lane-offset layout of the TPU kernel has no
// counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;          // output tile width  (threads in x)
constexpr int TH = 8;           // output tile height (threads in y)
constexpr int SH = TH + 2;      // blurred tile rows  (1-px halo)
constexpr int SW = TW + 2;      // blurred tile cols  (1-px halo)
constexpr int VW = TW + 6;      // vertical-blur tile cols (2 + 1 px halo)

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// sum_j x_j * w_j, accumulated left to right without contraction
__device__ __forceinline__ float tap5(float a, float b, float c, float d,
                                      float e) {
  float s = __fmul_rn(a, 0.0625f);
  s = __fadd_rn(s, __fmul_rn(b, 0.25f));
  s = __fadd_rn(s, __fmul_rn(c, 0.375f));
  s = __fadd_rn(s, __fmul_rn(d, 0.25f));
  return __fadd_rn(s, __fmul_rn(e, 0.0625f));
}

__device__ __forceinline__ float deriv3(float a, float b, float c) {
  float s = __fmul_rn(a, -0.5f);
  s = __fadd_rn(s, __fmul_rn(b, 0.0f));
  return __fadd_rn(s, __fmul_rn(c, 0.5f));
}

__device__ __forceinline__ float smooth3(float a, float b, float c) {
  float s = __fmul_rn(a, 0.25f);
  s = __fadd_rn(s, __fmul_rn(b, 0.5f));
  return __fadd_rn(s, __fmul_rn(c, 0.25f));
}

__global__ void __launch_bounds__(TW * TH)
pyramid_level_kernel(const float* __restrict__ img, float* __restrict__ sm,
                     float* __restrict__ dx, float* __restrict__ dy,
                     int H, int W, int derivs) {
  __shared__ float vt[SH][VW];   // vertical blur at blurred-tile rows
  __shared__ float st[SH][SW];   // blurred image at clamped coordinates
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = (size_t)H * W;
  const float* im = img + blockIdx.z * plane;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // vt[ly][lc] = vblur(img)(clamp(y0-1+ly), clamp(x0-3+lc))
  for (int i = tid; i < SH * VW; i += TW * TH) {
    const int ly = i / VW, lc = i % VW;
    const int ys = clampi(y0 - 1 + ly, H - 1);
    const int xs = clampi(x0 - 3 + lc, W - 1);
    const float* col = im + xs;
    vt[ly][lc] = tap5(col[(size_t)clampi(ys - 2, H - 1) * W],
                      col[(size_t)clampi(ys - 1, H - 1) * W],
                      col[(size_t)ys * W],
                      col[(size_t)clampi(ys + 1, H - 1) * W],
                      col[(size_t)clampi(ys + 2, H - 1) * W]);
  }
  __syncthreads();

  // st[ly][lx] = sm(clamp(y0-1+ly), xs) with xs = clamp(x0-1+lx): its
  // horizontal taps clamp(xs+j-2) sit at vt column xs - x0 + 1 + j
  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int ly = i / SW, lx = i % SW;
    const int xs = clampi(x0 - 1 + lx, W - 1);
    const float* v = &vt[ly][0];
    const int c = xs - x0 + 1;
    st[ly][lx] = tap5(v[c], v[c + 1], v[c + 2], v[c + 3], v[c + 4]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  const size_t o = blockIdx.z * plane + (size_t)y * W + x;
  sm[o] = st[ly][lx];
  if (!derivs) return;
  // dx: horizontal derivative of rows y-1, y, y+1 (clamped), then the
  // vertical [1 2 1]/4 smoothing
  const float hm = deriv3(st[ly - 1][lx - 1], st[ly - 1][lx], st[ly - 1][lx + 1]);
  const float hc = deriv3(st[ly][lx - 1], st[ly][lx], st[ly][lx + 1]);
  const float hp = deriv3(st[ly + 1][lx - 1], st[ly + 1][lx], st[ly + 1][lx + 1]);
  dx[o] = smooth3(hm, hc, hp);
  // dy: vertical derivative of columns x-1, x, x+1 (clamped), then the
  // horizontal [1 2 1]/4 smoothing
  const float vm = deriv3(st[ly - 1][lx - 1], st[ly][lx - 1], st[ly + 1][lx - 1]);
  const float vc = deriv3(st[ly - 1][lx], st[ly][lx], st[ly + 1][lx]);
  const float vp = deriv3(st[ly - 1][lx + 1], st[ly][lx + 1], st[ly + 1][lx + 1]);
  dy[o] = smooth3(vm, vc, vp);
}

}  // namespace

// img, sm: [C, H, W] f32 contiguous; dx, dy: the same, or null when
// derivs == 0. Launches on `stream`; returns cudaGetLastError().
extern "C" int pyramid_level(const float* img, float* sm, float* dx,
                             float* dy, int C, int H, int W, int derivs,
                             void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  pyramid_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, sm, dx, dy, H, W, derivs);
  return (int)cudaGetLastError();
}
