// The whole Gaussian pyramid in one launch: level 0 is the 5-tap binomial
// blur of the input with its x/y derivative-of-Gaussian gradients; each
// level l > 0 is the blur of the 2x2 average of level l-1. Batched images
// [C, H, W] f32.
//
// Replaces: coslam_tpu/ops/pyramid_pallas.py::pyramid_level_pallas (kernel
// body _level_kernel), the Pallas TPU kernel behind build_pyramid, which
// the JAX package calls once per level with an XLA downsample between the
// calls.
//
// Semantics: those of the plain PyTorch twin
// (ops/pyramid.py::build_pyramid_plain, the ops/image.py filters):
//   level 0:  sm = hblur(vblur(img)), dx = vsmooth(hderiv(sm)),
//             dy = hsmooth(vderiv(sm))
//   level l:  sm = hblur(vblur(down(sm_{l-1})))
//   down(p)(y, x) = (((p[2y][2x] + p[2y][2x+1]) + p[2y+1][2x])
//                    + p[2y+1][2x+1]) * 0.25      (odd trailing row/col dropped)
// with blur taps [1 4 6 4 1]/16, deriv [-1 0 1]/2, smooth [1 2 1]/4, where
// every separable pass edge-replicates ITS OWN input (reads it at clamped
// coordinates). Each tap is one rounded multiply and one rounded add, in
// the plain version's order (__fmul_rn/__fadd_rn: no FMA contraction), so
// every level equals the plain composition bit for bit, border frame
// included.
//
// Bound: bytes. At 480x640 with 4 levels the pyramid reads the 1.2 MB
// input once and writes 3.7 MB (level 0 with dx, dy) plus 0.4 MB (levels
// 1-3): about 1.6 us at 3.35 TB/s. At ~2 flop per byte nothing else comes
// close; per level, launch latency and the dependency on the finished
// finer level dominate.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of as many
// 32x8-thread blocks as the card holds at once (at most one per level-0
// tile). Each level is a grid-stride pass over its 32x8 output tiles, and
// the levels are separated by cooperative_groups grid.sync(), which makes
// the finer level's writes visible to every block; the finer level is read
// back through L2 (__ldcg: it was written in this launch, so L1 may hold
// no copy of it). A tile pass stages its (8+6) x (32+6) input
// neighbourhood in shared memory at clamped coordinates; at level l > 0
// the staging computes the 2x2 average from the finer level on the fly
// (downsample2 fused into the load), so the downsampled image never goes
// to device memory. The vertical-blur and blurred tiles follow in shared
// memory with their halos, and each output is written once, coalesced
// along x. One launch replaces 4 level launches and 3 downsample passes
// (about 12 elementwise launches) of the per-level design. Needs no build
// flag beyond the package's: grid.sync() does not need -rdc since CUDA 11.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TW = 32;          // output tile width  (threads in x)
constexpr int TH = 8;           // output tile height (threads in y)
constexpr int SH = TH + 2;      // blurred tile rows  (1-px halo)
constexpr int SW = TW + 2;      // blurred tile cols  (1-px halo)
constexpr int VW = TW + 6;      // vertical-blur tile cols (2 + 1 px halo)
constexpr int IH = TH + 6;      // input tile rows (2 + 1 px halo)

struct PyrArgs {
  const float* img;             // [C, H, W] input
  float* dx;                    // [C, H, W] level-0 gradients
  float* dy;
  float* sm[MAX_LEVELS];        // [C, H >> l, W >> l] blurred levels
  int C, H, W, n_levels;
};

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

struct Smem {
  float in[IH][VW];   // level input at clamped coordinates
  float vt[SH][VW];   // vertical blur at blurred-tile rows
  float st[SH][SW];   // blurred image at clamped coordinates
};

// One 32x8 output tile of level `lv` (input: the image at level 0, the
// 2x2 average of level lv-1 above it) for camera c.
__device__ __forceinline__ void tile_pass(const PyrArgs& a, Smem& s,
                                          int lv, int c, int x0, int y0) {
  const int H = a.H >> lv, W = a.W >> lv;
  const size_t plane = (size_t)H * W;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // in[r][q] = input(clamp(y0-3+r), clamp(x0-3+q))
  if (lv == 0) {
    const float* im = a.img + c * plane;
    for (int i = tid; i < IH * VW; i += TW * TH) {
      const int r = i / VW, q = i % VW;
      const int ys = clampi(y0 - 3 + r, H - 1), xs = clampi(x0 - 3 + q, W - 1);
      s.in[r][q] = __ldg(im + (size_t)ys * W + xs);
    }
  } else {
    const int Wp = a.W >> (lv - 1);
    const float* p = a.sm[lv - 1] + c * (size_t)(a.H >> (lv - 1)) * Wp;
    for (int i = tid; i < IH * VW; i += TW * TH) {
      const int r = i / VW, q = i % VW;
      const int ys = clampi(y0 - 3 + r, H - 1), xs = clampi(x0 - 3 + q, W - 1);
      const float* t = p + (size_t)(2 * ys) * Wp + 2 * xs;
      float v = __fadd_rn(__ldcg(t), __ldcg(t + 1));
      v = __fadd_rn(v, __ldcg(t + Wp));
      v = __fadd_rn(v, __ldcg(t + Wp + 1));
      s.in[r][q] = __fmul_rn(v, 0.25f);
    }
  }
  __syncthreads();

  // vt[ly][lc] = vblur(input)(ys, clamp(x0-3+lc)), ys = clamp(y0-1+ly):
  // its vertical taps clamp(ys+j-2) sit at input row ys + j - 2 - (y0-3)
  // (the input tile holds clamped coordinates, so the unclamped row index
  // reads the clamped pixel)
  for (int i = tid; i < SH * VW; i += TW * TH) {
    const int ly = i / VW, lc = i % VW;
    const int r = clampi(y0 - 1 + ly, H - 1) - y0 + 1;
    s.vt[ly][lc] = tap5(s.in[r][lc], s.in[r + 1][lc], s.in[r + 2][lc],
                        s.in[r + 3][lc], s.in[r + 4][lc]);
  }
  __syncthreads();

  // st[ly][lx] = sm(clamp(y0-1+ly), xs), xs = clamp(x0-1+lx): its
  // horizontal taps clamp(xs+j-2) sit at vt column xs - x0 + 1 + j
  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int ly = i / SW, lx = i % SW;
    const float* v = &s.vt[ly][0];
    const int q = clampi(x0 - 1 + lx, W - 1) - x0 + 1;
    s.st[ly][lx] = tap5(v[q], v[q + 1], v[q + 2], v[q + 3], v[q + 4]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x < W && y < H) {
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    const size_t o = c * plane + (size_t)y * W + x;
    a.sm[lv][o] = s.st[ly][lx];
    if (lv == 0) {
      // dx: horizontal derivative of rows y-1, y, y+1 (clamped), then the
      // vertical [1 2 1]/4 smoothing
      const float hm = deriv3(s.st[ly - 1][lx - 1], s.st[ly - 1][lx],
                              s.st[ly - 1][lx + 1]);
      const float hc = deriv3(s.st[ly][lx - 1], s.st[ly][lx],
                              s.st[ly][lx + 1]);
      const float hp = deriv3(s.st[ly + 1][lx - 1], s.st[ly + 1][lx],
                              s.st[ly + 1][lx + 1]);
      a.dx[o] = smooth3(hm, hc, hp);
      // dy: vertical derivative of columns x-1, x, x+1 (clamped), then
      // the horizontal [1 2 1]/4 smoothing
      const float vm = deriv3(s.st[ly - 1][lx - 1], s.st[ly][lx - 1],
                              s.st[ly + 1][lx - 1]);
      const float vc = deriv3(s.st[ly - 1][lx], s.st[ly][lx],
                              s.st[ly + 1][lx]);
      const float vp = deriv3(s.st[ly - 1][lx + 1], s.st[ly][lx + 1],
                              s.st[ly + 1][lx + 1]);
      a.dy[o] = smooth3(vm, vc, vp);
    }
  }
  __syncthreads();   // the next tile pass overwrites the shared tiles
}

__global__ void __launch_bounds__(TW * TH)
build_pyramid_kernel(const __grid_constant__ PyrArgs a) {
  __shared__ Smem s;
  cg::grid_group grid = cg::this_grid();
  for (int lv = 0; lv < a.n_levels; ++lv) {
    if (lv > 0) grid.sync();
    const int H = a.H >> lv, W = a.W >> lv;
    const int tx = (W + TW - 1) / TW, ty = (H + TH - 1) / TH;
    const int tiles = tx * ty * a.C;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int c = t / (tx * ty), r = t % (tx * ty);
      tile_pass(a, s, lv, c, (r % tx) * TW, (r / tx) * TH);
    }
  }
}

}  // namespace

// img, dx, dy: [C, H, W] f32 contiguous device tensors; sm: a host array
// of n_levels device pointers, level l being [C, H >> l, W >> l] f32
// contiguous. Requires 1 <= n_levels <= 16 and H >> (n_levels-1) >= 1,
// W >> (n_levels-1) >= 1. Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int build_pyramid(const float* img, float* dx, float* dy,
                             float* const* sm, int C, int H, int W,
                             int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || C < 1 ||
      (H >> (n_levels - 1)) < 1 || (W >> (n_levels - 1)) < 1)
    return (int)cudaErrorInvalidValue;
  PyrArgs a;
  a.img = img;
  a.dx = dx;
  a.dy = dy;
  for (int l = 0; l < n_levels; ++l) a.sm[l] = sm[l];
  a.C = C;
  a.H = H;
  a.W = W;
  a.n_levels = n_levels;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, build_pyramid_kernel, TW * TH, 0);
  if (err != cudaSuccess) return (int)err;
  const int tiles0 = ((W + TW - 1) / TW) * ((H + TH - 1) / TH) * C;
  int blocks = per_sm * sms;
  if (blocks > tiles0) blocks = tiles0;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)build_pyramid_kernel,
                                    dim3(blocks), dim3(TW, TH), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
