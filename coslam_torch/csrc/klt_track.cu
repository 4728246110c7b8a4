// Coarse-to-fine KLT tracking of every feature of every camera in one
// launch: per pyramid level, the feature's template and target windows go
// into shared memory once, and its whole inverse-compositional
// Gauss-Newton loop (translation plus closed-form illumination gain) runs
// on chip, each feature stopping on its own once it converges.
//
// Replaces: the KLT uses of coslam_tpu/ops/patches.py::_extract_windows_pallas
// (the Pallas TPU kernel that cuts the G = 14 template and G = 24 target
// windows of every level, called from coslam_tpu/ops/klt.py::_track_level)
// together with the per-iteration array code of that function's
// while_loop, which the PyTorch port ran as ~70 small operations per
// iteration.
//
// Semantics: those of the plain PyTorch twin
// (ops/klt.py::klt_track_plain), which follows the JAX klt_track:
//   per level (coarse to fine; the host drops levels smaller than the
//   search window, as klt.py does): template origin bt = clamp(floor(p - r)
//   - 1), T/Tx/Ty from the bilinear shift of the (S+3)^2 template window,
//   the fixed Hessian; target origin b = clamp(floor(q - r) - 6) of the
//   (S+13)^2 target window; up to n_iter iterations of resample, gain,
//   residual, update with the step_ok / done / in_range rules; final
//   residual SSD and (finest level) the in-search-range flag; then the
//   border, SSD and finiteness checks.
// Each per-pixel product and each scalar step is one rounded operation in
// the plain version's order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn: no
// FMA contraction). Only the order of the S^2-term sums differs (a warp
// reduction here), so a feature agrees with the plain version to float32
// rounding unless it sits on a threshold (convergence 0.1 px, the search
// range, the SSD threshold). The plain version runs every iteration; a
// finished feature is masked out of every update there, so leaving the
// loop once `done` gives the same result (the JAX reference's early exit,
// per feature and without a host sync).
//
// Non-finite or far-off positions (slots that are invalid on input are
// tracked too): every float-to-int conversion is clamped to +-1e9 first
// (NaN to -1e9), and every window origin is clamped into its image before
// any read, so no read leaves the image; such a feature is out of the
// search range and never steps.
//
// Bound: at 480x640, N = 1024, 4 levels the bytes are the distinct window
// pixels of both pyramids plus the outputs (~2 MB on the main path's
// frames, ~0.6 us at 3.35 TB/s); the operations, ~17 flop per patch pixel
// per iteration and ~31 per patch pixel per level (~26 MFLOP there, ~0.4
// us at 67 TFLOP/s f32), come close. What holds a feature back is
// latency: per level a dependent load of its windows from L2, and per
// iteration a chain of 4 warp reductions (5 shuffles each) and a scalar
// update; a feature runs ~5 iterations over the 4 levels.
// Design: one warp per feature, 4 warps per block; lane l owns window
// pixels l, l+32, ... of the S x S patch and keeps T, Tx, Ty in registers;
// the target window (576 floats at r = 5), the template window and its
// shifted copy sit in the warp's slice of shared memory, loaded with
// coalesced row runs through the read-only path (both pyramids fit in
// L2). Every sum is a __shfl_xor_sync butterfly, which leaves the same
// value in every lane, so the loop's branches are warp-uniform. The level
// list (pointers and level numbers) is a kernel argument passed by value:
// no device array and no host-to-device copy per call.
//
// Window radii above 7 (any radius whose search window the kept levels
// hold) take a general path: the same warp per feature, the same
// per-pixel operations in the same order (lane l sums pixels l, l + 32,
// ... in turn), so at a radius the tuned path takes it gives the same
// bits; but nothing is held in registers per pixel. T, Tx and Ty are read
// from the shifted template each time they are needed and I is resampled
// per use. The target window, the template window and the shifted
// template sit in dynamic shared memory (up to four warps a block, as
// many as the card's opt-in shared memory holds); where one warp's three
// windows do not fit, the windows are read straight from the pyramid
// levels in device memory (their origins are clamped into the level, so
// they are the same pixels) and the shifted template is recomputed from
// the template window at each read.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_RADIUS = 7;                      // the tuned path's radii
constexpr int MARGIN = 6;                          // ops/klt.py _MARGIN
constexpr int WARPS = 4;                           // features per block
constexpr int MAX_S = 2 * MAX_RADIUS + 1;          // patch side
constexpr int MAX_PIX = (MAX_S * MAX_S + 31) / 32; // patch pixels per lane
constexpr int MAX_G = MAX_S + 1 + 2 * MARGIN;      // target window side
constexpr int MAX_GT = MAX_S + 3;                  // template window side
constexpr int MAX_TB = MAX_S + 2;                  // shifted template side

struct KltLevel {
  const float* prev;   // [C, H >> lv, W >> lv] previous frame's level
  const float* cur;    // the current frame's
  int lv;              // level number
};

struct KltArgs {
  KltLevel level[MAX_LEVELS];   // kept levels, coarse to fine
  int n_levels;
  const float* pos;             // [C*N, 2]
  const unsigned char* valid;   // [C*N]
  float* pos_out;               // [C*N, 2]
  unsigned char* valid_out;     // [C*N]
  float* ssd_out;               // [C*N]
  float* gain_out;              // [C*N]
  int C, N, H, W;               // level-0 size
  int r, n_iter, with_gain;
  float lam, conv, border, ssd_thr;
};

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

struct Bilinear {
  float w00, w01, w10, w11;
  __device__ Bilinear(float fx, float fy) {
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    w00 = __fmul_rn(gx, gy);
    w01 = __fmul_rn(fx, gy);
    w10 = __fmul_rn(gx, fy);
    w11 = __fmul_rn(fx, fy);
  }
  // ops/patches.py::frac_shift at (y, x) of a row-major window of width ld
  __device__ float at(const float* wnd, int ld, int y, int x) const {
    const float* p = wnd + y * ld + x;
    float s = __fmul_rn(p[0], w00);
    s = __fadd_rn(s, __fmul_rn(p[1], w01));
    s = __fadd_rn(s, __fmul_rn(p[ld], w10));
    return __fadd_rn(s, __fmul_rn(p[ld + 1], w11));
  }
};

// copy the side x side window at (x0, y0) of a row-major image of width w
__device__ __forceinline__ void load_window(float* dst, const float* img,
                                            int w, int x0, int y0, int side,
                                            int lane) {
  for (int i = lane; i < side * side; i += 32) {
    const int y = i / side, x = i - y * side;
    dst[i] = __ldg(img + (size_t)(y0 + y) * w + x0 + x);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
klt_track_kernel(const __grid_constant__ KltArgs a) {
  __shared__ float s_wc[WARPS][MAX_G * MAX_G];
  __shared__ float s_wt[WARPS][MAX_GT * MAX_GT];
  __shared__ float s_tb[WARPS][MAX_TB * MAX_TB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + warp;
  if (f >= a.C * a.N) return;           // a whole warp; no block barrier
  const int c = f / a.N;                // cameras ride the feature axis
  const int r = a.r, S = 2 * r + 1, NP = S * S;
  const int G = S + 1 + 2 * MARGIN, GT = S + 3, TB = S + 2;
  const int top = G - S - 2;            // last in-range sub-window origin
  const float fr = (float)r;
  float* wc = s_wc[warp];
  float* wt = s_wt[warp];
  float* tb = s_tb[warp];

  const float px = a.pos[2 * f], py = a.pos[2 * f + 1];
  const int top_lv = a.level[0].lv;
  float qx = __fmul_rn(px, ldexpf(1.f, -top_lv));
  float qy = __fmul_rn(py, ldexpf(1.f, -top_lv));
  float g = 1.f, ssd = 0.f;
  bool ok0 = true;
  int prev_lv = top_lv;

  for (int li = 0; li < a.n_levels; ++li) {
    const int lv = a.level[li].lv;
    const int h = a.H >> lv, w = a.W >> lv;
    if (li > 0) {
      const float up = ldexpf(1.f, prev_lv - lv);
      qx = __fmul_rn(qx, up);
      qy = __fmul_rn(qy, up);
    }
    prev_lv = lv;
    const size_t plane = (size_t)c * h * w;

    // --- template: T, Tx, Ty (registers) and the fixed Hessian ---
    const float sc = ldexpf(1.f, -lv);
    const float ptx = __fmul_rn(px, sc), pty = __fmul_rn(py, sc);
    const int btx = clampi(floor_int(__fsub_rn(ptx, fr)) - 1, 0, w - GT);
    const int bty = clampi(floor_int(__fsub_rn(pty, fr)) - 1, 0, h - GT);
    load_window(wt, a.level[li].prev + plane, w, btx, bty, GT, lane);
    __syncwarp();
    {
      const Bilinear bl(
          clamp01(__fsub_rn(__fsub_rn(__fsub_rn(ptx, fr), 1.f), (float)btx)),
          clamp01(__fsub_rn(__fsub_rn(__fsub_rn(pty, fr), 1.f), (float)bty)));
      for (int i = lane; i < TB * TB; i += 32) {
        const int y = i / TB, x = i - y * TB;
        tb[i] = bl.at(wt, GT, y, x);
      }
    }
    __syncwarp();
    float T[MAX_PIX], Tx[MAX_PIX], Ty[MAX_PIX];
    float hxx = 0.f, hxy = 0.f, hyy = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_PIX; ++k) {
      const int p = lane + 32 * k;
      T[k] = Tx[k] = Ty[k] = 0.f;
      if (p < NP) {
        const int y = p / S + 1, x = p % S + 1;
        T[k] = tb[y * TB + x];
        Tx[k] = __fmul_rn(0.5f, __fsub_rn(tb[y * TB + x + 1],
                                          tb[y * TB + x - 1]));
        Ty[k] = __fmul_rn(0.5f, __fsub_rn(tb[(y + 1) * TB + x],
                                          tb[(y - 1) * TB + x]));
        hxx = __fadd_rn(hxx, __fmul_rn(Tx[k], Tx[k]));
        hxy = __fadd_rn(hxy, __fmul_rn(Tx[k], Ty[k]));
        hyy = __fadd_rn(hyy, __fmul_rn(Ty[k], Ty[k]));
      }
    }
    const float H11 = __fadd_rn(warp_sum(hxx), 1e-4f);
    const float H12 = warp_sum(hxy);
    const float H22 = __fadd_rn(warp_sum(hyy), 1e-4f);
    float det = __fsub_rn(__fmul_rn(H11, H22), __fmul_rn(H12, H12));
    if (fabsf(det) < 1e-8f) det = 1e-8f;

    // --- target window around the level-start estimate ---
    const int bx = clampi(floor_int(__fsub_rn(qx, fr)) - MARGIN, 0, w - G);
    const int by = clampi(floor_int(__fsub_rn(qy, fr)) - MARGIN, 0, h - G);
    load_window(wc, a.level[li].cur + plane, w, bx, by, G, lane);
    __syncwarp();
    const float bfx = (float)bx, bfy = (float)by;

    // resample the S x S patch at the estimate (qx, qy); returns in_range
    float I[MAX_PIX];
    auto resample = [&](float x, float y) {
      const float sx = __fsub_rn(__fsub_rn(x, fr), bfx);
      const float sy = __fsub_rn(__fsub_rn(y, fr), bfy);
      const int ix = floor_int(sx), iy = floor_int(sy);
      const bool in_range = ix >= 0 && ix <= top && iy >= 0 && iy <= top;
      const int icx = clampi(ix, 0, top), icy = clampi(iy, 0, top);
      const Bilinear bl(__fsub_rn(sx, (float)ix), __fsub_rn(sy, (float)iy));
#pragma unroll
      for (int k = 0; k < MAX_PIX; ++k) {
        const int p = lane + 32 * k;
        I[k] = p < NP ? bl.at(wc, G, icy + p / S, icx + p % S) : 0.f;
      }
      return in_range;
    };

    bool done = false;
    for (int it = 0; it < a.n_iter && !done; ++it) {
      const bool in_range = resample(qx, qy);
      float g_new = 1.f;
      if (a.with_gain) {
        float sit = 0.f, sii = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_PIX; ++k) {
          if (lane + 32 * k < NP) {
            sit = __fadd_rn(sit, __fmul_rn(I[k], T[k]));
            sii = __fadd_rn(sii, __fmul_rn(I[k], I[k]));
          }
        }
        g_new = __fdiv_rn(__fadd_rn(warp_sum(sit), a.lam),
                          __fadd_rn(warp_sum(sii), a.lam));
      }
      float sbx = 0.f, sby = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_PIX; ++k) {
        if (lane + 32 * k < NP) {
          const float e = __fsub_rn(T[k], __fmul_rn(g_new, I[k]));
          sbx = __fadd_rn(sbx, __fmul_rn(Tx[k], e));
          sby = __fadd_rn(sby, __fmul_rn(Ty[k], e));
        }
      }
      const float bxs = warp_sum(sbx), bys = warp_sum(sby);
      const float du = __fdiv_rn(
          __fsub_rn(__fmul_rn(H22, bxs), __fmul_rn(H12, bys)), det);
      const float dv = __fdiv_rn(
          __fsub_rn(__fmul_rn(H11, bys), __fmul_rn(H12, bxs)), det);
      if (in_range && isfinite(du) && isfinite(dv)) {
        qx = __fadd_rn(qx, du);
        qy = __fadd_rn(qy, dv);
        g = g_new;
      }
      done = hypotf(du, dv) < a.conv || !in_range;
    }

    // in-search-range check (finest level) and the final residual
    const bool ok_l = resample(qx, qy);
    float see = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_PIX; ++k) {
      if (lane + 32 * k < NP) {
        const float e = __fsub_rn(T[k], __fmul_rn(g, I[k]));
        see = __fadd_rn(see, __fmul_rn(e, e));
      }
    }
    ssd = warp_sum(see);
    if (lv == 0) ok0 = ok_l;
    __syncwarp();   // the next level overwrites this warp's windows
  }

  if (lane == 0) {
    const float bd = a.border;
    const bool in_border = qx >= bd && qx <= (float)(a.W - 1) - bd &&
                           qy >= bd && qy <= (float)(a.H - 1) - bd;
    a.pos_out[2 * f] = qx;
    a.pos_out[2 * f + 1] = qy;
    a.valid_out[f] = a.valid[f] && ok0 && in_border && ssd < a.ssd_thr &&
                     isfinite(qx) && isfinite(qy);
    a.ssd_out[f] = ssd;
    a.gain_out[f] = g;
  }
}

// where the general path samples the patch: the clamped sub-window origin
// in the target window and whether the unclamped one was in range
struct Sample {
  int icx, icy;
  bool in_range;
};

// The general path (any radius). SHARED: this warp's target window,
// template window and shifted template in dynamic shared memory;
// otherwise the windows are read in place from the levels and the shifted
// template is recomputed at each read.
template <bool SHARED>
__global__ void __launch_bounds__(WARPS * 32)
klt_track_general_kernel(const __grid_constant__ KltArgs a) {
  extern __shared__ float s_dyn[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * warps + warp;
  if (f >= a.C * a.N) return;           // a whole warp; no block barrier
  const int c = f / a.N;
  const int r = a.r, S = 2 * r + 1, NP = S * S;
  const int G = S + 1 + 2 * MARGIN, GT = S + 3, TB = S + 2;
  const int top = G - S - 2;
  const float fr = (float)r;
  float* s_wc = s_dyn + (size_t)warp * (G * G + GT * GT + TB * TB);
  float* s_wt = s_wc + G * G;
  float* s_tb = s_wt + GT * GT;

  const float px = a.pos[2 * f], py = a.pos[2 * f + 1];
  const int top_lv = a.level[0].lv;
  float qx = __fmul_rn(px, ldexpf(1.f, -top_lv));
  float qy = __fmul_rn(py, ldexpf(1.f, -top_lv));
  float g = 1.f, ssd = 0.f;
  bool ok0 = true;
  int prev_lv = top_lv;

  for (int li = 0; li < a.n_levels; ++li) {
    const int lv = a.level[li].lv;
    const int h = a.H >> lv, w = a.W >> lv;
    if (li > 0) {
      const float up = ldexpf(1.f, prev_lv - lv);
      qx = __fmul_rn(qx, up);
      qy = __fmul_rn(qy, up);
    }
    prev_lv = lv;
    const size_t plane = (size_t)c * h * w;

    const float sc = ldexpf(1.f, -lv);
    const float ptx = __fmul_rn(px, sc), pty = __fmul_rn(py, sc);
    const int btx = clampi(floor_int(__fsub_rn(ptx, fr)) - 1, 0, w - GT);
    const int bty = clampi(floor_int(__fsub_rn(pty, fr)) - 1, 0, h - GT);
    const float* wt = a.level[li].prev + plane + (size_t)bty * w + btx;
    int ldt = w;
    const Bilinear blt(
        clamp01(__fsub_rn(__fsub_rn(__fsub_rn(ptx, fr), 1.f), (float)btx)),
        clamp01(__fsub_rn(__fsub_rn(__fsub_rn(pty, fr), 1.f), (float)bty)));
    if (SHARED) {
      for (int i = lane; i < GT * GT; i += 32) {
        const int y = i / GT, x = i - y * GT;
        s_wt[i] = __ldg(wt + (size_t)y * w + x);
      }
      __syncwarp();
      wt = s_wt;
      ldt = GT;
      for (int i = lane; i < TB * TB; i += 32) {
        const int y = i / TB, x = i - y * TB;
        s_tb[i] = blt.at(wt, ldt, y, x);
      }
      __syncwarp();
    }
    // the shifted template at (y, x): T(p) = tb(y + 1, x + 1)
    auto tb = [&](int y, int x) {
      return SHARED ? s_tb[y * TB + x] : blt.at(wt, ldt, y, x);
    };
    auto grads = [&](int p, float& t, float& tx, float& ty) {
      const int y = p / S + 1, x = p % S + 1;
      t = tb(y, x);
      tx = __fmul_rn(0.5f, __fsub_rn(tb(y, x + 1), tb(y, x - 1)));
      ty = __fmul_rn(0.5f, __fsub_rn(tb(y + 1, x), tb(y - 1, x)));
    };
    float hxx = 0.f, hxy = 0.f, hyy = 0.f;
    for (int p = lane; p < NP; p += 32) {
      float t, tx, ty;
      grads(p, t, tx, ty);
      hxx = __fadd_rn(hxx, __fmul_rn(tx, tx));
      hxy = __fadd_rn(hxy, __fmul_rn(tx, ty));
      hyy = __fadd_rn(hyy, __fmul_rn(ty, ty));
    }
    const float H11 = __fadd_rn(warp_sum(hxx), 1e-4f);
    const float H12 = warp_sum(hxy);
    const float H22 = __fadd_rn(warp_sum(hyy), 1e-4f);
    float det = __fsub_rn(__fmul_rn(H11, H22), __fmul_rn(H12, H12));
    if (fabsf(det) < 1e-8f) det = 1e-8f;

    const int bx = clampi(floor_int(__fsub_rn(qx, fr)) - MARGIN, 0, w - G);
    const int by = clampi(floor_int(__fsub_rn(qy, fr)) - MARGIN, 0, h - G);
    const float* wc = a.level[li].cur + plane + (size_t)by * w + bx;
    int ldc = w;
    if (SHARED) {
      for (int i = lane; i < G * G; i += 32) {
        const int y = i / G, x = i - y * G;
        s_wc[i] = __ldg(wc + (size_t)y * w + x);
      }
      __syncwarp();
      wc = s_wc;
      ldc = G;
    }
    const float bfx = (float)bx, bfy = (float)by;

    // the patch's sub-window origin and fraction at the estimate (x, y)
    auto locate = [&](float x, float y, Bilinear& bl) {
      const float sx = __fsub_rn(__fsub_rn(x, fr), bfx);
      const float sy = __fsub_rn(__fsub_rn(y, fr), bfy);
      const int ix = floor_int(sx), iy = floor_int(sy);
      bl = Bilinear(__fsub_rn(sx, (float)ix), __fsub_rn(sy, (float)iy));
      return Sample{clampi(ix, 0, top), clampi(iy, 0, top),
                    ix >= 0 && ix <= top && iy >= 0 && iy <= top};
    };

    bool done = false;
    for (int it = 0; it < a.n_iter && !done; ++it) {
      Bilinear bl(0.f, 0.f);
      const Sample sm = locate(qx, qy, bl);
      float g_new = 1.f;
      if (a.with_gain) {
        float sit = 0.f, sii = 0.f;
        for (int p = lane; p < NP; p += 32) {
          const float I = bl.at(wc, ldc, sm.icy + p / S, sm.icx + p % S);
          float t, tx, ty;
          grads(p, t, tx, ty);
          sit = __fadd_rn(sit, __fmul_rn(I, t));
          sii = __fadd_rn(sii, __fmul_rn(I, I));
        }
        g_new = __fdiv_rn(__fadd_rn(warp_sum(sit), a.lam),
                          __fadd_rn(warp_sum(sii), a.lam));
      }
      float sbx = 0.f, sby = 0.f;
      for (int p = lane; p < NP; p += 32) {
        const float I = bl.at(wc, ldc, sm.icy + p / S, sm.icx + p % S);
        float t, tx, ty;
        grads(p, t, tx, ty);
        const float e = __fsub_rn(t, __fmul_rn(g_new, I));
        sbx = __fadd_rn(sbx, __fmul_rn(tx, e));
        sby = __fadd_rn(sby, __fmul_rn(ty, e));
      }
      const float bxs = warp_sum(sbx), bys = warp_sum(sby);
      const float du = __fdiv_rn(
          __fsub_rn(__fmul_rn(H22, bxs), __fmul_rn(H12, bys)), det);
      const float dv = __fdiv_rn(
          __fsub_rn(__fmul_rn(H11, bys), __fmul_rn(H12, bxs)), det);
      if (sm.in_range && isfinite(du) && isfinite(dv)) {
        qx = __fadd_rn(qx, du);
        qy = __fadd_rn(qy, dv);
        g = g_new;
      }
      done = hypotf(du, dv) < a.conv || !sm.in_range;
    }

    Bilinear bl(0.f, 0.f);
    const Sample sm = locate(qx, qy, bl);
    float see = 0.f;
    for (int p = lane; p < NP; p += 32) {
      const float I = bl.at(wc, ldc, sm.icy + p / S, sm.icx + p % S);
      float t, tx, ty;
      grads(p, t, tx, ty);
      const float e = __fsub_rn(t, __fmul_rn(g, I));
      see = __fadd_rn(see, __fmul_rn(e, e));
    }
    ssd = warp_sum(see);
    if (lv == 0) ok0 = sm.in_range;
    __syncwarp();   // the next level overwrites this warp's windows
  }

  if (lane == 0) {
    const float bd = a.border;
    const bool in_border = qx >= bd && qx <= (float)(a.W - 1) - bd &&
                           qy >= bd && qy <= (float)(a.H - 1) - bd;
    a.pos_out[2 * f] = qx;
    a.pos_out[2 * f + 1] = qy;
    a.valid_out[f] = a.valid[f] && ok0 && in_border && ssd < a.ssd_thr &&
                     isfinite(qx) && isfinite(qy);
    a.ssd_out[f] = ssd;
    a.gain_out[f] = g;
  }
}

int launch_general(const KltArgs& a, cudaStream_t stream) {
  const int S = 2 * a.r + 1, G = S + 1 + 2 * MARGIN, GT = S + 3, TB = S + 2;
  const size_t per_warp = sizeof(float) * ((size_t)G * G + (size_t)GT * GT +
                                           (size_t)TB * TB);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int fit = (int)((size_t)optin / per_warp);
  const int features = a.C * a.N;
  if (fit >= 1) {
    const int w = fit < WARPS ? fit : WARPS;
    const size_t bytes = per_warp * w;
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(klt_track_general_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    klt_track_general_kernel<true><<<(features + w - 1) / w, w * 32, bytes,
                                     stream>>>(a);
  } else {
    klt_track_general_kernel<false><<<(features + WARPS - 1) / WARPS,
                                      WARPS * 32, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// prev, cur: host arrays of device pointers to every level of the two
// pyramids, level l being [C, H >> l, W >> l] f32 contiguous; levels: host
// array of the n_levels kept level numbers, coarse to fine, ending at 0.
// pos [C, N, 2] f32, valid [C, N] bool (one byte each); outputs pos_out
// [C, N, 2], valid_out [C, N] bool, ssd_out and gain_out [C, N] f32.
// Requires radius >= 0, 1 <= n_levels <= 16 and every kept level at least
// 2 * radius + 14 pixels on each side; radii above 7 take the general
// path. Launches on `stream`; returns cudaGetLastError().
extern "C" int klt_track(const float* const* prev, const float* const* cur,
                         const int* levels, int n_levels, const float* pos,
                         const unsigned char* valid, float* pos_out,
                         unsigned char* valid_out, float* ssd_out,
                         float* gain_out, int C, int N, int H, int W,
                         int radius, int n_iter, int with_gain,
                         float lam, float conv, float border, float ssd_thr,
                         void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || radius < 0 || C < 1 ||
      N < 1)
    return (int)cudaErrorInvalidValue;
  const int G = 2 * radius + 2 + 2 * MARGIN;
  KltArgs a;
  for (int i = 0; i < n_levels; ++i) {
    const int lv = levels[i];
    if (lv < 0 || (H >> lv) < G || (W >> lv) < G)
      return (int)cudaErrorInvalidValue;
    a.level[i].prev = prev[lv];
    a.level[i].cur = cur[lv];
    a.level[i].lv = lv;
  }
  a.n_levels = n_levels;
  a.pos = pos;
  a.valid = valid;
  a.pos_out = pos_out;
  a.valid_out = valid_out;
  a.ssd_out = ssd_out;
  a.gain_out = gain_out;
  a.C = C;
  a.N = N;
  a.H = H;
  a.W = W;
  a.r = radius;
  a.n_iter = n_iter;
  a.with_gain = with_gain;
  a.lam = lam;
  a.conv = conv;
  a.border = border;
  a.ssd_thr = ssd_thr;
  if (radius > MAX_RADIUS) return launch_general(a, (cudaStream_t)stream);
  const int features = C * N;
  klt_track_kernel<<<(features + WARPS - 1) / WARPS, WARPS * 32, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
