// Loop closure's dense NCC template search in one launch: for each centre,
// its G x G search window and its template go into shared memory, the
// window sums of every offset come from separable box sums there, every
// offset's correlation is computed from registers and shared memory, and
// a block-wide arg-max leaves one best pixel and score per centre.
//
// Replaces: the search use of
// coslam_tpu/ops/patches.py::_extract_windows_pallas (the Pallas TPU
// kernel that cuts the G = 2 (r + sr) + 1 windows, called from
// coslam_tpu/ops/ncc.py::ncc_search) together with that function's
// consumer (two convolutions, the variance, the score and the arg-max),
// which the PyTorch port ran as ~30 operations around its window launch,
// two of them cuDNN convolutions (ops/ncc.py::ncc_search_plain).
//
// Semantics: those of the plain version, which follows the JAX function:
//   origin = round(centre) - (r + sr) (round half to even), clamped to
//   [0, W - G - 1] x [0, H - G - 1]; at every offset (dx, dy) of the K x K
//   grid (K = 2 sr + 1): dot = <template, window patch at (dy, dx)>, Sp
//   and Sp2 = the patch's sum and sum of squares, var = max(Sp2 -
//   Sp * Sp / S^2, 1e-6) (the reference's formula, kept), score = dot /
//   sqrt(var); the arg-max over dy * K + dx, the first index on ties (NaN
//   counts as the largest, as torch.argmax and jnp.argmax have it);
//   best_px = origin + (dx, dy) + r; the score is NCC_INVALID (-2) where
//   the origin was clamped.
// The sums run in another order than the plain version's convolutions
// (here: the dot over template columns, then rows, with FMAs; the window
// sums as S-row column sums, then S-column row sums), so a score agrees to
// float32 rounding of those sums; the best pixel can differ only where two
// offsets score within that rounding. Every offset's sums run in the same
// order over the same values, so offsets over identical pixels tie
// exactly and the first one wins, as in the plain version.
//
// Bound: operations. At the engine's search (r = 5, sr = 16: G = 43,
// K = 33, N = 256) the correlation is 2 x 121 x 1089 x 256 = 67.5 MFLOP,
// ~1.0 us at 67 TFLOP/s f32 (tensor cores do not apply: one template per
// centre makes it a matrix-vector product, and TF32 would cost the
// scores' precision); the bytes, ~0.94 MB of covered window pixels plus
// the templates (124 KB) and outputs (3 KB), take ~0.32 us at 3.35 TB/s.
// Design: one block of 128 threads per centre (256 blocks, two an SM: at
// r = 5 a thread holds 188 registers, so one scheduler's 16K registers
// take two warps; a block of 160 threads fits once per SM, and the search
// took 1.7x as long on the H100). The block copies the window, zero-padded
// below to whole strips, into shared memory with asynchronous copies
// (cp.async: every copy in flight at once, one wait), and the template
// transposed, each column padded to a multiple of 4 floats. All three
// passes over the window work in strips of V = 11 outputs along one line,
// so that each value a thread loads from shared memory feeds up to V
// register accumulators (V + S - 1 loads per S * V sums, instead of one
// load per sum), the strip's registers indexed at compile time: the S-row
// column sums of p and p^2 (a strip down a column), the S-column row sums
// of those and sqrt(var) (a strip along a row; G is odd, so the threads'
// rows fall in distinct banks), and the correlation (a strip down a
// column, the template column in registers from three 16-byte broadcast
// loads). At the engine's K = 33 each pass is three strips a line: 129
// strips for the column sums (43 columns), 99 for the others. Every
// output's sum runs over its terms in ascending order. The patch side is
// a template parameter (one instantiation per radius 0..7); the search
// radius is a run-time argument. Each thread keeps its best (score,
// index); a warp shuffle and a pass over the warps' bests give the
// block's, with the lower index winning ties.
//
// Patch radii above 7, search radii above 20, or a window the tuned
// path's 48 KB cannot hold, take a general path: one block of 128
// threads per centre; thread k scores offsets k, k + 128, ... each on its
// own (the patch sum, sum of squares and correlation over the S x S patch
// in row-major order, with FMAs, then the same variance, score and
// arg-max rule), reading the window and the template from dynamic shared
// memory, or from device memory where they do not fit there (the window's
// origin is clamped into the image, so the pixels are the same). Every
// offset's sums run in one order over its values, so offsets over
// identical pixels tie exactly, as above.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int MAX_RADIUS = 7;         // the tuned path's patch radii
constexpr int MAX_SEARCH = 20;        // and search radii
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int V = 11;                 // outputs per strip

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// round half to even as an int, v clamped to +-1e9 first (NaN to -1e9)
__device__ __forceinline__ int round_int(float v) {
  return __float2int_rn(fminf(fmaxf(v, -1e9f), 1e9f));
}

// does (a, ia) beat (b, ib) under torch.argmax: NaN is the largest, then
// the larger value, then the lower index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// shared floats of one block: transposed template + window (rows padded to
// whole strips) + column sums of p and p^2 (columns padded likewise) +
// sqrt(var)
__host__ __device__ inline int smem_floats(int S, int sr) {
  const int G = S + 2 * sr, K = 2 * sr + 1;
  const int rows = (K + V - 1) / V * V + S - 1;
  return S * pad4(S) + rows * G + 2 * G * rows + K * K;
}

template <int R>
__global__ void __launch_bounds__(THREADS)
ncc_search_kernel(const float* __restrict__ img,
                  const float* __restrict__ centers,
                  const float* __restrict__ templates,
                  float* __restrict__ best_px, float* __restrict__ best_score,
                  int H, int W, int sr) {
  constexpr int S = 2 * R + 1, NP = S * S, SP = pad4(S);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x, tid = threadIdx.x;
  const int G = S + 2 * sr, K = 2 * sr + 1;
  const int strips = (K + V - 1) / V;
  const int rows = strips * V + S - 1;    // >= G
  float* tmpl = smem;                     // [S][SP]: t(i, j) at j * SP + i
  float* wnd = tmpl + S * SP;             // [rows][G], rows >= G are zero
  float* col = wnd + rows * G;            // [G][rows]: sums of p over S rows
  float* col2 = col + G * rows;           // [G][rows]: sums of p^2
  float* sd = col2 + G * rows;            // [K][K]: sqrt(var)

  const int bx = round_int(centers[2 * n]) - (R + sr);
  const int by = round_int(centers[2 * n + 1]) - (R + sr);
  const int x0 = clampi(bx, 0, W - G - 1), y0 = clampi(by, 0, H - G - 1);
  for (int i = tid; i < G * G; i += THREADS) {
    const int y = i / G, x = i - y * G;
    __pipeline_memcpy_async(wnd + i, img + (size_t)(y0 + y) * W + x0 + x,
                            sizeof(float));
  }
  __pipeline_commit();
  for (int i = G * G + tid; i < rows * G; i += THREADS) wnd[i] = 0.f;
  for (int i = tid; i < S * SP; i += THREADS) {
    const int j = i / SP, k = i - j * SP;
    tmpl[i] = k < S ? __ldg(templates + (size_t)n * NP + k * S + j) : 0.f;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // column sums: strip (x, ys..ys+V-1) of sum_k p(y + k, x), stored
  // transposed (col[x * rows + y]) for the row pass
  for (int item = tid; item < G * strips; item += THREADS) {
    const int x = item % G, ys = item / G * V;
    float s[V], s2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = s2[v] = 0.f;
#pragma unroll
    for (int rho = 0; rho < V + S - 1; ++rho) {
      const float p = wnd[(ys + rho) * G + x];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = rho - v;
        if (k >= 0 && k < S) {
          s[v] += p;
          s2[v] = fmaf(p, p, s2[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      col[x * rows + ys + v] = s[v];
      col2[x * rows + ys + v] = s2[v];
    }
  }
  __syncthreads();
  // row sums and sqrt(var): strip (y, xs..xs+V-1), reading the transposed
  // column sums along y
  for (int item = tid; item < K * strips; item += THREADS) {
    const int y = item % K, xs = item / K * V;
    float s[V], s2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = s2[v] = 0.f;
#pragma unroll
    for (int rho = 0; rho < V + S - 1; ++rho) {
      const int x = xs + rho;
      const float c = x < G ? col[x * rows + y] : 0.f;
      const float c2 = x < G ? col2[x * rows + y] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = rho - v;
        if (k >= 0 && k < S) {
          s[v] += c;
          s2[v] += c2;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (xs + v < K) {
        const float var = fmaxf(
            s2[v] - __fdiv_rn(__fmul_rn(s[v], s[v]), (float)NP), 1e-6f);
        sd[y * K + xs + v] = __fsqrt_rn(var);
      }
    }
  }
  __syncthreads();

  float best = __int_as_float(0xff800000);   // -inf
  int best_i = INT_MAX;
  for (int item = tid; item < K * strips; item += THREADS) {
    const int dx = item % K, dy0 = item / K * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float t[SP];
#pragma unroll
      for (int q = 0; q < SP / 4; ++q) {
        const float4 t4 = reinterpret_cast<const float4*>(tmpl + j * SP)[q];
        t[4 * q] = t4.x;
        t[4 * q + 1] = t4.y;
        t[4 * q + 2] = t4.z;
        t[4 * q + 3] = t4.w;
      }
      const float* wc = wnd + dy0 * G + dx + j;
#pragma unroll
      for (int rho = 0; rho < V + S - 1; ++rho) {
        const float w = wc[rho * G];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int i = rho - v;
          if (i >= 0 && i < S) acc[v] = fmaf(t[i], w, acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int dy = dy0 + v;
      if (dy < K) {
        const int idx = dy * K + dx;
        const float score = __fdiv_rn(acc[v], sd[idx]);
        if (beats(score, idx, best, best_i)) {
          best = score;
          best_i = idx;
        }
      }
    }
  }

  __shared__ float s_best[WARPS];
  __shared__ int s_idx[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float b = __shfl_down_sync(0xffffffffu, best, o);
    const int bi = __shfl_down_sync(0xffffffffu, best_i, o);
    if (beats(b, bi, best, best_i)) {
      best = b;
      best_i = bi;
    }
  }
  if ((tid & 31) == 0) {
    s_best[tid >> 5] = best;
    s_idx[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      if (beats(s_best[w], s_idx[w], best, best_i)) {
        best = s_best[w];
        best_i = s_idx[w];
      }
    }
    best_px[2 * n] = (float)(x0 + best_i % K + R);
    best_px[2 * n + 1] = (float)(y0 + best_i / K + R);
    best_score[n] = (bx == x0 && by == y0) ? best : -2.f;
  }
}

template <int R>
int launch(const float* img, const float* centers, const float* templates,
           float* best_px, float* best_score, int H, int W, int N, int sr,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(2 * R + 1, sr);
  ncc_search_kernel<R><<<N, THREADS, bytes, stream>>>(
      img, centers, templates, best_px, best_score, H, W, sr);
  return (int)cudaGetLastError();
}

// The general path (any radii): SHARED copies the window and the template
// into dynamic shared memory; otherwise both are read in place.
template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
ncc_search_general_kernel(const float* __restrict__ img,
                          const float* __restrict__ centers,
                          const float* __restrict__ templates,
                          float* __restrict__ best_px,
                          float* __restrict__ best_score, int H, int W,
                          int r, int sr) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x, tid = threadIdx.x;
  const int S = 2 * r + 1, NP = S * S, G = S + 2 * sr, K = 2 * sr + 1;
  const int bx = round_int(centers[2 * n]) - (r + sr);
  const int by = round_int(centers[2 * n + 1]) - (r + sr);
  const int x0 = clampi(bx, 0, W - G - 1), y0 = clampi(by, 0, H - G - 1);
  const float* wnd = img + (size_t)y0 * W + x0;
  const float* tmpl = templates + (size_t)n * NP;
  int ld = W;
  if (SHARED) {
    float* t_s = smem;
    float* w_s = smem + NP;
    for (int i = tid; i < G * G; i += THREADS) {
      const int y = i / G, x = i - y * G;
      __pipeline_memcpy_async(w_s + i, wnd + (size_t)y * W + x,
                              sizeof(float));
    }
    __pipeline_commit();
    for (int i = tid; i < NP; i += THREADS) t_s[i] = __ldg(tmpl + i);
    __pipeline_wait_prior(0);
    __syncthreads();
    wnd = w_s;
    tmpl = t_s;
    ld = G;
  }
  float best = __int_as_float(0xff800000);   // -inf
  int best_i = INT_MAX;
  for (int idx = tid; idx < K * K; idx += THREADS) {
    const int dy = idx / K, dx = idx - dy * K;
    float sp = 0.f, sp2 = 0.f, dot = 0.f;
    for (int i = 0; i < S; ++i) {
      const float* row = wnd + (size_t)(dy + i) * ld + dx;
      const float* trow = tmpl + i * S;
      for (int j = 0; j < S; ++j) {
        const float p = row[j];
        sp += p;
        sp2 = fmaf(p, p, sp2);
        dot = fmaf(trow[j], p, dot);
      }
    }
    const float var =
        fmaxf(sp2 - __fdiv_rn(__fmul_rn(sp, sp), (float)NP), 1e-6f);
    const float score = __fdiv_rn(dot, __fsqrt_rn(var));
    if (beats(score, idx, best, best_i)) {
      best = score;
      best_i = idx;
    }
  }
  __shared__ float s_best[WARPS];
  __shared__ int s_idx[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float b = __shfl_down_sync(0xffffffffu, best, o);
    const int bi = __shfl_down_sync(0xffffffffu, best_i, o);
    if (beats(b, bi, best, best_i)) {
      best = b;
      best_i = bi;
    }
  }
  if ((tid & 31) == 0) {
    s_best[tid >> 5] = best;
    s_idx[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      if (beats(s_best[w], s_idx[w], best, best_i)) {
        best = s_best[w];
        best_i = s_idx[w];
      }
    }
    best_px[2 * n] = (float)(x0 + best_i % K + r);
    best_px[2 * n + 1] = (float)(y0 + best_i / K + r);
    best_score[n] = (bx == x0 && by == y0) ? best : -2.f;
  }
}

int launch_general(const float* img, const float* centers,
                   const float* templates, float* best_px, float* best_score,
                   int H, int W, int N, int r, int sr, cudaStream_t stream) {
  const int S = 2 * r + 1, G = S + 2 * sr;
  const size_t bytes = sizeof(float) * ((size_t)S * S + (size_t)G * G);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes + sizeof(float) * 2 * WARPS <= (size_t)optin) {
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(ncc_search_general_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    ncc_search_general_kernel<true><<<N, THREADS, bytes, stream>>>(
        img, centers, templates, best_px, best_score, H, W, r, sr);
  } else {
    ncc_search_general_kernel<false><<<N, THREADS, 0, stream>>>(
        img, centers, templates, best_px, best_score, H, W, r, sr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// img: [H, W] f32; centers: [N, 2] f32 (x, y); templates: [N, S^2] f32
// (S = 2 patch_radius + 1, pre-normalized blocks); outputs best_px [N, 2]
// and best_score [N] f32; all contiguous. Requires both radii >= 0 and a
// search window of S + 2 search_radius + 1 pixels inside the image; a
// patch radius above 7, a search radius above 20 or a window whose strips
// need more than 48 KB of shared memory take the general path. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int ncc_search(const float* img, const float* centers,
                          const float* templates, float* best_px,
                          float* best_score, int H, int W, int N,
                          int patch_radius, int search_radius, void* stream) {
  const int S = 2 * patch_radius + 1, G = S + 2 * search_radius;
  if (patch_radius < 0 || search_radius < 0 || N < 1 || G + 1 > H ||
      G + 1 > W)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int sr = search_radius;
  if (patch_radius > MAX_RADIUS || search_radius > MAX_SEARCH ||
      sizeof(float) * smem_floats(S, search_radius) > 48 * 1024)
    return launch_general(img, centers, templates, best_px, best_score, H,
                          W, N, patch_radius, sr, s);
  switch (patch_radius) {
    case 0: return launch<0>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 1: return launch<1>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 2: return launch<2>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 3: return launch<3>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 4: return launch<4>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 5: return launch<5>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    case 6: return launch<6>(img, centers, templates, best_px, best_score,
                             H, W, N, sr, s);
    default: return launch<7>(img, centers, templates, best_px, best_score,
                              H, W, N, sr, s);
  }
}
