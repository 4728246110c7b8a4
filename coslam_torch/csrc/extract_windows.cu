// Integer-origin window extraction: out[g1, g2, c, n] =
// imgs[c, y0 + g1, x0 + g2], with the origin (x0, y0) = base[c, n]
// clamped to [0, W-G] x [0, H-G].
//
// Replaces: coslam_tpu/ops/patches.py::_extract_windows_pallas, the Pallas
// TPU kernel behind extract_windows, one for one. The engine no longer
// launches it on the card: its three uses there are kernels that cut
// their windows on chip (the KLT's G = 14 templates and G = 24 targets:
// csrc/klt_track.cu; the G = 12 NCC blocks: csrc/ncc_blocks.cu; loop
// closure's G = 43 search: csrc/ncc_search.cu). It serves the plain
// PyTorch versions of those kernels when they are given CUDA tensors
// (ops/klt.py::klt_track_plain, ops/ncc.py::extract_ncc_blocks_batched_plain
// and ncc_search_plain), which chip_smoke.py times on the card as the
// "before" figures.
//
// The output is a verbatim copy of pixels, so it is bit-identical to the
// plain PyTorch twin (ops/patches.py::extract_windows_plain, the flat-index
// gather of _extract_windows_gather).
//
// Bound: bytes. At G = 24, N = 1024, one camera: 2.4 MB written and (at
// most) 2.4 MB of window pixels read, about 1.4 us at 3.35 TB/s. Design:
// one thread per feature n, blocks over (a run of 128 consecutive
// features, one window row g1, one camera), each thread looping over g2.
// Consecutive threads write consecutive n, so every store of a warp is one
// coalesced 128-byte line; the reads are per-thread gathers, each thread
// walking one image row, served by L1/L2 (the whole 1.2 MB level-0 image
// fits in L2). G is a runtime argument: one kernel serves every window
// size. The TPU kernel's aligned-band-plus-roll design and 128-wide output
// rows are Mosaic workarounds with no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
extract_windows_kernel(const float* __restrict__ imgs,
                       const int* __restrict__ base, float* __restrict__ out,
                       int C, int H, int W, int N, int G) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int g1 = blockIdx.y;
  const int c = blockIdx.z;
  if (n >= N) return;
  const int* b = base + ((size_t)c * N + n) * 2;
  int x0 = b[0], y0 = b[1];
  x0 = x0 < 0 ? 0 : (x0 > W - G ? W - G : x0);
  y0 = y0 < 0 ? 0 : (y0 > H - G ? H - G : y0);
  const float* src = imgs + ((size_t)c * H + (y0 + g1)) * W + x0;
  // out index ((g1 * G + g2) * C + c) * N + n
  float* dst = out + ((size_t)g1 * G * C + c) * N + n;
  const size_t step = (size_t)C * N;
  for (int g2 = 0; g2 < G; ++g2) dst[g2 * step] = __ldg(src + g2);
}

}  // namespace

// imgs: [C, H, W] f32; base: [C, N, 2] int32 (x0, y0); out: [G, G, C, N]
// f32; all contiguous. Requires G <= H and G <= W. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int extract_windows(const float* imgs, const int* base, float* out,
                               int C, int H, int W, int N, int G,
                               void* stream) {
  const dim3 grid((N + THREADS - 1) / THREADS, G, C);
  extract_windows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      imgs, base, out, C, H, W, N, G);
  return (int)cudaGetLastError();
}
