// Fused z-buffer rasterization + in-kernel shading for Hopper (sm_90a).
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="shade"
// (launched there by rasterize_shaded). It computes the same function:
// per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center (raster_common.cuh), then the
// winner's barycentrics (from its anchored affine forms) and its blended
// radiance. None of the TPU mechanism comes over: there is no one-hot
// matrix-unit select, no hi/lo bf16 record split, no lane-transposed
// output. A pixel reads its winner's f32 record directly and writes f32.
//
// Bound on this card: the larger of the bytes of setup, records and
// outputs over the memory rate, and the f32 work of the pixel x candidate
// coverage/depth tests over the f32 rate. This first design does nothing
// about either bound yet (one block per column tile, one chunk of setup
// staged in shared memory at a time, no overlap of loads and tests).
//
// Layout (all row-major, contiguous):
//   setup, blo/bn, cmask as in raster_common.cuh
//   rec    (B, 24, rows) f32: 0..8 radiance corner-major [c*3+channel],
//          9..14 affine forms, 15..16 anchor
// Outputs: tri_id (B, H, W) i32 (-1 = background), color and bary
// (B, H, W, 3) f32 (zero on background).

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(1024)
raster_shade_kernel(const float* __restrict__ setup,
                    const float* __restrict__ rec,
                    const int* __restrict__ blo, const int* __restrict__ bn,
                    const int* __restrict__ cmask, int* __restrict__ tri_id,
                    float* __restrict__ color, float* __restrict__ bary,
                    int height, int width, int tile_h, int n_cols, int col_w,
                    int n_bands, int rows, int n_faces) {
  __shared__ float s[kStaged][kChunk];

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int x = c * col_w + tid % col_w;
  const int y = t * tile_h + tid / col_w;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int band = b * n_bands + t;
  const Winner win = band_ztest(
      s, setup + static_cast<size_t>(b) * kSetupFields * rows, rows,
      blo[band], bn[band],
      cmask + (static_cast<size_t>(band) * n_cols + c) * kMaskWords, px, py);

  if (x >= width || y >= height) return;  // column padding

  const int id = winner_id(win, n_faces);
  const size_t pix = (static_cast<size_t>(b) * height + y) * width + x;
  tri_id[pix] = id;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
  if (id >= 0) {
    const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                     win.row;
    auto field = [&](int f) { return r[static_cast<size_t>(f) * rows]; };
    const float qx = __fsub_rn(px, field(15));
    const float qy = __fsub_rn(py, field(16));
    w0 = affine(field(9), qx, field(10), qy, field(11));
    w1 = affine(field(12), qx, field(13), qy, field(14));
    w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
    for (int ch = 0; ch < 3; ++ch) {
      rgb[ch] = __fadd_rn(__fadd_rn(__fmul_rn(w0, field(ch)),
                                    __fmul_rn(w1, field(ch + 3))),
                          __fmul_rn(w2, field(ch + 6)));
    }
  }
  for (int ch = 0; ch < 3; ++ch) color[pix * 3 + ch] = rgb[ch];
  bary[pix * 3 + 0] = w0;
  bary[pix * 3 + 1] = w1;
  bary[pix * 3 + 2] = w2;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int raster_shade(const void* setup, const void* rec,
                            const void* blo, const void* bn,
                            const void* cmask, void* tri_id, void* color,
                            void* bary, int batch, int height, int width,
                            int tile_h, int n_cols, int col_w, int n_bands,
                            int rows, int n_faces, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  const int threads = tile_h * col_w;
  raster_shade_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<int*>(tri_id),
      static_cast<float*>(color), static_cast<float*>(bary), height, width,
      tile_h, n_cols, col_w, n_bands, rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
