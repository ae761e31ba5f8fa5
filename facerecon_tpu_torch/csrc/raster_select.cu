// Fused z-buffer rasterization + winner-record select for Hopper (sm_90a):
// the forward of the differentiable training render.
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="select"
// (launched there by _fused_impl). It computes the same function: the
// z-test of raster_common.cuh (the one raster_shade.cu runs), then each
// covered pixel's winner record fields and its raster row, which the
// backward (select_grad.cu) sums the cotangent over. None of the TPU
// mechanism comes over: no one-hot matrix-unit select, no 48/56-row hi/lo
// bf16 record, no banded bf16 output. A pixel reads its winner's 20 f32
// fields directly and writes them as f32 image planes.
//
// Bound on this card: the f32 work of the pixel x candidate tests (the
// same as raster_shade's), against the bytes of setup, records and the 22
// output planes. This first design, like raster_shade's, stages one chunk
// of setup at a time in shared memory and does not overlap loads with
// tests; the 20 record loads per pixel are scattered (one row each).
//
// Layout (all row-major, contiguous):
//   setup, blo/bn, cmask as in raster_common.cuh
//   rec    (B, 24, rows) f32: 0..8 radiance corner-major, 9..14 affine
//          forms, 15..16 anchor, 17..19 skin corners, 20..23 unused
// Outputs: tri_id (B, H, W) i32 and row (B, H, W) i32 (-1 = background),
// sel (B, 20, H, W) f32: fields 0..19 of the winner's record, zero on
// background.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kSelFields = 20;

__global__ void __launch_bounds__(1024)
raster_select_kernel(const float* __restrict__ setup,
                     const float* __restrict__ rec,
                     const int* __restrict__ blo, const int* __restrict__ bn,
                     const int* __restrict__ cmask, int* __restrict__ tri_id,
                     int* __restrict__ row_out, float* __restrict__ sel,
                     int height, int width, int tile_h, int n_cols,
                     int col_w, int n_bands, int rows, int n_faces) {
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
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t pix = static_cast<size_t>(y) * width + x;
  tri_id[b * plane + pix] = id;
  row_out[b * plane + pix] = id >= 0 ? win.row : -1;
  float* o = sel + static_cast<size_t>(b) * kSelFields * plane + pix;
  if (id >= 0) {
    const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                     win.row;
    for (int f = 0; f < kSelFields; ++f) {
      o[f * plane] = r[static_cast<size_t>(f) * rows];
    }
  } else {
    for (int f = 0; f < kSelFields; ++f) o[f * plane] = 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int raster_select(const void* setup, const void* rec,
                             const void* blo, const void* bn,
                             const void* cmask, void* tri_id, void* row,
                             void* sel, int batch, int height, int width,
                             int tile_h, int n_cols, int col_w, int n_bands,
                             int rows, int n_faces, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  const int threads = tile_h * col_w;
  raster_select_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<int*>(tri_id),
      static_cast<int*>(row), static_cast<float*>(sel), height, width,
      tile_h, n_cols, col_w, n_bands, rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
