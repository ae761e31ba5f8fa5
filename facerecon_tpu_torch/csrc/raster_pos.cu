// Hard-visibility z-buffer pass for Hopper (sm_90a): the z-test alone.
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="pos"
// (launched there by rasterize_positions). It computes the same function:
// the z-test of raster_common.cuh (the one raster_shade.cu and
// raster_select.cu run), then per pixel the winner's original face id,
// its depth and its raster row. The TPU packing does not come over: no
// (face id + 1) byte planes, no 3-part bf16 depth, no banded output. A
// pixel writes its three values as (B, H, W) planes, 12 bytes a pixel.
// The §9.5 contract path (ops/rasterize.rasterize_batch) decodes the
// barycentrics from the winner's setup row, which the row output names.
//
// Bound on this card: the f32 work of the pixel x candidate tests (the
// same as raster_shade's and raster_select's), against the bytes of
// setup, windows and the 3 output planes. This first design, like theirs,
// stages one chunk of setup at a time in shared memory and does not
// overlap loads with tests.
//
// Layout (all row-major, contiguous): setup, blo/bn, cmask as in
// raster_common.cuh. Outputs: tri_id (B, H, W) i32 and row (B, H, W) i32
// (-1 = background), zbuf (B, H, W) f32 (+inf = background).

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(1024)
raster_pos_kernel(const float* __restrict__ setup,
                  const int* __restrict__ blo, const int* __restrict__ bn,
                  const int* __restrict__ cmask, int* __restrict__ tri_id,
                  float* __restrict__ zbuf, int* __restrict__ row_out,
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
  const size_t at = static_cast<size_t>(b) * height * width +
                    static_cast<size_t>(y) * width + x;
  tri_id[at] = id;
  zbuf[at] = id >= 0 ? win.z : __int_as_float(0x7f800000);
  row_out[at] = id >= 0 ? win.row : -1;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int raster_pos(const void* setup, const void* blo, const void* bn,
                          const void* cmask, void* tri_id, void* zbuf,
                          void* row, int batch, int height, int width,
                          int tile_h, int n_cols, int col_w, int n_bands,
                          int rows, int n_faces, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  const int threads = tile_h * col_w;
  raster_pos_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const int*>(blo),
      static_cast<const int*>(bn), static_cast<const int*>(cmask),
      static_cast<int*>(tri_id), static_cast<float*>(zbuf),
      static_cast<int*>(row), height, width, tile_h, n_cols, col_w, n_bands,
      rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
