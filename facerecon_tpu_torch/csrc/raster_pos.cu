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
// Bound on this card: the f32 work of the pixel x triangle tests that the
// group cull keeps (it writes only 12 bytes a pixel). The design runs
// the z-test of raster_shade.cu unchanged through the shared skeleton
// (raster_common.cuh, tile_raster): 2 x 2 pixels a lane share a
// triangle's shared-memory read and their qx/qy products, each warp
// drops the triangles of its chunk segment that cover no pixel center of
// its pixel group for certain (an exact bound), and the next segment
// loads while the current one is tested. The epilogue writes one pixel a
// thread, row-major within the group, so the plane stores are coalesced.
//
// Layout (all row-major, contiguous): setup, blo/bn, cmask as in
// raster_common.cuh. Outputs: tri_id (B, H, W) i32 and row (B, H, W) i32
// (-1 = background), zbuf (B, H, W) f32 (+inf = background).
//
// Ablation switches (raster_common.cuh): this epilogue loads no record,
// so RP_ABLATE_SEL does not apply (the reference's pos mode has no
// select); RP_ABLATE_PACK drops the stores: the winner's id, depth and
// row fold into one word, stored only when n_faces < 0 (never).

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(kTileThreads)
raster_pos_kernel(const float* __restrict__ setup,
                  const int* __restrict__ blo, const int* __restrict__ bn,
                  const int* __restrict__ cmask, int* __restrict__ tri_id,
                  float* __restrict__ zbuf, int* __restrict__ row_out,
                  int height, int width, int tile_h, int n_cols, int col_w,
                  int n_bands, int rows, int n_faces) {
  tile_raster(
      setup, blo, bn, cmask, height, width, tile_h, n_cols, col_w, n_bands,
      rows, [&](int, int, int, size_t pix, const Winner& win) {
        const int id = winner_id(win, n_faces);
#ifdef RP_ABLATE_PACK
        const unsigned int sink = static_cast<unsigned int>(id) ^
                                  __float_as_uint(win.z) ^
                                  static_cast<unsigned int>(win.row);
        if (n_faces < 0) tri_id[pix] = static_cast<int>(sink);
#else
        tri_id[pix] = id;
        zbuf[pix] = id >= 0 ? win.z : __int_as_float(0x7f800000);
        row_out[pix] = id >= 0 ? win.row : -1;
#endif
      });
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int raster_pos(const void* setup, const void* blo, const void* bn,
                          const void* cmask, void* tri_id, void* zbuf,
                          void* row, int batch, int height, int width,
                          int tile_h, int n_cols, int col_w, int n_bands,
                          int rows, int n_faces, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  raster_pos_kernel<<<grid, kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const int*>(blo),
      static_cast<const int*>(bn), static_cast<const int*>(cmask),
      static_cast<int*>(tri_id), static_cast<float*>(zbuf),
      static_cast<int*>(row), height, width, tile_h, n_cols, col_w, n_bands,
      rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
