// Fused z-buffer rasterization + winner-record select for Hopper (sm_90a):
// the forward of the differentiable training render.
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="select"
// (launched there by _fused_impl). It computes the same function: the
// z-test of raster_common.cuh (the one raster_shade.cu and raster_pos.cu
// run), then each covered pixel's winner record fields and its raster
// row, which the backward (select_grad.cu) sums the cotangent over. None
// of the TPU mechanism comes over: no one-hot matrix-unit select, no
// 48/56-row hi/lo bf16 record, no banded bf16 output. A pixel reads its
// winner's 20 f32 fields directly and writes them as f32 image planes.
//
// Bound on this card: the bytes (the walked setup chunks, the winners'
// 20 record fields, the 22 output planes at 88 bytes a pixel); the
// pixel x triangle tests the inputs need are far fewer. The design runs
// the z-test of raster_shade.cu unchanged through the shared skeleton
// (raster_common.cuh, tile_raster): an exact per-group triangle cull,
// each triangle's covered micro-tiles found by its lane, each 2 x 2
// micro-tile's lane z-testing only those, the next chunk segment loaded
// while the current one is tested. Its epilogue writes one pixel a
// thread, row-major within the group, so each of the 22 plane stores is
// coalesced; the 20 record loads of a pixel are one row each, mostly L2
// hits because neighbouring pixels share winners.
//
// Layout (all row-major, contiguous):
//   setup, blo/bn, cmask as in raster_common.cuh
//   rec    (B, 24, rows) f32: 0..8 radiance corner-major, 9..14 affine
//          forms, 15..16 anchor, 17..19 skin corners, 20..23 unused
// Outputs: tri_id (B, H, W) i32 and row (B, H, W) i32 (-1 = background),
// sel (B, 20, H, W) f32: fields 0..19 of the winner's record, zero on
// background.
//
// Ablation switches (raster_common.cuh) of this epilogue: RP_ABLATE_SEL
// makes the winner's 20 record fields from its row with no load;
// RP_ABLATE_PACK drops every store: the winner's id, row and record
// fields fold into one word, stored only when n_faces < 0 (never), so
// the loads stay.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kSelFields = 20;

__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
raster_select_kernel(const float* __restrict__ setup,
                     const float* __restrict__ rec,
                     const int* __restrict__ blo, const int* __restrict__ bn,
                     const int* __restrict__ cmask, int* __restrict__ tri_id,
                     int* __restrict__ row_out, float* __restrict__ sel,
                     int height, int width, int tile_h, int n_cols,
                     int col_w, int n_bands, int rows, int n_faces) {
  const size_t plane = static_cast<size_t>(height) * width;
  tile_raster(
      setup, blo, bn, cmask, height, width, tile_h, n_cols, col_w, n_bands,
      rows, [&](int b, int x, int y, size_t pix, const Winner& win) {
        const int id = winner_id(win, n_faces);
#ifdef RP_ABLATE_PACK
        unsigned int sink = static_cast<unsigned int>(id) ^
                            static_cast<unsigned int>(win.row);
        if (id >= 0) {
#pragma unroll
          for (int f = 0; f < kSelFields; ++f) {
#ifdef RP_ABLATE_SEL
            sink ^= static_cast<unsigned int>(win.row + f);
#else
            sink ^= __float_as_uint(rec[(static_cast<size_t>(b) * kRecFields +
                                         f) * rows + win.row]);
#endif
          }
        }
        if (n_faces < 0) tri_id[pix] = static_cast<int>(sink);
#else
        tri_id[pix] = id;
        row_out[pix] = id >= 0 ? win.row : -1;
        float* o = sel + (static_cast<size_t>(b) * kSelFields * height + y) *
                             width + x;
        if (id >= 0) {
#ifdef RP_ABLATE_SEL
#pragma unroll
          for (int f = 0; f < kSelFields; ++f) {
            o[f * plane] = __int_as_float(win.row + f);
          }
#else
          const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                           win.row;
#pragma unroll
          for (int f = 0; f < kSelFields; ++f) {
            o[f * plane] = r[static_cast<size_t>(f) * rows];
          }
#endif
        } else {
#pragma unroll
          for (int f = 0; f < kSelFields; ++f) o[f * plane] = 0.0f;
        }
#endif
      });
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
  raster_select_kernel<<<grid, kTileThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<int*>(tri_id),
      static_cast<int*>(row), static_cast<float*>(sel), height, width,
      tile_h, n_cols, col_w, n_bands, rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
