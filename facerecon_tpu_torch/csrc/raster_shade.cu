// Fused z-buffer rasterization + in-kernel shading for Hopper (sm_90a).
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="shade"
// (launched there by rasterize_shaded). It computes the same function:
// per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center, then the winner's
// barycentrics (from its anchored affine forms) and its blended radiance.
// None of the TPU mechanism comes over: there is no one-hot matrix-unit
// select, no hi/lo bf16 record split, no lane-transposed output. A pixel
// reads its winner's f32 record directly and writes f32.
//
// Bound on this card: the pixel x triangle coverage/depth tests, which
// run one instruction at a time (the build has -fmad=false for bit
// parity, so no multiply-add fuses), and the bytes of setup, records and
// outputs. The design cuts the instructions a test costs and the tests
// made (raster_common.cuh, tile_ztest): 2 x 2 pixels a lane share one
// shared-memory read of a triangle and their qx/qy products (about 11
// f32 ops a test against 15); each warp drops, before testing, the
// triangles of its chunk segment that cover no pixel center of its
// pixel group for certain (an exact, monotone-rounding bound); the next
// segment loads while the current one is tested. One block of 4 warps a
// column tile of a band, any size (raster_common.cuh, tile_raster, the
// skeleton K2 and K4 share): it loops over pixel groups of up to 32
// micro-tiles, merges its warps' winners in shared memory, and this
// kernel's epilogue shades one pixel a thread, with coalesced stores.
//
// Layout (all row-major, contiguous):
//   setup, blo/bn, cmask as in raster_common.cuh
//   rec    (B, 24, rows) f32: 0..8 radiance corner-major [c*3+channel],
//          9..14 affine forms, 15..16 anchor
// Outputs: tri_id (B, H, W) i32 (-1 = background), color and bary
// (B, H, W, 3) f32 (zero on background).
//
// Ablation switches (raster_common.cuh) of this epilogue: RP_ABLATE_SEL
// makes the winner's 17 record fields from its row with no load;
// RP_ABLATE_PACK drops the barycentric and shading arithmetic and every
// store: the winner's id and record fields fold into one word, stored
// only when n_faces < 0 (never), so the loads stay.

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(kTileThreads)
raster_shade_kernel(const float* __restrict__ setup,
                    const float* __restrict__ rec,
                    const int* __restrict__ blo, const int* __restrict__ bn,
                    const int* __restrict__ cmask, int* __restrict__ tri_id,
                    float* __restrict__ color, float* __restrict__ bary,
                    int height, int width, int tile_h, int n_cols, int col_w,
                    int n_bands, int rows, int n_faces) {
  tile_raster(
      setup, blo, bn, cmask, height, width, tile_h, n_cols, col_w, n_bands,
      rows, [&](int b, int x, int y, size_t pix, const Winner& win) {
        const int fid = winner_id(win, n_faces);
#ifdef RP_ABLATE_PACK
        unsigned int sink = static_cast<unsigned int>(fid);
#else
        tri_id[pix] = fid;
        float rgb[3] = {0.0f, 0.0f, 0.0f};
        float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
#endif
        if (fid >= 0) {
#ifdef RP_ABLATE_SEL
          auto field = [&](int f) { return __int_as_float(win.row + f); };
#else
          const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                           win.row;
          auto field = [&](int f) { return r[static_cast<size_t>(f) * rows]; };
#endif
#ifdef RP_ABLATE_PACK
#pragma unroll
          for (int f = 0; f < 17; ++f) sink ^= __float_as_uint(field(f));
        }
        if (n_faces < 0) tri_id[pix] = static_cast<int>(sink);
#else
          const float fx = static_cast<float>(x) + 0.5f;
          const float fy = static_cast<float>(y) + 0.5f;
          const float qx = __fsub_rn(fx, field(15));
          const float qy = __fsub_rn(fy, field(16));
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
#endif
      });
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
  raster_shade_kernel<<<grid, kTileThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<int*>(tri_id),
      static_cast<float*>(color), static_cast<float*>(bary), height, width,
      tile_h, n_cols, col_w, n_bands, rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
