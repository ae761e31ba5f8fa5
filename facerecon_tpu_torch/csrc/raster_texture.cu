// Fused z-buffer rasterization + DECA's textured SH shade for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no DECA/FLAME path. It was
// added for DECA's coarse model (arXiv:2012.04012), whose renderer
// interpolates per-face attributes with a rasterizer's barycentrics and
// then shades every pixel: world normal -> SH-9 with DECA's constant
// factors -> times the albedo read with F.grid_sample (bilinear, zeros
// padding, align_corners=False) at the pixel's interpolated UV. Done
// eagerly that is a dozen full-image passes over (B, 3, H, W) planes; this
// kernel does it in the epilogue of the rasterizer K1 uses, one pixel a
// thread, so the only writes are K1's outputs.
//
// It computes, per pixel: the lexicographic minimum of (depth, original
// face id) over the triangles that cover the pixel center (the z-test and
// block skeleton of raster_common.cuh, tile_raster, unchanged), then from
// the winner's record: the barycentrics (its anchored affine forms, as
// K1), the interpolated world normal n and grid coordinates g (each
// ((w0 a0 + w1 a1) + w2 a2)), shading_c = sum_k (Y_k(n) * sh_factor_k) *
// light[k][c] in k order with Y = [1, x, y, z, xy, xz, yz, x^2 - y^2,
// 3z^2 - 1], and the bilinear albedo with PyTorch's grid_sample float ops
// in its order (unnormalise ((g + 1) * S - 1) / 2, corner weights, then
// nw, ne, sw, se added to 0, a corner outside the texture adding
// nothing); color = albedo * shading. The plain version is
// ops/rasterize.texture_windows_reference, op for op (-fmad=false).
//
// Bound on this card: the bytes of the setup, the records, the outputs and
// the albedo texels the covered pixels read (each pixel's 4 corner texels
// of 12 B lie in at most two 32-byte sectors a row; neighbouring pixels
// share them); the z-test's needed pixel x triangle tests are far fewer.
// The epilogue adds ~60 float ops and 4 texel loads a covered pixel to
// K1's, which stays small beside the z-test's issued tests.
//
// Layout (all row-major, contiguous):
//   setup, blo/bn, cmask as in raster_common.cuh
//   rec     (B, 24, rows) f32: 0..8 world-normal corners [c*3 + axis],
//           9..14 affine forms, 15..16 anchor, 17..22 UV corners in
//           grid_sample coordinates [17 + 2c + axis]
//   albedo  (B, S, S, 3) f32, RGB last
//   light   (B, 9, 3) f32, DECA's SH coefficients [k][channel]
//   shf     (9,) f32, DECA's constant factors
// Outputs: tri_id (B, H, W) i32 (-1 = background), color and bary
// (B, H, W, 3) f32 (zero on background).
//
// raster_texfetch_kernel, a second kernel of this file, is the fetch of
// DECA's detailed image (predicted_detailed_image): the same z-test,
// barycentrics and UV, then the bilinear fetch of a texture that is
// already shaded (the detail model's uv_texture = albedo x SH(detail
// normal), ops/detail.py), with no normals and no light: a bilinear
// fetch of SH(n) x albedo is not SH(bilinear n) x bilinear albedo, so
// the shading cannot move to the pixel. It reads records 9..22 and
// writes K1's outputs; its plain version is
// ops/rasterize.texfetch_windows_reference.
//   tex     (B, S, S, 3) f32, RGB last

#include "raster_common.cuh"

namespace {

using namespace raster;

__device__ __forceinline__ float lerp3(float w0, float a, float w1, float b,
                                       float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}

// grid_sample's unnormalisation for align_corners=False
__device__ __forceinline__ float unnormalise(float g, int size) {
  return __fdiv_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(size)),
                1.0f),
      2.0f);
}

__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
raster_texture_kernel(const float* __restrict__ setup,
                      const float* __restrict__ rec,
                      const int* __restrict__ blo, const int* __restrict__ bn,
                      const int* __restrict__ cmask,
                      const float* __restrict__ albedo,
                      const float* __restrict__ light,
                      const float* __restrict__ shf, int* __restrict__ tri_id,
                      float* __restrict__ color, float* __restrict__ bary,
                      int height, int width, int tile_h, int n_cols,
                      int col_w, int n_bands, int rows, int n_faces,
                      int uv_size) {
  tile_raster(
      setup, blo, bn, cmask, height, width, tile_h, n_cols, col_w, n_bands,
      rows, [&](int b, int x, int y, size_t pix, const Winner& win) {
        const int fid = winner_id(win, n_faces);
        tri_id[pix] = fid;
        float rgb[3] = {0.0f, 0.0f, 0.0f};
        float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
        if (fid >= 0) {
          const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                           win.row;
          auto field = [&](int f) { return r[static_cast<size_t>(f) * rows]; };
          const float fx = static_cast<float>(x) + 0.5f;
          const float fy = static_cast<float>(y) + 0.5f;
          const float qx = __fsub_rn(fx, field(15));
          const float qy = __fsub_rn(fy, field(16));
          w0 = affine(field(9), qx, field(10), qy, field(11));
          w1 = affine(field(12), qx, field(13), qy, field(14));
          w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
          const float nx = lerp3(w0, field(0), w1, field(3), w2, field(6));
          const float ny = lerp3(w0, field(1), w1, field(4), w2, field(7));
          const float nz = lerp3(w0, field(2), w1, field(5), w2, field(8));
          const float gx = lerp3(w0, field(17), w1, field(19), w2, field(21));
          const float gy = lerp3(w0, field(18), w1, field(20), w2, field(22));
          const float sh[9] = {
              1.0f, nx, ny, nz, __fmul_rn(nx, ny), __fmul_rn(nx, nz),
              __fmul_rn(ny, nz), __fsub_rn(__fmul_rn(nx, nx),
                                           __fmul_rn(ny, ny)),
              __fsub_rn(__fmul_rn(3.0f, __fmul_rn(nz, nz)), 1.0f)};
          const float* lb = light + static_cast<size_t>(b) * 27;
          float shade[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float acc = __fmul_rn(__fmul_rn(sh[0], shf[0]), lb[ch]);
#pragma unroll
            for (int k = 1; k < 9; ++k) {
              acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(sh[k], shf[k]),
                                             lb[k * 3 + ch]));
            }
            shade[ch] = acc;
          }
          // bilinear fetch, zeros outside (PyTorch's grid_sampler_2d)
          const float ix = unnormalise(gx, uv_size);
          const float iy = unnormalise(gy, uv_size);
          const float x0 = floorf(ix);
          const float y0 = floorf(iy);
          const float x1 = __fadd_rn(x0, 1.0f);
          const float y1 = __fadd_rn(y0, 1.0f);
          const float wt[4] = {
              __fmul_rn(__fsub_rn(x1, ix), __fsub_rn(y1, iy)),
              __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(y1, iy)),
              __fmul_rn(__fsub_rn(x1, ix), __fsub_rn(iy, y0)),
              __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(iy, y0))};
          const float cx[4] = {x0, x1, x0, x1};
          const float cy[4] = {y0, y0, y1, y1};
          const float* tex = albedo + static_cast<size_t>(b) * uv_size *
                                          uv_size * 3;
          float alb[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float fs = static_cast<float>(uv_size);
            if (cx[k] >= 0.0f && cx[k] < fs && cy[k] >= 0.0f && cy[k] < fs) {
              const float* t =
                  tex + (static_cast<size_t>(cy[k]) * uv_size +
                         static_cast<size_t>(cx[k])) * 3;
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) {
                alb[ch] = __fadd_rn(alb[ch], __fmul_rn(t[ch], wt[k]));
              }
            }
          }
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            rgb[ch] = __fmul_rn(alb[ch], shade[ch]);
          }
        }
        for (int ch = 0; ch < 3; ++ch) color[pix * 3 + ch] = rgb[ch];
        bary[pix * 3 + 0] = w0;
        bary[pix * 3 + 1] = w1;
        bary[pix * 3 + 2] = w2;
      });
}

// grid_sample's bilinear fetch (zeros padding, align_corners=False) of
// one image's S x S x 3 texture at grid coordinates (gx, gy), with
// PyTorch's float ops in its order: nw, ne, sw, se added to 0
__device__ __forceinline__ void fetch_bilinear(const float* tex, int size,
                                               float gx, float gy,
                                               float out[3]) {
  const float ix = unnormalise(gx, size);
  const float iy = unnormalise(gy, size);
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float wt[4] = {__fmul_rn(__fsub_rn(x1, ix), __fsub_rn(y1, iy)),
                       __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(y1, iy)),
                       __fmul_rn(__fsub_rn(x1, ix), __fsub_rn(iy, y0)),
                       __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(iy, y0))};
  const float cx[4] = {x0, x1, x0, x1};
  const float cy[4] = {y0, y0, y1, y1};
  const float fs = static_cast<float>(size);
  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cx[k] >= 0.0f && cx[k] < fs && cy[k] >= 0.0f && cy[k] < fs) {
      const float* t = tex + (static_cast<size_t>(cy[k]) * size +
                              static_cast<size_t>(cx[k])) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        out[ch] = __fadd_rn(out[ch], __fmul_rn(t[ch], wt[k]));
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
raster_texfetch_kernel(const float* __restrict__ setup,
                       const float* __restrict__ rec,
                       const int* __restrict__ blo,
                       const int* __restrict__ bn,
                       const int* __restrict__ cmask,
                       const float* __restrict__ texture,
                       int* __restrict__ tri_id, float* __restrict__ color,
                       float* __restrict__ bary, int height, int width,
                       int tile_h, int n_cols, int col_w, int n_bands,
                       int rows, int n_faces, int uv_size) {
  tile_raster(
      setup, blo, bn, cmask, height, width, tile_h, n_cols, col_w, n_bands,
      rows, [&](int b, int x, int y, size_t pix, const Winner& win) {
        const int fid = winner_id(win, n_faces);
        tri_id[pix] = fid;
        float rgb[3] = {0.0f, 0.0f, 0.0f};
        float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
        if (fid >= 0) {
          const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                           win.row;
          auto field = [&](int f) { return r[static_cast<size_t>(f) * rows]; };
          const float fx = static_cast<float>(x) + 0.5f;
          const float fy = static_cast<float>(y) + 0.5f;
          const float qx = __fsub_rn(fx, field(15));
          const float qy = __fsub_rn(fy, field(16));
          w0 = affine(field(9), qx, field(10), qy, field(11));
          w1 = affine(field(12), qx, field(13), qy, field(14));
          w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
          const float gx = lerp3(w0, field(17), w1, field(19), w2, field(21));
          const float gy = lerp3(w0, field(18), w1, field(20), w2, field(22));
          fetch_bilinear(texture + static_cast<size_t>(b) * uv_size *
                                       uv_size * 3,
                         uv_size, gx, gy, rgb);
        }
        for (int ch = 0; ch < 3; ++ch) color[pix * 3 + ch] = rgb[ch];
        bary[pix * 3 + 0] = w0;
        bary[pix * 3 + 1] = w1;
        bary[pix * 3 + 2] = w2;
      });
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int raster_texture(const void* setup, const void* rec,
                              const void* blo, const void* bn,
                              const void* cmask, const void* albedo,
                              const void* light, const void* shf,
                              void* tri_id, void* color, void* bary,
                              int batch, int height, int width, int tile_h,
                              int n_cols, int col_w, int n_bands, int rows,
                              int n_faces, int uv_size, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  raster_texture_kernel<<<grid, kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<const float*>(albedo),
      static_cast<const float*>(light), static_cast<const float*>(shf),
      static_cast<int*>(tri_id), static_cast<float*>(color),
      static_cast<float*>(bary), height, width, tile_h, n_cols, col_w,
      n_bands, rows, n_faces, uv_size);
  return static_cast<int>(cudaGetLastError());
}

// The detailed image's fetch: launches raster_texfetch_kernel on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int raster_texfetch(const void* setup, const void* rec,
                               const void* blo, const void* bn,
                               const void* cmask, const void* texture,
                               void* tri_id, void* color, void* bary,
                               int batch, int height, int width, int tile_h,
                               int n_cols, int col_w, int n_bands, int rows,
                               int n_faces, int uv_size, void* stream) {
  const dim3 grid(n_cols, n_bands, batch);
  raster_texfetch_kernel<<<grid, kTileThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<const float*>(texture),
      static_cast<int*>(tri_id), static_cast<float*>(color),
      static_cast<float*>(bary), height, width, tile_h, n_cols, col_w,
      n_bands, rows, n_faces, uv_size);
  return static_cast<int>(cudaGetLastError());
}
