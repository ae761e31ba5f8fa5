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
// column tile of a band, any size: it loops over pixel groups of up to
// 32 micro-tiles, merges its warps' winners in shared memory and shades
// one pixel a thread, with coalesced stores.
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

constexpr int kR = 2;                        // micro-tile rows
constexpr int kC = 2;                        // micro-tile columns
constexpr int kThreads = kTileWarps * 32;
constexpr int kGroupPx = 32 * kR * kC;       // pixels of a full group
static_assert(kGroupPx == kThreads, "one thread a group pixel to shade");

__global__ void __launch_bounds__(kThreads)
raster_shade_kernel(const float* __restrict__ setup,
                    const float* __restrict__ rec,
                    const int* __restrict__ blo, const int* __restrict__ bn,
                    const int* __restrict__ cmask, int* __restrict__ tri_id,
                    float* __restrict__ color, float* __restrict__ bary,
                    int height, int width, int tile_h, int n_cols, int col_w,
                    int n_bands, int rows, int n_faces) {
  __shared__ Staged s_seg[kTileWarps][32];
  __shared__ int s_segrow[kTileWarps][32];
  __shared__ float s_z[kTileWarps][kGroupPx];
  __shared__ float s_id[kTileWarps][kGroupPx];
  __shared__ int s_row[kTileWarps][kGroupPx];

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int band = b * n_bands + t;
  const int lo = blo[band];
  const int n = bn[band];
  const int* cm = cmask + (static_cast<size_t>(band) * n_cols + c) *
                              kMaskWords;
  const float* sb = setup + static_cast<size_t>(b) * kSetupFields * rows;
  const float* rb = rec + static_cast<size_t>(b) * kRecFields * rows;

  // pixel groups: gc x gr micro-tiles (gc * gr <= 32) of the column tile
  const int mcols = (col_w + kC - 1) / kC;
  const int mrows = (tile_h + kR - 1) / kR;
  const int gc = min(mcols, 32);
  const int gr = min(mrows, 32 / gc);
  const int gw = gc * kC;                     // group pixel columns
  const int gh = gr * kR;                     // group pixel rows
  const int x_tile = c * col_w;               // the tile's first pixel
  const int y_tile = t * tile_h;

  for (int gy = 0; gy < mrows; gy += gr) {
    for (int gx = 0; gx < mcols; gx += gc) {
      // this lane's micro-tile (lanes beyond the group test pixels that
      // are never written, so every lane stages a triangle)
      const int x0 = x_tile + (gx + lane % gc) * kC;
      const int y0 = y_tile + (gy + lane / gc) * kR;
      float px[kC], py[kR];
#pragma unroll
      for (int k = 0; k < kC; ++k) px[k] = static_cast<float>(x0 + k) + 0.5f;
#pragma unroll
      for (int k = 0; k < kR; ++k) py[k] = static_cast<float>(y0 + k) + 0.5f;
      const int gx_px = x_tile + gx * kC;
      const int gy_px = y_tile + gy * kR;
      const float gx0 = static_cast<float>(gx_px) + 0.5f;
      const float gy0 = static_cast<float>(gy_px) + 0.5f;
      const float gx1 = static_cast<float>(gx_px + gw - 1) + 0.5f;
      const float gy1 = static_cast<float>(gy_px + gh - 1) + 0.5f;
      const TileWinners<kR, kC> w = tile_ztest<kR, kC>(
          s_seg[warp], s_segrow[warp], sb, rows, lo, n, cm, px, py, gx0, gx1,
          gy0, gy1);

      // merge the warps' winners per group pixel
      if (lane < gc * gr) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            const int p = ((lane / gc) * kR + r) * gw + (lane % gc) * kC + k;
            s_z[warp][p] = w.z[r][k];
            s_id[warp][p] = w.id[r][k];
            s_row[warp][p] = w.row[r][k];
          }
        }
      }
      __syncthreads();
      if (tid < gw * gh) {
        float z = s_z[0][tid], id = s_id[0][tid];
        int row = s_row[0][tid];
#pragma unroll
        for (int v = 1; v < kTileWarps; ++v) {
          if (beats(s_z[v][tid], s_id[v][tid], s_row[v][tid], z, id, row)) {
            z = s_z[v][tid];
            id = s_id[v][tid];
            row = s_row[v][tid];
          }
        }
        const int xo = gx * kC + tid % gw;    // column in the tile
        const int yo = gy * kR + tid / gw;    // row in the band
        const int x = x_tile + xo;
        const int y = y_tile + yo;
        if (xo < col_w && yo < tile_h && x < width && y < height) {
          const int fid = winner_id(Winner{z, id, row}, n_faces);
          const size_t pix = (static_cast<size_t>(b) * height + y) * width + x;
          tri_id[pix] = fid;
          float rgb[3] = {0.0f, 0.0f, 0.0f};
          float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
          if (fid >= 0) {
            const float* r = rb + row;
            auto field = [&](int f) { return r[static_cast<size_t>(f) * rows]; };
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
        }
      }
      __syncthreads();   // the next group rewrites the merge arrays
    }
  }
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
  raster_shade_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(setup), static_cast<const float*>(rec),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<const int*>(cmask), static_cast<int*>(tri_id),
      static_cast<float*>(color), static_cast<float*>(bary), height, width,
      tile_h, n_cols, col_w, n_bands, rows, n_faces);
  return static_cast<int>(cudaGetLastError());
}
