// The z-test shared by the rasterizer kernels (raster_shade.cu,
// raster_select.cu), so the two cannot drift apart.
//
// Per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center, walking the band's union
// window [blo, blo + bn) of 128-row chunks: the column's masked chunks of
// the window's first 64, then every chunk beyond them (spatially
// incoherent face orders). It computes what the z-test phase of
// facerecon_tpu/ops/rasterize_pallas.py::_kernel computes.
//
// Setup layout (B, 16, rows) f32, row-major: fields 0..5 affine w0/w1
// forms [wa0 wb0 wc0 wa1 wb1 wc1], 6..8 depth form [za zb z0], 9..10
// anchor [x0 y0], 12 the original face id (f32-exact). cmask (B, n_bands,
// n_cols, 2) i32: bit i of word w = chunk blo + 32w + i may cover a pixel
// of the column tile.
//
// The edge and depth forms keep the reference's operation order with
// explicit round-to-nearest intrinsics (and the build passes -fmad=false),
// so no multiply-add contraction moves a knife-edge pixel.

#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int kChunk = 128;      // setup rows per chunk
constexpr int kWindow = 64;      // chunks covered by the column masks
constexpr int kMaskWords = 2;
constexpr int kSetupFields = 16;
constexpr int kRecFields = 24;
constexpr int kStaged = 12;      // setup fields 0..10 and the id (12)

__device__ __forceinline__ float affine(float a, float qx, float b, float qy,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, qx), __fmul_rn(b, qy)), c);
}

struct Winner {
  float z;    // +inf when nothing covers the pixel
  float id;   // original face id of the winner
  int row;    // its raster row
};

// The band's z-test for the pixel (px, py) of column tile `c`. Every
// thread of the block calls it with the same band: chunks are staged in
// `s` with one cooperative load each (the loop trip counts are uniform).
__device__ __forceinline__ Winner band_ztest(
    float (&s)[kStaged][kChunk], const float* __restrict__ sb, int rows,
    int lo, int n, const int* __restrict__ cm, float px, float py) {
  const int tid = threadIdx.x;
  Winner w{__int_as_float(0x7f800000), 3e38f, 0};

  // Stage chunk `k` of the band window (rows (lo + k) * 128 ...) in
  // shared memory with one cooperative load, then test this thread's
  // pixel against its 128 triangles. `k` is uniform across the block.
  auto test_chunk = [&](int k) {
    const int r0 = (lo + k) * kChunk;
    __syncthreads();
    for (int i = tid; i < kStaged * kChunk; i += blockDim.x) {
      const int f = i / kChunk;
      const int field = f < 11 ? f : 12;
      s[f][i % kChunk] = sb[static_cast<size_t>(field) * rows + r0 +
                            i % kChunk];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float qx = __fsub_rn(px, s[9][j]);
      const float qy = __fsub_rn(py, s[10][j]);
      const float e0 = affine(s[0][j], qx, s[1][j], qy, s[2][j]);
      const float e1 = affine(s[3][j], qx, s[4][j], qy, s[5][j]);
      const float ez = affine(s[6][j], qx, s[7][j], qy, s[8][j]);
      const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) &&
                       (__fadd_rn(e0, e1) <= 1.0f);
      const float id = s[11][j];
      if (cov && (ez < w.z || (ez == w.z && id < w.id))) {
        w.z = ez;
        w.id = id;
        w.row = r0 + j;
      }
    }
  };

  // the column's masked chunks of the window's first 64 ...
  for (int word = 0; word < kMaskWords; ++word) {
    unsigned int m = static_cast<unsigned int>(cm[word]);
    while (m != 0u) {
      const int i = __ffs(m) - 1;
      m &= m - 1u;
      test_chunk(word * 32 + i);
    }
  }
  // ... and every chunk beyond them (spatially incoherent face orders)
  for (int k = kWindow; k < n; ++k) test_chunk(k);
  return w;
}

// The winner's original face id, or -1 (background, or a padding row).
__device__ __forceinline__ int winner_id(const Winner& w, int n_faces) {
  if (w.z < 3e37f) {
    const int v = static_cast<int>(w.id);
    if (v >= 0 && v < n_faces) return v;
  }
  return -1;
}

}  // namespace raster
