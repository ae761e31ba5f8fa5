// Fused z-buffer rasterization + in-kernel shading for Hopper (sm_90a).
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_kernel in mode="shade"
// (launched there by rasterize_shaded). It computes the same function:
// per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center, then the winner's
// barycentrics (from its anchored affine forms) and its blended
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
//   setup  (B, 16, rows) f32: fields 0..5 affine w0/w1 forms
//          [wa0 wb0 wc0 wa1 wb1 wc1], 6..8 depth form [za zb z0],
//          9..10 anchor [x0 y0], 12 the original face id (f32-exact)
//   rec    (B, 24, rows) f32: 0..8 radiance corner-major [c*3+channel],
//          9..14 affine forms, 15..16 anchor
//   blo/bn (B, n_bands) i32: the band's union window, in 128-row chunks
//   cmask  (B, n_bands, n_cols, 2) i32: bit i of word w = chunk
//          blo + 32w + i may cover a pixel of the column tile; chunks
//          blo + 64 .. blo + bn - 1 are tested without a mask
// Outputs: tri_id (B, H, W) i32 (-1 = background), color and bary
// (B, H, W, 3) f32 (zero on background).
//
// The edge and depth forms keep the reference's operation order with
// explicit round-to-nearest intrinsics (and the build passes
// -fmad=false), so no multiply-add contraction moves a knife-edge pixel.

#include <cuda_runtime.h>

namespace {

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

  const float* sb = setup + static_cast<size_t>(b) * kSetupFields * rows;
  const int band = b * n_bands + t;
  const int lo = blo[band];
  const int n = bn[band];

  float best_z = __int_as_float(0x7f800000);  // +inf
  float best_id = 3e38f;
  int best_row = 0;

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
      if (cov && (ez < best_z || (ez == best_z && id < best_id))) {
        best_z = ez;
        best_id = id;
        best_row = r0 + j;
      }
    }
  };

  // the column's masked chunks of the window's first 64 ...
  const int* cm = cmask + (static_cast<size_t>(band) * n_cols + c) *
                              kMaskWords;
  for (int w = 0; w < kMaskWords; ++w) {
    unsigned int m = static_cast<unsigned int>(cm[w]);
    while (m != 0u) {
      const int i = __ffs(m) - 1;
      m &= m - 1u;
      test_chunk(w * 32 + i);
    }
  }
  // ... and every chunk beyond them (spatially incoherent face orders)
  for (int k = kWindow; k < n; ++k) test_chunk(k);

  if (x >= width || y >= height) return;  // column padding

  int id = -1;
  if (best_z < 3e37f) {
    const int v = static_cast<int>(best_id);
    if (v >= 0 && v < n_faces) id = v;
  }
  const size_t pix = (static_cast<size_t>(b) * height + y) * width + x;
  tri_id[pix] = id;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
  if (id >= 0) {
    const float* r = rec + static_cast<size_t>(b) * kRecFields * rows +
                     best_row;
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
