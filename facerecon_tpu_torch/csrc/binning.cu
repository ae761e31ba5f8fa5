// Static binning of the raster rows for Hopper (sm_90a): the inputs that
// K1, K2 and K4 take (ops/rasterize.band_windows, Windows). Two kernels:
//
//   1. bin_setup_kernel: the padded field-major triangle setup (B, 16,
//      rows) and, per 128-row chunk, the union of its live triangles'
//      screen boxes (B, chunks, 4);
//   2. bin_windows_kernel: per (image, band), the union window of chunks
//      that any column tile of the band hits (blo, bn), and per (image,
//      band, column tile) the exact window-relative chunk mask (2 words).
//
// Replaces no Pallas kernel: the JAX package bins with XLA-fused jnp
// (facerecon_tpu/ops/binning.py bin_triangles_static_t, called by
// facerecon_tpu/ops/rasterize_pallas.py _band_windows). The port ran the
// same function as a chain of about 140 eager ops (ops/binning.py
// bin_triangles_static_t and ops/rasterize.band_windows_reference, the
// plain version): a (B, bands, cols, chunks) hit matrix packed through
// int64, and the setup written three times. That chain took 19% of the
// inference path's device time on an H100 (5.08 of 26.9 ms a microbatch
// of 128) and about 140 launches a call.
//
// Bound on this card: bytes. The padded setup is the one large output,
// 16 fields x rows x 4 B an image (688 MB at batch 128 and the asset's
// 83,968 rows: 0.21 ms at 3.35e12 B/s); the vertices read are a twelfth
// of it, the chunk boxes, windows and masks under 1% of it. The design writes each
// setup word once, coalesced (consecutive threads write consecutive rows
// of one field), with no zero fill, no stacked temporary and no hit
// matrix:
//   - the setup pass is one thread a raster row and one block of 128
//     threads a chunk; each thread gathers its row's three corners,
//     computes the setup in registers and stores its 16 fields (slack
//     rows: wc0 = wc1 = -3e38, the rest 0); the block reduces its chunk's
//     box in registers and shared memory, dead and slack rows filled with
//     +-3e38 as the plain version pads;
//   - the window pass is one block an (image, band) and one warp a column
//     tile: the warps share the image's chunk boxes out 32 at a time, each
//     lane tests one chunk against the band and every column tile, and a
//     ballot gives the group's first and last hit; the block's union sets
//     the window, then each warp ballots its tile's 2 mask words over the
//     window's first 64 chunks. The boxes are read from L2 (about 9 KB
//     an image).
//
// Bit for bit the plain version's Windows on finite vertices: every
// value is the same float32 operation in the same order (the library is
// built with -fmad=false, so no product is fused into an add; 1 / area
// is the correctly rounded reciprocal, as torch's), the window tests
// compare the same float32 band and column edges (exact small integers),
// and a min or max does not depend on the order of its reduction.
//
// Layout (all row-major, contiguous): verts (B, N, 3) f32 NDC (x, y,
// depth); faces (F, 3) i64 vertex ids of each raster row; row_id (F,) i64
// the face id each row carries (setup field 12). Outputs: setup (B, 16,
// rows) f32, rows >= F (ops/rasterize.padded_rows); boxes (B, chunks, 4)
// f32 (ymin, ymax, xmin, xmax), chunks = ceil(F / 128), scratch between
// the two kernels; blo, bn (B, bands) i32; cmask (B, bands, cols, 2) i32,
// bit i of word w set iff chunk blo + 32 w + i exists and hits the tile.

#include <climits>

#include <cuda_runtime.h>

#include "setup_forms.cuh"   // the screen transform and the affine forms

namespace {

constexpr int kChunk = 128;        // raster rows a chunk (a setup block)
constexpr int kFields = 16;        // setup fields a row, 12..15 padding
constexpr int kMaskWords = 2;      // chunk-mask words a column tile
constexpr int kMaxCols = 32;       // column tiles a window block (warps)
constexpr float kNeg = -3e38f;     // kills coverage of a dead row
constexpr float kBig = 3e38f;      // empty box

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, d));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  }
  return v;
}

__global__ void __launch_bounds__(kChunk)
bin_setup_kernel(const float* __restrict__ verts,
                 const long long* __restrict__ faces,
                 const long long* __restrict__ row_id,
                 float* __restrict__ setup, float4* __restrict__ boxes,
                 int n_verts, int n_faces, int rows, int height, int width,
                 int cull) {
  __shared__ float4 s_box[kChunk / 32];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kChunk + threadIdx.x;
  float* out = setup + static_cast<size_t>(b) * kFields * rows + r;
  float ymin = kBig, ymax = -kBig, xmin = kBig, xmax = -kBig;
  if (r < n_faces) {
    const float* vb = verts + static_cast<size_t>(b) * n_verts * 3;
    const float half_w = static_cast<float>(width) * 0.5f;
    const float half_h = static_cast<float>(height) * 0.5f;
    float x[3], y[3], z[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* p = vb + faces[static_cast<size_t>(r) * 3 + k] * 3;
      setup::to_screen(p, half_w, half_h, x[k], y[k]);
      z[k] = p[2];
    }
    setup::Forms fm = setup::affine_forms(x, y, cull != 0);
    // the depth forms take the weights before a dead row's are zeroed
    // (+-0 products: the plain version's signs)
    const float za = fm.wa0 * (z[0] - z[2]) + fm.wa1 * (z[1] - z[2]);
    const float zb = fm.wb0 * (z[0] - z[2]) + fm.wb1 * (z[1] - z[2]);
    if (fm.dead) {
      fm.wc0 = kNeg;
      fm.wc1 = kNeg;
      fm.wa0 = fm.wb0 = fm.wa1 = fm.wb1 = 0.0f;
    } else {
      ymin = fminf(fminf(y[0], y[1]), y[2]);
      ymax = fmaxf(fmaxf(y[0], y[1]), y[2]);
      xmin = fminf(fminf(x[0], x[1]), x[2]);
      xmax = fmaxf(fmaxf(x[0], x[1]), x[2]);
    }
    const float f[kFields] = {
        fm.wa0, fm.wb0, fm.wc0, fm.wa1, fm.wb1, fm.wc1, za, zb, z[0], x[0],
        y[0], ymin, static_cast<float>(row_id[r]), 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kFields; ++k) {
      out[static_cast<size_t>(k) * rows] = f[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kFields; ++k) {
      out[static_cast<size_t>(k) * rows] = (k == 2 || k == 5) ? kNeg : 0.0f;
    }
  }

  // the chunk's box; a block past the last chunk holds slack rows alone
  const int n_chunks = (n_faces + kChunk - 1) / kChunk;
  if (static_cast<int>(blockIdx.x) >= n_chunks) return;
  ymin = warp_min(ymin);
  ymax = warp_max(ymax);
  xmin = warp_min(xmin);
  xmax = warp_max(xmax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_box[warp] = make_float4(ymin, ymax, xmin, xmax);
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 box = s_box[0];
#pragma unroll
    for (int w = 1; w < kChunk / 32; ++w) {
      box.x = fminf(box.x, s_box[w].x);
      box.y = fmaxf(box.y, s_box[w].y);
      box.z = fminf(box.z, s_box[w].z);
      box.w = fmaxf(box.w, s_box[w].w);
    }
    boxes[static_cast<size_t>(b) * n_chunks + blockIdx.x] = box;
  }
}

// Whether a chunk's box hits the band [top, top + tile_h] and the column
// tile [left, left + tile_w], as the plain version tests it.
__device__ __forceinline__ bool hits_y(const float4& q, float top,
                                       float bottom) {
  return q.x <= bottom && q.y >= top;
}

__device__ __forceinline__ bool hits_x(const float4& q, float left,
                                       float right) {
  return q.z <= right && q.w >= left;
}

__global__ void __launch_bounds__(kMaxCols * 32)
bin_windows_kernel(const float4* __restrict__ boxes, int* __restrict__ blo,
                   int* __restrict__ bn, unsigned int* __restrict__ cmask,
                   int n_chunks, int n_bands, int tile_h, int n_cols,
                   int tile_w) {
  __shared__ int s_lo, s_hi;
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* bx = boxes + static_cast<size_t>(b) * n_chunks;
  // the plain version's edges: arange(n) * size and + size, in float32
  const float top = static_cast<float>(t) * static_cast<float>(tile_h);
  const float bottom = top + static_cast<float>(tile_h);
  const float width = static_cast<float>(tile_w);
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = 0;
  }
  __syncthreads();

  // the band's union over its column tiles: first and last chunk that
  // hits any of them
  int lo = INT_MAX, hi = 0;
  for (int c0 = warp * 32; c0 < n_chunks; c0 += n_cols * 32) {
    const int k = c0 + lane;
    bool any = false;
    if (k < n_chunks) {
      const float4 q = bx[k];
      if (hits_y(q, top, bottom)) {
        for (int c = 0; c < n_cols && !any; ++c) {
          const float left = static_cast<float>(c) * width;
          any = hits_x(q, left, left + width);
        }
      }
    }
    const unsigned int m = __ballot_sync(0xffffffffu, any);
    if (m) {
      lo = min(lo, c0 + __ffs(m) - 1);
      hi = c0 + 32 - __clz(m);               // last hit + 1, ascending c0
    }
  }
  if (lane == 0 && lo != INT_MAX) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const bool hit = s_lo != INT_MAX;
  const int wlo = hit ? s_lo : 0;

  // each column tile's mask over the window's first 32 x kMaskWords chunks
  const float left = static_cast<float>(warp) * width;
  unsigned int* mb = cmask + ((static_cast<size_t>(b) * n_bands + t) *
                              n_cols + warp) * kMaskWords;
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    const int k = wlo + 32 * w + lane;
    bool in = false;
    if (k < n_chunks) {
      const float4 q = bx[k];
      in = hits_y(q, top, bottom) && hits_x(q, left, left + width);
    }
    const unsigned int m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) mb[w] = m;
  }
  if (threadIdx.x == 0) {
    blo[b * n_bands + t] = wlo;
    bn[b * n_bands + t] = hit ? s_hi - s_lo : 0;
  }
}

}  // namespace

// The setup pass on `stream`: one block a chunk of `rows` (a multiple of
// 128) for each image. Returns cudaGetLastError() of the launch.
extern "C" int bin_setup(const void* verts, const void* faces,
                         const void* row_id, void* setup, void* boxes,
                         int batch, int n_verts, int n_faces, int rows,
                         int height, int width, int cull, void* stream) {
  const dim3 grid(rows / kChunk, batch);
  bin_setup_kernel<<<grid, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const long long*>(faces),
      static_cast<const long long*>(row_id), static_cast<float*>(setup),
      static_cast<float4*>(boxes), n_verts, n_faces, rows, height, width,
      cull);
  return static_cast<int>(cudaGetLastError());
}

// The window pass on `stream`: one block of n_cols warps (n_cols <= 32)
// for each (band, image). Returns cudaGetLastError() of the launch.
extern "C" int bin_windows(const void* boxes, void* blo, void* bn,
                           void* cmask, int batch, int n_chunks, int n_bands,
                           int tile_h, int n_cols, int tile_w, void* stream) {
  const dim3 grid(n_bands, batch);
  bin_windows_kernel<<<grid, n_cols * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<int*>(blo),
      static_cast<int*>(bn), static_cast<unsigned int*>(cmask), n_chunks,
      n_bands, tile_h, n_cols, tile_w);
  return static_cast<int>(cudaGetLastError());
}
