// The render records for Hopper (sm_90a): the (B, 24, rows) float32
// field-major record whose winner fields K1 (raster_shade.cu) and DECA's
// textured kernel (raster_texture.cu) read (ops/render.pack_records). One
// kernel, one thread an (image, raster row): blocks run along the rows
// and the grid's y is the image, so a warp's store to each field is 128
// contiguous bytes.
//
// A row r < F' gathers its three corners' NDC x, y and attribute triple
// (the SH radiance for the BFM, the world normal for DECA), turns x, y
// into screen coordinates, computes the affine forms (setup_forms.cuh,
// shared with bin_setup) and writes
//   [attribute corners 9, corner-major | wa0 wb0 wc0 wa1 wb1 wc1 | x0 y0 |
//    tail 17..23],
// the tail being the first n_tail static rows of `tail` (n_tail <= 7:
// DECA's six UV rows, flame.raster_uv) and zero after them. A row
// F' <= r < rows is zero in every field. Every word of the output is
// written once, so the caller allocates it uninitialised.
//
// Replaces no TPU kernel: the JAX package packs the records with
// XLA-fused jnp (facerecon_tpu/ops/render.py _render_fields, _stack24).
// The port ran them as about 41 eager launches a call (the screen
// transform, five gathers, three corner stacks, ~24 ops of the affine
// forms, a zero fill, a 17-way stack and a slice copy), each (B, F')
// plane through memory many times: 3.53 ms a microbatch of 128 on an
// H100, ten times its bound.
//
// Bound on this card: bytes. The record is the one large output, 24
// fields x rows x 4 B an image (1,032 MB at batch 128 and the BFM's
// 83,968 rows: 0.308 ms at 3.35e12 B/s); the two (B, N, 3) planes read
// add a tenth. An image's planes (0.86 MB for the BFM's 35,721 vertices)
// and the shared face and tail rows stay in L2, so the corner gathers
// cost no more HBM traffic than one read of each. On an H100 the kernel
// takes 0.417 ms at batch 128, 82% of the 0.341 ms bound (a bare fill of
// the same record takes 0.315 ms).
//
// Bit for bit the plain version (ops/render.pack_render_records_reference,
// pack_texture_records_reference): the gathers and copies are exact, and
// the screen transform and the forms are its float32 operations in its
// order, signed zeros of dead and pad rows included.
//
// Layout (all row-major, contiguous): verts (B, N, 3) f32 NDC (x, y,
// depth); attr (B, N, 3) f32; faces (F', 3) i64 vertex ids of each raster
// row; tail (n_tail, F') f32, read only when n_tail > 0; out (B, 24, rows)
// f32, rows >= F'.

#include <cuda_runtime.h>

#include "setup_forms.cuh"   // the screen transform and the affine forms

namespace {

constexpr int kThreads = 256;      // raster rows a block
constexpr int kFields = 24;        // record fields a row
constexpr int kTail = 17;          // the first tail field

__global__ void __launch_bounds__(kThreads)
records_kernel(const float* __restrict__ verts,
               const float* __restrict__ attr,
               const long long* __restrict__ faces,
               const float* __restrict__ tail, float* __restrict__ out,
               int n_verts, int n_faces, int rows, int n_tail, int height,
               int width) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  float* o = out + static_cast<size_t>(b) * kFields * rows + r;
  float f[kFields];
  if (r < n_faces) {
    const size_t plane = static_cast<size_t>(b) * n_verts * 3;
    const float half_w = static_cast<float>(width) * 0.5f;
    const float half_h = static_cast<float>(height) * 0.5f;
    float x[3], y[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const size_t v = plane + faces[static_cast<size_t>(r) * 3 + k] * 3;
      setup::to_screen(verts + v, half_w, half_h, x[k], y[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) f[3 * k + c] = attr[v + c];
    }
    const setup::Forms fm = setup::affine_forms(x, y, false);
    f[9] = fm.wa0;
    f[10] = fm.wb0;
    f[11] = fm.wc0;
    f[12] = fm.wa1;
    f[13] = fm.wb1;
    f[14] = fm.wc1;
    f[15] = x[0];
    f[16] = y[0];
#pragma unroll
    for (int t = 0; t < kFields - kTail; ++t) {
      f[kTail + t] = t < n_tail ? tail[static_cast<size_t>(t) * n_faces + r]
                                : 0.0f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kFields; ++k) f[k] = 0.0f;
  }
  // streaming stores (evict first): the record is far larger than L2
  // and read back only at the winners, so L2 keeps the gathered planes
#pragma unroll
  for (int k = 0; k < kFields; ++k) {
    __stcs(o + static_cast<size_t>(k) * rows, f[k]);
  }
}

}  // namespace

// The records on `stream`: one block of 256 rows for each image. Returns
// cudaGetLastError() of the launch.
extern "C" int records(const void* verts, const void* attr,
                       const void* faces, const void* tail, void* out,
                       int batch, int n_verts, int n_faces, int rows,
                       int n_tail, int height, int width, void* stream) {
  const dim3 grid((rows + kThreads - 1) / kThreads, batch);
  records_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const float*>(attr),
      static_cast<const long long*>(faces), static_cast<const float*>(tail),
      static_cast<float*>(out), n_verts, n_faces, rows, n_tail, height,
      width);
  return static_cast<int>(cudaGetLastError());
}
