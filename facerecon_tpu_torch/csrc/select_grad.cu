// Adjoint of the winner-record select (the backward of raster_select.cu)
// for Hopper (sm_90a):
//
//   d_rec[b, f, r] = sum over pixels p with row[b, p] == r of g[b, f, p]
//
// for the 17 differentiable record fields f = 0..16; fields 17..23 are
// zero (the skin corners and the unused fields get no gradient).
//
// Replaces facerecon_tpu/ops/rasterize_pallas.py::_grad_kernel (launched
// there by _select_grad), which computes the same sum as a one-hot matrix
// product on the TPU's matrix unit. None of that comes over: here a block
// owns 128 raster rows, one per thread, and sums its rows' pixels itself.
//
// Deterministic: no float atomics. Each row's sum runs in one thread in a
// fixed order (bands in order, pixels in order inside a band: the image's
// row-major pixel order), so two launches give the same bits.
//
// Bound on this card: bytes (the winner rows, 17 cotangent planes and the
// (B, 24, rows) output; a few adds per covered pixel). A block walks only
// the bands whose union window [blo, blo + bn) holds its chunk (a pixel's
// winner row always lies in its band's window), 128 pixels at a time: it
// compacts the step's pixels whose winner lies in its chunk into shared
// memory, in pixel order (warp ballots), and every thread scans that short
// list for its own row. The scan is the first design's cost; the output
// write (24 fields of every row) is its floor.
//
// Layout (all row-major, contiguous): row (B, H, W) i32 winner raster
// rows (-1 = background); g (B, 20, H, W) f32 cotangent of the select's
// output planes; blo/bn (B, n_bands) i32 in 128-row chunks; output d_rec
// (B, 24, rows) f32, rows a multiple of 128.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;         // raster rows per block, one per thread
constexpr int kWarps = kRows / 32;
constexpr int kGradFields = 17;    // differentiable record fields
constexpr int kSelFields = 20;     // cotangent planes
constexpr int kRecFields = 24;

__global__ void __launch_bounds__(kRows)
select_grad_kernel(const int* __restrict__ row, const float* __restrict__ g,
                   const int* __restrict__ blo, const int* __restrict__ bn,
                   float* __restrict__ d_rec, int height, int width,
                   int tile_h, int n_bands, int rows) {
  __shared__ int s_pix[kRows];
  __shared__ int s_row[kRows];
  __shared__ int s_count[kWarps];

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_row = chunk * kRows + tid;
  const size_t plane = static_cast<size_t>(height) * width;
  const int* rb = row + b * plane;
  const float* gb = g + b * kSelFields * plane;

  float acc[kGradFields];
#pragma unroll
  for (int f = 0; f < kGradFields; ++f) acc[f] = 0.0f;

  for (int t = 0; t < n_bands; ++t) {
    const int lo = blo[b * n_bands + t];
    const int n = bn[b * n_bands + t];
    if (chunk < lo || chunk >= lo + n) continue;   // uniform per block
    const int p0 = t * tile_h * width;             // band pixels [p0, p1)
    const int p1 = min(height, (t + 1) * tile_h) * width;
    for (int base = p0; base < p1; base += kRows) {
      const int p = base + tid;
      const int rv = p < p1 ? rb[p] : -1;
      const bool match = rv >= 0 && rv / kRows == chunk;
      const unsigned int ballot = __ballot_sync(0xffffffffu, match);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int offset = 0, count = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        offset += w < warp ? s_count[w] : 0;
        count += s_count[w];
      }
      if (match) {
        const int k = offset + __popc(ballot & ((1u << lane) - 1u));
        s_pix[k] = p;
        s_row[k] = rv;
      }
      __syncthreads();
      for (int k = 0; k < count; ++k) {
        if (s_row[k] == my_row) {
          const float* gp = gb + s_pix[k];
#pragma unroll
          for (int f = 0; f < kGradFields; ++f) acc[f] += gp[f * plane];
        }
      }
      __syncthreads();   // the next step rewrites the list
    }
  }

  float* out = d_rec + static_cast<size_t>(b) * kRecFields * rows + my_row;
#pragma unroll
  for (int f = 0; f < kGradFields; ++f) {
    out[static_cast<size_t>(f) * rows] = acc[f];
  }
  for (int f = kGradFields; f < kRecFields; ++f) {
    out[static_cast<size_t>(f) * rows] = 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int select_grad(const void* row, const void* g, const void* blo,
                           const void* bn, void* d_rec, int batch,
                           int height, int width, int tile_h, int n_bands,
                           int rows, void* stream) {
  const dim3 grid(rows / kRows, batch);
  select_grad_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row), static_cast<const float*>(g),
      static_cast<const int*>(blo), static_cast<const int*>(bn),
      static_cast<float*>(d_rec), height, width, tile_h, n_bands, rows);
  return static_cast<int>(cudaGetLastError());
}
