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
// product on the TPU's matrix unit. None of that comes over: here the
// winner rows are counting-sorted, and each row sums its own pixels.
//
// Bound on this card: bytes. The (B, 24, rows) output is the floor (1 GB
// at batch 128 and 84k rows); the inputs are the winner rows and the 17
// cotangent planes at covered pixels. The design reads the row plane
// twice, coalesced, and each covered pixel's 17 cotangent values once,
// and writes every output field once, coalesced, zeros included:
//   1. histogram: per image, an int count of winner pixels per row
//      (int atomics into `offsets`, zeroed first);
//   2. scan: per image, one block turns the counts into exclusive
//      offsets, in place;
//   3. scatter: each covered pixel takes a slot of its row with an int
//      atomic on its row's offset, which ends at the row's end, so row r
//      owns pixels[offsets[r - 1] .. offsets[r]) (offsets[-1] = 0); the
//      order inside a row is arbitrary;
//   4. sum: one thread a row, 128 rows a block, sums its pixels in
//      ascending pixel order (the plain version's order) by walking the
//      successive minima of its short list. Rows with more than kSerial
//      pixels (a near-camera triangle) are ranked by the whole block into
//      `sorted` and summed field-parallel in the same order. The sums go
//      to shared memory, and the block writes its rows' 24 fields, zeros
//      included, with 16-byte coalesced stores (no separate zero fill).
// Deterministic: no float atomics, and every sum runs in ascending pixel
// order whatever the atomics' slot order, so two launches give the same
// bits. All of it sits behind one C entry.
//
// Layout (all row-major, contiguous): row (B, H, W) i32 winner raster
// rows (-1 = background; a row outside [0, rows) is ignored); g (B, 20,
// H, W) f32 cotangent of the select's output planes; output d_rec (B, 24,
// rows) f32, rows a multiple of 128. Scratch from the wrapper: offsets
// (B, rows) i32, pixels and sorted (B, H*W) i32.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;         // rows per block of the sum pass
constexpr int kSerial = 32;        // longest row a single thread sums
constexpr int kScan = 1024;        // threads of the scan block
constexpr int kGradFields = 17;    // differentiable record fields
constexpr int kSelFields = 20;     // cotangent planes
constexpr int kRecFields = 24;

__global__ void count_rows(const int* __restrict__ row, int* __restrict__ off,
                           int plane, int rows, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = row[i];
  if (r >= 0 && r < rows) atomicAdd(off + i / plane * rows + r, 1);
}

// In-place exclusive scan of one image's row counts, 4 per thread a step.
__global__ void __launch_bounds__(kScan)
scan_rows(int* __restrict__ off, int rows) {
  __shared__ int warp_sum[kScan / 32];
  int* a = off + static_cast<size_t>(blockIdx.x) * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < rows; base += 4 * kScan) {
    const int i = base + 4 * tid;
    int4 v = make_int4(0, 0, 0, 0);
    if (i < rows) v = *reinterpret_cast<const int4*>(a + i);  // rows % 4 == 0
    const int s1 = v.x + v.y, s2 = s1 + v.z, own = s2 + v.w;
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += t;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp ? warp_sum[warp - 1] : 0) + incl - own;
    if (i < rows) {
      *reinterpret_cast<int4*>(a + i) =
          make_int4(excl, excl + v.x, excl + s1, excl + s2);
    }
    carry += warp_sum[kScan / 32 - 1];
    __syncthreads();   // the next step rewrites warp_sum
  }
}

__global__ void scatter_pixels(const int* __restrict__ row,
                               int* __restrict__ off, int* __restrict__ pix,
                               int plane, int rows, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = row[i];
  if (r < 0 || r >= rows) return;
  const size_t b = i / plane;
  const int slot = atomicAdd(off + b * rows + r, 1);
  pix[b * plane + slot] = static_cast<int>(i - b * plane);
}

__global__ void __launch_bounds__(kRows)
sum_rows(const float* __restrict__ g, const int* __restrict__ off,
         const int* __restrict__ pix, int* __restrict__ sorted,
         float* __restrict__ d_rec, int plane, int rows) {
  __shared__ int s_long[kRows];
  __shared__ int s_nlong;
  __shared__ __align__(16) float s_out[kGradFields][kRows];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int r = r0 + tid;
  const int* ob = off + static_cast<size_t>(b) * rows;
  const int* pb = pix + static_cast<size_t>(b) * plane;
  int* sb = sorted + static_cast<size_t>(b) * plane;
  const float* gb = g + static_cast<size_t>(b) * kSelFields * plane;
  float* ib = d_rec + static_cast<size_t>(b) * kRecFields * rows;
  if (tid == 0) s_nlong = 0;
  __syncthreads();

  const int start = r ? ob[r - 1] : 0;
  const int end = ob[r];
  if (end - start <= kSerial) {
    float acc[kGradFields];
#pragma unroll
    for (int f = 0; f < kGradFields; ++f) acc[f] = 0.0f;
    int prev = -1;
    for (int k = start; k < end; ++k) {
      int p = INT_MAX;               // the next pixel in ascending order
      for (int j = start; j < end; ++j) {
        const int q = pb[j];
        if (q > prev && q < p) p = q;
      }
      prev = p;
#pragma unroll
      for (int f = 0; f < kGradFields; ++f) {
        acc[f] = __fadd_rn(acc[f], gb[static_cast<size_t>(f) * plane + p]);
      }
    }
#pragma unroll
    for (int f = 0; f < kGradFields; ++f) s_out[f][tid] = acc[f];
  } else {
    s_long[atomicAdd(&s_nlong, 1)] = r;
  }
  __syncthreads();

  // long rows: rank each pixel among its row's (pixel indices are unique),
  // then one thread a field sums in that order
  for (int k = 0; k < s_nlong; ++k) {
    const int rl = s_long[k];
    const int lo = rl ? ob[rl - 1] : 0;
    const int hi = ob[rl];
    for (int i = lo + tid; i < hi; i += kRows) {
      const int p = pb[i];
      int rank = 0;
      for (int j = lo; j < hi; ++j) rank += pb[j] < p;
      sb[lo + rank] = p;
    }
    __syncthreads();
    if (tid < kGradFields) {
      float acc = 0.0f;
      for (int i = lo; i < hi; ++i) {
        acc = __fadd_rn(acc, gb[static_cast<size_t>(tid) * plane + sb[i]]);
      }
      s_out[tid][rl - r0] = acc;
    }
  }
  __syncthreads();

  // the block's 24 fields x 128 rows, 16 bytes a thread a store
  constexpr int kVec = kRows / 4;
  for (int i = tid; i < kRecFields * kVec; i += kRows) {
    const int f = i / kVec, v = i % kVec;
    const float4 val = f < kGradFields
        ? reinterpret_cast<const float4*>(s_out[f])[v]
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(ib + static_cast<size_t>(f) * rows + r0)[v] =
        val;
  }
}

}  // namespace

// Launches the four passes on `stream` and returns the first CUDA error
// (0 when every launch was accepted).
extern "C" int select_grad(const void* row, const void* g, void* d_rec,
                           void* offsets, void* pixels, void* sorted,
                           int batch, int plane, int rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(batch) * plane;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                threads);
  int* off = static_cast<int*>(offsets);
  const int* rw = static_cast<const int*>(row);
  cudaError_t err = cudaMemsetAsync(
      off, 0, static_cast<size_t>(batch) * rows * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total) {
    count_rows<<<blocks, threads, 0, st>>>(rw, off, plane, rows, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  scan_rows<<<batch, kScan, 0, st>>>(off, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (total) {
    scatter_pixels<<<blocks, threads, 0, st>>>(
        rw, off, static_cast<int*>(pixels), plane, rows, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  sum_rows<<<dim3(rows / kRows, batch), kRows, 0, st>>>(
      static_cast<const float*>(g), off, static_cast<const int*>(pixels),
      static_cast<int*>(sorted), static_cast<float*>(d_rec), plane, rows);
  return static_cast<int>(cudaGetLastError());
}
