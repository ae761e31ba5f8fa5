// Live-chunk walk microbenchmark for Hopper (sm_90a).
//
// Replaces benchmarks/ctzloop_probe.py::kernel, the TPU probe of the
// rasterizers' walk over the set bits of a chunk mask word. It computes
// the same function: for each program, one 32-bit mask word; for each of
// 112 pixels p = 0..111, the minimum over the set bits k of the minimum
// over the 128 triangles j of chunk k of
//   ez = s4[j] * p + s5[j]   where   e0 = s0[j] * p + s1[j] >= 0,
//   e1 = s2[j] * p + s3[j] >= 0   and   e0 + e1 <= 1,
// with s_f[j] = setup[f][128 k + j]; +inf where nothing is covered. On
// this card the walk is an __ffs loop over the set bits (the order of
// raster_common.cuh's ChunkWalk): each set bit stages its chunk's six
// fields in shared memory with one cooperative load, and each thread
// tests its pixel against the chunk.
// The float ops keep the probe's order with explicit round-to-nearest
// intrinsics (and the build passes -fmad=false), so the result equals the
// plain version exactly.
//
// Bound on this card: the f32 work of the live tests (7 ops each), far
// above the bytes (the 24 KB of live setup is shared by every program).
// The probe measures the walk's cost per live chunk, so the design keeps
// the walk plain: stage, synchronise, test.
//
// Layout: mask (n_prog,) i32; setup (8, 8192) f32 row-major (fields 0..5
// used, chunks 0..31 reachable); out (n_prog, 112) f32.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kPix = 112;
constexpr int kFields = 6;
constexpr int kCols = 64 * kChunk;  // setup row length

__global__ void __launch_bounds__(kChunk)
ctz_walk_kernel(const int* __restrict__ mask, const float* __restrict__ setup,
                float* __restrict__ out) {
  __shared__ float s[kFields][kChunk];
  const int tid = threadIdx.x;
  const float p = static_cast<float>(tid);
  float best = __int_as_float(0x7f800000);
  unsigned int m = static_cast<unsigned int>(mask[blockIdx.x]);
  while (m != 0u) {
    const int k = __ffs(m) - 1;
    m &= m - 1u;
    __syncthreads();
    for (int f = 0; f < kFields; ++f) {
      s[f][tid] = setup[f * kCols + k * kChunk + tid];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float e0 = __fadd_rn(__fmul_rn(s[0][j], p), s[1][j]);
      const float e1 = __fadd_rn(__fmul_rn(s[2][j], p), s[3][j]);
      const float ez = __fadd_rn(__fmul_rn(s[4][j], p), s[5][j]);
      if (e0 >= 0.0f && e1 >= 0.0f && __fadd_rn(e0, e1) <= 1.0f) {
        best = fminf(best, ez);
      }
    }
  }
  if (tid < kPix) out[static_cast<size_t>(blockIdx.x) * kPix + tid] = best;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int ctz_walk(const void* mask, const void* setup, void* out,
                        int n_prog, void* stream) {
  ctz_walk_kernel<<<n_prog, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), static_cast<const float*>(setup),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
