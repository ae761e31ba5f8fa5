// Live-chunk walk microbenchmark for Hopper (sm_90a).
//
// Replaces benchmarks/ctzloop_probe.py::kernel (pallas_call at :95), the
// TPU probe of the rasterizers' walk over the set bits of a chunk mask
// word. It computes the same function: for each program, one 32-bit mask
// word; for each of 112 pixels p = 0..111, the minimum over the set bits
// k of the minimum over the 128 triangles j of chunk k of
//   ez = s4[j] * p + s5[j]   where   e0 = s0[j] * p + s1[j] >= 0,
//   e1 = s2[j] * p + s3[j] >= 0   and   e0 + e1 <= 1,
// with s_f[j] = setup[f][128 k + j]; +inf where nothing is covered. The
// float ops keep the probe's order with explicit round-to-nearest
// intrinsics (and the build passes -fmad=false), so the result equals the
// plain version exactly. Every program makes its own tests: per-chunk
// minima are not shared across programs.
//
// Bound on this card: instruction throughput. A test is 7 f32 ops
// (3 x (mul + add), 1 add), each its own instruction under -fmad=false,
// plus 3 compares and a predicated min that the ops bound does not count:
// 11 warp instructions per 32 tests, at one a cycle per SM sub-partition.
// The design runs at about 1.8x the ops bound of the per-program walk on
// an H100 (PERF.md); the function alone, with each chunk's minima shared
// across programs, would need a small fraction of those tests. The bytes
// are negligible (the 96 KB of reachable setup stays cached).
//
// Design, triangle-stationary, one warp a program: lane l holds triangle
// 32 q + l of slice q = 0..3 of each live chunk in registers (6 coalesced
// loads a slice, the next slice's in flight while this one is tested) and
// keeps a running minimum of each of the 112 pixels in registers, in a
// fully unrolled pixel loop where p is an immediate. The inner loop has
// no shared memory, no barrier and no idle lane. At the end
// a butterfly reduce-scatter over the warp's shuffles leaves each lane the
// minima of a few consecutive pixels, which it stores. Min is exact, so
// any order gives the plain version's values (-0.0 and +0.0 compare
// equal).
//
// The design it replaced (a block of 128 threads a program, a thread a
// pixel, each live chunk staged into shared memory between two
// __syncthreads, six shared loads a test, 16 idle lanes) took 0.1325 ms at
// 2,048 programs x 8 live bits, 8.1 ns a live chunk, on an H100 80GB HBM3
// at 700 W (chip_smoke.py).
//
// Layout: mask (n_prog,) i32; setup (8, 8192) f32 row-major (fields 0..5
// used, chunks 0..31 reachable); out (n_prog, 112) f32.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kPix = 112;
constexpr int kFields = 6;
constexpr int kCols = 64 * kChunk;   // setup row length
constexpr int kWarps = 4;            // programs (one a warp) per block
constexpr int kPerLane = (kPix + 31) / 32;  // minima a lane stores
constexpr int kSlots = 32 * kPerLane;       // kPix padded with +inf

__device__ __forceinline__ void load_slice(const float* __restrict__ setup,
                                           int col, float (&f)[kFields]) {
#pragma unroll
  for (int i = 0; i < kFields; ++i) f[i] = __ldg(setup + i * kCols + col);
}

// One reduce-scatter step over lanes lane and lane ^ O: of the
// 2 * O * kPerLane minima a lane holds, it keeps the upper half if bit O of
// its lane is set, else the lower half, each the min with its partner's.
template <int O>
__device__ __forceinline__ void halve(float (&best)[kSlots], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O * kPerLane; ++i) {
    const float lo = best[i];
    const float hi = best[i + O * kPerLane];
    const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
    best[i] = fminf(up ? hi : lo, got);
  }
}

// The walk of one program: its kPix minima, stored to out_row.
__device__ __forceinline__ void walk(unsigned int m,
                                     const float* __restrict__ setup,
                                     float* __restrict__ out_row, int lane) {
  float best[kSlots];
#pragma unroll
  for (int p = 0; p < kSlots; ++p) best[p] = __int_as_float(0x7f800000);
  // the slices in walk order: each set bit from the lowest, then its 4
  // slices of 32 triangles; col is this lane's setup column, -1 = done
  int col = -1;
  float f[kFields], g[kFields] = {};
  if (m != 0u) {
    col = (__ffs(m) - 1) * kChunk + lane;
    m &= m - 1u;
    load_slice(setup, col, f);
  }
  while (col >= 0) {
    int next = -1;
    if ((col & 96) != 96) {
      next = col + 32;
    } else if (m != 0u) {
      next = (__ffs(m) - 1) * kChunk + lane;
      m &= m - 1u;
    }
    if (next >= 0) load_slice(setup, next, g);   // in flight during the tests
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float x = static_cast<float>(p);
      const float e0 = __fadd_rn(__fmul_rn(f[0], x), f[1]);
      const float e1 = __fadd_rn(__fmul_rn(f[2], x), f[3]);
      const float ez = __fadd_rn(__fmul_rn(f[4], x), f[5]);
      if (e0 >= 0.0f && e1 >= 0.0f && __fadd_rn(e0, e1) <= 1.0f) {
        best[p] = fminf(best[p], ez);
      }
    }
#pragma unroll
    for (int i = 0; i < kFields; ++i) f[i] = g[i];
    col = next;
  }
  // lane l ends with the minima of pixels kPerLane l + i
  halve<16>(best, lane);
  halve<8>(best, lane);
  halve<4>(best, lane);
  halve<2>(best, lane);
  halve<1>(best, lane);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int p = kPerLane * lane + i;
    if (p < kPix) out_row[p] = best[i];
  }
}

__global__ void __launch_bounds__(32 * kWarps)
ctz_walk_kernel(const int* __restrict__ mask, const float* __restrict__ setup,
                float* __restrict__ out, int n_prog) {
  const int prog = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (prog >= n_prog) return;   // whole warps: no barrier follows
  walk(static_cast<unsigned int>(mask[prog]), setup,
       out + static_cast<size_t>(prog) * kPix, threadIdx.x & 31);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int ctz_walk(const void* mask, const void* setup, void* out,
                        int n_prog, void* stream) {
  const int blocks = (n_prog + kWarps - 1) / kWarps;
  ctz_walk_kernel<<<blocks, 32 * kWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), static_cast<const float*>(setup),
      static_cast<float*>(out), n_prog);
  return static_cast<int>(cudaGetLastError());
}
