// DECA's detail decoder for Hopper (sm_90a): each of its five
// "Upsample(x2, bilinear) -> Conv2d(3x3, pad 1) -> LeakyReLU(0.2)" layers
// as one kernel (upconv), and its last "Conv2d(16 -> 1, 3x3, pad 1) ->
// Tanh -> x 0.01" as another (outconv).
//
// Replaces no TPU kernel: the JAX package has no DECA path. It was added
// because, done eagerly, PyTorch's NCHW upsample_bilinear2d held 64% of
// the detail cell's busy time (36.9 of 57.4 ms a microbatch of 256), and
// cuDNN's convolutions, their NCHW<->NHWC transposes and the separate
// bias and LeakyReLU passes most of the rest: the upsampled tensors were
// written to memory and read back (3.66 GB a microbatch).
//
// upconv: y = LeakyReLU(conv3x3_pad1(upsample_bilinear_x2(x)) + b), x
// (B, s, s, Cin) and y (B, 2s, 2s, Cout), NHWC float32, as an implicit
// GEMM on the TF32 tensor cores (mma.sync m16n8k8, float32 accumulation):
// M = output pixels, N = Cout, K = 9 Cin. A block takes one image, a
// TH x TW tile of output pixels and NB output channels; each of its 8
// warps a strip of MF rows x 16 pixels by NF x 8 channels. For each
// chunk of 16 input channels it copies (cp.async) the low-res patch
// under the tile, (TH/2 + 2) x (TW/2 + 2) pixels at source coordinates
// clamped to [0, s - 1], and the chunk's weights into shared memory, then
// builds the upsampled (TH + 2) x (TW + 2) patch there, rounded to TF32
// (cvt.rna): zero outside [0, 2s), the convolution's padding of the
// upsampled image; else PyTorch's value, h0 (w0 x00 + w1 x01) +
// h1 (w0 x10 + w1 x11) with its weights and in its order (-fmad=false
// keeps the order; `weights` gives the weights, and each column's two
// horizontal blends serve the two patch rows that share them). While the
// next chunk's patch lands, the nine taps read shifted windows of this
// one: for each column shift, each of a strip's MF + 2 patch rows is
// loaded once and serves the up to three row taps that read it. K is
// permuted inside each pair of k-steps (channels 4t, 4t+1 in the first,
// 4t+2, 4t+3 in the second, for thread t of a quad) so that a thread's
// A and B fragments for both come from one 16-byte load; rows of 16
// floats make those loads conflict-free. The epilogue pairs the lanes of
// a quad so that each holds four channels of one pixel, adds the bias,
// applies LeakyReLU and writes them with one 16-byte store: y is written
// once and nothing upsampled reaches device memory.
//
// outconv: uv_z = tanh(conv3x3_pad1(x) + b) x scale, x (B, S, S, 16)
// NHWC, uv_z (B, S, S); a 32 x 16 tile staged with its halo in shared
// memory, two output rows a thread (each staged row read once for both),
// float32 on the CUDA cores (cuDNN's own choice for this 16 -> 1 layer is
// a direct float32 kernel).
//
// Bound on this card: at 256 faces the five layers need 449 GFLOP and,
// each input read once and each output written once, 2.9 GB; layer by
// layer the larger of FLOPs at the dense TF32 peak (494.5e12/s) and
// bytes at 3.35e12 B/s sums to 1.07 ms, and outconv's 1.14 GB to 0.34
// ms: 1.41 ms in all. The layers sit near the TF32 ridge (147 FLOP a
// byte): the first four by FLOPs, the last (32 -> 16, 1.07 GB written)
// by bytes. What binds this design is shared memory: mma.sync takes its
// operands from registers, so every A fragment (16 pixels x 8 channels,
// 512 B) is loaded from the patch for the NF = 2 channel fragments that
// use it, about one cycle of shared-memory bandwidth a tensor-core MMA,
// and the patch's build adds a third or more; two blocks an SM (128
// registers a thread) hide the latency between the phases.
//
// Layout (row-major, contiguous): x (B, s, s, Cin), w (9, Cout, Cin) by
// tap (ky * 3 + kx), b (Cout,), y (B, 2s, 2s, Cout) f32; outconv's w
// (9, 16) by tap, b (1,), uv_z (B, S, S) f32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;  // input channels a chunk: one row of a tile

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.0f ? v : __fmul_rn(v, slope);
}

// The weights (l0, l1) of an upsampled row (column) d of an image 2n
// wide over its two source rows (columns): PyTorch's
// upsample_bilinear2d at scale 0.5, align_corners=False, takes source
// max(0, (d + 0.5) / 2 - 0.5), so row 0 is (1, 0), an odd row 2i + 1
// (0.75, 0.25) over rows i and min(i + 1, n - 1), an even row 2i > 0
// (0.25, 0.75) over rows i - 1 and i; (0, 0) marks a row outside
// [0, 2n), the convolution's zero padding.
struct Lerp {
  float l0, l1;
};

__device__ __forceinline__ Lerp weights(int d, int size) {
  if (d < 0 || d >= size) return {0.0f, 0.0f};
  if (d == 0) return {1.0f, 0.0f};
  return (d & 1) ? Lerp{0.75f, 0.25f} : Lerp{0.25f, 0.75f};
}

// l0 a + l1 b, channel by channel, as PyTorch's upsample_bilinear2d
// computes each of its three blends
__device__ __forceinline__ float4 lerp4(Lerp w, float4 a, float4 b) {
  return make_float4(
      __fadd_rn(__fmul_rn(w.l0, a.x), __fmul_rn(w.l1, b.x)),
      __fadd_rn(__fmul_rn(w.l0, a.y), __fmul_rn(w.l1, b.y)),
      __fadd_rn(__fmul_rn(w.l0, a.z), __fmul_rn(w.l1, b.z)),
      __fadd_rn(__fmul_rn(w.l0, a.w), __fmul_rn(w.l1, b.w)));
}

__device__ __forceinline__ uint4 tf32x4(float4 v) {
  return make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
}

template <int WY, int WX, int WN, int MF, int NF>
struct Tile {
  static constexpr int kTH = WY * MF, kTW = WX * 16, kNB = WN * NF * 8;
  static constexpr int kXH = kTH / 2 + 2, kXW = kTW / 2 + 2;
  static constexpr int kUH = kTH + 2, kUW = kTW + 2;
  static constexpr int kX = kXH * kXW * kKC;  // low-res patch, floats
  static constexpr int kW = 9 * kNB * kKC;    // weights
  static constexpr int kU = kUH * kUW * kKC;  // upsampled patch
  static constexpr int kSmem = (kX + kW + kU) * 4;
};

template <int CIN, int COUT, int WY, int WX, int WN, int MF, int NF>
__global__ void __launch_bounds__(kThreads, 2)
upconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int s,
              float slope) {
  using T = Tile<WY, WX, WN, MF, NF>;
  constexpr int TH = T::kTH, TW = T::kTW, NB = T::kNB;
  static_assert(WY * WX * WN == kWarps, "one warp a strip and slice");
  static_assert(COUT % NB == 0 && CIN % kKC == 0, "shapes");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + T::kX;
  uint32_t* us = reinterpret_cast<uint32_t*>(smem + T::kX + T::kW);

  const int size = 2 * s;
  const int tiles_x = (size + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_x) * TH;
  const int ox0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int ly0 = oy0 / 2 - 1;
  const int lx0 = ox0 / 2 - 1;
  const float* xb = x + static_cast<size_t>(b) * s * s * CIN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = tid >> 5;
  const int wn = warp % WN;
  const int wx = (warp / WN) % WX;
  const int wy = warp / (WN * WX);

  // the warp's strip: MF patch rows from wy * MF, 16 pixels from
  // wx * 16; row g of its fragments at tap (0, 0)
  const int a_off = ((wy * MF) * T::kUW + wx * 16 + g) * kKC + 4 * t;
  const int b_off = (wn * NF * 8 + g) * kKC + 4 * t;

  float acc[MF][NF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] = 0.0f;

  // the chunk of input channels from c0: the low-res patch (source
  // coordinates clamped) and the weights, copied as they are
  auto stage_x = [&](int c0) {
    for (int i = tid; i < T::kXH * T::kXW * 4; i += kThreads) {
      const int pix = i >> 2;
      const int ly = min(max(ly0 + pix / T::kXW, 0), s - 1);
      const int lx = min(max(lx0 + pix % T::kXW, 0), s - 1);
      copy16(xs + 4 * i, xb + (static_cast<size_t>(ly) * s + lx) * CIN + c0
                             + 4 * (i & 3));
    }
  };
  auto stage_w = [&](int c0) {
    for (int i = tid; i < 9 * NB * 4; i += kThreads) {
      const int row = i >> 2;  // tap * NB + channel
      copy16(ws + 4 * i, w + (static_cast<size_t>(row / NB) * COUT + n0
                              + row % NB) * CIN + c0 + 4 * (i & 3));
    }
  };
  stage_x(0);
  stage_w(0);
  copies_commit();

  for (int c0 = 0; c0 < CIN; c0 += kKC) {
    copies_wait();
    __syncthreads();
    // patch row (column) 2k or 2k + 1 blends low-res patch rows
    // (columns) k and k + 1: the source rows of its image row, or, where
    // PyTorch's second one is the first clamped (the image's last row)
    // or carries weight 0 (its row 0), the clamped copy that holds the
    // same value. Each column's two horizontal blends serve both rows.
#pragma unroll 2
    for (int i = tid; i < (T::kXH - 1) * T::kUW * 4; i += kThreads) {
      const int col = (i >> 2) % T::kUW;
      const int k = (i >> 2) / T::kUW;
      const Lerp v = weights(ox0 - 1 + col, size);
      const Lerp h0 = weights(oy0 - 1 + 2 * k, size);
      const Lerp h1 = weights(oy0 + 2 * k, size);
      uint4 ra = make_uint4(0u, 0u, 0u, 0u);
      uint4 rb = ra;
      if (v.l0 != 0.0f) {
        const float4* x4 = reinterpret_cast<const float4*>(xs) + (i & 3)
                           + (k * T::kXW + (col >> 1)) * 4;
        const float4 p = lerp4(v, x4[0], x4[4]);
        const float4 q = lerp4(v, x4[T::kXW * 4], x4[T::kXW * 4 + 4]);
        if (h0.l0 != 0.0f) ra = tf32x4(lerp4(h0, p, q));
        if (h1.l0 != 0.0f) rb = tf32x4(lerp4(h1, p, q));
      }
      uint4* u4 = reinterpret_cast<uint4*>(us) + (i & 3);
      u4[(2 * k * T::kUW + col) * 4] = ra;
      u4[((2 * k + 1) * T::kUW + col) * 4] = rb;
    }
    __syncthreads();
    if (c0 + kKC < CIN) {  // the next chunk's patch lands during the MMAs
      stage_x(c0 + kKC);
      copies_commit();
    }
    // tap (dy, dx) of output row f reads patch row f + dy: for each dx,
    // each of the strip's MF + 2 patch rows is loaded once and serves
    // the (up to) three taps that read it
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint4 bq[3][NF];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int j = 0; j < NF; ++j)
          bq[dy][j] = tf32x4(*reinterpret_cast<const float4*>(
              ws + (dy * 3 + dx) * NB * kKC + b_off + j * 8 * kKC));
#pragma unroll
      for (int r = 0; r < MF + 2; ++r) {
        const uint32_t* a = us + a_off + (r * T::kUW + dx) * kKC;
        const uint4 lo = *reinterpret_cast<const uint4*>(a);
        const uint4 hi = *reinterpret_cast<const uint4*>(a + 8 * kKC);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int f = r - dy;
          if (f < 0 || f >= MF) continue;
#pragma unroll
          for (int j = 0; j < NF; ++j)
            mma(acc[f][j], lo.x, hi.x, lo.y, hi.y, bq[dy][j].x, bq[dy][j].y);
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int f = r - dy;
          if (f < 0 || f >= MF) continue;
#pragma unroll
          for (int j = 0; j < NF; ++j)
            mma(acc[f][j], lo.z, hi.z, lo.w, hi.w, bq[dy][j].z, bq[dy][j].w);
        }
      }
    }
    __syncthreads();
    if (c0 + kKC < CIN) {  // the weights are free again
      stage_w(c0 + kKC);
      copies_commit();
    }
  }

  // lanes t and t ^ 1 trade halves: an even lane then holds channels
  // 2t .. 2t + 3 of row g, an odd one those of row g + 8
  const bool odd = t & 1;
  float* yb = y + static_cast<size_t>(b) * size * size * COUT;
  const int ox = ox0 + wx * 16 + g + (odd ? 8 : 0);
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int oy = oy0 + wy * MF + f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float c0 = acc[f][j][0], c1 = acc[f][j][1];
      const float c2 = acc[f][j][2], c3 = acc[f][j][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c0 : c2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c1 : c3, 1);
      float4 v = odd ? make_float4(r0, r1, c2, c3)
                     : make_float4(c0, c1, r0, r1);
      const int ch = n0 + (wn * NF + j) * 8 + (t & 2) * 2;
      const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + ch));
      v = make_float4(leaky(__fadd_rn(v.x, bb.x), slope),
                      leaky(__fadd_rn(v.y, bb.y), slope),
                      leaky(__fadd_rn(v.z, bb.z), slope),
                      leaky(__fadd_rn(v.w, bb.w), slope));
      if (oy < size && ox < size) {
        *reinterpret_cast<float4*>(
            yb + (static_cast<size_t>(oy) * size + ox) * COUT + ch) = v;
      }
    }
  }
}

template <int CIN, int COUT, int WY, int WX, int WN, int MF, int NF>
int run(const float* x, const float* w, const float* b, float* y, int batch,
        int s, float slope, cudaStream_t stream) {
  using T = Tile<WY, WX, WN, MF, NF>;
  auto kernel = upconv_kernel<CIN, COUT, WY, WX, WN, MF, NF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = 2 * s;
  const dim3 grid(((size + T::kTH - 1) / T::kTH)
                  * ((size + T::kTW - 1) / T::kTW), COUT / T::kNB, batch);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(x, w, b, y, s, slope);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kOutW = 32;   // outconv's tile: 32 x 16 pixels, two rows
constexpr int kOutH = 16;   // a thread
constexpr int kOutC = 16;   // its input channels
constexpr int kOutP = 20;   // floats a staged pixel: conflict-free rows
constexpr int kOutSmem = ((kOutH + 2) * (kOutW + 2) * kOutP + 9 * kOutC) * 4;

__global__ void __launch_bounds__(kThreads)
outconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int size, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + (kOutH + 2) * (kOutW + 2) * kOutP;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kOutH;
  const int ox0 = blockIdx.x * kOutW;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * size * size * kOutC;
  for (int i = tid; i < 9 * kOutC; i += kThreads) ws[i] = w[i];
  for (int i = tid; i < (kOutH + 2) * (kOutW + 2) * 4; i += kThreads) {
    const int pix = i >> 2;
    const int yy = oy0 - 1 + pix / (kOutW + 2);
    const int xx = ox0 - 1 + pix % (kOutW + 2);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (yy >= 0 && yy < size && xx >= 0 && xx < size) {
      v = __ldg(reinterpret_cast<const float4*>(
          xb + (static_cast<size_t>(yy) * size + xx) * kOutC) + (i & 3));
    }
    *reinterpret_cast<float4*>(xs + pix * kOutP + (i & 3) * 4) = v;
  }
  __syncthreads();
  // output rows 2 ty and 2 ty + 1 of column tx: staged row r serves the
  // first as tap row r and the second as tap row r - 1, each summed in
  // tap order
  const int ty = tid / kOutW;
  const int tx = tid % kOutW;
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* px = xs + ((2 * ty + r) * (kOutW + 2) + tx + dx) * kOutP;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(px + 4 * q);
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int dy = r - o;
          if (dy < 0 || dy > 2) continue;
          const float* wq = ws + (dy * 3 + dx) * kOutC + 4 * q;
          acc[o] = __fadd_rn(acc[o], __fmul_rn(v.x, wq[0]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(v.y, wq[1]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(v.z, wq[2]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(v.w, wq[3]));
        }
      }
    }
  }
  const int ox = ox0 + tx;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int oy = oy0 + 2 * ty + o;
    if (oy < size && ox < size) {
      out[(static_cast<size_t>(b) * size + oy) * size + ox] =
          __fmul_rn(tanhf(__fadd_rn(acc[o], bias[0])), scale);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a (cin, cout) pair with no tiling: the
// wrapper, models/deca_detail.py, names the five it takes). The tiles
// follow the layer's widths: 16 x 16 pixels and 64 channels a block where
// Cout >= 64, 16 x 32 pixels and all 32 channels at 64 -> 32, 32 x 32
// and all 16 at 32 -> 16 (the upsampled patch then takes most of the
// shared memory two blocks an SM can have).
extern "C" int upconv(const void* x, const void* w, const void* b, void* y,
                      int batch, int s, int cin, int cout, float slope,
                      void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin == 128 && cout == 128)
    return run<128, 128, 2, 1, 4, 8, 2>(xp, wp, bp, yp, batch, s, slope, st);
  if (cin == 128 && cout == 64)
    return run<128, 64, 2, 1, 4, 8, 2>(xp, wp, bp, yp, batch, s, slope, st);
  if (cin == 64 && cout == 64)
    return run<64, 64, 2, 1, 4, 8, 2>(xp, wp, bp, yp, batch, s, slope, st);
  if (cin == 64 && cout == 32)
    return run<64, 32, 2, 2, 2, 8, 2>(xp, wp, bp, yp, batch, s, slope, st);
  if (cin == 32 && cout == 16)
    return run<32, 16, 4, 2, 1, 8, 2>(xp, wp, bp, yp, batch, s, slope, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int outconv(const void* x, const void* w, const void* b, void* out,
                       int batch, int size, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      outconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((size + kOutW - 1) / kOutW, (size + kOutH - 1) / kOutH,
                  batch);
  outconv_kernel<<<grid, kThreads, kOutSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), size, scale);
  return static_cast<int>(cudaGetLastError());
}
