// Mamba-2's depthwise causal conv over the sequence, with its bias and SiLU,
// for Hopper (sm_90a): the served prefill's conv of every Mamba layer, from
// in_proj's output to the xBC the SSD reads.
//
// Replaces no TPU kernel: the JAX package's conv (repro/models/mamba2.py:
// _causal_conv) is plain tensor code, which XLA fuses into one loop.  The
// port's plain version (kernels/causal_conv.py:causal_conv_plain) runs on the
// card as a chain of full-size elementwise passes (the pad's copy, the zeros,
// a multiply and an add a tap, the bias, the SiLU), about 27 passes over the
// tensor with a bf16 temporary between each.
//
// What it computes, for x (b, L, ch) in bf16 read at any batch and position
// strides (in_proj's output, sliced in place), w (4, ch) and bias (ch,) in
// bf16, at every position t (pad positions included):
//   y[t] = silu(((((0 + x[t-3] w0) + x[t-2] w1) + x[t-1] w2) + x[t] w3) + bias),
// x before the row's first position read as zero, y written (b, L, ch)
// packed.  Every product and every sum is rounded to bf16, as the plain
// version's bf16 elementwise passes round each result (computed in f32):
// here they are bf16x2 instructions with round-to-nearest-even (mul.rn,
// add.rn), whose one rounding of the exact result is what the f32
// operation followed by a rounding to bf16 gives (a product of two bf16 is
// exact in f32; a sum of two is exact in f32 or off by far less than half
// a bf16 step).  The SiLU is computed in f32 as PyTorch computes it,
// x / (1 + expf(-x)), and rounded once.  So the kernel gives the plain
// version's numbers.
//
// Bound.  One read and one write of xBC: at the served widths (ch 20480,
// 8 x 4096 positions) 1.34 GB each way, 0.80 ms a layer at 3.35 TB/s.  The
// arithmetic is near that too: an element's SiLU takes two MUFU operations
// (ex2, rcp) at 16 a clock an SM, 0.36 ms a layer.  Rounding each f32 result
// to bf16 by conversion (F2F, 16 a clock an SM, nine an element) would take
// 1.6 ms, twice the bound: hence the bf16x2 arithmetic, two elements an
// instruction and no conversion.
//
// Design.  A thread owns 8 consecutive channels (one 16-byte load or store a
// position) and holds their 4 x 8 weights and 8 biases in registers, as
// bf16 pairs.  A CTA
// of 128 threads (1024 channels) walks a tile of 128 positions of one row,
// keeping the last three inputs in registers as a sliding window, so each
// input is read once, plus a 3-position halo a tile (which the tile before
// it has just brought into L2).  Loads go 4 positions at a time, before any
// of them is used: 64 bytes in flight a thread, at about 70 registers, so
// that many CTAs fit an SM (8 positions at a time took 88 registers and ran
// 6 % slower at the served shape).  Grid: (rows x position tiles, channel
// tiles).  No shared memory is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 4;      // the conv's taps
constexpr int kVec = 8;        // channels a thread: one 16-byte load or store
constexpr int kThreads = 128;  // a CTA: 1024 channels
constexpr int kTile = 128;     // positions a CTA walks
constexpr int kBatch = 4;      // positions loaded before any is used

struct ConvArgs {
  const __nv_bfloat16* x;     // (b, L, ch) at strides (x_bs, x_ts, 1)
  const __nv_bfloat16* w;     // (4, ch), packed
  const __nv_bfloat16* bias;  // (ch,)
  __nv_bfloat16* y;           // (b, L, ch), packed
  int64_t x_bs, x_ts;         // batch / position strides, elements
  int L, ch, tiles;           // tiles: position tiles a row
};

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& u, uint32_t (&v)[4]) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// two bf16 products and sums, each rounded once to nearest even (with the
// .rn modifier ptxas never fuses a mul and an add into an fma)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y at one position from its window x[t-3], x[t-2], x[t-1], x[t], rounded as
// the plain version rounds
__device__ __forceinline__ uint4 conv_silu(const uint32_t (&w)[kWidth][4],
                                           const uint32_t (&bias)[4], const uint4 (&win)[kWidth]) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    uint32_t v[4];
    unpack(win[i], v);
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] = add_bf16x2(acc[m], mul_bf16x2(v[m], w[i][m]));
  }
  uint32_t out[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t z = add_bf16x2(acc[m], bias[m]);
    out[m] = pack_bf16(silu(__uint_as_float(z << 16)), silu(__uint_as_float(z & 0xffff0000u)));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(kThreads) causal_conv_silu(ConvArgs a) {
  const int c0 = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  if (c0 >= a.ch) return;
  const int row = blockIdx.x / a.tiles;
  const int t0 = (blockIdx.x % a.tiles) * kTile, t1 = min(t0 + kTile, a.L);
  uint32_t w[kWidth][4], bias[4];
#pragma unroll
  for (int i = 0; i < kWidth; ++i)
    unpack(load16(a.w + static_cast<int64_t>(i) * a.ch + c0), w[i]);
  unpack(load16(a.bias + c0), bias);
  const __nv_bfloat16* xr = a.x + row * a.x_bs + c0;
  __nv_bfloat16* yr = a.y + static_cast<int64_t>(row) * a.L * a.ch + c0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 win[kWidth];  // x[t-3], x[t-2], x[t-1], x[t]
#pragma unroll
  for (int i = 0; i < kWidth - 1; ++i) {
    const int t = t0 - (kWidth - 1) + i;
    win[i] = t >= 0 ? load16(xr + t * a.x_ts) : zero;
  }
#pragma unroll 1
  for (int tb = t0; tb < t1; tb += kBatch) {
    uint4 in[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) in[j] = tb + j < t1 ? load16(xr + (tb + j) * a.x_ts) : zero;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      win[kWidth - 1] = in[j];
      if (tb + j < t1)
        *reinterpret_cast<uint4*>(yr + static_cast<int64_t>(tb + j) * a.ch) =
            conv_silu(w, bias, win);
#pragma unroll
      for (int i = 0; i < kWidth - 1; ++i) win[i] = win[i + 1];
    }
  }
}

}  // namespace

// One call's conv: width 4, ch a multiple of 8, every pointer and stride on a
// 16-byte boundary.  Returns 0, a CUDA error code, or -1 for a width or
// channel count the kernel does not take.
extern "C" int repro_conv(int width, const void* x, const void* w, const void* bias, void* y,
                          int64_t x_bs, int64_t x_ts, int b, int L, int ch, void* stream) {
  if (width != kWidth || ch % kVec) return -1;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.x_bs = x_bs;
  a.x_ts = x_ts;
  a.L = L;
  a.ch = ch;
  a.tiles = (L + kTile - 1) / kTile;
  const dim3 grid(b * a.tiles, (ch / kVec + kThreads - 1) / kThreads);
  causal_conv_silu<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
