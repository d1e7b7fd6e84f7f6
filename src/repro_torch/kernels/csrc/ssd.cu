// The chunked SSD of Mamba-2 (arXiv:2405.21060, Listing 1) for Hopper
// (sm_90a): the served prefill's scan of every Mamba layer, from the raw dt
// to y with its D skip, and the state each row ends in.
//
// Replaces no TPU kernel: the JAX package's SSD (repro/models/mamba2.py:
// ssd_chunked) is plain tensor code, and so was the port's
// (kernels/ssd.py:ssd_chunked, the plain version of this file).  It was
// added because that code, run as f32 einsums on the card, spent its time
// in elementwise passes over per-head (q, q) decay blocks, in f32 SIMT
// products, and in a host loop over the chunks.
//
// What it computes, for x (b, L, h, 64), dt_raw (b, L, h), B and C (b, L, g, n)
// in bf16 (head k reads group k / (h / g)), dt_bias, A and D (h,) in f32 and
// each row's valid length:
//   dt    = softplus(dt_raw + dt_bias), 0 at and past the row's length;
//   dA_cs = the cumulative sum of dt * A within each chunk of Q positions;
//   y     = (C B^T o L o dt_j) x  +  exp(dA_cs_i) C state_entering^T  +  D x,
//           rounded once to bf16, with L[i, j] = exp(dA_cs_i - dA_cs_j) for
//           j <= i and 0 above (masked before the exponential);
//   S_c   = sum_j B_j (x) x_j dt_j exp(dA_cs_last - dA_cs_j), each chunk's state;
//   state_entering(c + 1) = state_entering(c) exp(dA_cs_last(c)) + S_c, the
//           final state written (b, h, 64, n) in f32.
// A length the chunk does not divide reads zeros past L, with dt = 0 there.
//
// Bound.  At the served widths (h 256, p 64, g 8, n 256, Q 128) a position
// costs about 2 (Q/2 (g n + h p) + 2 h p n) = 1.9e7 operations against about
// 72 KB of bf16 traffic (x, B, C, dt and y), 265 a byte, near the card's
// bf16 ridge (about 295): the benchmark's bound (ssd_bound_s: the operations
// at the bf16 peak, the bytes at HBM's) is 0.59 ms a layer at the served
// batch (8 x 4096), set by the bytes.  This kernel's products run in TF32,
// at half the bf16 rate, and the split below doubles those with an operand
// formed in f32, so its own floor is the products: about 1.3e12 TF32
// operations a layer there, 2.7 ms at the 495 TFLOP/s peak; the entering
// states add 4.3 GB written and read (2.6 ms at 3.35 TB/s).
// Precision: the einsums this replaces ran in true f32 (TF32 off).  Here the
// bf16 operands (x, B, C) enter the tensor cores exactly, as TF32 (and as
// bf16 for C B^T); every operand formed in f32 inside the kernel (the
// decayed, dt-scaled scores, x scaled by dt and its decay, the entering
// state) enters split into a high and a low TF32 part, hi = a with its low
// 13 mantissa bits cleared and lo = the remainder so cleared, two wgmma
// into one f32 accumulator: about 22 bits of each operand are kept.  The
// decays, cumulative sums, dt, the states and every accumulation stay f32;
// only y is rounded to bf16, once.
//
// Design, three kernels in order on one stream, each one warpgroup (128
// threads):
//   ssd_chunk_prep  (Q/64, chunks, b*g): C_i B_j^T of a group's chunk for 64
//     rows i, bf16 wgmma (m64 nQ k16) from C and B staged by cp.async in
//     the no-swizzle core-matrix layout, written f32 (b, chunks, g, Q, Q);
//     the first CTA of each (row, chunk, group) also computes dt and dA_cs
//     for the group's heads (a warp a head: softplus, the length mask, a
//     warp scan), written f32 (b, chunks, h, Q).
//   ssd_chunk_state (n/NT, h, b): the walk over chunks, a loop inside the
//     kernel.  A CTA carries NT columns of one head's state (64 x NT) in
//     its accumulator registers: each chunk it writes them out as the
//     state entering the chunk (f32, b, chunks, h, 64, n), scales them by
//     the chunk's decay and accumulates (x dt decay)^T (64 x Q) B (Q x NT)
//     onto them, B^T staged as TF32 and the f32-formed A operand built in
//     registers from x (copied by cp.async a chunk ahead) and the decays,
//     and split; after the last chunk they are the final state.
//   ssd_chunk_scan  (Q/64, chunks, b*h): y for 64 positions of one head:
//     y_off^T (64 x 64) = state_entering (A: split, from device memory) C^T
//     (B: TF32, staged), y_diag (64 x 64) = scores (A: split, formed in
//     registers from C B^T, the decays and dt, causal blocks only) x (B:
//     x^T as TF32, staged); both meet in shared memory, where D x is added,
//     and y leaves as bf16 in 16-byte stores.
// Every TF32 product takes A from registers and B from shared memory, K-major
// in the no-swizzle core-matrix layout (8 rows x 16 bytes a core matrix).
// Each 8-deep k step is permuted: its first core matrix holds the even k
// (0, 2, 4, 6), the second the odd ones, so the A fragment's columns t and
// t + 4 are the adjacent k = 2t and 2t + 1, which a thread loads as one
// float2 (from device memory) or computes side by side.  The (q, q) decay
// blocks and f32 copies of x, B and C never reach device memory; the states
// entering the chunks do (4.3 GB a layer at the served batch, written once
// by the walk and read once by the scan).
// Left for later work: keeping the entering states out of device memory in
// a single pass, and TMA loads with a producer warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;            // head dim: the M of the state products
constexpr int kThreads = 128;     // one warpgroup
constexpr int kXPitch = kP + 8;   // bf16 row pitch of a staged x tile (conflict-free reads)
constexpr int kYPitch = kP + 4;   // f32 row pitch of the output tile
constexpr int kBatch = 8;         // k steps between two waits of a main loop
constexpr uint32_t kTf32Mask = 0xffffe000u;

struct SsdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dt_raw;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* dt_bias;
  const float* A;
  const float* D;
  const int* valid_len;  // (b,) or null: every position real
  __nv_bfloat16* y;      // (b, L, h, 64), contiguous
  float* state;          // (b, h, 64, n), the final state
  float* dt;             // (b, chunks, h, Q) scratch
  float* dacs;           // (b, chunks, h, Q) scratch
  float* cb;             // (b, chunks, g, Q, Q) scratch
  float* S;              // (b, chunks, h, 64, n) scratch: the state entering each chunk
  int64_t x_bs, x_ts, dt_bs, dt_ts, b_bs, b_ts, c_bs, c_ts;  // batch / token strides, elements
  int b, L, h, g, chunks;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// brings bytes (a multiple of 16, from a 16-byte boundary) into L2, asynchronously
__device__ __forceinline__ void prefetch_l2(const void* gmem, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// st.shared and cp.async write through the generic proxy; wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins a register between two asm statements: the compiler neither reads an
// accumulator before wgmma.wait nor reuses an operand register while a
// wgmma that reads it is in flight
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two core matrices of a k step) and stride byte
// offset (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

#define R8(b)                                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D (64 x N, f32) += A (64 x 8, TF32 registers) * B (8 x N, TF32 shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
// D (64 x N, f32) += A (64 x 16) * B (16 x N), bf16, both shared and K-major
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1));
}


#undef R8

// bf16 halves of a 32-bit word, exactly as f32 (and so as TF32)
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Float offset of core matrix cm of row r in a TF32 tile kd elements deep:
// 8-row groups of kd / 4 core matrices, each 8 rows x 16 bytes.
__device__ __forceinline__ int tf32_at(int r, int cm, int kd) {
  return (((r >> 3) * (kd >> 2) + cm) * 8 + (r & 7)) * 4;
}

// a = hi + lo: hi keeps a's top 10 mantissa bits, lo the next ones (TF32 each)
__device__ __forceinline__ void split_tf32(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t h = __float_as_uint(v[i]) & kTf32Mask;
    hi[i] = h;
    lo[i] = __float_as_uint(v[i] - __uint_as_float(h)) & kTf32Mask;
  }
}

// Step s0 .. s0 + kBatch - 1's raw A values: load(s, v) for each
template <class Load>
__device__ __forceinline__ void load_batch(float (&raw)[kBatch][4], int s0, Load load) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) load(s0 + u, raw[u]);
}

// D (64 x NB) += A B over nbatch batches of kBatch 8-deep k steps.  Step s's
// A fragment (rows g, g + 8; permuted columns 2t, 2t + 1) is load(s, v) then
// form(s, v), split into TF32 hi and lo, each multiplied with B's step s at
// desc(s).  raw holds the first batch's loads on entry (the caller issues
// them as early as it can); the next batch's loads are issued before this
// batch's products, so they arrive while the tensor cores work.  The
// fragments stay pinned until the products that read them have completed.
template <int NB, class Load, class Form, class Desc>
__device__ __forceinline__ void split_products(float (&d)[NB / 2], int nbatch, float (&raw)[kBatch][4],
                                               Load load, Form form, Desc desc) {
  for (int bi = 0; bi < nbatch; ++bi) {
    uint32_t hi[kBatch][4], lo[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      form(bi * kBatch + u, raw[u]);
      split_tf32(raw[u], hi[u], lo[u]);
    }
    if (bi + 1 < nbatch) load_batch(raw, (bi + 1) * kBatch, load);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) fence_operand(d[i]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const uint64_t db = desc(bi * kBatch + u);
      wgmma_tf32<NB>(d, hi[u], db);
      wgmma_tf32<NB>(d, lo[u], db);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_operand(hi[u][i]);
        fence_operand(lo[u][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) fence_operand(d[i]);
  }
}

// -- ssd_chunk_prep: C B^T by group, dt and dA_cs by head ---------------------------

// rows [pos0, pos0 + rows) of N bf16 each into the core-matrix layout
// (element (r, c) in 16-byte unit (r / 8) * (N / 8) * 8 + (c / 8) * 8 + r % 8),
// zeros at and past L
template <int N>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int64_t ts, int pos0, int rows, int L, int tid) {
  constexpr int NC = N / 8;
  for (int e = tid; e < rows * NC; e += kThreads) {
    const int r = (e / (8 * NC)) * 8 + (e & 7), c = (e >> 3) % NC;
    const int pos = pos0 + r;
    const bool in = pos < L;
    cp_async16(dst + 8 * e, src + static_cast<int64_t>(in ? pos : 0) * ts + 8 * c, in ? 16 : 0);
  }
}

// dt and dA_cs of a chunk for the group's heads, a warp a head: lane l holds
// positions l * Q / 32 .. (l + 1) * Q / 32 - 1 and the warp scans its sums
template <int Q>
__device__ __forceinline__ void prep_dt(const SsdArgs& a, int bb, int ch, int gi, int tid) {
  constexpr int PER = Q / 32;
  const int warp = tid >> 5, lane = tid & 31, r = a.h / a.g;
  const int vlen = a.valid_len ? min(a.valid_len[bb], a.L) : a.L;
  for (int hh = warp; hh < r; hh += kThreads / 32) {
    const int k = gi * r + hh;
    const float bias = a.dt_bias[k], Ak = a.A[k];
    float dtv[PER], cs[PER], run = 0.0f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int pos = ch * Q + lane * PER + u;
      float v = 0.0f;
      if (pos < vlen) {
        v = __bfloat162float(a.dt_raw[bb * a.dt_bs + pos * a.dt_ts + k]) + bias;
        v = v > 20.0f ? v : log1pf(expf(v));  // softplus, threshold 20 as torch's
      }
      dtv[u] = v;
      run += v * Ak;
      cs[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.0f;
    const int64_t base = ((static_cast<int64_t>(bb) * a.chunks + ch) * a.h + k) * Q + lane * PER;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      a.dt[base + u] = dtv[u];
      a.dacs[base + u] = before + cs[u];
    }
  }
}

// One CTA: 64 rows i of a group's chunk against its Q positions j.
template <int Q, int N>
__global__ void __launch_bounds__(kThreads) ssd_chunk_prep(const SsdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][N]
  __nv_bfloat16* Bs = Cs + 64 * N;                                  // [Q][N]
  const int w = blockIdx.x, ch = blockIdx.y, bb = blockIdx.z / a.g, gi = blockIdx.z % a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_rows_bf16<N>(Cs, a.C + bb * a.c_bs + gi * N, a.c_ts, ch * Q + 64 * w, 64, a.L, tid);
  load_rows_bf16<N>(Bs, a.B + bb * a.b_bs + gi * N, a.b_ts, ch * Q, Q, a.L, tid);
  cp_async_commit();
  if (w == 0) prep_dt<Q>(a, bb, ch, gi, tid);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  float acc[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) fence_operand(acc[i]);
  wgmma_fence();
  const uint32_t ca = smem_u32(Cs), ba = smem_u32(Bs);
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
    wgmma_bf16<Q>(acc, make_desc(ca + ks * 256, 128, N * 16), make_desc(ba + ks * 256, 128, N * 16));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) fence_operand(acc[i]);

  float* out = a.cb + (((static_cast<int64_t>(bb) * a.chunks + ch) * a.g + gi) * Q + 64 * w) * Q;
  const int row = 16 * warp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < Q / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + (row + 8 * hf) * Q + 8 * j + col) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// -- ssd_chunk_state: the walk over chunks, each head's states --------------------

// Q positions of one head's x (64 bf16 a position), rows kXPitch apart; zeros past L
template <int Q>
__device__ __forceinline__ void load_x(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t ts,
                                       int pos0, int L, int tid) {
  for (int e = tid; e < Q * 8; e += kThreads) {
    const int j = e >> 3, c = e & 7, pos = pos0 + j;
    const bool in = pos < L;
    cp_async16(dst + j * kXPitch + 8 * c, src + static_cast<int64_t>(in ? pos : 0) * ts + 8 * c,
               in ? 16 : 0);
  }
}

// B^T of a chunk for NT state columns, as TF32: rows n, Q deep (k = position),
// each k step's even positions in its first core matrix, odd in its second.
// Every load is issued before the first store, so their latencies overlap.
template <int Q, int NT>
__device__ __forceinline__ void stage_bt(float* dst, const __nv_bfloat16* src, int64_t ts, int pos0,
                                         int L, int tid) {
  constexpr int kItems = (NT / 2) * (Q / 8) / kThreads;
  uint32_t v[kItems][8];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, np = e % (NT / 2), s = e / (NT / 2);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int pos = pos0 + 8 * s + jj;
      v[it][jj] = pos < L ? __ldg(reinterpret_cast<const unsigned int*>(
                                src + static_cast<int64_t>(pos) * ts + 2 * np))
                          : 0u;
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, np = e % (NT / 2), s = e / (NT / 2);
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const uint32_t* w = v[it] + odd;
      *reinterpret_cast<float4*>(dst + tf32_at(2 * np, 2 * s + odd, Q)) =
          make_float4(bf16_lo(w[0]), bf16_lo(w[2]), bf16_lo(w[4]), bf16_lo(w[6]));
      *reinterpret_cast<float4*>(dst + tf32_at(2 * np + 1, 2 * s + odd, Q)) =
          make_float4(bf16_hi(w[0]), bf16_hi(w[2]), bf16_hi(w[4]), bf16_hi(w[6]));
    }
  }
}

// One CTA: NT state columns of one head, walking the chunks in order.  The
// state stays in the accumulator registers: each chunk, it is written out as
// the state entering the chunk, scaled by the chunk's decay, and the chunk's
// (x dt decay)^T B is accumulated onto it; the last is the final state.
template <int Q, int N, int NT>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(const SsdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Bt = reinterpret_cast<float*>(smem_raw);                     // [NT][Q], TF32
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(Bt + NT * Q);  // [2][Q][kXPitch]
  float* Ws = reinterpret_cast<float*>(Xs + 2 * Q * kXPitch);         // [Q]
  const int nt = blockIdx.x, k = blockIdx.y, bb = blockIdx.z, gi = k / (a.h / a.g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int p0 = 16 * warp + (lane >> 2);  // this thread's state rows p0 and p0 + 8
  const __nv_bfloat16* xk = a.x + bb * a.x_bs + k * kP;
  const __nv_bfloat16* bg = a.B + bb * a.b_bs + gi * N + nt * NT;
  const int64_t head = static_cast<int64_t>(bb) * a.chunks * a.h + k;  // (bb, chunk 0, k)
  const uint32_t bt = smem_u32(Bt);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  load_x<Q>(Xs, xk, a.x_ts, 0, a.L, tid);
  cp_async_commit();

  for (int ch = 0; ch < a.chunks; ++ch) {
    const __nv_bfloat16* xs = Xs + (ch & 1) * Q * kXPitch;
    const int64_t hc = head + static_cast<int64_t>(ch) * a.h;  // (bb, ch, k)
    __syncthreads();  // chunk ch - 1 is done with Bt, Ws and the other x buffer
    if (ch + 1 < a.chunks)
      load_x<Q>(Xs + ((ch + 1) & 1) * Q * kXPitch, xk, a.x_ts, (ch + 1) * Q, a.L, tid);
    cp_async_commit();
    const float* dacs = a.dacs + hc * Q;
    constexpr int kPer = Q / kThreads;  // positions whose weight this thread forms
    float dt_j[kPer], dacs_j[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      dt_j[u] = a.dt[hc * Q + tid + u * kThreads];
      dacs_j[u] = dacs[tid + u * kThreads];
    }
    const float last = dacs[Q - 1], decay = expf(last);
    stage_bt<Q, NT>(Bt, bg, a.b_ts, ch * Q, a.L, tid);
    // the state entering chunk ch, then its decay over the chunk
    float* out = a.S + hc * kP * N + nt * NT;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* o = out + (p0 + 8 * hf) * N + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        acc[4 * j + 2 * hf] *= decay;
        acc[4 * j + 2 * hf + 1] *= decay;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) Ws[tid + u * kThreads] = dt_j[u] * expf(last - dacs_j[u]);
    cp_async_wait_1();  // chunk ch's x has landed (chunk ch + 1's may be in flight)
    fence_proxy_async();
    __syncthreads();
    // A = (x dt decay)^T: rows p, k = position
    const auto load = [&](int s, float (&v)[4]) {
      const __nv_bfloat16* r0 = xs + (8 * s + 2 * t) * kXPitch + p0;
      v[0] = __bfloat162float(r0[0]);
      v[1] = __bfloat162float(r0[8]);
      v[2] = __bfloat162float(r0[kXPitch]);
      v[3] = __bfloat162float(r0[kXPitch + 8]);
    };
    float raw[kBatch][4];
    load_batch(raw, 0, load);
    split_products<NT>(
        acc, Q / (8 * kBatch), raw, load,
        [&](int s, float (&v)[4]) {
          const float2 wj = *reinterpret_cast<const float2*>(Ws + 8 * s + 2 * t);
          v[0] *= wj.x;
          v[1] *= wj.x;
          v[2] *= wj.y;
          v[3] *= wj.y;
        },
        [&](int s) { return make_desc(bt + s * 256, 128, 32 * Q); });
  }
  cp_async_wait_all();
  float* fin = a.state + (static_cast<int64_t>(bb) * a.h + k) * kP * N + nt * NT;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(fin + (p0 + 8 * hf) * N + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// -- ssd_chunk_scan: y ---------------------------------------------------------------

// C rows [pos0, pos0 + 64) as TF32: rows i, N deep (k = state index),
// permuted; every load issued before the first store
template <int N>
__device__ __forceinline__ void stage_ct(float* dst, const __nv_bfloat16* src, int64_t ts, int pos0,
                                         int L, int tid) {
  constexpr int kItems = 64 * (N / 8) / kThreads;
  uint4 raw[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, s = (e >> 3) % (N / 8), i = (e / N) * 8 + (e & 7);
    const int pos = pos0 + i;
    raw[it] = pos < L ? __ldg(reinterpret_cast<const uint4*>(src + static_cast<int64_t>(pos) * ts + 8 * s))
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, s = (e >> 3) % (N / 8), i = (e / N) * 8 + (e & 7);
    const uint4 r = raw[it];
    *reinterpret_cast<float4*>(dst + tf32_at(i, 2 * s, N)) =
        make_float4(bf16_lo(r.x), bf16_lo(r.y), bf16_lo(r.z), bf16_lo(r.w));
    *reinterpret_cast<float4*>(dst + tf32_at(i, 2 * s + 1, N)) =
        make_float4(bf16_hi(r.x), bf16_hi(r.y), bf16_hi(r.z), bf16_hi(r.w));
  }
}

// x^T of one head at positions [pos0, pos0 + J) as TF32: rows p, J deep
// (J <= Q), permuted; every load issued before the first store
template <int Q>
__device__ __forceinline__ void stage_xt(float* dst, const __nv_bfloat16* src, int64_t ts, int pos0,
                                         int J, int L, int tid) {
  constexpr int kItems = 32 * (Q / 8) / kThreads;
  uint32_t v[kItems][8];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, pp = e & 31, s = e >> 5;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int pos = pos0 + 8 * s + jj;
      v[it][jj] = 8 * s < J && pos < L ? __ldg(reinterpret_cast<const unsigned int*>(
                                             src + static_cast<int64_t>(pos) * ts + 2 * pp))
                                       : 0u;
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads, pp = e & 31, s = e >> 5;
    if (8 * s >= J) break;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const uint32_t* w = v[it] + odd;
      *reinterpret_cast<float4*>(dst + tf32_at(2 * pp, 2 * s + odd, J)) =
          make_float4(bf16_lo(w[0]), bf16_lo(w[2]), bf16_lo(w[4]), bf16_lo(w[6]));
      *reinterpret_cast<float4*>(dst + tf32_at(2 * pp + 1, 2 * s + odd, J)) =
          make_float4(bf16_hi(w[0]), bf16_hi(w[2]), bf16_hi(w[4]), bf16_hi(w[6]));
    }
  }
}

// One CTA: positions [64 w, 64 w + 64) of one head's chunk.
template <int Q, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_scan(const SsdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ct = reinterpret_cast<float*>(smem_raw);  // [64][N], TF32
  float* Xt = Ct + 64 * N;                         // [64][J], TF32
  float* Ds = Xt + 64 * Q;                         // dA_cs [Q]
  float* Ts = Ds + Q;                              // dt [Q]
  float* Yt = N >= kYPitch ? Ct : Ts + Q;  // [64][kYPitch], in Ct's place where it fits
  const int w = blockIdx.x, ch = blockIdx.y, bb = blockIdx.z / a.h, k = blockIdx.z % a.h;
  const int gi = k / (a.h / a.g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int J = 64 * (w + 1), i0 = 64 * w, pos0 = ch * Q;
  const int64_t head = (static_cast<int64_t>(bb) * a.chunks + ch) * a.h + k;
  const int g0 = 16 * warp + (lane >> 2);  // this thread's rows g0 and g0 + 8 of each product
  const int r0 = i0 + g0, r1 = r0 + 8;     // ... as rows of the chunk

  // A's sources, whose first loads go out before the staging: the state
  // entering the chunk (rows p, k = state index) and C B^T (rows i, k = j)
  const float* s0 = a.S + head * kP * N + g0 * N + 2 * t;
  const float* s1 = s0 + 8 * N;
  const auto load_state = [&](int s, float (&v)[4]) {
    const float2 u0 = __ldg(reinterpret_cast<const float2*>(s0 + 8 * s));
    const float2 u1 = __ldg(reinterpret_cast<const float2*>(s1 + 8 * s));
    v[0] = u0.x;
    v[1] = u1.x;
    v[2] = u0.y;
    v[3] = u1.y;
  };
  const float* c0 = a.cb + (((static_cast<int64_t>(bb) * a.chunks + ch) * a.g + gi) * Q + r0) * Q + 2 * t;
  const float* c1 = c0 + 8 * Q;
  const auto load_cb = [&](int s, float (&v)[4]) {
    const float2 u0 = __ldg(reinterpret_cast<const float2*>(c0 + 8 * s));
    const float2 u1 = __ldg(reinterpret_cast<const float2*>(c1 + 8 * s));
    v[0] = u0.x;
    v[1] = u1.x;
    v[2] = u0.y;
    v[3] = u1.y;
  };
  // the rest of both into L2 now, so later batches' loads wait for L2 only
  if (tid == 0 && ch > 0) prefetch_l2(a.S + head * kP * N, kP * N * sizeof(float));
  if (tid == 32) prefetch_l2(c0 - g0 * Q - 2 * t, 64 * Q * sizeof(float));
  float raw_state[kBatch][4], raw_cb[kBatch][4];
  if (ch > 0) load_batch(raw_state, 0, load_state);
  load_batch(raw_cb, 0, load_cb);

  stage_ct<N>(Ct, a.C + bb * a.c_bs + gi * N, a.c_ts, pos0 + i0, a.L, tid);
  stage_xt<Q>(Xt, a.x + bb * a.x_bs + k * kP, a.x_ts, pos0, J, a.L, tid);
  for (int j = tid; j < Q; j += kThreads) {
    Ds[j] = a.dacs[head * Q + j];
    Ts[j] = a.dt[head * Q + j];
  }
  fence_proxy_async();
  __syncthreads();

  // 1. y_off^T (p x i) = state_entering (p x n) C^T; no state enters the first chunk
  float yo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yo[i] = 0.0f;
  if (ch > 0) {
    const uint32_t ct = smem_u32(Ct);
    split_products<64>(yo, N / (8 * kBatch), raw_state, load_state, [](int, float (&)[4]) {},
                       [&](int s) { return make_desc(ct + s * 256, 128, 32 * N); });
  }

  // 2. y_diag (i x p) = scores (i x j) x over the causal positions j < J, the
  //    scores C_i B_j^T exp(dA_cs_i - dA_cs_j) dt_j formed in registers, 0 for j > i
  float yd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yd[i] = 0.0f;
  {
    const float d0 = Ds[r0], d1 = Ds[r1];
    const uint32_t xt = smem_u32(Xt);
    split_products<64>(
        yd, J / (8 * kBatch), raw_cb, load_cb,
        [&](int s, float (&v)[4]) {
          const int j0 = 8 * s + 2 * t, j1 = j0 + 1;
          const float2 dj = *reinterpret_cast<const float2*>(Ds + j0);
          const float2 tj = *reinterpret_cast<const float2*>(Ts + j0);
          v[0] = j0 <= r0 ? v[0] * expf(d0 - dj.x) * tj.x : 0.0f;
          v[1] = j0 <= r1 ? v[1] * expf(d1 - dj.x) * tj.x : 0.0f;
          v[2] = j1 <= r0 ? v[2] * expf(d0 - dj.y) * tj.y : 0.0f;
          v[3] = j1 <= r1 ? v[3] * expf(d1 - dj.y) * tj.y : 0.0f;
        },
        [&](int s) { return make_desc(xt + s * 256, 128, 32 * J); });
  }

  // 3. y = y_diag + exp(dA_cs_i) y_off + D x, rounded once to bf16
  __syncthreads();  // every product has read Ct, where the output tile may lie
  const int col = 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(Yt + (g0 + 8 * hf) * kYPitch + 8 * j + col) =
          make_float2(yd[4 * j + 2 * hf], yd[4 * j + 2 * hf + 1]);
  }
  __syncthreads();
  if (ch > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * j + col + e;
        const float decay = expf(Ds[i0 + i]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) Yt[i * kYPitch + g0 + 8 * hf] += yo[4 * j + 2 * hf + e] * decay;
      }
    }
    __syncthreads();
  }
  // x of the tile's positions is in Xt (position i0 + i, k step (i0 + i) / 8)
  const float Dk = a.D[k];
  for (int e = tid; e < 64 * 8; e += kThreads) {
    const int i = e >> 3, o = e & 7, pos = pos0 + i0 + i;
    if (pos >= a.L) continue;
    const int j = i0 + i, at = 2 * (j >> 3) + (j & 1), slot = (j & 7) >> 1;
    const float* yt = Yt + i * kYPitch + 8 * o;
    uint32_t out[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      out[m] = pack_bf16(yt[2 * m] + Dk * Xt[tf32_at(8 * o + 2 * m, at, J) + slot],
                         yt[2 * m + 1] + Dk * Xt[tf32_at(8 * o + 2 * m + 1, at, J) + slot]);
    *reinterpret_cast<uint4*>(a.y + ((static_cast<int64_t>(bb) * a.L + pos) * a.h + k) * kP + 8 * o) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// -- launch ----------------------------------------------------------------------------

template <class K>
int opt_in(K kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int Q, int N>
struct Shape {
  static constexpr int NT = (Q == 128 && N >= 128) ? 128 : 64;  // B^T of one CTA in 64 KB
  static constexpr size_t prep_smem = sizeof(__nv_bfloat16) * (64 + Q) * N;
  static constexpr size_t state_smem =
      sizeof(float) * (NT * Q + Q) + sizeof(__nv_bfloat16) * 2 * Q * kXPitch;
  static constexpr size_t scan_smem =
      sizeof(float) * (64 * N + 64 * Q + 2 * Q + (N >= kYPitch ? 0 : 64 * kYPitch));
};

template <int Q, int N>
int launch(const SsdArgs& a, cudaStream_t st) {
  using S = Shape<Q, N>;
  int rc;
  if ((rc = opt_in(ssd_chunk_prep<Q, N>, S::prep_smem))) return rc;
  if ((rc = opt_in(ssd_chunk_state<Q, N, S::NT>, S::state_smem))) return rc;
  if ((rc = opt_in(ssd_chunk_scan<Q, N>, S::scan_smem))) return rc;
  ssd_chunk_prep<Q, N><<<dim3(Q / 64, a.chunks, a.b * a.g), kThreads, S::prep_smem, st>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ssd_chunk_state<Q, N, S::NT><<<dim3(N / S::NT, a.h, a.b), kThreads, S::state_smem, st>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ssd_chunk_scan<Q, N><<<dim3(Q / 64, a.chunks, a.b * a.h), kThreads, S::scan_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The chunked scan of one call: (q, n) pick the instantiation (q 128 or 256;
// n 64, 128 or 256, n * q <= 32768).  Returns 0, a CUDA error code, or -1 for
// a shape without an instantiation.
extern "C" int repro_ssd(int n, int q, const void* x, const void* dt_raw, const void* B,
                         const void* C, const void* dt_bias, const void* A, const void* D,
                         const void* valid_len, void* y, void* state, void* dt, void* dacs, void* cb,
                         void* S, int64_t x_bs, int64_t x_ts, int64_t dt_bs, int64_t dt_ts,
                         int64_t b_bs, int64_t b_ts, int64_t c_bs, int64_t c_ts, int b, int L, int h,
                         int g, void* stream) {
  SsdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt_raw = static_cast<const __nv_bfloat16*>(dt_raw);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.valid_len = static_cast<const int*>(valid_len);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.state = static_cast<float*>(state);
  a.dt = static_cast<float*>(dt);
  a.dacs = static_cast<float*>(dacs);
  a.cb = static_cast<float*>(cb);
  a.S = static_cast<float*>(S);
  a.x_bs = x_bs;
  a.x_ts = x_ts;
  a.dt_bs = dt_bs;
  a.dt_ts = dt_ts;
  a.b_bs = b_bs;
  a.b_ts = b_ts;
  a.c_bs = c_bs;
  a.c_ts = c_ts;
  a.b = b;
  a.L = L;
  a.h = h;
  a.g = g;
  a.chunks = (L + q - 1) / q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q == 128 && n == 64) return launch<128, 64>(a, st);
  if (q == 128 && n == 128) return launch<128, 128>(a, st);
  if (q == 128 && n == 256) return launch<128, 256>(a, st);
  if (q == 256 && n == 64) return launch<256, 64>(a, st);
  if (q == 256 && n == 128) return launch<256, 128>(a, st);
  return -1;
}
