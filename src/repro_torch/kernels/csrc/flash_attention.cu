// Flash attention for Hopper (sm_90a): causal (or full) GQA attention with an
// online softmax in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_flash_kernel
// (pallas_call at flash_attention.py:110).  It computes what that kernel
// computes: q is scaled by 1/sqrt(hd), logits are masked to -1e30 where
// q_pos < k_pos (no offset: the causal form needs Sq == Sk, which the wrapper
// enforces), the running max starts at -1e30, kv blocks stop at
// ceil((iq+1)*bq / bkv), and the output is acc / max(l, 1e-30).
// q/o are (B, Sq, H, hd) and k/v (B, Sk, KV, hd), row-major and contiguous,
// bfloat16 or float32; H = KV * G and query head h reads kv head h / G.
//
// Both kernels below take one CTA per (q block, batch x query head): grid
// (Sq / bq, B * H), heaviest causal q blocks launched first.  (The TPU kernel
// folds the G query heads of a kv head into one grid cell with a (G, bq, hd)
// f32 VMEM accumulator; at yi-6b's G = 8, hd = 128 that is 256 KB for
// bq = 64, over a CTA's 227 KB of shared memory and far over its registers.
// Here the G heads of a kv head read its K/V blocks through the L2.)
// block_q and block_kv are runtime arguments of the C interface; head_dim
// and block_kv are template parameters (the launcher picks the
// instantiation by block_kv).
//
// Bound.  At serving shapes (yi-6b prefill: B = 8, S = 4096, H = 32,
// hd = 128) attention does 4*B*H*hd*S(S+1)/2 operations on 2*B*S*(H+KV)*hd
// elements: thousands of operations per byte, far above the H100's ~295
// bf16 ops/byte ridge, so it is bound by operations, and only the tensor
// cores (989 TFLOP/s bf16 dense; 67 TFLOP/s f32 on CUDA cores) come near it.
//
// bfloat16: flash_fwd_bf16, on the tensor cores.
//   * One warpgroup (4 warps, 128 threads) per 64 query rows, the M of
//     wgmma: bq is 64 or 128, so 128 or 256 threads.
//   * Q (loaded once) and a ring of kStages K/V tiles stay bf16 in shared
//     memory, in wgmma's no-swizzle "core matrix" layout: each 8-row x
//     16-byte core matrix is 128 contiguous bytes (load_tile below), so
//     the 16-byte cp.async writes of a quarter warp and every wgmma read
//     touch 32 distinct banks without padding or swizzle.  The copy of
//     kv block ik + kStages - 1 is in flight while block ik is computed.
//   * S = Q K^T: one wgmma m64 n(bkv) k16 per 16 columns of hd, Q and K
//     from shared memory (K-major), f32 accumulators in registers.  bkv is
//     a multiple of 16 up to kMaxBkv and a template parameter (the launcher
//     picks the instantiation), so the S fragments have a fixed size.
//   * Online softmax on the accumulator fragments: each thread holds two
//     rows; row max and sum over a row's four threads by quad shuffles;
//     exp2f with scale * log2(e) folded into one multiply of the f32
//     logits; the causal mask only on blocks that cross the diagonal; l
//     from the f32 probabilities, kept per thread and reduced at the end.
//   * O += P V: P, rounded to bf16, never leaves registers: the S
//     accumulator layout of a 16-key chunk is the A-fragment layout of a
//     k16 step, so wgmma m64n{hd}k16 takes P from registers and V from
//     shared memory (MN-major, the transpose flag for 16-bit B).
//   Left for later work: TMA loads and warp specialisation (a producer
//   warp, softmax of one warpgroup overlapping the products of the other),
//   and a swizzled layout for 128-byte rows.
//
// float32: flash_fwd_f32<HD, BKV>, on CUDA cores (TF32 keeps about three
//   digits and breaks the f32 limit of 2e-5).  Bound by operations: at
//   yi-6b's geometry in f32 (q 1 x 4096 x 32 x 128, k/v 4 heads, causal)
//   the two products are 1.375e11 operations, 2.06 ms at the FP32 peak of
//   66.9 TFLOP/s, on 151 MB (0.045 ms at 3.35 TB/s).  So the goal is an FMA
//   stream that neither waits for its operands nor spends its issue slots on
//   loads, as in the f32 SIMT GEMM (gemm.cu):
//   * Both products are register-tiled outer products.  bq / 4 row groups of
//     RT threads (RT = 16 at head_dim >= 64, else 8; consecutive lanes of one
//     warp); a thread owns 4 query rows, the same rows in S and in O, so the
//     running max, sum and rescale stay in the row's group, reduced by
//     shuffles.  S = Q K^T: per d, one LDS.128 of the thread's 4 rows of Q and
//     runs of its BKV / RT keys of K, then 4 x BKV / RT FMAs, from Q (loaded
//     once per CTA) and K sitting d-major in padded slabs.  O += P V: per key,
//     one LDS.128 of the thread's 4 rows of P (key-major) and runs of its
//     HD / RT columns of V (row-major, as stored), then 4 x HD / RT FMAs.  Runs
//     are at most 4 floats, RT * 4 apart, so a quarter warp's 16-byte loads
//     hit distinct banks or broadcast.  At hd 128, BKV 64 a thread issues 4096
//     FMAs per kv block against 448 LDS.128.
//   * A ring of K/V stages filled by cp.async: V by 16-byte copies; K (and Q)
//     transposed into d-major slabs by 4-byte copies, rows padded to 4 (mod
//     8) floats, so a warp reads 8 consecutive d of 4 rows (whole 32-byte
//     sectors) and its stores hit 32 banks.  The copy of kv block ik + 1 is in
//     flight while block ik is computed; the depth is what the opt-in shared
//     memory holds beside Q and P, at most 2, and one stage is allowed (its
//     slot refilled after a barrier, the copy exposed).
//   * Online softmax in the exp2 domain: scale * log2(e) in one multiply of
//     the logits, exp2f, the causal mask only on blocks that cross the
//     diagonal.  P goes to shared memory key-major; each row group's lanes
//     are in one warp, so a warp barrier orders its writes and reads, and a
//     kv block costs one block-wide barrier (two with one stage).
//   Left for later work: folding the G query heads of a kv head into one CTA,
//   and a 3xTF32 tensor-core path.
//
// Launch limits.  __launch_bounds__ caps each instantiation's registers;
// the Python side (repro_torch/core/analysis.py:flash_launch_error) states
// the same limits, the shared-memory sums and the grid limit, and refuses
// every configuration outside them before it reaches this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- bfloat16: tensor cores ----------------------------------------------------

constexpr int kStages = 2;    // K/V ring depth (analysis.FLASH_STAGES)
constexpr int kWgRows = 64;   // query rows per warpgroup: the M of wgmma
constexpr int kMaxBq = 128;   // two warpgroups (analysis.FLASH_BF16_MAX_BQ)
constexpr int kMaxBkv = 128;  // the largest block_kv (analysis.FLASH_BF16_MAX_BKV)
constexpr int kKeyStep = 16;  // keys per P.V k-step, the block_kv granularity
constexpr int kBf16Threads = 2 * kMaxBq;

size_t smem_bytes_bf16(int bq, int bkv, int hd) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(hd) * (bq + 2 * kStages * bkv);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one
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
// pins a register's definition between two asm statements, so the compiler
// neither reads an accumulator before wgmma.wait nor writes an operand
// after wgmma.fence
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor in the no-swizzle layout: start address,
// leading byte offset (between core matrices along K) and stride byte
// offset (along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

#define R8(b)                                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D (64xN, f32) = or += A (64x16, shared) * B (16xN, shared), both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : R8(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// D (64xN, f32) += A (64x16, bf16 registers) * B (16xN, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef R8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows x HD bf16 (rows a multiple of 8, source rows `stride` elements
// apart) into the core-matrix layout: element (r, c) sits at 16-byte unit
// (r / 8) * (HD / 8) * 8 + (c / 8) * 8 + r % 8.  Copy e takes unit e, so a
// quarter warp fills one 128-byte core matrix and a warp reads 64
// contiguous bytes of each of 8 rows.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                          int64_t stride, int tid, int nthreads) {
  constexpr int NC = HD / 8;
  for (int e = tid; e < rows * NC; e += nthreads) {
    const int r = (e / (8 * NC)) * 8 + e % 8, c = (e / 8) % NC;
    cp_async16(dst + 8 * e, src + r * stride + 8 * c);
  }
}

// One CTA of bq (64 or 128) query rows against kv blocks of BKV keys.
template <int HD, int BKV>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
               const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O, int Sq,
               int Sk, int H, int KVH, int bq, int causal, float scale_log2) {
  static_assert(BKV % kKeyStep == 0 && BKV <= kMaxBkv, "block_kv: 16, 32, .., 128");
  constexpr int ROWG = HD * 16;        // bytes of one 8-row group of a tile
  constexpr int NCH = BKV / kKeyStep;  // 16-key chunks of a block
  constexpr int bkv = BKV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [bq][HD]
  __nv_bfloat16* Ks = Qs + bq * HD;                                 // [kStages][bkv][HD]
  __nv_bfloat16* Vs = Ks + kStages * bkv * HD;                      // [kStages][bkv][HD]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = iq * bq;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;  // between sequence rows
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const __nv_bfloat16* Qb =
      Q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;
  const __nv_bfloat16* Kb =
      K + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  const __nv_bfloat16* Vb =
      V + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  __nv_bfloat16* Ob =
      O + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;

  const int n_kv = Sk / bkv;
  const int n_visit = causal ? min(n_kv, ((iq + 1) * bq + bkv - 1) / bkv) : n_kv;

  // prologue: Q and the first kStages - 1 K/V blocks, one group each
  load_tile<HD>(Qs, Qb, bq, q_stride, tid, nthreads);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_visit) {
      const int64_t off = static_cast<int64_t>(st) * bkv * kv_stride;
      load_tile<HD>(Ks + st * bkv * HD, Kb + off, bkv, kv_stride, tid, nthreads);
      load_tile<HD>(Vs + st * bkv * HD, Vb + off, bkv, kv_stride, tid, nthreads);
    }
    cp_async_commit();
  }

  // this thread's two rows of the warpgroup's 64 (the wgmma fragment layout)
  const int row0 = wg * kWgRows + warp * 16 + lane / 4;
  const int qpos[2] = {q0 + row0, q0 + row0 + 8};
  const int col = 2 * (lane % 4);  // first of the thread's two columns per 8
  const uint32_t q_addr = smem_u32(Qs) + wg * 8 * ROWG;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float s[BKV / 2];  // S, then P: s[8c + 4j + 2i + e] is row i's key 16c + 8j + col + e
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.0f, 0.0f};

  for (int ik = 0; ik < n_visit; ++ik) {
    // block ik has landed (and, at ik = 0, Q); every thread is done with
    // block ik - 1, whose stage the next copy overwrites
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    {
      const int nxt = ik + kStages - 1;
      if (nxt < n_visit) {
        const int st = nxt % kStages;
        const int64_t off = static_cast<int64_t>(nxt) * bkv * kv_stride;
        load_tile<HD>(Ks + st * bkv * HD, Kb + off, bkv, kv_stride, tid, nthreads);
        load_tile<HD>(Vs + st * bkv * HD, Vb + off, bkv, kv_stride, tid, nthreads);
      }
      cp_async_commit();
    }
    const int st = ik % kStages;
    const int k0 = ik * bkv;
    const uint32_t k_addr = smem_u32(Ks + st * bkv * HD);
    const uint32_t v_addr = smem_u32(Vs + st * bkv * HD);

    // 1. S = Q K^T: one m64 n(BKV) k16 instruction per 16 columns of hd
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) fence_operand(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BKV>(s, make_desc(q_addr + kk * 256, 128, ROWG),
                    make_desc(k_addr + kk * 256, 128, ROWG), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) fence_operand(s[i]);

    // 2. online softmax on the fragments
    const bool diagonal = causal && k0 + bkv - 1 > q0;
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int t = 0; t < BKV / 2; ++t) {
      const int i = (t >> 1) & 1;
      const int kpos = k0 + 8 * (t >> 2) + col + (t & 1);
      float x = s[t] * scale_log2;
      if (diagonal && qpos[i] < kpos) x = -1e30f;
      s[t] = x;
      m_new[i] = fmaxf(m_new[i], x);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      corr[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int t = 0; t < BKV / 2; ++t) {
      const int i = (t >> 1) & 1;
      const float p = exp2f(s[t] - m_new[i]);
      s[t] = p;
      l_run[i] += p;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[4 * j + t] *= corr[t >> 1];

    // 3. O += P V: each 16-key chunk of P, rounded to bf16, is the A
    //    fragment (rows r, r + 8; keys 2q.., 8 + 2q..) of one k16 step
    uint32_t pa[NCH][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
        fence_operand(pa[c][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) fence_operand(o[i]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_rs<HD>(o, pa[c], make_desc(v_addr + c * 2 * ROWG, ROWG, 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) fence_operand(o[i]);
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  // 4. the row's sum over its four threads; O = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float denom[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* orow = Ob + static_cast<int64_t>(row0 + 8 * i) * q_stride + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / denom[i], o[4 * j + 2 * i + 1] / denom[i]);
  }
}

// -- float32: CUDA cores -------------------------------------------------------

constexpr int kF32Rows = 4;          // query rows a thread owns (analysis.FLASH_F32_ROWS)
constexpr int kF32MaxThreads = 512;  // __launch_bounds__ (analysis.FLASH_F32_MAX_THREADS)
constexpr int kF32MaxStages = 2;     // K/V ring depth at most (analysis.FLASH_F32_MAX_STAGES)
constexpr int kPad = 4;              // floats of padding of a d-major row (analysis._FLASH_PAD)

// threads that share a query row (analysis.flash_row_threads)
__host__ __device__ constexpr int f32_row_threads(int hd) { return hd >= 64 ? 16 : 8; }

// floats of the d-major Q tile, of one ring stage (K d-major, then V
// row-major) and of the key-major P tile
size_t f32_q_floats(int bq, int hd) { return static_cast<size_t>(hd) * (bq + kPad); }
size_t f32_stage_floats(int bkv, int hd) {
  return static_cast<size_t>(hd) * (bkv + kPad) + static_cast<size_t>(bkv) * hd;
}
size_t f32_p_floats(int bq, int bkv) { return static_cast<size_t>(bkv) * (bq + kPad); }

// the ring's depth: as many stages as the opt-in shared memory holds beside
// Q and P, at most kF32MaxStages; 0 where one does not fit
// (analysis.flash_stages)
int f32_stages(int bq, int bkv, int hd, int smem_optin) {
  const long long fixed = sizeof(float) * (f32_q_floats(bq, hd) + f32_p_floats(bq, bkv));
  const long long stage = sizeof(float) * f32_stage_floats(bkv, hd);
  const long long fit = fixed > smem_optin ? 0 : (smem_optin - fixed) / stage;
  return static_cast<int>(fit < kF32MaxStages ? fit : kF32MaxStages);
}

size_t f32_smem_bytes(int bq, int bkv, int hd, int stages) {
  return sizeof(float) *
         (f32_q_floats(bq, hd) + stages * f32_stage_floats(bkv, hd) + f32_p_floats(bq, bkv));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

// W consecutive floats, one load or store of 32 W bits (p is 4 W-byte aligned);
// gemm.cu has the same (each source builds alone, and a planted-fault
// variant of it builds from a copy in another directory)
template <int W> struct Run;
template <> struct Run<1> {
  static __device__ __forceinline__ void load(float* r, const float* p) { r[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* r) { *p = r[0]; }
};
template <> struct Run<2> {
  static __device__ __forceinline__ void load(float* r, const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x, r[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* r) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
};
template <> struct Run<4> {
  static __device__ __forceinline__ void load(float* r, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* r) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};

// Stage `rows` rows of HD floats (source rows `stride` floats apart) d-major
// into dst[d][r] (rows `ld` floats apart, ld = 4 (mod 8)) by 4-byte cp.async:
// copy e takes d = 8 (e / 8 / rows) + e % 8 of row e / 8 % rows, so a warp
// reads 8 consecutive d of 4 rows (whole 32-byte sectors) and its 32 stores
// hit 32 distinct banks.
template <int HD>
__device__ __forceinline__ void load_dmajor(float* dst, const float* src, int rows, int ld,
                                            int64_t stride, int tid, int nthreads) {
  for (int e = tid; e < rows * HD; e += nthreads) {
    const int t = e / 8, r = t % rows, d = 8 * (t / rows) + e % 8;
    cp_async4(dst + d * ld + r, src + r * stride + d);
  }
}

// Stage BKV rows of HD floats row-major into dst[r][d] by 16-byte cp.async.
template <int HD, int BKV>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int tid,
                                          int nthreads) {
  constexpr int NC = HD / 4;
  for (int e = tid; e < BKV * NC; e += nthreads) {
    const int r = e / NC, c = e % NC;
    cp_async16(dst + r * HD + 4 * c, src + r * stride + 4 * c);
  }
}

// One CTA of bq query rows against kv blocks of BKV keys: bq / kF32Rows row
// groups of RT threads, RT consecutive lanes per group.  A thread owns
// kF32Rows rows in S and the same rows in O: the row's max and sum stay in
// its group, reduced by shuffles.
template <int HD, int BKV>
__global__ void __launch_bounds__(kF32MaxThreads)
flash_fwd_f32(const float* __restrict__ Q, const float* __restrict__ K, const float* __restrict__ V,
              float* __restrict__ O, int Sq, int Sk, int H, int KVH, int bq, int stages, int causal,
              float scale_log2) {
  constexpr int RM = kF32Rows;
  constexpr int RT = f32_row_threads(HD);
  constexpr int RNS = BKV / RT, WS = RNS < 4 ? RNS : 4;  // keys of S a thread owns, run width
  constexpr int RNO = HD / RT, WO = RNO < 4 ? RNO : 4;   // columns of O, run width
  constexpr int LDK = BKV + kPad;                        // row stride of the d-major K tile
  static_assert(RM == 4 && RNS >= 1 && RNO >= 1 && BKV % RT == 0 && HD % RT == 0, "tile");
  static_assert(kF32MaxStages == 2, "one copy group in flight: cp.async.wait_group 0");
  extern __shared__ __align__(16) float smem[];
  const int ldq = bq + kPad;  // row stride of the d-major Q tile and the key-major P tile
  float* Qs = smem;                     // [HD][ldq]
  float* Ps = Qs + HD * ldq;            // [BKV][ldq]
  float* ring = Ps + BKV * ldq;         // [stages][K: HD][LDK | V: BKV][HD]
  constexpr int kStage = HD * LDK + BKV * HD;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rg = tid / RT, c = tid % RT;
  const int r0 = rg * RM;                     // the thread's first row in the q block
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = iq * bq;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;  // between sequence rows
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const float* Qb = Q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;
  const float* Kb = K + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  const float* Vb = V + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  float* Ob = O + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;

  const int n_kv = Sk / BKV;
  const int n_visit = causal ? min(n_kv, ((iq + 1) * bq + BKV - 1) / BKV) : n_kv;

  auto load = [&](int st, int ik) {
    float* ks = ring + st * kStage;
    const int64_t off = static_cast<int64_t>(ik) * BKV * kv_stride;
    load_dmajor<HD>(ks, Kb + off, BKV, LDK, kv_stride, tid, nthreads);
    load_rows<HD, BKV>(ks + HD * LDK, Vb + off, kv_stride, tid, nthreads);
  };

  // Q joins the first copy group; then kv blocks 0 .. stages - 2, one group each
  load_dmajor<HD>(Qs, Qb, bq, ldq, q_stride, tid, nthreads);
  for (int st = 0; st < stages - 1; ++st) {
    if (st < n_visit) load(st, st);
    cp_async_commit();
  }

  float o[RM][RNO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RNO; ++j) o[i][j] = 0.0f;
  float m_run[RM], l_run[RM];  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < RM; ++i) m_run[i] = -1e30f, l_run[i] = 0.0f;

  // the thread's keys in S: RNS / WS runs of WS, RT * WS apart; its columns
  // of O likewise (a quarter warp's 16-byte loads hit distinct banks)
  const int key0 = c * WS, col0 = c * WO;

  for (int ik = 0; ik < n_visit; ++ik) {
    // one stage: the slot is refilled once every thread is done with block ik - 1
    if (stages == 1) {
      if (ik > 0) __syncthreads();
      load(0, ik);
      cp_async_commit();
    }
    // block ik has landed (and, at ik = 0, Q); every thread is done with
    // block ik - 1, whose stage the next copy overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (stages > 1) {
      const int nxt = ik + stages - 1;
      if (nxt < n_visit) load(nxt % stages, nxt);
      cp_async_commit();
    }
    const int cur = ik % stages;
    const float* ks = ring + cur * kStage;
    const float* vs = ks + HD * LDK;
    const int k0 = ik * BKV;

    // 1. S = Q K^T: per d, the thread's RM rows of Q and RNS keys of K,
    //    then RM x RNS FMAs
    float s[RM][RNS];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int u = 0; u < RNS; ++u) s[i][u] = 0.0f;
    {
      const float* qp = Qs + r0;
      const float* kp = ks + key0;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float a[RM], kk[RNS];
        Run<RM>::load(a, qp + d * ldq);
#pragma unroll
        for (int r = 0; r < RNS / WS; ++r) Run<WS>::load(kk + r * WS, kp + d * LDK + r * RT * WS);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int u = 0; u < RNS; ++u) s[i][u] = fmaf(a[i], kk[u], s[i][u]);
      }
    }

    // 2. online softmax in the exp2 domain: scale * log2(e) in one multiply,
    //    the causal mask only on blocks that cross the diagonal
    const bool diagonal = causal && k0 + BKV - 1 > q0;
    float m_new[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m_new[i] = m_run[i];
#pragma unroll
      for (int u = 0; u < RNS; ++u) {
        const int key = k0 + key0 + (u / WS) * RT * WS + u % WS;
        float x = s[i][u] * scale_log2;
        if (diagonal && q0 + r0 + i < key) x = -1e30f;
        s[i][u] = x;
        m_new[i] = fmaxf(m_new[i], x);
      }
#pragma unroll
      for (int off = RT / 2; off > 0; off >>= 1)
        m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], off));
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float corr = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= corr;
#pragma unroll
      for (int u = 0; u < RNS; ++u) {
        const float p = exp2f(s[i][u] - m_new[i]);
        s[i][u] = p;
        l_run[i] += p;
      }
#pragma unroll
      for (int j = 0; j < RNO; ++j) o[i][j] *= corr;  // rescale the row's accumulator
    }

    // 3. P to shared memory, key-major: the row group's lanes exchange their
    //    keys within the warp, so a warp barrier suffices
#pragma unroll
    for (int u = 0; u < RNS; ++u) {
      const float pc[RM] = {s[0][u], s[1][u], s[2][u], s[3][u]};
      Run<RM>::store(Ps + (key0 + (u / WS) * RT * WS + u % WS) * ldq + r0, pc);
    }
    __syncwarp();

    // 4. O += P V: per key, the thread's RM rows of P and RNO columns of V
    {
      const float* pp = Ps + r0;
      const float* vp = vs + col0;
#pragma unroll 8
      for (int j = 0; j < BKV; ++j) {
        float a[RM], vv[RNO];
        Run<RM>::load(a, pp + j * ldq);
#pragma unroll
        for (int r = 0; r < RNO / WO; ++r) Run<WO>::load(vv + r * WO, vp + j * HD + r * RT * WO);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int t = 0; t < RNO; ++t) o[i][t] = fmaf(a[i], vv[t], o[i][t]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  // 5. the row's sum over its group; O = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = RT / 2; off > 0; off >>= 1)
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], off);
    const float denom = fmaxf(l_run[i], 1e-30f);
    float out[RNO];
#pragma unroll
    for (int t = 0; t < RNO; ++t) out[t] = o[i][t] / denom;
    float* orow = Ob + static_cast<int64_t>(r0 + i) * q_stride + col0;
#pragma unroll
    for (int r = 0; r < RNO / WO; ++r) Run<WO>::store(orow + r * RT * WO, out + r * WO);
  }
}

// -- launch ----------------------------------------------------------------------

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err;
}

template <int HD, int BKV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int KVH, int bq, int causal, float scale,
                        cudaStream_t stream) {
  auto kernel = flash_fwd_bf16<HD, BKV>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(Sq / bq, B * H);
  kernel<<<grid, 2 * bq, smem_bytes_bf16(bq, BKV, HD), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KVH, bq,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// block_kv (a multiple of 16 up to kMaxBkv) picks the instantiation
template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int KVH, int bq, int bkv, int causal, float scale,
                        cudaStream_t stream) {
#define LAUNCH_BKV(BKV)                                                                  \
  case BKV:                                                                              \
    return launch_bf16<HD, BKV>(q, k, v, o, B, Sq, Sk, H, KVH, bq, causal, scale, stream)
  switch (bkv) {
    LAUNCH_BKV(16);
    LAUNCH_BKV(32);
    LAUNCH_BKV(48);
    LAUNCH_BKV(64);
    LAUNCH_BKV(80);
    LAUNCH_BKV(96);
    LAUNCH_BKV(112);
    LAUNCH_BKV(128);
  }
#undef LAUNCH_BKV
  return cudaErrorInvalidValue;
}

// the opt-in shared-memory limit of the current device (read once)
int smem_optin() {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    optin = v;
  }
  return optin;
}

template <int HD, int BKV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KVH, int bq, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_f32<HD, BKV>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int stages = f32_stages(bq, BKV, HD, smem_optin());
  if (stages < 1 || bq % kF32Rows) return cudaErrorInvalidValue;
  const dim3 grid(Sq / bq, B * H);
  kernel<<<grid, (bq / kF32Rows) * f32_row_threads(HD), f32_smem_bytes(bq, BKV, HD, stages),
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KVH, bq,
                     stages, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// the f32 block_kv instantiations (analysis.FLASH_F32_BKV)
#define F32_BKV(X) X(16) X(32) X(64)

// block_kv picks the instantiation
template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KVH, int bq, int bkv, int causal, float scale,
                       cudaStream_t stream) {
#define LAUNCH_BKV(BKV) \
  case BKV: return launch_f32<HD, BKV>(q, k, v, o, B, Sq, Sk, H, KVH, bq, causal, scale, stream);
  switch (bkv) { F32_BKV(LAUNCH_BKV) }
#undef LAUNCH_BKV
  return cudaErrorInvalidValue;
}

template <typename Kernel>
int max_threads_of(Kernel kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.maxThreadsPerBlock : -static_cast<int>(err);
}

// the least limit over a head_dim's f32 block_kv instantiations
template <int HD>
int max_threads_f32() {
  int least = kF32MaxThreads;
#define MAXT_BKV(BKV)                                               \
  {                                                                 \
    const int t = max_threads_of(flash_fwd_f32<HD, BKV>);          \
    least = t < least ? t : least;                                  \
  }
  F32_BKV(MAXT_BKV)
#undef MAXT_BKV
  return least;
}

// the least limit over a head_dim's block_kv instantiations
template <int HD>
int max_threads_bf16() {
  const int limits[] = {
      max_threads_of(flash_fwd_bf16<HD, 16>), max_threads_of(flash_fwd_bf16<HD, 32>),
      max_threads_of(flash_fwd_bf16<HD, 48>), max_threads_of(flash_fwd_bf16<HD, 64>),
      max_threads_of(flash_fwd_bf16<HD, 80>), max_threads_of(flash_fwd_bf16<HD, 96>),
      max_threads_of(flash_fwd_bf16<HD, 112>), max_threads_of(flash_fwd_bf16<HD, 128>)};
  int least = limits[0];
  for (int x : limits) least = x < least ? x : least;
  return least;
}

}  // namespace

#define ALL_HEAD_DIMS(X) \
  case 16: X(16);        \
  case 32: X(32);        \
  case 64: X(64);        \
  case 128: X(128);

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success), or -1 for a dtype/head_dim this file has no instantiation
// for.  Launches on `stream`; never synchronises or allocates.
int repro_flash(int dtype, int head_dim, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int KVH, int bq, int bkv, int causal, float scale,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_F32(HD) return launch_f32<HD>(q, k, v, o, B, Sq, Sk, H, KVH, bq, bkv, causal, scale, s)
#define LAUNCH_BF16(HD) \
  return launch_bf16<HD>(q, k, v, o, B, Sq, Sk, H, KVH, bq, bkv, causal, scale, s)
  if (dtype == 0) {
    switch (head_dim) { ALL_HEAD_DIMS(LAUNCH_F32) }
  } else if (dtype == 1) {
    switch (head_dim) { ALL_HEAD_DIMS(LAUNCH_BF16) }
  }
  return -1;
}

// The launch limit the compiled instantiations report
// (cudaFuncAttributes::maxThreadsPerBlock, the least over a head_dim's
// block_kv instantiations), or -1 / -cudaError_t.
int repro_flash_max_threads(int dtype, int head_dim) {
#define MAXT_F32(HD) return max_threads_f32<HD>()
#define MAXT_BF16(HD) return max_threads_bf16<HD>()
  if (dtype == 0) {
    switch (head_dim) { ALL_HEAD_DIMS(MAXT_F32) }
  } else if (dtype == 1) {
    switch (head_dim) { ALL_HEAD_DIMS(MAXT_BF16) }
  }
  return -1;
}

// The ring the float32 kernel launches (block_q, block_kv, head_dim) with
// on the current device: its stages (0 where one does not fit beside Q and
// P), and in *smem_bytes its shared memory (analysis.flash_stages /
// flash_smem_bytes).
int repro_flash_f32_ring(int bq, int bkv, int hd, int* smem_bytes) {
  const int stages = f32_stages(bq, bkv, hd, smem_optin());
  *smem_bytes = stages > 0 ? static_cast<int>(f32_smem_bytes(bq, bkv, hd, stages)) : 0;
  return stages;
}

}  // extern "C"
