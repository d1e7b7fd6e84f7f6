// Tiled GEMM for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/gemm.py:_gemm_kernel
// (pallas_call at gemm.py:158).  A (M, K), B (K, N) and C (M, N) are
// row-major and contiguous; inputs are float32 or bfloat16 and C has the
// input type.
//
// The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid and carries an
// f32 VMEM accumulator across the k axis.  Hopper runs blocks in parallel
// and in no order, so nothing carries between blocks: here one CTA owns one
// bm x bn tile of C and loops over K itself, bk-deep slab by slab, with its
// f32 accumulators in registers.  Three kernels, chosen by dtype and bm:
//
// float32: gemm_tiled<float, RM, RN>, on CUDA cores (f32 has to stay exact to
//   1e-4, which TF32 tensor cores are not).  The tuner's state maps onto it
//   level by level:
//     m0 x n0          CTA grid (gridDim.y x gridDim.x)
//     bm x bn          CTA tile; bk the shared-memory K slab, k0 = K/bk trips
//     sub_m x sub_n    warp tile: (sub_m/reg_m) x (sub_n/reg_n) consecutive
//                      threads cover it, (bm/sub_m) x (bn/sub_n) of them per CTA
//     reg_m x reg_n    per-thread register tile (a template parameter)
//   Each thread loads reg_m + reg_n shared-memory values per reg_m * reg_n
//   FMAs; the register tile sets its arithmetic intensity.
//
// bfloat16, bm >= 64: gemm_tiled_wgmma<BK, MT, SN>, on the tensor cores.
//   Bound.  At the served and tuned shapes (M >= 8192, K, N >= 512) a GEMM
//   does 2MKN operations on (MK + KN + MN) elements, hundreds per byte, far
//   above the H100's ~295 bf16 ops/byte ridge: it is bound by operations,
//   which only wgmma delivers at the card's rate.
//     m0 x n0          CTA grid
//     bm x bn          CTA tile, bk the slab depth (BK: 64 or 128)
//     m1 x n1          consumer warpgroups of the CTA (1 or 2 in all)
//     sub_m x sub_n    a warpgroup's tile: sub_m = 64 * MT rows (MT m64
//                      instructions), sub_n = SN, the instruction's N
//                      (64, 128 or 256); m3 = n3 = 1 (a wgmma fragment is
//                      fixed by the instruction)
//   * A ring of `stages` bf16 slabs (A bm x BK, then B BK x bn), filled by
//     16-byte cp.async copies of all threads: slab i + S - 1 is copied while
//     slab i is multiplied.  stages = min(4, (opt-in shared memory - 1 KB
//     of alignment slack) / slab bytes), at least 2 (analysis.gemm_stages).
//   * Both slabs sit in wgmma's 128-byte swizzled layout: 64-element atoms
//     of 128-byte rows (A: bm rows of 64 k; B: BK rows of 64 n), each
//     row's eight 16-byte chunks permuted by chunk ^ (row % 8), atoms
//     1024-byte aligned.  Eight consecutive threads copy one contiguous
//     128-byte row segment, and a warp's four rows land on 32 distinct
//     banks.  (In the no-swizzle core-matrix layout a quarter warp takes
//     16 bytes from each of 8 rows, and the copies alone set the kernel's
//     time; here they still bound it, less tightly.)  A is a K-major
//     operand (stride 1024 B
//     between 8-row groups, 32 B start offset per k16 step inside an
//     atom); B, row-major (K, N), is an MN-major operand read with the
//     transpose flag (leading offset BK * 128 B between 64-column atoms,
//     stride 1024 B between 8-row k groups).
//   * Per slab each warpgroup issues MT x BK/16 wgmma m64 n(SN) k16 from
//     shared memory into f32 accumulators (MT * SN / 2 registers a thread,
//     at most 128), commits them as one group and waits for it before the
//     next slab's barrier.  (Keeping a group in flight across the loop's
//     back-edge makes ptxas serialize every wgmma: the accumulators'
//     loop-carried copies count as writes inside the pipeline stage.)
//   * CTAs walk the C tiles in groups of 8 tile rows, column by column,
//     so the CTAs in flight share A strips and B slabs in the L2.
//   * The epilogue rounds the fragments to bf16 and stores them directly.
//   Left for later work: TMA with a producer warp, clusters with multicast,
//   a persistent grid and a staged epilogue.
//
// bfloat16, bm < 64: gemm_tiled_stream<BN>, for decode's skinny products.
//   Bound.  At M = 8 a product reads K * N * 2 bytes of weights for 16 K N
//   operations, far below the ridge: it is bound by bytes, and the only goal
//   is to stream B from device memory once, at close to its rate.
//     m0 x n0          CTA grid (n0 = N / BN: 128 CTAs at N = 4096, BN = 32)
//     bm               the CTA's rows, 8 or 16 (m1 = m3 = 1, m2 = bm)
//     bn = BN          the CTA's columns, 8 .. 64 (n1 = n3 = 1, n2 = bn)
//     bk               the slab depth, a multiple of 16
//   * A ring of up to 8 stages of (A bm x bk, B bk x BN) slabs in at most
//     96 KB (so two CTAs fit an SM), filled by 16-byte cp.async copies:
//     every slab after the one being multiplied is in flight.
//   * The CTA's 4 warps split each slab's k16 chunks (split-K inside the
//     CTA): mma.sync m16n8k16 with A's rows bm .. 15 zero and B's fragments
//     from ldmatrix.trans, f32 partial sums in registers.  At the end the
//     warps' partials meet in shared memory and are summed in warp order:
//     deterministic, no atomics.
//
// Launch limits.  __launch_bounds__ caps each instantiation's registers; the
// Python wrapper (repro_torch/core/analysis.py:gemm_launch_error) states the
// same limits, the shared-memory ring, the instantiations and the grid
// limit, and refuses every configuration outside them before it reaches
// this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// -- float32: CUDA cores ---------------------------------------------------------

constexpr int max_threads(int tile) { return tile <= 4 ? 1024 : (tile <= 16 ? 512 : 256); }

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(max_threads(RM * RN), 1)
gemm_tiled(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
           int K, int N, int bm, int bk, int bn, int sub_m, int sub_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [bk][bm]: the A slab, transposed
  T* Bs = As + bk * bm;                 // [bk][bn]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int m2 = sub_m / RM, n2 = sub_n / RN;  // threads per warp tile
  const int warp_tiles_n = bn / sub_n;
  const int group = tid / (m2 * n2), lane = tid % (m2 * n2);
  const int row0 = (group / warp_tiles_n) * sub_m + (lane / n2) * RM;
  const int col0 = (group % warp_tiles_n) * sub_n + (lane % n2) * RN;
  const int64_t tile_m = static_cast<int64_t>(blockIdx.y) * bm;
  const int64_t tile_n = static_cast<int64_t>(blockIdx.x) * bn;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < bm * bk; e += nthreads) {
      const int r = e / bk, c = e % bk;
      As[c * bm + r] = A[(tile_m + r) * K + k0 + c];
    }
    for (int e = tid; e < bk * bn; e += nthreads) {
      const int r = e / bn, c = e % bn;
      Bs[r * bn + c] = B[static_cast<int64_t>(k0 + r) * N + tile_n + c];
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = to_f32(As[kk * bm + row0 + i]);
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = to_f32(Bs[kk * bn + col0 + j]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      C[(tile_m + row0 + i) * N + tile_n + col0 + j] = from_f32<T>(acc[i][j]);
}

// -- bfloat16: shared helpers ------------------------------------------------------

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
// wait until at most n (a runtime value below 8) copy groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<0>(); break;
  }
}
// cp.async writes through the generic proxy; wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a register's definition between two asm statements, so the compiler
// neither reads an accumulator before wgmma.wait nor writes one after
// wgmma.fence
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory matrix descriptor in the 128-byte swizzled layout (layout
// type 1): start address, leading byte offset and stride byte offset, each
// in 16-byte units.
__device__ __forceinline__ uint64_t make_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// -- bfloat16, bm >= 64: tensor cores (wgmma) ---------------------------------------

constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kWgRows = 64;         // the M of wgmma
constexpr int kMaxWarpgroups = 2;   // analysis.GEMM_WG_MAX
constexpr int kWgMaxStages = 4;     // analysis.GEMM_WG_MAX_STAGES
constexpr int kWgMinStages = 2;     // analysis.GEMM_WG_MIN_STAGES
constexpr int kGroupRows = 8;       // tile rows per raster group
constexpr int kAtom = 64;           // elements of one 128-byte swizzled row
constexpr int kAlignSlack = 1024;   // analysis.GEMM_ALIGN_SLACK: atoms are 1024-byte aligned

int wgmma_stages(int bm, int bk, int bn, int smem_optin) {
  const int slab = (bm + bn) * bk * static_cast<int>(sizeof(bf16));
  const int fit = (smem_optin - kAlignSlack) / slab;
  return fit < kWgMaxStages ? fit : kWgMaxStages;
}

#define R8(b)                                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D (64xN, f32) += A (64x16, shared, K-major) * B (16xN, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_kn(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_kn<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_kn<128>(float (&d)[64], uint64_t da, uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_kn<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1));
}
#undef R8

// Copy a rows x (64 * atoms) bf16 block of a row-major matrix (rows `ld`
// elements apart) into the 128-byte swizzled layout: atom a (columns 64a ..
// 64a + 63) holds `rows` rows of 128 bytes, and the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) of its row.  Copy e fills row e / 8 of its atom,
// chunk e % 8: eight threads copy one contiguous 128-byte row segment.
__device__ __forceinline__ void load_sw128(bf16* dst, const bf16* src, int rows, int atoms,
                                           int64_t ld, int tid, int nthreads) {
  const int units = rows * atoms * 8;
  for (int e = tid; e < units; e += nthreads) {
    const int c = e & 7, row = e >> 3;           // row over the atoms, atom-major
    const int a = row / rows, r = row - a * rows;
    cp_async16(dst + (a * rows + r) * kAtom + ((c ^ (r & 7)) << 3),
               src + r * ld + a * kAtom + 8 * c);
  }
}

// One CTA: a bm x bn tile of C by (bm / (64 MT)) x (bn / SN) warpgroups.
template <int BK, int MT, int SN>
__global__ void __launch_bounds__(kMaxWarpgroups * kWgThreads)
gemm_tiled_wgmma(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
                 int K, int N, int bm, int bn, int stages) {
  static_assert(MT * SN / 2 <= 128, "accumulators over the register cliff");
  static_assert(BK % kAtom == 0 && SN % kAtom == 0, "whole 128-byte swizzle atoms");
  constexpr int WG_M = kWgRows * MT;  // a warpgroup's rows (sub_m)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [stages][A: BK/64 atoms of bm rows | B: bn/64 atoms of BK rows], 1024-aligned
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlignSlack - 1) & ~uintptr_t(kAlignSlack - 1));
  const int slab = (bm + bn) * BK;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int wg = tid / kWgThreads, warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const int wgs_n = bn / SN;
  const int wm = (wg / wgs_n) * WG_M, wn = (wg % wgs_n) * SN;  // the warpgroup's tile
  // grouped raster: kGroupRows tile rows at a time, column by column
  const int grid_n = gridDim.x, lin = blockIdx.y * grid_n + blockIdx.x;
  const int first = (lin / (kGroupRows * grid_n)) * kGroupRows;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroupRows);
  const int in_group = lin % (kGroupRows * grid_n);
  const int64_t tile_m = static_cast<int64_t>(first + in_group % rows) * bm;
  const int64_t tile_n = static_cast<int64_t>(in_group / rows) * bn;
  const bf16* Ab = A + tile_m * K;
  const bf16* Bb = B + tile_n;
  const int n_k = K / BK;

  auto load = [&](int st, int kt) {
    bf16* As = ring + st * slab;
    const int64_t k0 = static_cast<int64_t>(kt) * BK;
    load_sw128(As, Ab + k0, bm, BK / kAtom, K, tid, nthreads);
    load_sw128(As + bm * BK, Bb + k0 * N, BK, bn / kAtom, N, tid, nthreads);
  };

  // prologue: slabs 0 .. stages - 2, one group each
  for (int st = 0; st < stages - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }

  float acc[MT][SN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < SN / 2; ++i) acc[mt][i] = 0.0f;

  for (int i = 0; i < n_k; ++i) {
    // slab i has landed; every warpgroup is done with slab i - 1, whose
    // stage the next copy overwrites
    cp_async_wait_upto(stages - 2);
    fence_proxy_async();
    __syncthreads();
    {
      const int nxt = i + stages - 1;
      if (nxt < n_k) load(nxt % stages, nxt);
      cp_async_commit();
    }
    const int slot = i % stages;
    // A: the warpgroup's rows of each atom; B: its first 64-column atom
    const uint32_t a_addr = smem_u32(ring + slot * slab) + wm * 128;
    const uint32_t b_addr = smem_u32(ring + slot * slab + bm * BK) + (wn / kAtom) * BK * 128;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < SN / 2; ++j) fence_operand(acc[mt][j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_kn<SN>(acc[mt],
                     make_desc_sw128(a_addr + (kk / 4) * bm * 128 + mt * kWgRows * 128 +
                                         (kk % 4) * 32, 16, 1024),
                     make_desc_sw128(b_addr + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < SN / 2; ++j) fence_operand(acc[mt][j]);
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  // the fragment of m64nSN: warp w holds rows 16w .. 16w + 15; acc[4j + 2h + e]
  // is row 16w + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = tile_m + wm + mt * kWgRows + warp * 16 + lane / 4 + 8 * h;
      bf16* crow = C + row * N + tile_n + wn + col;
#pragma unroll
      for (int j = 0; j < SN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(crow + 8 * j) =
            __floats2bfloat162_rn(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
    }
  }
}

// -- bfloat16, bm < 64: bandwidth-bound (decode) -------------------------------------

constexpr int kStreamWarps = 4;          // analysis.GEMM_BW_WARPS
constexpr int kStreamMaxStages = 8;      // analysis.GEMM_BW_MAX_STAGES
constexpr int kStreamRingBytes = 98304;  // analysis.GEMM_BW_RING_BYTES

// row strides (elements) of the A and B slabs: an odd number of 16-byte
// units, so the 8 rows of one ldmatrix or fragment load hit distinct banks
__host__ __device__ constexpr int stream_ldb(int bn) { return (bn / 8) % 2 ? bn : bn + 8; }
__host__ __device__ constexpr int stream_lda(int bk) { return bk + 8; }

int stream_stage_elems(int bm, int bk, int bn) {
  return bm * stream_lda(bk) + bk * stream_ldb(bn);
}

int stream_stages(int bm, int bk, int bn) {
  const int fit = kStreamRingBytes / (stream_stage_elems(bm, bk, bn) * static_cast<int>(sizeof(bf16)));
  return fit < kStreamMaxStages ? fit : kStreamMaxStages;
}

size_t stream_smem_bytes(int bm, int bk, int bn, int stages) {
  return sizeof(bf16) * static_cast<size_t>(stages) * stream_stage_elems(bm, bk, bn) +
         sizeof(float) * static_cast<size_t>(kStreamWarps) * bm * bn;
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA: a bm x BN tile of C (bm 8 or 16), its 4 warps splitting K.
template <int BN>
__global__ void __launch_bounds__(kStreamWarps * 32)
gemm_tiled_stream(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
                  int K, int N, int bm, int bk, int stages) {
  constexpr int LDB = stream_ldb(BN);
  constexpr int NT = BN / 8;  // n8 tiles of one mma each
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stages][A bm x lda | B bk x LDB]
  const int lda = stream_lda(bk);
  const int stage_elems = bm * lda + bk * LDB;
  float* red = reinterpret_cast<float*>(ring + stages * stage_elems);  // [warps][bm][BN]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int64_t tile_m = static_cast<int64_t>(blockIdx.y) * bm;
  const int64_t tile_n = static_cast<int64_t>(blockIdx.x) * BN;
  const bf16* Ab = A + tile_m * K;
  const bf16* Bb = B + tile_n;
  const int n_k = K / bk, a_units = bk / 8;

  auto load = [&](int st, int kt) {
    bf16* As = ring + st * stage_elems;
    bf16* Bs = As + bm * lda;
    const int64_t k0 = static_cast<int64_t>(kt) * bk;
    for (int e = tid; e < bm * a_units; e += nthreads) {
      const int r = e / a_units, c = e % a_units;
      cp_async16(As + r * lda + 8 * c, Ab + r * static_cast<int64_t>(K) + k0 + 8 * c);
    }
    for (int e = tid; e < bk * (BN / 8); e += nthreads) {
      const int r = e / (BN / 8), c = e % (BN / 8);
      cp_async16(Bs + r * LDB + 8 * c, Bb + (k0 + r) * N + 8 * c);
    }
  };

  for (int st = 0; st < stages - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const bool hi = bm > 8;  // rows 8 .. 15 of the m16 tile are live

  for (int i = 0; i < n_k; ++i) {
    // slab i has landed; every warp is done with slab i - 1, whose stage
    // the next copy overwrites
    cp_async_wait_upto(stages - 2);
    __syncthreads();
    {
      const int nxt = i + stages - 1;
      if (nxt < n_k) load(nxt % stages, nxt);
      cp_async_commit();
    }
    const bf16* As = ring + (i % stages) * stage_elems;
    const bf16* Bs = As + bm * lda;
    for (int c = warp; c < bk / 16; c += kStreamWarps) {
      const bf16* ap = As + g * lda + 16 * c + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ap);
      a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
      a[1] = hi ? *reinterpret_cast<const uint32_t*>(ap + 8 * lda) : 0u;
      a[3] = hi ? *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 8) : 0u;
      const uint32_t b_row = smem_u32(Bs + (16 * c + (lane & 15)) * LDB);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, b_row + 16 * j);
        mma_16816(acc[j], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  // split-K inside the CTA: each warp's partial sums, then their sum in warp order
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (row < bm) {
        float* dst = red + (warp * bm + row) * BN + 8 * j + 2 * t;
        dst[0] = acc[j][2 * h];
        dst[1] = acc[j][2 * h + 1];
      }
    }
  __syncthreads();
  for (int e = tid; e < bm * BN; e += nthreads) {
    float s = 0.0f;
    for (int w = 0; w < kStreamWarps; ++w) s += red[w * bm * BN + e];
    C[(tile_m + e / BN) * N + tile_n + e % BN] = __float2bfloat16(s);
  }
}

// -- launch ----------------------------------------------------------------------

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

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel) {
  const int optin = smem_optin();
  if (optin <= 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

template <typename T, int RM, int RN>
cudaError_t launch(const void* a, const void* b, void* c, int M, int K, int N, int bm,
                   int bk, int bn, int sub_m, int sub_n, cudaStream_t stream) {
  auto kernel = gemm_tiled<T, RM, RN>;
  const size_t smem = static_cast<size_t>(bm + bn) * bk * sizeof(T);
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(N / bn, M / bm);
  const int threads = (bm / RM) * (bn / RN);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                          static_cast<T*>(c), K, N, bm, bk, bn, sub_m, sub_n);
  return cudaGetLastError();
}

template <int BK, int MT, int SN>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int K, int N, int bm,
                         int bn, cudaStream_t stream) {
  auto kernel = gemm_tiled_wgmma<BK, MT, SN>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int wg_m = kWgRows * MT;
  if (bm % wg_m || bn % SN) return cudaErrorInvalidValue;
  const int warpgroups = (bm / wg_m) * (bn / SN);
  const int stages = wgmma_stages(bm, BK, bn, smem_optin());
  if (warpgroups > kMaxWarpgroups || stages < kWgMinStages) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(stages) * (bm + bn) * BK * sizeof(bf16) + kAlignSlack;
  const dim3 grid(N / bn, M / bm);
  kernel<<<grid, warpgroups * kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), K, N, bm,
      bn, stages);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_stream(const void* a, const void* b, void* c, int M, int K, int N, int bm,
                          int bk, cudaStream_t stream) {
  auto kernel = gemm_tiled_stream<BN>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if ((bm != 8 && bm != 16) || bk < 16 || bk % 16) return cudaErrorInvalidValue;
  const int stages = stream_stages(bm, bk, BN);
  if (stages < 2) return cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / bm);
  kernel<<<grid, kStreamWarps * 32, stream_smem_bytes(bm, bk, BN, stages), stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), K, N, bm,
      bk, stages);
  return cudaGetLastError();
}

template <typename Kernel>
int max_threads_of(Kernel kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.maxThreadsPerBlock : -static_cast<int>(err);
}

constexpr int wgmma_key(int bk, int mt, int sn) { return bk * 10000 + mt * 1000 + sn; }

}  // namespace

#define REG_TILE_CASES(RM, X) \
  case RM * 16 + 1: X(RM, 1); \
  case RM * 16 + 2: X(RM, 2); \
  case RM * 16 + 4: X(RM, 4); \
  case RM * 16 + 8: X(RM, 8);
#define ALL_REG_TILES(X) REG_TILE_CASES(1, X) REG_TILE_CASES(2, X) REG_TILE_CASES(4, X) REG_TILE_CASES(8, X)

// the wgmma instantiations (analysis.GEMM_WG_INSTANCES): slab depth BK x
// m64 instructions per warpgroup MT x instruction N, with MT * SN <= 256
#define WG_BK(BK, X) X(BK, 1, 64) X(BK, 1, 128) X(BK, 1, 256) X(BK, 2, 64) X(BK, 2, 128)
#define WG_INSTANCES(X) WG_BK(64, X) WG_BK(128, X)
// the bandwidth kernel's instantiations (analysis.GEMM_BW_BN)
#define STREAM_INSTANCES(X) X(8) X(16) X(32) X(64)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success), or -1 for a dtype/tile this file has no instantiation for.
// float32 takes the SIMT kernel of register tile reg_m x reg_n; bfloat16 the
// wgmma kernel for bm >= 64 (instantiation by bk, sub_m / 64 and sub_n) and
// the bandwidth kernel below (instantiation by bn), both with a 1 x 1
// register tile.  Launches on `stream`; never synchronises or allocates.
int repro_gemm(int dtype, const void* a, const void* b, void* c, int M, int K, int N, int bm,
               int bk, int bn, int sub_m, int sub_n, int reg_m, int reg_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_F32(RM, RN) \
  return launch<float, RM, RN>(a, b, c, M, K, N, bm, bk, bn, sub_m, sub_n, s)
#define LAUNCH_WG(BK, MT, SN) \
  case wgmma_key(BK, MT, SN): return launch_wgmma<BK, MT, SN>(a, b, c, M, K, N, bm, bn, s);
#define LAUNCH_STREAM(BN) \
  case BN: return launch_stream<BN>(a, b, c, M, K, N, bm, bk, s);
  if (dtype == 0) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(LAUNCH_F32) }
  } else if (dtype == 1 && reg_m == 1 && reg_n == 1) {
    if (bm >= kWgRows) {
      if (sub_m % kWgRows == 0) {
        switch (wgmma_key(bk, sub_m / kWgRows, sub_n)) { WG_INSTANCES(LAUNCH_WG) }
      }
    } else {
      switch (bn) { STREAM_INSTANCES(LAUNCH_STREAM) }
    }
  }
  return -1;
}

// The launch limit a float32 SIMT instantiation reports
// (cudaFuncAttributes::maxThreadsPerBlock), or -1 / -cudaError_t.
int repro_gemm_max_threads(int dtype, int reg_m, int reg_n) {
#define MAXT_F32(RM, RN) return max_threads_of(gemm_tiled<float, RM, RN>)
  if (dtype == 0) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(MAXT_F32) }
  }
  return -1;
}

// The launch limit of the bfloat16 instantiation repro_gemm launches for
// this tile (bm >= 64: by bk, sub_m / 64 and sub_n; below: by bn), or
// -1 / -cudaError_t.
int repro_gemm_bf16_max_threads(int bm, int bk, int bn, int sub_m, int sub_n) {
#define MAXT_WG(BK, MT, SN) \
  case wgmma_key(BK, MT, SN): return max_threads_of(gemm_tiled_wgmma<BK, MT, SN>);
#define MAXT_STREAM(BN) \
  case BN: return max_threads_of(gemm_tiled_stream<BN>);
  if (bm >= kWgRows) {
    if (sub_m % kWgRows == 0) {
      switch (wgmma_key(bk, sub_m / kWgRows, sub_n)) { WG_INSTANCES(MAXT_WG) }
    }
  } else {
    switch (bn) { STREAM_INSTANCES(MAXT_STREAM) }
  }
  return -1;
}

}  // extern "C"
