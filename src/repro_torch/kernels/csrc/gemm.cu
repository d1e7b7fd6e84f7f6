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
//   1e-4, which TF32 tensor cores are not).  Bound by operations at the
//   tuned shapes (1024^3 does 2 G operations on 12 MB: 170 per byte, above
//   the ~20 of the FP32 ridge), so the goal is an FMA stream that neither
//   waits for its operands nor spends its issue slots on loads.  The tuner's
//   state maps onto it level by level:
//     m0 x n0          CTA grid (gridDim.y x gridDim.x)
//     bm x bn          CTA tile; bk the shared-memory K slab, k0 = K/bk trips
//     sub_m x sub_n    warp tile: (sub_m/reg_m) x (sub_n/reg_n) consecutive
//                      threads cover it, (bm/sub_m) x (bn/sub_n) of them per CTA
//     reg_m x reg_n    per-thread register tile (a template parameter)
//   * A ring of `stages` slabs: slab i + S - 1 is copied by cp.async while
//     slab i is multiplied.  stages = min(4, opt-in shared memory / slab
//     bytes) (analysis.gemm_stages): a slab that fits once runs with one
//     stage, the same loop with its slot refilled after a barrier.
//   * B's rows arrive by 16-byte cp.async into [bk][bn] (4-byte copies where
//     N or bn is not a multiple of 4).  A is stored transposed, [bk][lda]
//     with lda = 4 (mod 8), by 4-byte cp.async: a warp reads 8 consecutive k
//     of 4 rows (whole 32-byte sectors) and its 32 stores hit 32 banks.  (A
//     16-byte load through registers would hold bm * bk / threads staging
//     registers across the FMAs, a runtime count, where the 8 x 8 tile
//     already holds 64 accumulators.)
//   * A thread's register tile is one run of reg_m (reg_n) rows (columns),
//     or two runs of 4 half a warp tile apart at 8; each run is one 64- or
//     128-bit shared load, so an 8 x 8 tile loads 4 times per 64 FMAs, and
//     a quarter warp's 16-byte loads hit distinct banks or broadcast.
//   * The k loop is unrolled 8 deep; each output sums its K terms in order.
//   * __launch_bounds__ keep the thread limit and ask for two CTAs an SM
//     where the register tile fits the cap that leaves (64 registers at 512
//     threads, 128 at 256): all but the 1024-thread tiles and 2 x 8, 8 x 2.
//
// bfloat16, bm >= 64: gemm_tiled_wgmma<BK, MT, SN>, on the tensor cores.
//   Bound.  At the served and tuned shapes (M >= 8192, K, N >= 512) a GEMM
//   does 2MKN operations on (MK + KN + MN) elements, hundreds per byte, far
//   above the H100's ~295 bf16 ops/byte ridge: it is bound by operations,
//   which only wgmma delivers at the card's rate, and only while the tensor
//   cores are never left without a slab.
//     m0 x n0          CTA grid
//     bm x bn          CTA tile, bk the slab depth (BK: 64 or 128)
//     m1 x n1          consumer warpgroups of the CTA (1 or 2 in all)
//     sub_m x sub_n    a consumer's tile: sub_m = 64 * MT rows (MT m64
//                      instructions), sub_n = SN, the instruction's N
//                      (64, 128 or 256); m3 = n3 = 1 (a wgmma fragment is
//                      fixed by the instruction)
//   * Warp-specialised: the consumer warpgroups and one producer warpgroup
//     (threads (m1 n1 + 1) x 128).  One thread of the producer issues the
//     TMA loads (cp.async.bulk.tensor.2d) of each slab, A's bm x BK and
//     B's BK x bn, as 64-element-wide boxes; the hardware computes every
//     address, so the consumers spend no issue slot or register on a copy.
//     The producer gives its registers up (setmaxnreg.dec to 40) and the
//     consumers take them (setmaxnreg.inc to 232), in one if/else over the
//     warpgroup index, as ptxas requires.
//   * A ring of `stages` slabs (A, then B) and two mbarriers a stage: the
//     TMA completes the stage's `full` barrier with the slab's bytes
//     (expect_tx), and each consumer warpgroup arrives once on its `empty`
//     barrier when its wgmmas have read the slab; phase bits alternate on
//     each pass around the ring.  The main loops hold no __syncthreads.
//     stages = min(8, (opt-in shared memory - 1 KB of alignment slack -
//     128 B of barriers) / slab bytes), at least 2 (analysis.gemm_stages):
//     4 of 128 x 256 x 64, 2 of the 96 KB slabs of 128 x 256 x 128.
//   * Both slabs sit in wgmma's 128-byte swizzled layout: 64-element atoms
//     of 128-byte rows (A: bm rows of 64 k; B: BK rows of 64 n), each
//     row's eight 16-byte chunks permuted by chunk ^ (row % 8), atoms
//     1024-byte aligned, which is what a box lands as under
//     CU_TENSOR_MAP_SWIZZLE_128B.  A is a K-major operand (stride 1024 B
//     between 8-row groups, 32 B start offset per k16 step inside an
//     atom); B, row-major (K, N), is an MN-major operand read with the
//     transpose flag (leading offset BK * 128 B between 64-column atoms,
//     stride 1024 B between 8-row k groups).
//   * Per slab each consumer waits on the slab's `full` barrier, issues
//     MT x BK/16 wgmma m64 n(SN) k16 from shared memory into f32
//     accumulators (MT * SN / 2 registers a thread, at most 128) and
//     commits them as one group; then wgmma.wait_group 1 retires the slab
//     before's group while this one runs, and only then does the consumer
//     release the slab before's stage.  One group stays in flight across
//     slabs, so the tensor cores do not drain at each slab's end.  The
//     accumulators are fenced (an empty asm that pins them) after each
//     wait, as CUTLASS's mainloop does, and the loop is not unrolled, so
//     no instruction but a wgmma defines them while a group is in flight
//     (ptxas otherwise serializes every wgmma).
//   * CTAs walk the C tiles in groups of 8 tile rows, column by column,
//     so the CTAs in flight share A strips and B slabs in the L2.
//   * The epilogue rounds the fragments to bf16 and stores them directly.
//   * The launcher encodes A's and B's tensor maps at each launch
//     (libcuda's cuTensorMapEncodeTiled, looked up through the runtime,
//     so nothing links libcuda) and passes them as __grid_constant__
//     parameters.
//   Tried on the card and not kept (PERF.md section 6): a persistent grid
//   walking the same raster (one CTA an SM, the ring running on across
//   tiles), 8-22 % slower at the served shapes' best tiles; 2 x 1
//   clusters multicasting B's slab to both CTAs, 2.1-2.4 times as long
//   as written.  A staged epilogue was not tried: the direct stores are
//   one pass over C a tile, against 64-462 slabs of operands.
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

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// -- shared helpers ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
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

// -- float32: CUDA cores ---------------------------------------------------------

constexpr int max_threads(int tile) { return tile <= 4 ? 1024 : (tile <= 16 ? 512 : 256); }
// CTAs an SM holds under the register cap: two where the register tile fits
// the cap that leaves (64 registers a thread at 512 threads, 128 at 256); one
// at 1024 threads, and for the 2 x 8 and 8 x 2 tiles, whose operand runs
// take 78-79 registers (ptxas spills them under 64)
constexpr int min_blocks(int rm, int rn) {
  return rm * rn <= 4 || (rm * rn == 16 && rm != rn) ? 1 : 2;
}

constexpr int kSimtMaxStages = 4;  // analysis.GEMM_SIMT_MAX_STAGES
constexpr int kSimtUnroll = 8;     // k steps of one unrolled block of the inner loop

// the row stride (floats) of a transposed A slab: the least ld >= bm with
// ld = 4 (mod 8) (analysis.simt_lda)
__host__ __device__ constexpr int simt_lda(int bm) { return bm + (12 - bm % 8) % 8; }

int simt_slab_bytes(int bm, int bk, int bn) {
  return (simt_lda(bm) + bn) * bk * static_cast<int>(sizeof(float));
}

int simt_stages(int bm, int bk, int bn, int smem_optin) {
  const int fit = smem_optin / simt_slab_bytes(bm, bk, bn);
  return fit < kSimtMaxStages ? fit : kSimtMaxStages;
}

// W consecutive floats, one load or store of 32 W bits (p is 4 W-byte aligned)
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

// How a CTA's threads split one slab's copies: thread t takes the elements
// e = t, t + threads, ... of a grid with `cols` columns, each as (row, col)
// with e = row * cols + col.  The steps are computed once on the host (kernel
// parameters sit in the constant bank, not in registers).
struct SimtCopy {
  int a_run;              // A: k elements a thread copies in a row (at most 8)
  int a_drow, a_dcol;     // A's grid: (k run, row of A), bm columns
  int b_cols;             // B's grid: (k, 16- or 4-byte unit of a row)
  int b_drow, b_dcol;
};

SimtCopy simt_copy(int bm, int bk, int bn, int N, int threads) {
  SimtCopy c;
  c.a_run = (bk & -bk) < 8 ? (bk & -bk) : 8;  // threads is whole warps: a multiple of it
  c.a_drow = threads / c.a_run / bm, c.a_dcol = threads / c.a_run % bm;
  c.b_cols = bn % 4 == 0 && N % 4 == 0 ? bn / 4 : bn;  // 16-byte units where rows align
  c.b_drow = threads / c.b_cols, c.b_dcol = threads % c.b_cols;
  return c;
}

// (row, col) of one thread's copy e, stepped by (drow, dcol) without a division
struct Walk {
  int row, col;
  __device__ __forceinline__ void next(int drow, int dcol, int cols) {
    row += drow, col += dcol;
    if (col >= cols) col -= cols, ++row;
  }
};

// one k step: a thread's RM values of A and RN of B from shared memory, in
// runs of up to 4 (two runs half a warp tile apart at 8), then RM x RN FMAs
template <int RM, int RN>
__device__ __forceinline__ void fma_step(float (&acc)[RM][RN], const float* ap, const float* bp,
                                         int row_step, int col_step) {
  constexpr int WM = RM < 4 ? RM : 4, WN = RN < 4 ? RN : 4;
  float a[RM], b[RN];
#pragma unroll
  for (int r = 0; r < RM / WM; ++r) Run<WM>::load(a + r * WM, ap + r * row_step);
#pragma unroll
  for (int r = 0; r < RN / WN; ++r) Run<WN>::load(b + r * WN, bp + r * col_step);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// One CTA: a bm x bn tile of C, (bm / RM) x (bn / RN) threads, each holding
// RM x RN accumulators; K in bk-deep slabs through a ring of `stages` slots.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(max_threads(RM * RN), min_blocks(RM, RN))
gemm_tiled(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
           int K, int N, int bm, int bk, int bn, int sub_m, int sub_n, int stages,
           const SimtCopy copy) {
  static_assert(sizeof(T) == sizeof(float), "the SIMT kernel is float32's");
  constexpr int WM = RM < 4 ? RM : 4, WN = RN < 4 ? RN : 4;  // run widths
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = simt_lda(bm);
  float* As = reinterpret_cast<float*>(smem);  // [stages][bk][lda]: A slabs, transposed
  float* Bs = As + stages * bk * lda;          // [stages][bk][bn]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int m2 = sub_m / RM, n2 = sub_n / RN;  // threads per warp tile
  const int warp_tiles_n = bn / sub_n;
  const int group = tid / (m2 * n2), lane = tid % (m2 * n2);
  // a thread's rows: RM / WM runs of WM, the second sub_m / 2 below the first
  // (so a quarter warp's 16-byte loads cover 32 distinct banks); likewise columns
  const int row_step = sub_m / 2, col_step = sub_n / 2;
  const int row0 = (group / warp_tiles_n) * sub_m + (lane / n2) * WM;
  const int col0 = (group % warp_tiles_n) * sub_n + (lane % n2) * WN;
  const int64_t tile_m = static_cast<int64_t>(blockIdx.y) * bm;
  const int64_t tile_n = static_cast<int64_t>(blockIdx.x) * bn;
  const T* Ab = A + tile_m * K;
  const T* Bb = B + tile_n;
  const int n_k = K / bk;

  // A: each warp copies runs of a_run (8) consecutive k of 32 / a_run rows
  // (whole 32-byte sectors), 4 bytes a copy, each landing transposed; with
  // lda = 4 (mod 8) the 32 stores of a warp hit 32 distinct banks.  B: 16
  // bytes a copy where its rows are 16-byte aligned (copy.b_cols < bn)
  const int a_k = tid % copy.a_run;
  const Walk a0{tid / copy.a_run / bm, tid / copy.a_run % bm};  // (k run, row of A)
  const Walk b0{tid / copy.b_cols, tid % copy.b_cols};          // (k, unit of a row)

  auto load = [&](int st, int kt) {
    float* as = As + st * bk * lda;
    float* bs = Bs + st * bk * bn;
    const int64_t k0 = static_cast<int64_t>(kt) * bk;
    for (Walk e = a0; e.row * copy.a_run < bk; e.next(copy.a_drow, copy.a_dcol, bm)) {
      const int c = e.row * copy.a_run + a_k;
      cp_async4(as + c * lda + e.col, Ab + static_cast<int64_t>(e.col) * K + k0 + c);
    }
    for (Walk e = b0; e.row < bk; e.next(copy.b_drow, copy.b_dcol, copy.b_cols)) {
      const T* src = Bb + (k0 + e.row) * N;
      if (copy.b_cols < bn)
        cp_async16(bs + e.row * bn + 4 * e.col, src + 4 * e.col);
      else
        cp_async4(bs + e.row * bn + e.col, src + e.col);
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  // the ring: slabs 0 .. stages - 2 first, one copy group each; then slab
  // i + stages - 1 is in flight while slab i is multiplied.  One stage: the
  // slot is refilled once every thread is done with the slab before.
  for (int st = 0; st < stages - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    if (stages == 1) {
      if (i > 0) __syncthreads();
      load(0, i);
      cp_async_commit();
    }
    // slab i has landed; every thread is done with slab i - 1, whose slot
    // the next copy overwrites
    cp_async_wait_upto(stages > 1 ? stages - 2 : 0);
    __syncthreads();
    if (stages > 1) {
      const int nxt = i + stages - 1;
      if (nxt < n_k) load(nxt % stages, nxt);
      cp_async_commit();
    }
    const int cur = i % stages;
    const float* ap = As + cur * bk * lda + row0;
    const float* bp = Bs + cur * bk * bn + col0;
    int kk = 0;
    for (; kk + kSimtUnroll <= bk; kk += kSimtUnroll)
#pragma unroll
      for (int u = 0; u < kSimtUnroll; ++u, ap += lda, bp += bn)
        fma_step<RM, RN>(acc, ap, bp, row_step, col_step);
    for (; kk < bk; ++kk, ap += lda, bp += bn) fma_step<RM, RN>(acc, ap, bp, row_step, col_step);
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* crow = C + (tile_m + row0 + (i / WM) * row_step + i % WM) * N + tile_n + col0;
#pragma unroll
    for (int r = 0; r < RN / WN; ++r) Run<WN>::store(crow + r * col_step, &acc[i][r * WN]);
  }
}

// -- bfloat16: shared helpers ------------------------------------------------------

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

// mbarriers in shared memory (addresses from smem_u32)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more of the TMA's transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed (a barrier in its
// first phase counts the phase before it, of parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 innermost, c1) of a tensor map into shared memory,
// completing `bar`'s transactions with its bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- bfloat16, bm >= 64: tensor cores (wgmma) ---------------------------------------

constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kWgRows = 64;         // the M of wgmma
constexpr int kMaxWarpgroups = 2;   // consumer warpgroups: analysis.GEMM_WG_MAX
// the CTA's thread limit: the consumers and the producer warpgroup
constexpr int kWgCtaThreads = (kMaxWarpgroups + 1) * kWgThreads;
constexpr int kWgMaxStages = 8;     // analysis.GEMM_WG_MAX_STAGES
constexpr int kWgMinStages = 2;     // analysis.GEMM_WG_MIN_STAGES
constexpr int kGroupRows = 8;       // tile rows per raster group
constexpr int kAtom = 64;           // elements of one 128-byte swizzled row
constexpr int kAlignSlack = 1024;   // analysis.GEMM_ALIGN_SLACK: atoms are 1024-byte aligned
// a full and an empty mbarrier for each stage (analysis.GEMM_WG_BARRIER_BYTES)
constexpr int kBarrierBytes = 2 * kWgMaxStages * 8;
// registers a thread after setmaxnreg: the launch gives 168 (65536 / 384);
// the producer keeps 40, the consumers take 232 (128 x 40 + 256 x 232 fit)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

int wgmma_slab_bytes(int bm, int bk, int bn) {
  return (bm + bn) * bk * static_cast<int>(sizeof(bf16));
}

int wgmma_stages(int bm, int bk, int bn, int smem_optin) {
  const int fit = (smem_optin - kAlignSlack - kBarrierBytes) / wgmma_slab_bytes(bm, bk, bn);
  return fit < kWgMaxStages ? fit : kWgMaxStages;
}

size_t wgmma_smem_bytes(int bm, int bk, int bn, int stages) {
  return static_cast<size_t>(stages) * wgmma_slab_bytes(bm, bk, bn) + kAlignSlack + kBarrierBytes;
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

// One CTA: a bm x bn tile of C by (bm / (64 MT)) x (bn / SN) consumer
// warpgroups and one producer warpgroup (the last).
template <int BK, int MT, int SN>
__global__ void __launch_bounds__(kWgCtaThreads, 1)
gemm_tiled_wgmma(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, bf16* __restrict__ C, int K, int N,
                 int bm, int bn, int stages) {
  static_assert(MT * SN / 2 <= 128, "accumulators over the register cliff");
  static_assert(BK % kAtom == 0 && SN % kAtom == 0, "whole 128-byte swizzle atoms");
  constexpr int WG_M = kWgRows * MT;  // a warpgroup's rows (sub_m)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [stages][A: BK/64 atoms of bm rows | B: bn/64 atoms of BK rows], 1024-aligned,
  // then the full and the empty barriers
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlignSlack - 1) & ~uintptr_t(kAlignSlack - 1));
  const int slab_bytes = (bm + bn) * BK * static_cast<int>(sizeof(bf16));
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t full = ring_addr + stages * slab_bytes, empty = full + 8 * kWgMaxStages;

  const int tid = threadIdx.x;
  const int consumers = blockDim.x / kWgThreads - 1;
  const int wg = tid / kWgThreads;
  // grouped raster: kGroupRows tile rows at a time, column by column
  const int grid_n = gridDim.x, lin = blockIdx.y * grid_n + blockIdx.x;
  const int first = (lin / (kGroupRows * grid_n)) * kGroupRows;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroupRows);
  const int in_group = lin % (kGroupRows * grid_n);
  const int tile_m = (first + in_group % rows) * bm;
  const int tile_n = (in_group / rows) * bn;
  const int n_k = K / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == consumers) {
    // the producer: one thread keeps every free stage's TMA loads in flight
    setmaxnreg_dec<kProducerRegs>();
    if (tid == consumers * kWgThreads) {
      for (int i = 0; i < n_k; ++i) {
        const int slot = i % stages;
        // the consumers have released slab i - stages (the first pass
        // waits on the phase before the first, which counts as completed)
        mbar_wait(empty + 8 * slot, ((i / stages) & 1) ^ 1);
        const uint32_t bar = full + 8 * slot;
        mbar_arrive_expect_tx(bar, slab_bytes);
        const uint32_t as = ring_addr + slot * slab_bytes, bs = as + 2 * bm * BK;
        const int k0 = i * BK;
#pragma unroll
        for (int a = 0; a < BK / kAtom; ++a)
          tma_load_2d(as + a * bm * 128, &a_map, k0 + a * kAtom, tile_m, bar);
        for (int a = 0; a < bn / kAtom; ++a)
          tma_load_2d(bs + a * BK * 128, &b_map, tile_n + a * kAtom, k0, bar);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
    const int wgs_n = bn / SN;
    const int wm = (wg / wgs_n) * WG_M, wn = (wg % wgs_n) * SN;  // the warpgroup's tile
    const bool leader = tid % kWgThreads == 0;  // arrives for the warpgroup

    float acc[MT][SN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) acc[mt][i] = 0.0f;

#pragma unroll 1
    for (int i = 0; i < n_k; ++i) {
      const int slot = i % stages;
      mbar_wait(full + 8 * slot, (i / stages) & 1);  // slab i has landed
      const uint32_t stage = ring_addr + slot * slab_bytes;
      // A: the warpgroup's rows of each atom; B: its first 64-column atom
      const uint32_t a_addr = stage + wm * 128;
      const uint32_t b_addr = stage + 2 * bm * BK + (wn / kAtom) * BK * 128;
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
      // slab i - 1's group has retired (slab i's runs on): its stage is free
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < SN / 2; ++j) fence_operand(acc[mt][j]);
      if (i > 0 && leader) mbar_arrive(empty + 8 * (slot == 0 ? stages - 1 : slot - 1));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < SN / 2; ++j) fence_operand(acc[mt][j]);

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
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    const cudaError_t err = opt_in_smem(kernel);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int stages = simt_stages(bm, bk, bn, smem_optin());
  if (stages < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(stages) * simt_slab_bytes(bm, bk, bn);
  const dim3 grid(N / bn, M / bm);
  const int threads = (bm / RM) * (bn / RN);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                          static_cast<T*>(c), K, N, bm, bk, bn, sub_m, sub_n,
                                          stages, simt_copy(bm, bk, bn, N, threads));
  return cudaGetLastError();
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (nothing
// links libcuda); null where it is not found
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled load_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

// The tensor map of a row-major rows x cols bf16 matrix read in boxes of
// box_rows x 64 columns, each landing in the 128-byte swizzled layout.
bool encode_sw128(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  static const EncodeTiled encode = load_encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {kAtom, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// consumer warpgroups of a wgmma tile, and the CTA's threads with the producer
int wgmma_consumers(int bm, int bn, int sub_m, int sub_n) { return (bm / sub_m) * (bn / sub_n); }
int wgmma_threads(int bm, int bn, int sub_m, int sub_n) {
  return (wgmma_consumers(bm, bn, sub_m, sub_n) + 1) * kWgThreads;
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
  const int stages = wgmma_stages(bm, BK, bn, smem_optin());
  if (wgmma_consumers(bm, bn, wg_m, SN) > kMaxWarpgroups || stages < kWgMinStages)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!encode_sw128(&a_map, a, M, K, bm) || !encode_sw128(&b_map, b, K, N, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(N / bn, M / bm);
  kernel<<<grid, wgmma_threads(bm, bn, wg_m, SN), wgmma_smem_bytes(bm, BK, bn, stages), stream>>>(
      a_map, b_map, static_cast<bf16*>(c), K, N, bm, bn, stages);
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

// The ring the float32 SIMT kernel launches a bm x bk x bn tile with on the
// current device: its stages (0 where one slab does not fit), and in
// *smem_bytes its shared memory (analysis.gemm_stages / gemm_smem_bytes).
int repro_gemm_f32_ring(int bm, int bk, int bn, int* smem_bytes) {
  const int stages = simt_stages(bm, bk, bn, smem_optin());
  *smem_bytes = stages * simt_slab_bytes(bm, bk, bn);
  return stages;
}

// The ring the bfloat16 wgmma kernel launches a bm x bk x bn tile of
// sub_m x sub_n consumer warpgroups with on the current device: its stages
// (below 2 where the kernel refuses the tile), in *threads the CTA's
// threads (the consumers and the producer) and in *smem_bytes its shared
// memory (analysis.gemm_stages, gemm_wgmma_threads, gemm_smem_bytes).
int repro_gemm_wgmma_ring(int bm, int bk, int bn, int sub_m, int sub_n, int* threads,
                          int* smem_bytes) {
  const int stages = wgmma_stages(bm, bk, bn, smem_optin());
  *threads = wgmma_threads(bm, bn, sub_m, sub_n);
  *smem_bytes = static_cast<int>(wgmma_smem_bytes(bm, bk, bn, stages));
  return stages;
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
