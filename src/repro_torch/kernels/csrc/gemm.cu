// Tiled GEMM for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/gemm.py:_gemm_kernel
// (pallas_call at gemm.py:158).  A (M, K), B (K, N) and C (M, N) are
// row-major and contiguous; inputs are float32 or bfloat16 and C has the
// input type.
//
// Design.  The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid and
// carries an f32 VMEM accumulator across the k axis.  Hopper runs blocks
// in parallel and in no order, so nothing carries between blocks: one CTA
// owns one bm x bn tile of C and loops over K itself, staging each
// bk-deep A and B slab through dynamic shared memory, with the f32
// accumulator in registers.  The tuner's state maps onto the schedule
// level by level:
//   m0 x n0          CTA grid (gridDim.y x gridDim.x)
//   bm x bn          CTA tile; bk the shared-memory K slab, k0 = K/bk trips
//   sub_m x sub_n    warp tile: (sub_m/reg_m) x (sub_n/reg_n) consecutive
//                    threads cover it, (bm/sub_m) x (bn/sub_n) of them per CTA
//   reg_m x reg_n    per-thread register tile (a template parameter)
// All tile sizes but the register tile are runtime arguments, so one
// build serves every state the tuner proposes.
//
// Bound.  At the yi-6b training shapes (M=8192, K>=4096, N>=4096) a GEMM
// does 2MKN operations on (MK + KN + MN) elements: hundreds of operations
// per byte, far above the H100's ~295 bf16 ops/byte ridge, so it is
// bound by operations.  This first kernel computes with CUDA-core FMAs
// (f32 has to stay exact to 1e-4 anyway, which TF32 tensor cores are
// not); the register tile is what sets its arithmetic intensity: each
// thread loads reg_m + reg_n shared-memory values per reg_m * reg_n FMAs.
// Tensor cores (wgmma) and TMA pipelining are later work.
//
// Launch limits.  __launch_bounds__ caps each instantiation's registers
// so that max_threads(reg_m * reg_n) threads always fit a block; the
// Python wrapper (repro_torch/core/analysis.py:gemm_launch_error) refuses
// every configuration outside those limits before it reaches this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int max_threads(int tile) { return tile <= 4 ? 1024 : (tile <= 16 ? 512 : 256); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int RM, int RN>
cudaError_t launch(const void* a, const void* b, void* c, int M, int K, int N, int bm,
                   int bk, int bn, int sub_m, int sub_n, cudaStream_t stream) {
  auto kernel = gemm_tiled<T, RM, RN>;
  const size_t smem = static_cast<size_t>(bm + bn) * bk * sizeof(T);
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(N / bn, M / bm);
  const int threads = (bm / RM) * (bn / RN);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                          static_cast<T*>(c), K, N, bm, bk, bn, sub_m, sub_n);
  return cudaGetLastError();
}

template <typename T, int RM, int RN>
int max_threads_of() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gemm_tiled<T, RM, RN>);
  return err == cudaSuccess ? attr.maxThreadsPerBlock : -static_cast<int>(err);
}

}  // namespace

#define REG_TILE_CASES(RM, X) \
  case RM * 16 + 1: X(RM, 1); \
  case RM * 16 + 2: X(RM, 2); \
  case RM * 16 + 4: X(RM, 4); \
  case RM * 16 + 8: X(RM, 8);
#define ALL_REG_TILES(X) REG_TILE_CASES(1, X) REG_TILE_CASES(2, X) REG_TILE_CASES(4, X) REG_TILE_CASES(8, X)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success), or -1 for a dtype/register tile this file has no
// instantiation for.  Launches on `stream`; never synchronises or allocates.
int repro_gemm(int dtype, const void* a, const void* b, void* c, int M, int K, int N, int bm,
               int bk, int bn, int sub_m, int sub_n, int reg_m, int reg_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_F32(RM, RN) \
  return launch<float, RM, RN>(a, b, c, M, K, N, bm, bk, bn, sub_m, sub_n, s)
#define LAUNCH_BF16(RM, RN) \
  return launch<__nv_bfloat16, RM, RN>(a, b, c, M, K, N, bm, bk, bn, sub_m, sub_n, s)
  if (dtype == 0) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(LAUNCH_F32) }
  } else if (dtype == 1) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(LAUNCH_BF16) }
  }
  return -1;
}

// The launch limit the compiled instantiation reports
// (cudaFuncAttributes::maxThreadsPerBlock), or -1 / -cudaError_t.
int repro_gemm_max_threads(int dtype, int reg_m, int reg_n) {
#define MAXT_F32(RM, RN) return max_threads_of<float, RM, RN>()
#define MAXT_BF16(RM, RN) return max_threads_of<__nv_bfloat16, RM, RN>()
  if (dtype == 0) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(MAXT_F32) }
  } else if (dtype == 1) {
    switch (reg_m * 16 + reg_n) { ALL_REG_TILES(MAXT_BF16) }
  }
  return -1;
}

}  // extern "C"
