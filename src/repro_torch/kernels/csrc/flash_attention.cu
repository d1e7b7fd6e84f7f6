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
// float32 or bfloat16; H = KV * G and query head h reads kv head h / G.
//
// Design.  The TPU kernel folds all G query heads of a kv head into one grid
// cell with a (G, bq, hd) f32 VMEM accumulator; at yi-6b's G = 8, hd = 128
// that is 256 KB for bq = 64, over a CTA's 227 KB of shared memory and far
// over its registers.  So one CTA takes one (q block, batch x query head):
// grid (Sq / bq, B * H), heaviest causal q blocks launched first.  bq x TPR
// threads: TPR consecutive threads own one query row.  Per kv block:
//   1. all threads stage the K and V tiles (bkv x hd) in shared memory as
//      f32 (converted once, so the inner loops read float4);
//   2. each thread computes bkv / TPR logits of its row (keys g, g+TPR, ..)
//      from the f32 Q tile (staged once per CTA, pre-scaled) and writes them
//      to the row's slice of a shared P tile;
//   3. the row's TPR threads reduce max and sum with warp shuffles, rescale
//      their accumulator columns by exp(m_old - m_new) and turn the logits
//      into probabilities in place;
//   4. each thread accumulates P @ V for its hd / TPR accumulator columns
//      (float4 chunks interleaved across the row's threads, so one row's
//      reads of a V row hit 32 distinct banks), kept in registers.
// block_q and block_kv are runtime arguments; head_dim is a template
// parameter (16, 32, 64, 128), which fixes TPR and the register tile.
//
// Bound.  At serving shapes (yi-6b prefill: B = 8, S = 4096, H = 32,
// hd = 128) attention does 4*B*H*hd*S(S+1)/2 operations on 2*B*S*(H+KV)*hd
// elements: thousands of operations per byte, far above the H100's ~295
// bf16 ops/byte ridge, so it is bound by operations.  This simple kernel
// computes on CUDA-core FMAs from shared memory.  Left undone, for later
// work: tensor cores (mma.sync, then wgmma over 64-row warpgroup tiles),
// TMA loads of K/V into a pipelined ring of stages (here every K/V tile is
// loaded by all threads between two barriers, with no overlap), bf16
// staging to halve shared memory, and warp specialisation.
//
// Launch limits.  __launch_bounds__ caps each instantiation's registers so
// that max_threads(hd) threads always fit a block; the Python side
// (repro_torch/core/analysis.py:flash_launch_error) refuses every
// configuration outside those limits and over the shared-memory budget
// before it reaches this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 4;  // floats of padding per shared-memory row
__host__ __device__ constexpr int threads_per_row(int hd) { return hd >= 32 ? 8 : 4; }
__host__ __device__ constexpr int max_threads(int hd) { return hd >= 128 ? 512 : 1024; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int bq, int bkv, int hd) {
  const size_t ld = hd + kPad;
  return sizeof(float) * (bq * ld + 2 * bkv * ld + bq * static_cast<size_t>(bkv + kPad));
}

template <typename T, int HD>
__global__ void __launch_bounds__(max_threads(HD))
flash_fwd(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
          T* __restrict__ O, int Sq, int Sk, int H, int KVH, int bq, int bkv, int causal,
          float scale) {
  constexpr int TPR = threads_per_row(HD);
  constexpr int CPT = HD / TPR;  // accumulator columns per thread
  constexpr int C4 = CPT / 4;    // ... in float4 chunks
  constexpr int LD = HD + kPad;  // row stride of the Q, K and V tiles
  extern __shared__ __align__(16) float smem[];
  const int ldp = bkv + kPad;  // row stride of the P tile
  float* Qs = smem;            // [bq][LD], pre-scaled
  float* Ks = Qs + bq * LD;    // [bkv][LD]
  float* Vs = Ks + bkv * LD;   // [bkv][LD]
  float* Ps = Vs + bkv * LD;   // [bq][ldp]: logits, then probabilities

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = tid / TPR, g = tid % TPR;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = iq * bq;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;     // between sequence rows
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const T* Qb = Q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;
  const T* Kb = K + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  const T* Vb = V + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * HD;
  T* Ob = O + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * HD;

  for (int e = tid; e < bq * HD; e += nthreads) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] = to_f32(Qb[r * q_stride + d]) * scale;
  }

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;
  float m_run = -1e30f, l_run = 0.0f;

  const int n_kv = Sk / bkv;
  const int last = causal ? min(n_kv, ((iq + 1) * bq + bkv - 1) / bkv) : n_kv;
  const int nk = bkv / TPR;  // logits per thread per kv block
  const int q_pos = q0 + row;
  const float* qrow = Qs + row * LD;
  float* prow = Ps + row * ldp;

  for (int ik = 0; ik < last; ++ik) {
    const int k0 = ik * bkv;
    __syncthreads();  // the Q tile is stored; the last block's K/V/P reads are done
    for (int e = tid; e < bkv * HD; e += nthreads) {
      const int r = e / HD, d = e % HD;
      const int64_t off = static_cast<int64_t>(k0 + r) * kv_stride + d;
      Ks[r * LD + d] = to_f32(Kb[off]);
      Vs[r * LD + d] = to_f32(Vb[off]);
    }
    __syncthreads();

    // 2. logits of this thread's keys, four at a time
    float bmax = -1e30f;
    for (int i0 = 0; i0 < nk; i0 += 4) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u < nk) {
            const float4 kv =
                *reinterpret_cast<const float4*>(Ks + (g + TPR * (i0 + u)) * LD + d);
            s[u] = fmaf(qv.x, kv.x, s[u]);
            s[u] = fmaf(qv.y, kv.y, s[u]);
            s[u] = fmaf(qv.z, kv.z, s[u]);
            s[u] = fmaf(qv.w, kv.w, s[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u < nk) {
          const int j = g + TPR * (i0 + u);
          const float x = (causal && q_pos < k0 + j) ? -1e30f : s[u];
          prow[j] = x;
          bmax = fmaxf(bmax, x);
        }
      }
    }

    // 3. online softmax over the row's TPR threads
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
    const float m_new = fmaxf(m_run, bmax);
    const float corr = expf(m_run - m_new);
    float bsum = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int j = g + TPR * i;
      const float p = expf(prow[j] - m_new);
      prow[j] = p;
      bsum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
    l_run = l_run * corr + bsum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= corr;
    __syncwarp();  // the row's whole P slice is in shared memory

    // 4. acc += P @ V on this thread's columns 4g + 4*TPR*t + (0..3)
    for (int j = 0; j < bkv; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (j + u) * LD + 4 * g;
#pragma unroll
        for (int t = 0; t < C4; ++t) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * TPR * t);
          acc[4 * t + 0] = fmaf(pj[u], v4.x, acc[4 * t + 0]);
          acc[4 * t + 1] = fmaf(pj[u], v4.y, acc[4 * t + 1]);
          acc[4 * t + 2] = fmaf(pj[u], v4.z, acc[4 * t + 2]);
          acc[4 * t + 3] = fmaf(pj[u], v4.w, acc[4 * t + 3]);
        }
      }
    }
  }

  const float denom = fmaxf(l_run, 1e-30f);
  T* orow = Ob + row * q_stride + 4 * g;
#pragma unroll
  for (int t = 0; t < C4; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) orow[4 * TPR * t + u] = from_f32<T>(acc[4 * t + u] / denom);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KVH, int bq, int bkv, int causal, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd<T, HD>;
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
  const dim3 grid(Sq / bq, B * H);
  const int threads = bq * threads_per_row(HD);
  kernel<<<grid, threads, smem_bytes(bq, bkv, HD), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KVH, bq, bkv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
int max_threads_of() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd<T, HD>);
  return err == cudaSuccess ? attr.maxThreadsPerBlock : -static_cast<int>(err);
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
#define LAUNCH_F32(HD) \
  return launch<float, HD>(q, k, v, o, B, Sq, Sk, H, KVH, bq, bkv, causal, scale, s)
#define LAUNCH_BF16(HD) \
  return launch<__nv_bfloat16, HD>(q, k, v, o, B, Sq, Sk, H, KVH, bq, bkv, causal, scale, s)
  if (dtype == 0) {
    switch (head_dim) { ALL_HEAD_DIMS(LAUNCH_F32) }
  } else if (dtype == 1) {
    switch (head_dim) { ALL_HEAD_DIMS(LAUNCH_BF16) }
  }
  return -1;
}

// The launch limit the compiled instantiation reports
// (cudaFuncAttributes::maxThreadsPerBlock), or -1 / -cudaError_t.
int repro_flash_max_threads(int dtype, int head_dim) {
#define MAXT_F32(HD) return max_threads_of<float, HD>()
#define MAXT_BF16(HD) return max_threads_of<__nv_bfloat16, HD>()
  if (dtype == 0) {
    switch (head_dim) { ALL_HEAD_DIMS(MAXT_F32) }
  } else if (dtype == 1) {
    switch (head_dim) { ALL_HEAD_DIMS(MAXT_BF16) }
  }
  return -1;
}

}  // extern "C"
