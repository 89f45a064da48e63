// cold_fuse — the Repository's single-pass screen + fuse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cold_fuse.py:_kernel
// (launched by _cold_fuse_impl).  For base [N], contribs [K, N] (bf16 or
// f32, one dtype), weights w [K] (f32) and a scalar alpha it computes
//
//     fused[n]  = base[n] + alpha * (sum_k (w_k / sum_j w_j) * m_k[n] - base[n])
//     sq[k]     = sum_n (contribs[k, n] - base[n])^2
//
// where m_k[n] = 0 if w_k == 0 else contribs[k, n]: a zero-weight row is
// removed by a select, not a product, so a NaN row of weight 0 adds nothing
// to fused, while sq is taken from the raw values (a NaN row gives a NaN
// norm, which the screen rejects).  Math is f32; fused is cast to the base
// dtype (round to nearest even).
//
// What bounds it: bytes.  Each element of base and of the K rows is read
// once and fused written once: (K+1)*N*s_in + N*s_out bytes, against a few
// flops per byte.  At K=5, N=123,969,792 bf16 that is 1.736 GB, about
// 0.52 ms at the H100's 3.35 TB/s.
//
// Design:
// * The TPU kernel walks a sequential grid and carries sq in its output
//   block.  Here blocks run in parallel: a fixed grid of blocks strides over
//   N, each thread keeping the K running sums of squares in registers
//   (KMAX is a template bound so the array stays in registers), then each
//   block reduces them (warp shuffles, then across warps in a fixed order)
//   and writes its K partials to scratch[block][k].  A second one-block
//   kernel sums each column in block order.  No atomics: the result is
//   deterministic for a given grid.
// * 16-byte vector loads and stores (8 bf16 or 4 f32 a thread) when N is a
//   multiple of the vector width and the pointers are 16-byte aligned;
//   otherwise a scalar variant (VEC=1).  The grid-stride bound masks the
//   ragged tail; the wrapper pads nothing.
// * sum_j w_j and w_k / sum_j w_j are computed in the kernel from w, in
//   shared memory, as the TPU kernel does.
// Simple and right first: no TMA, no warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, int64_t c, float (&x)[4]) {
    const float4 v = reinterpret_cast<const float4*>(p)[c];
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, int64_t c, const float (&x)[4]) {
    reinterpret_cast<float4*>(p)[c] = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, int64_t c, float (&x)[8]) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t c, const float (&x)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    reinterpret_cast<uint4*>(p)[c] = raw;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, int64_t c, float (&x)[1]) { x[0] = p[c]; }
  static __device__ __forceinline__ void store(float* p, int64_t c, const float (&x)[1]) { p[c] = x[0]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, int64_t c, float (&x)[1]) {
    x[0] = __bfloat162float(p[c]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t c, const float (&x)[1]) {
    p[c] = __float2bfloat16_rn(x[0]);
  }
};

// One pass over [0, n_chunks) chunks of VEC elements: fused for every
// element, and this block's K partial sums of squares into scratch.
template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
cold_fuse_kernel(const T* __restrict__ base, const T* __restrict__ contribs,
                 const float* __restrict__ w, float alpha, T* __restrict__ fused,
                 float* __restrict__ scratch, int64_t n, int64_t n_chunks, int k) {
  __shared__ float s_w[KMAX];    // raw weights (the zero-weight mask)
  __shared__ float s_wn[KMAX];   // w / sum(w)
  __shared__ float s_part[kWarps][KMAX];

  const int tid = threadIdx.x;
  if (tid < k) s_w[tid] = w[tid];
  __syncthreads();
  if (tid < k) {
    float wsum = 0.f;
    for (int j = 0; j < k; ++j) wsum += s_w[j];
    s_wn[tid] = s_w[tid] / wsum;
  }
  __syncthreads();

  float sq[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) sq[j] = 0.f;

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t c = (int64_t)blockIdx.x * kThreads + tid; c < n_chunks; c += stride) {
    float b[VEC], acc[VEC], x[VEC];
    Vec<T, VEC>::load(base, c, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        Vec<T, VEC>::load(contribs + (int64_t)j * n, c, x);
        const bool masked = s_w[j] == 0.f;
        const float wn = s_wn[j];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = x[i] - b[i];
          s = fmaf(d, d, s);
          acc[i] = fmaf(wn, masked ? 0.f : x[i], acc[i]);
        }
        sq[j] += s;
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = b[i] + alpha * (acc[i] - b[i]);
    Vec<T, VEC>::store(fused, c, acc);
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      float v = sq[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[warp][j] = v;
    }
  }
  __syncthreads();
  if (tid < k) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += s_part[i][tid];
    scratch[(int64_t)blockIdx.x * k + tid] = s;
  }
}

// sq[k] = sum over blocks of scratch[block][k], in block order.
__global__ void cold_fuse_reduce(const float* __restrict__ scratch, int n_blocks, int k,
                                 float* __restrict__ sq) {
  const int j = threadIdx.x;
  if (j >= k) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += scratch[(int64_t)b * k + j];
  sq[j] = s;
}

template <typename T, int VEC, int KMAX>
void launch(const void* base, const void* contribs, const void* w, float alpha, void* fused,
            void* scratch, int64_t n, int k, int n_blocks, cudaStream_t stream) {
  cold_fuse_kernel<T, VEC, KMAX><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(base), static_cast<const T*>(contribs),
      static_cast<const float*>(w), alpha, static_cast<T*>(fused),
      static_cast<float*>(scratch), n, n / VEC, k);
}

template <typename T, int VEC>
void dispatch_k(const void* base, const void* contribs, const void* w, float alpha, void* fused,
                void* scratch, int64_t n, int k, int n_blocks, cudaStream_t stream) {
  if (k <= 8) launch<T, VEC, 8>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
  else if (k <= 16) launch<T, VEC, 16>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
  else if (k <= 32) launch<T, VEC, 32>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
  else launch<T, VEC, 64>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
}

}  // namespace

extern "C" {

int cold_fuse_max_k() { return kMaxK; }
int cold_fuse_threads() { return kThreads; }

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 = 16-byte vector path (the
// caller checked N % width == 0 and 16-byte alignment), 0 = scalar path.
// scratch holds n_blocks * k floats.  Returns cudaGetLastError() after
// both launches (0 on success).
int cold_fuse_launch(const void* base, const void* contribs, const void* w, float alpha,
                     void* fused, void* sq, void* scratch, long long n, int k, int n_blocks,
                     int dtype, int vec, void* stream_ptr) {
  if (k < 1 || k > kMaxK || n_blocks < 1 || n < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) {
    if (vec) dispatch_k<float, 4>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
    else dispatch_k<float, 1>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
  } else {
    if (vec) dispatch_k<__nv_bfloat16, 8>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
    else dispatch_k<__nv_bfloat16, 1>(base, contribs, w, alpha, fused, scratch, n, k, n_blocks, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cold_fuse_reduce<<<1, kMaxK, 0, stream>>>(static_cast<const float*>(scratch), n_blocks, k,
                                            static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

const char* cold_fuse_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
