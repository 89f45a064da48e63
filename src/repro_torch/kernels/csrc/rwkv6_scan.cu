// rwkv6_scan — the RWKV6 recurrence with data-dependent decay, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:_kernel
// (launched by rwkv6_scan).  Per batch b and head h, with the state
// S [hd, hd] (f32, starting at s0) and w_t = exp(logw_t), for t = 0..T-1:
//
//     y_t[j]     = sum_i r_t[i] * (u[i] * k_t[i] * v_t[j] + S[i][j])
//     S[i][j]   <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r, k, v, logw are [B, T, H, hd] (bf16 or f32, one dtype), u [H, hd] f32,
// s0 [B, H, hd, hd] f32; y has r's dtype and the final state is f32.
//
// Why sequential: the TPU kernel turns chunks of 16 steps into matrix
// products through exp(m - cum) factors that stay finite only for
// logw >= -4 (its wrapper clamps).  The model never clamps, and the
// sequential form is exact for any logw <= 0, so this kernel runs the
// recurrence step by step.
//
// What bounds it: at the rwkv6-7b prefill shape (B=4, T=256, H=64, hd=64,
// f32) the inputs and outputs are 5 x 16.8 MB plus 2 x 4.2 MB of state,
// 92 MB (27.5 us at 3.35 TB/s), and the recurrence needs 5 FLOPs per
// state element and step (y: 2; S: the k v product and a multiply-add),
// 1.34 GFLOP (20 us at 67 TFLOP/s, f32 on the CUDA cores): bytes bound
// it.  What limits this kernel is latency instead: each step depends on
// the one before, and only B x H = 256 blocks of hd threads exist, about
// two per SM.
//
// Design:
// * One block of hd threads per (b, h); thread j holds column j of S in
//   registers (hd floats; the loops over i are unrolled so S never spills
//   to local memory).
// * r, k, exp(logw) and v of 32 steps at a time are staged in shared
//   memory with coalesced loads (thread j loads channel j of each step),
//   then the 32 steps run with no barrier between them; every thread reads
//   the staged r_t[i], k_t[i], w_t[i] as broadcasts.
// * y_t[j] is written by thread j straight to global memory (coalesced
//   across the block); the final state is written column by column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;  // steps staged in shared memory per pass

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ logw, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                  int n_steps, int H) {
  __shared__ float sR[kSteps][HD], sK[kSteps][HD], sW[kSteps][HD], sV[kSteps][HD];
  __shared__ float sU[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;

  const float* s_in = s0 + ((int64_t)b * H + h) * HD * HD;
  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s_in[i * HD + j];
  sU[j] = u[h * HD + j];

  for (int t0 = 0; t0 < n_steps; t0 += kSteps) {
    const int n = min(kSteps, n_steps - t0);
    __syncthreads();  // the previous pass's reads are done (and sU is written)
    for (int t = 0; t < n; ++t) {
      const int64_t off = (((int64_t)b * n_steps + t0 + t) * H + h) * HD + j;
      sR[t][j] = to_f32(r[off]);
      sK[t][j] = to_f32(k[off]);
      sW[t][j] = expf(to_f32(logw[off]));
      sV[t][j] = to_f32(v[off]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sV[t][j];
      float yj = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = sK[t][i] * vj;
        yj = fmaf(sR[t][i], fmaf(sU[i], kv, S[i]), yj);
        S[i] = fmaf(sW[t][i], S[i], kv);
      }
      y[(((int64_t)b * n_steps + t0 + t) * H + h) * HD + j] = from_f32<T>(yj);
    }
  }

  float* s_fin = s_out + ((int64_t)b * H + h) * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_fin[i * HD + j] = S[i];
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v, const void* logw,
                     const void* u, const void* s0, void* y, void* s_out, int B, int n_steps,
                     int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  switch (hd) {
    case 32:
      rwkv6_scan_kernel<32, T><<<grid, 32, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(logw), static_cast<const float*>(u),
          static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out),
          n_steps, H);
      break;
    case 64:
      rwkv6_scan_kernel<64, T><<<grid, 64, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(logw), static_cast<const float*>(u),
          static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out),
          n_steps, H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r/k/v/logw/y [B, T, H, hd] (one dtype: is_bf16 ? bf16 : f32), u [H, hd]
// f32, s0/s_out [B, H, hd, hd] f32, all contiguous; hd in {32, 64},
// B, T, H >= 1 (the caller checked).  Returns the launch's CUDA error
// (0 on success).
int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, const void* s0, void* y, void* s_out, int B, int n_steps,
                      int H, int hd, int is_bf16, void* stream_ptr) {
  if (B < 1 || n_steps < 1 || H < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(hd, r, k, v, logw, u, s0, y, s_out, B, n_steps, H,
                                        stream);
  return (int)dispatch<float>(hd, r, k, v, logw, u, s0, y, s_out, B, n_steps, H, stream);
}

const char* rwkv6_scan_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
