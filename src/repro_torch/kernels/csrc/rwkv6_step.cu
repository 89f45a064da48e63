// rwkv6_step — one step (T = 1) of the RWKV6 recurrence, for Hopper (sm_90a):
// the "step" route of rwkv6_scan, the call a decode step makes on every
// layer.  Longer sequences take csrc/rwkv6_scan.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:_kernel at
// T = 1.  Per batch b and head h, with S = s0[b, h] [hd, hd] f32 and
// w = exp(logw):
//
//     y[j]      = v[j] * s + sum_i r[i] * S[i][j],   s = sum_i r[i] u[i] k[i]
//     S'[i][j]  = w[i] * S[i][j] + k[i] * v[j]
//
// What bounds it: reading S and writing S', 4.2 MB each way at rwkv6-7b's
// decode shape (B=4, H=64, hd=64), 2.5 us at 3.35 TB/s; r, k, v, logw and y
// add 0.3 MB.  The arithmetic (3 instructions per state element) is
// negligible, so the kernel is shaped for bandwidth:
// * every thread holds a 4 x 4 tile of S: four 16-byte loads, all issued
//   before any arithmetic, and four 16-byte stores; one block of 256
//   threads per (b, h), 256 blocks at that shape, so each SM has about 32 KB
//   of loads in flight;
// * the bonus term is hoisted: each thread adds v[j] times its own rows'
//   share of s to its partial sum;
// * the partial sums of y[j] are added across the row groups of a warp by
//   __shfl_xor_sync, then across warps through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// four consecutive elements as f32: 16 bytes (f32) or 8 bytes (bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

template <int HD, typename T>
__global__ void __launch_bounds__((HD / 4) * (HD / 4))
rwkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ logw, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                  int H) {
  constexpr int NC4 = HD / 4;                  // column groups of 4 (and row groups of 4)
  constexpr int THREADS = NC4 * NC4, NWARPS = THREADS / 32;
  __shared__ float4 red[NWARPS][NC4];          // per-warp partial sums of y
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int c4 = tid % NC4, row0 = (tid / NC4) * 4, col0 = c4 * 4;
  const int64_t bh = (int64_t)b * H + h;

  const float* s_in = s0 + bh * HD * HD + row0 * HD + col0;
  float4 S[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) S[i] = *reinterpret_cast<const float4*>(s_in + i * HD);

  const int64_t off = bh * HD;  // [b, 0, h, :] of a [B, 1, H, hd] array
  const float4 r4 = load4(r + off + row0), k4 = load4(k + off + row0);
  const float4 lw4 = load4(logw + off + row0), v4 = load4(v + off + col0);
  const float4 u4 = *reinterpret_cast<const float4*>(u + h * HD + row0);
  const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
  const float ww[4] = {expf(lw4.x), expf(lw4.y), expf(lw4.z), expf(lw4.w)};
  const float uu[4] = {u4.x, u4.y, u4.z, u4.w};

  // this thread's rows' share of s, then its partial sums of y
  float a = rr[0] * uu[0] * kk[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) a = fmaf(rr[i] * uu[i], kk[i], a);
  float4 p = make_float4(rr[0] * S[0].x, rr[0] * S[0].y, rr[0] * S[0].z, rr[0] * S[0].w);
#pragma unroll
  for (int i = 1; i < 4; ++i) p = fma4(rr[i], S[i], p);
  p = make_float4(fmaf(v4.x, a, p.x), fmaf(v4.y, a, p.y), fmaf(v4.z, a, p.z), fmaf(v4.w, a, p.w));

  float* s_fin = s_out + bh * HD * HD + row0 * HD + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 kv = make_float4(kk[i] * v4.x, kk[i] * v4.y, kk[i] * v4.z, kk[i] * v4.w);
    *reinterpret_cast<float4*>(s_fin + i * HD) = fma4(ww[i], S[i], kv);
  }

  // lanes m apart (m = NC4, 2 NC4, ... < 32) hold the same columns
#pragma unroll
  for (int m = NC4; m < 32; m <<= 1) {
    p.x += __shfl_xor_sync(0xffffffffu, p.x, m);
    p.y += __shfl_xor_sync(0xffffffffu, p.y, m);
    p.z += __shfl_xor_sync(0xffffffffu, p.z, m);
    p.w += __shfl_xor_sync(0xffffffffu, p.w, m);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < NC4) red[warp][c4] = p;
  __syncthreads();
  if (tid < NC4) {
    float4 acc = red[0][tid];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) {
      const float4 x = red[w][tid];
      acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
    }
    store4(y + off + col0, acc);
  }
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v, const void* logw,
                     const void* u, const void* s0, void* y, void* s_out, int B, int H,
                     cudaStream_t stream) {
  const dim3 grid(H, B);
  switch (hd) {
    case 32:
      rwkv6_step_kernel<32, T><<<grid, 64, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(logw), static_cast<const float*>(u),
          static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out), H);
      break;
    case 64:
      rwkv6_step_kernel<64, T><<<grid, 256, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(logw), static_cast<const float*>(u),
          static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out), H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r/k/v/logw/y [B, 1, H, hd] (one dtype: is_bf16 ? bf16 : f32), u [H, hd]
// f32, s0/s_out [B, H, hd, hd] f32, all contiguous and starting on 16-byte
// boundaries; hd in {32, 64}.  Returns the launch's CUDA error (0 on
// success).
int rwkv6_step_launch(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, const void* s0, void* y, void* s_out, int B, int H, int hd,
                      int is_bf16, void* stream_ptr) {
  if (B < 1 || H < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(hd, r, k, v, logw, u, s0, y, s_out, B, H, stream);
  return (int)dispatch<float>(hd, r, k, v, logw, u, s0, y, s_out, B, H, stream);
}

const char* rwkv6_step_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
