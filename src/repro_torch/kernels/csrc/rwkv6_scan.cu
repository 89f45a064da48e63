// rwkv6_scan — the RWKV6 recurrence with data-dependent decay, for Hopper
// (sm_90a): the "scan" route (T > 1, prefill).  The T = 1 decode step has its
// own kernel, csrc/rwkv6_step.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:_kernel
// (launched by rwkv6_scan).  Per batch b and head h, with the state
// S [hd, hd] (f32, starting at s0) and w_t = exp(logw_t), for t = 0..T-1:
//
//     y_t[j]     = v_t[j] * s_t + sum_i r_t[i] * S[i][j],   s_t = sum_i r_t[i] u[i] k_t[i]
//     S[i][j]   <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// (the bonus term u_i k_i v_j factors out of the sum over i, so it costs one
// dot product per step instead of one multiply-add per state element).
// r, k, v, logw are [B, T, H, hd] (bf16 or f32, one dtype), u [H, hd] f32,
// s0 [B, H, hd, hd] f32; y has r's dtype and the final state is f32.
//
// Why sequential: the TPU kernel turns chunks of 16 steps into matrix
// products through exp(m - cum) factors that stay finite only for
// logw >= -4 (its wrapper clamps).  The model never clamps, and the
// sequential form is exact for any logw <= 0, so this kernel runs the
// recurrence step by step.
//
// What bounds it: at rwkv6-7b's prefill shape (B=4, T=256, H=64, hd=64, f32)
// the inputs and outputs are 5 x 16.8 MB plus 2 x 4.2 MB of state, 92 MB
// (27.5 us at 3.35 TB/s).  Each state element and step costs three FP32
// instructions (k v, S = fma(w, S, kv), y = fma(r, S, y)): 0.81 G, about
// 25 us on the card's FP32 lanes.  So the kernel has to keep those lanes
// busy, which takes many warps: one thread per column and 64 rows (the
// first port) gave about 4 warps per SM and waited on its own FMA chain.
//
// Design:
// * The columns of S are independent; the rows of a column meet only in
//   y's sum.  A thread holds a 4 x 4 tile of S in registers and, each step,
//   writes its rows' partial sum of r_t[i] S[i][j] to shared memory; after
//   a chunk of 16 steps one pass adds the HD/4 row groups' sums (in order),
//   adds v_t[j] s_t and writes y.
// * One block of (hd / 4)^2 threads (256 at hd 64) per (b, h), so every
//   input is read once; 2 blocks (96 KB of shared memory each) and 16 warps
//   per SM.
// * Staging overlaps compute: the next chunk's r, k, logw, v are loaded
//   into registers (16 bytes a load) before the current chunk's steps and
//   written to the other shared buffer after them, as f32 with
//   w = exp(logw), so a chunk costs two barriers and no separate pass.
// * The recurrence stays exact and sequential: no chunked matrix form, no
//   clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive outputs, 16 bytes (f32) or 8 bytes (bf16)
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// 16 bytes of inputs as f32: 4 (f32) or 8 (bf16) values
__device__ __forceinline__ void unpack(uint4 x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x), f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z), f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, float (&f)[8]) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x, f[2 * i + 1] = p.y;
  }
}

template <int HD_>
struct Cfg {
  static constexpr int HD = HD_;        // head dim (rows and columns of S)
  static constexpr int RT = 4, CT = 4;  // rows x columns of S per thread
  static constexpr int CHUNK = 16;      // steps staged per pass
  static constexpr int NRG = HD / RT;   // row groups
  static constexpr int NCG = HD / CT;   // column groups
  static constexpr int THREADS = NRG * NCG;
  static constexpr int UNITS = HD / 4;                 // float4 columns of a y row
  static constexpr int TPW = 32 / UNITS;               // steps a warp's y pass takes at once
  static_assert(THREADS % 32 == 0 && 32 % UNITS == 0, "whole warps");
  // comp [2][4][CHUNK][HD] f32 (r, k, w, v of two chunks); u [HD]; ypart [CHUNK][NRG][HD]
  static constexpr int SMEM = 4 * (2 * 4 * CHUNK * HD + HD + CHUNK * NRG * HD);
};

template <class C, typename T>
__global__ void __launch_bounds__(C::THREADS, 2)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ logw, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                  int n_steps, int H) {
  constexpr int HD = C::HD, CHUNK = C::CHUNK, RT = C::RT, CT = C::CT;
  constexpr int NRG = C::NRG, NCG = C::NCG, THREADS = C::THREADS, NWARPS = THREADS / 32;
  constexpr int STAGE = 4 * CHUNK * HD;                 // floats of one chunk in comp
  constexpr int PER16 = 16 / (int)sizeof(T);            // elements per 16-byte load
  constexpr int PPR = HD / PER16;                       // loads per row of one step
  constexpr int NP = 4 * CHUNK * PPR / THREADS;         // loads per thread and chunk
  static_assert(NP * THREADS == 4 * CHUNK * PPR, "a chunk's loads split evenly");
  constexpr int UNITS = C::UNITS, TPW = C::TPW;
  constexpr int YSTEP = NWARPS * TPW;                       // steps per trip of the y pass
  constexpr int YEND = (CHUNK + YSTEP - 1) / YSTEP * YSTEP;  // every lane's trips end here
  extern __shared__ __align__(16) float smem[];
  float* comp = smem;                   // [2][4][CHUNK][HD]: r, k, w = exp(logw), v
  float* su = comp + 2 * STAGE;         // u [HD]
  float* ypart = su + HD;               // [CHUNK][NRG][HD]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cg = tid % NCG, rg = tid / NCG, warp = tid / 32, lane = tid % 32;
  const int row0 = rg * RT, col0 = cg * CT;
  const int64_t bh = (int64_t)b * H + h;
  const int64_t step_stride = (int64_t)H * HD;              // one step further in r, k, v, y
  const int64_t base = (int64_t)b * n_steps * step_stride + (int64_t)h * HD;

  float S[RT][CT];
  {
    const float* s_in = s0 + bh * HD * HD;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(s_in + (row0 + i) * HD + col0);
      S[i][0] = x.x, S[i][1] = x.y, S[i][2] = x.z, S[i][3] = x.w;
    }
  }
  for (int i = tid; i < HD; i += THREADS) su[i] = u[h * HD + i];

  // a chunk's r, k, logw, v: 16-byte loads into registers (issued a chunk
  // ahead), then into comp as f32 with w = exp(logw); steps past T read 0
  uint4 pre[NP];
  auto fetch = [&](int c) {
    const int t0 = c * CHUNK, n = min(CHUNK, n_steps - t0);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = tid + i * THREADS;
      const int a = p / (CHUNK * PPR), t = (p / PPR) % CHUNK, q = p % PPR;
      const T* src = a == 0 ? r : a == 1 ? k : a == 2 ? logw : v;
      pre[i] = t < n ? __ldg(reinterpret_cast<const uint4*>(
                           src + base + (int64_t)(t0 + t) * step_stride + q * PER16))
                     : make_uint4(0, 0, 0, 0);
    }
  };
  auto park = [&](int c) {
    float* dst = comp + (c & 1) * STAGE;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = tid + i * THREADS;
      const int a = p / (CHUNK * PPR), t = (p / PPR) % CHUNK, q = p % PPR;
      float f[PER16];
      unpack(pre[i], f);
      if (a == 2) {
#pragma unroll
        for (int e = 0; e < PER16; ++e) f[e] = expf(f[e]);
      }
      float* d = dst + (a * CHUNK + t) * HD + q * PER16;
#pragma unroll
      for (int e = 0; e < PER16; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  };

  // one step: partial sums of r_t[i] S[i][j] over this thread's rows into
  // ypart, then S <- w S + k v
  auto step = [&](const float* cc, int t) {
    float rr[RT], kk[RT], ww[RT];
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(cc + (0 * CHUNK + t) * HD + row0 + i);
      const float4 k4 = *reinterpret_cast<const float4*>(cc + (1 * CHUNK + t) * HD + row0 + i);
      const float4 w4 = *reinterpret_cast<const float4*>(cc + (2 * CHUNK + t) * HD + row0 + i);
      rr[i] = r4.x, rr[i + 1] = r4.y, rr[i + 2] = r4.z, rr[i + 3] = r4.w;
      kk[i] = k4.x, kk[i + 1] = k4.y, kk[i + 2] = k4.z, kk[i + 3] = k4.w;
      ww[i] = w4.x, ww[i + 1] = w4.y, ww[i + 2] = w4.z, ww[i + 3] = w4.w;
    }
    const float4 v4 = *reinterpret_cast<const float4*>(cc + (3 * CHUNK + t) * HD + col0);
    const float vv[CT] = {v4.x, v4.y, v4.z, v4.w};
    float p[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) p[j] = rr[0] * S[0][j];
#pragma unroll
    for (int i = 1; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) p[j] = fmaf(rr[i], S[i][j], p[j]);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) S[i][j] = fmaf(ww[i], S[i][j], kk[i] * vv[j]);
    *reinterpret_cast<float4*>(ypart + (t * NRG + rg) * HD + col0) =
        make_float4(p[0], p[1], p[2], p[3]);
  };

  const int n_chunks = (n_steps + CHUNK - 1) / CHUNK;
  fetch(0);
  park(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CHUNK, n = min(CHUNK, n_steps - t0);
    const float* cc = comp + (c & 1) * STAGE;
    if (c + 1 < n_chunks) fetch(c + 1);  // in flight while the steps run
    if (n == CHUNK) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) step(cc, t);
    } else {
      for (int t = 0; t < n; ++t) step(cc, t);
    }
    if (c + 1 < n_chunks) park(c + 1);  // the other buffer: its last readers are done
    __syncthreads();

    // y_t[j] = (the row groups' partial sums, in order) + v_t[j] s_t: a
    // warp takes TPW steps at once, UNITS lanes each; lane l of a step adds
    // the NRG partial sums of columns 4 l.. and s_t's terms of rows 4 l..
    // Every lane runs the same trips (the shuffles need the whole warp);
    // steps past n compute on stale values and store nothing.
    for (int t = warp * TPW + lane / UNITS; t < YEND; t += YSTEP) {
      const int tt = min(t, CHUNK - 1), c4 = (lane % UNITS) * 4;
      float s = 0.f;  // s_t = sum_i r_t[i] u[i] k_t[i]
      {
        const float4 r4 = *reinterpret_cast<const float4*>(cc + (0 * CHUNK + tt) * HD + c4);
        const float4 k4 = *reinterpret_cast<const float4*>(cc + (1 * CHUNK + tt) * HD + c4);
        const float4 u4 = *reinterpret_cast<const float4*>(su + c4);
        s = fmaf(r4.x * u4.x, k4.x, s), s = fmaf(r4.y * u4.y, k4.y, s);
        s = fmaf(r4.z * u4.z, k4.z, s), s = fmaf(r4.w * u4.w, k4.w, s);
      }
#pragma unroll
      for (int m = UNITS / 2; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      const float* yp = ypart + tt * NRG * HD + c4;
      float4 acc = *reinterpret_cast<const float4*>(yp);
#pragma unroll
      for (int g = 1; g < NRG; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(yp + g * HD);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      if (t < n) {
        const float4 v4 = *reinterpret_cast<const float4*>(cc + (3 * CHUNK + t) * HD + c4);
        acc.x = fmaf(v4.x, s, acc.x), acc.y = fmaf(v4.y, s, acc.y);
        acc.z = fmaf(v4.z, s, acc.z), acc.w = fmaf(v4.w, s, acc.w);
        store4(y + base + (int64_t)(t0 + t) * step_stride + c4, acc);
      }
    }
    __syncthreads();  // ypart and this chunk's buffer are free again
  }

  float* s_fin = s_out + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    *reinterpret_cast<float4*>(s_fin + (row0 + i) * HD + col0) =
        make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
}

template <class C, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
                   const void* s0, void* y, void* s_out, int B, int n_steps, int H,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  rwkv6_scan_kernel<C, T><<<dim3(H, B), C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(logw), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), n_steps, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0, void* y, void* s_out,
                     int B, int n_steps, int H, cudaStream_t stream) {
#define RWKV6_LAUNCH(C) launch<C, T>(r, k, v, logw, u, s0, y, s_out, B, n_steps, H, stream)
  if (hd == 64) return RWKV6_LAUNCH(Cfg<64>);
  if (hd == 32) return RWKV6_LAUNCH(Cfg<32>);
#undef RWKV6_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r/k/v/logw/y [B, T, H, hd] (one dtype: is_bf16 ? bf16 : f32), u [H, hd]
// f32, s0/s_out [B, H, hd, hd] f32, all contiguous and starting on 16-byte
// boundaries; hd in {32, 64}.  Returns the launch's CUDA error (0 on
// success).
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
