// flash_attention — blocked causal / sliding-window attention with GQA, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (launched by flash_attention) for f32.  For q [B, Sq, Hq, hd] and k, v
// [B, Sk, Hkv, hd] (f32, contiguous; query head h reads kv head
// h / (Hq / Hkv)) it computes, in f32,
//
//     s[i, j] = (q_i * hd^-0.5) . k_j          over the visible keys j
//     o_i     = sum_j softmax_j(s[i, :]) v_j    (0 where no key is visible)
//
// with key j visible from the query at absolute position p_i = q_offset + i
// when j < Sk, j <= p_i (causal) and j > p_i - window (window > 0).
//
// This file is the f32 prefill route of the port's flash_attention
// (kernels/flash_attention.py): f32 q, k, v with more than DECODE_ROWS
// query rows per kv head.  bf16 prefill runs on the tensor cores
// (csrc/flash_prefill.cu) and every decode shape, bf16 or f32, splits the
// cache over the card (csrc/flash_decode.cu).
//
// What bounds it: its products run as f32 FMAs on the CUDA cores, each fed
// by a shared-memory load, so shared-memory bandwidth bounds it, far above
// the f32 FMA peak (67 TFLOP/s).  The tensor cores would be faster, but
// only in TF32 for f32 inputs, which keeps about 10 mantissa bits: the
// port's f32 paths are held to 2e-5 of the plain version, so this route
// stays on exact f32 arithmetic.  It runs only on the reduced f32 models
// of the tests and the smoke run, never on the full-width serving path.
//
// Design:
// * One block of 128 threads per (q-tile of 32 rows, query head, batch).
//   The TPU's sequential key-block grid axis becomes a loop over key tiles
//   of 32, carrying the running max m, denominator l and the [32, hd]
//   accumulator in f32 (the accumulator in registers: each row is owned
//   by 4 consecutive lanes, each holding hd/4 interleaved columns).
// * Key tiles that the causal or window mask hides from every row of the
//   q-tile are skipped (the loop covers only [qlo - window + 1, qhi]); a
//   row with no visible key keeps l = 0 and writes 0.
// * q_offset, Sq and Sk are runtime values; ragged tile edges are masked.
// * Q, K, V tiles are read with 16-byte loads (every load of a thread in
//   flight at once) and staged in shared memory as f32 (rows padded by one
//   float so the 4 lanes of a row read different banks): 103 KB at
//   hd = 256 (66 KB at hd = 160, 40 columns a lane), past the 48 KB
//   default, so the launch raises the dynamic shared memory limit first.
// * QK^T and PV are plain FMA loops in the kernel (no library calls).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile
constexpr int kTPR = kThreads / kBQ;    // lanes per query row
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// 16 bytes of T (one vector load) widened to floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hq,
                       int Hkv, int causal, int window, int q_offset, float scale) {
  constexpr int kCols = HD / kTPR;   // accumulator columns per thread
  constexpr int kKeys = kBK / kTPR;  // scores per thread per key tile
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBQ][HD + 1]
  float* sK = sQ + kBQ * (HD + 1);   // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);   // [kBK][HD]
  float* sP = sV + kBK * HD;         // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int nq = min(kBQ, Sq - q0);  // valid rows of this q-tile

  // tiles are read with 16-byte loads, all of a thread's loads in flight
  // at once (the wrapper checked the alignment)
  constexpr int kV = Vec16<T>::N;
  constexpr int kQIters = kBQ * HD / (kThreads * kV);
  constexpr int kKIters = kBK * HD / (kThreads * kV);
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int i = (it * kThreads + tid) * kV, r = i / HD, d = i % HD;
    float x[kV];
    if (r < nq) {
      Vec16<T>::load(q + (((int64_t)b * Sq + q0 + r) * Hq + h) * HD + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) sQ[r * (HD + 1) + d + e] = x[e] * scale;
  }

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  const int qpos = q_offset + q0 + row;
  // rows past Sq skip the products (a decode tile has one row); every lane
  // still joins the shuffles
  const bool live = row < nq;
  const int qlo = q_offset + q0, qhi = q_offset + q0 + nq - 1;
  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, qlo - window + 1);
  if (causal) k_end = min(Sk, qhi + 1);
  k_begin -= k_begin % kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK / sV are done (and sQ is written)
#pragma unroll
    for (int it = 0; it < kKIters; ++it) {
      const int i = (it * kThreads + tid) * kV, j = i / HD, d = i % HD;
      float kx[kV], vx[kV];
      if (k0 + j < Sk) {
        const int64_t off = (((int64_t)b * Sk + k0 + j) * Hkv + hk) * HD + d;
        Vec16<T>::load(k + off, kx);
        Vec16<T>::load(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        sK[j * (HD + 1) + d + e] = kx[e];
        sV[j * HD + d + e] = vx[e];
      }
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int t = 0; t < kKeys; ++t) s[t] = 0.f;
    if (live) {
      const float* qrow = sQ + row * (HD + 1);
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qd = qrow[d];
#pragma unroll
        for (int t = 0; t < kKeys; ++t)
          s[t] = fmaf(qd, sK[(sub + kTPR * t) * (HD + 1) + d], s[t]);
      }
    }

    unsigned visible = 0;
    float tmax = kNegInf;
#pragma unroll
    for (int t = 0; t < kKeys; ++t) {
      const int kp = k0 + sub + kTPR * t;
      const bool ok = live && kp < Sk && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      if (ok) {
        visible |= 1u << t;
        tmax = fmaxf(tmax, s[t]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeys; ++t) {
      const float p = (visible >> t) & 1u ? expf(s[t] - m_new) : 0.f;
      psum += p;
      sP[row * (kBK + 1) + sub + kTPR * t] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's P is written by its own 4 lanes, all in this warp

    if (live) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= corr;
      const float* prow = sP + row * (kBK + 1);
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
        const float* vrow = sV + j * HD + sub;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(p, vrow[kTPR * c], acc[c]);
      }
    }
  }

  if (live) {
    T* out = o + (((int64_t)b * Sq + q0 + row) * Hq + h) * HD + sub;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[kTPR * c] = from_f32<T>(l > 0.f ? acc[c] / l : 0.f);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int Hq, int Hkv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Sk, int Hq, int Hkv, int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale,
                            stream);
    case 160:
      return launch<160, T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale,
                            stream);
    case 256:
      return launch<256, T>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd], o like q; all f32, contiguous,
// 16-byte aligned.  hd in {32, 64, 128, 160, 256}, Hq a multiple of Hkv, B, Sq,
// Hq >= 1 and Sk >= 0 (the caller checked).  window <= 0 means no window.
// Returns the first CUDA error of the attribute call or the launch (0 on
// success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Sk, int Hq, int Hkv, int hd, int causal, int window,
                           int q_offset, float scale, void* stream_ptr) {
  if (B < 1 || Sq < 1 || Sk < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)dispatch<float>(hd, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                              scale, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
