// decode_accum — decode + weighted accumulate of a delta-compressed cohort,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cold_fuse.py:_decode_kernel
// (launched by _decode_accum_impl).  For C compressed contributions, each
// nb codec blocks of `block` elements keeping kb entries (int16 offsets
// idx [C, nb, kb], int8 values val [C, nb, kb], f32 scales scl [C, nb]) and
// weights w [C] it computes
//
//     d = float(val[c, b, j]) * scl[c, b]           (the dequantised delta)
//     acc[b*block + idx[c, b, j]] += w[c] * d        for every c with w[c] != 0
//     sq[c] = sum over b, j of d^2                   (raw values, every entry)
//
// and returns acc cut to `size`.  Duplicate offsets add up; a row of weight
// exactly 0 is left out of acc by a select (so a NaN scale adds nothing),
// while sq still sees it (a NaN row gives a NaN norm, which the screen
// rejects).  Entries whose position lies past `size` count in sq only.
//
// What bounds it: bytes.  It reads the payloads as they are stored (3 bytes
// an entry plus 4 a block and contributor) and writes the f32 accumulator
// once: 94.9 MB + 495.9 MB = 590.8 MB at C=4 over the RoBERTa-base body
// (N=123,969,792, block 1024, kb 64), about 0.176 ms at 3.35 TB/s.  The TPU
// path dequantised into a [C, nb, kb] f32 array and int32 offsets first;
// here the dequantisation is folded in and that temporary never exists.
//
// Design:
// * One thread block per codec block.  The TPU kernel scattered through a
//   one-hot contraction (it has no scatter); here the block's slice of acc
//   lives in shared memory (block*4 bytes, up to 128 KB for the largest
//   codec block 32768, as dynamic shared memory), is zeroed, receives the
//   entries by shared-memory atomicAdd, and is written out with coalesced
//   16-byte stores (masked at `size` on the last block).  Every element of
//   acc is written exactly once, so nothing needs a memset.
// * Contributors are added in order c = 0..C-1 with a barrier between them,
//   so the sum across contributors has a fixed order; only duplicates inside
//   one row meet in an atomic.
// * Each block writes its C partial sums of squares to scratch [nb, C]; a
//   second kernel (one block per contributor) adds them in a fixed order, in
//   double.  No global atomics: the result does not change between runs
//   except in the order of duplicate offsets inside one row.
// * Offsets outside [0, block) are dropped from acc (the payload loader
//   refuses them before they get here).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 512;

__global__ void __launch_bounds__(kThreads)
decode_accum_kernel(const int16_t* __restrict__ idx, const int8_t* __restrict__ val,
                    const float* __restrict__ scl, const float* __restrict__ w,
                    float* __restrict__ acc, float* __restrict__ sq_part, int64_t size, int nb,
                    int kb, int n_contrib, int block) {
  extern __shared__ float4 s_dyn[];  // float4: the copy-out reads it 16 bytes at a time
  float* s_acc = reinterpret_cast<float*>(s_dyn);
  __shared__ float s_red[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < block; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  for (int c = 0; c < n_contrib; ++c) {
    const int64_t row = (int64_t)c * nb + b;
    const float wc = w[c];
    const float sc = scl[row];
    const int16_t* ri = idx + row * kb;
    const int8_t* rv = val + row * kb;
    float s = 0.f;
    for (int j = tid; j < kb; j += kThreads) {
      const float d = (float)rv[j] * sc;
      s = fmaf(d, d, s);
      const int off = ri[j];
      if (wc != 0.f && off >= 0 && off < block) atomicAdd(&s_acc[off], wc * d);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) s_red[warp] = s;
    __syncthreads();  // also orders contributor c's adds before c+1's
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) t += s_red[i];
      sq_part[(int64_t)b * n_contrib + c] = t;
    }
    __syncthreads();  // s_red is reused by the next contributor
  }

  const int64_t start = (int64_t)b * block;
  if (start + block <= size) {
    // whole block: acc + start is 16-byte aligned (block is a multiple of 1024)
    float4* dst = reinterpret_cast<float4*>(acc + start);
    for (int i = tid; i < block / 4; i += kThreads) dst[i] = s_dyn[i];
  } else {
    for (int i = tid; i < block && start + i < size; i += kThreads) acc[start + i] = s_acc[i];
  }
}

// sq[c] = sum over b of sq_part[b][c]: a fixed per-thread stride, then a
// fixed-order tree, in double.
__global__ void __launch_bounds__(kFinishThreads)
decode_accum_finish(const float* __restrict__ sq_part, int nb, int n_contrib,
                    float* __restrict__ sq) {
  __shared__ double s_red[kFinishThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  double s = 0.0;
  for (int b = tid; b < nb; b += kFinishThreads) s += sq_part[(int64_t)b * n_contrib + c];
  s_red[tid] = s;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (tid < half) s_red[tid] += s_red[tid + half];
    __syncthreads();
  }
  if (tid == 0) sq[c] = (float)s_red[0];
}

}  // namespace

extern "C" {

// idx/val/scl/w/acc/sq as above (contiguous; acc 16-byte aligned), sq_part
// holds nb * n_contrib floats.  The caller checked nb == ceil(size/block),
// block a multiple of 1024 up to 32768, n_contrib >= 1 and kb >= 1.
// Returns the first CUDA error of the attribute call or the two launches
// (0 on success).
int decode_accum_launch(const void* idx, const void* val, const void* scl, const void* w,
                        void* acc, void* sq, void* sq_part, long long size, int nb, int kb,
                        int n_contrib, int block, void* stream_ptr) {
  if (size < 1 || nb < 1 || kb < 1 || n_contrib < 1 || block < 1024 || block % 1024 != 0 ||
      block > 32768 || (long long)nb * block < size)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = (size_t)block * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_accum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_accum_kernel<<<nb, kThreads, smem, stream>>>(
      static_cast<const int16_t*>(idx), static_cast<const int8_t*>(val),
      static_cast<const float*>(scl), static_cast<const float*>(w), static_cast<float*>(acc),
      static_cast<float*>(sq_part), size, nb, kb, n_contrib, block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_accum_finish<<<n_contrib, kFinishThreads, 0, stream>>>(
      static_cast<const float*>(sq_part), nb, n_contrib, static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

const char* decode_accum_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
