// row_sketch — the novelty screen's fingerprint of one flat row, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cold_fuse.py (the body
// built by _make_sketch_kernel, launched by _row_sketch_impl).  For a row
// x [N] (bf16 or f32) and n_buckets it computes the [2, n_buckets] f32
//
//     out[0, j] = sum over tiles t with t % n_buckets == j of sum_i x[t*1024 + i]
//     out[1, j] = the same over x[t*1024 + i]^2
//
// with LANE = 1024-element tiles; the last partial tile counts as
// zero-padded (the padding adds nothing).
//
// What bounds it: bytes.  The row is read once (N * s bytes) against three
// flops per element: 247.9 MB for the RoBERTa-base body in bf16, about
// 0.074 ms at the H100's 3.35 TB/s.
//
// Design:
// * The TPU kernel walks a sequential grid and accumulates into one output
//   block through a one-hot matmul (the TPU has no scatter).  Here a grid of
//   G blocks runs in parallel, G a multiple of n_buckets: block g walks the
//   tiles t = g, g + G, g + 2G, ..., which all fall in bucket g % n_buckets,
//   so no bucket lookup or scatter is needed at all.
// * 128 threads cover a tile: 8 elements a thread, one 16-byte load in bf16
//   (two in f32) when the row is 16-byte aligned and the tile is whole;
//   masked scalar loads for the ragged last tile.  Two tiles are loaded
//   before either is summed, to keep more loads in flight.
// * Each tile is reduced in f32, as the plain version does; the running
//   sums across a block's tiles, the block reduction and the per-bucket sum
//   are in double, so the long sums lose nothing to f32 rounding.
// * A second one-block kernel adds the G partials of each bucket in block
//   order.  No atomics: the result is the same on every run.
//
// row_sketch_shard_launch is the partial of ONE shard of a row laid out
// block-cyclically over n_shards shards (blocks of tpb tiles): the slice's
// tile t is the row's tile g = ((t / tpb) * n_shards + shard) * tpb + t % tpb
// and feeds bucket g % n_buckets (repro.kernels.ref.row_sketch_shard).  When
// tpb % n_buckets == 0, g and t fall in the same bucket and row_sketch_launch
// over the slice already gives the partial; this entry is for the other
// layouts (a block clamped for a small row).  It is simple, not fast: one
// kernel writes each tile's sum and sum of squares in double, a second adds
// each bucket's tiles in tile order (the same bits on every run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = 128;
constexpr int kPer = kLane / kThreads;  // 8 elements a thread per tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load_vec(const float* p, float (&x)[kPer]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[kPer]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// This thread's 8 elements of tile t (zeros past n).
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ row, int64_t n, int64_t t,
                                          float (&x)[kPer]) {
  const int64_t first = t * kLane + (int64_t)threadIdx.x * kPer;
  if (VEC && (t + 1) * kLane <= n) {
    load_vec(row + first, x);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[i] = first + i < n ? to_f32(row[first + i]) : 0.f;
  }
}

__device__ __forceinline__ void add_tile(const float (&x)[kPer], double& s, double& q) {
  float ts = 0.f, tq = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    ts += x[i];
    tq = fmaf(x[i], x[i], tq);
  }
  s += ts;
  q += tq;
}

// partial[2g], partial[2g+1] = block g's sum and sum of squares.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
row_sketch_partial(const T* __restrict__ row, int64_t n, int64_t n_tiles,
                   double* __restrict__ partial) {
  __shared__ double s_red[2][kWarps];
  double s = 0.0, q = 0.0;
  const int64_t stride = gridDim.x;
  int64_t t = blockIdx.x;
  for (; t + stride < n_tiles; t += 2 * stride) {
    float a[kPer], b[kPer];
    load_tile<T, VEC>(row, n, t, a);
    load_tile<T, VEC>(row, n, t + stride, b);
    add_tile(a, s, q);
    add_tile(b, s, q);
  }
  if (t < n_tiles) {
    float a[kPer];
    load_tile<T, VEC>(row, n, t, a);
    add_tile(a, s, q);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  if (lane == 0) {
    s_red[0][warp] = s;
    s_red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ss = 0.0, qq = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += s_red[0][i];
      qq += s_red[1][i];
    }
    partial[2 * (int64_t)blockIdx.x] = ss;
    partial[2 * (int64_t)blockIdx.x + 1] = qq;
  }
}

// out[0, j], out[1, j] = the partials of blocks g = j, j + n_buckets, ...
// summed in block order.
__global__ void row_sketch_finish(const double* __restrict__ partial, int grid, int n_buckets,
                                  float* __restrict__ out) {
  for (int j = threadIdx.x; j < n_buckets; j += blockDim.x) {
    double s = 0.0, q = 0.0;
    for (int g = j; g < grid; g += n_buckets) {
      s += partial[2 * (int64_t)g];
      q += partial[2 * (int64_t)g + 1];
    }
    out[j] = (float)s;
    out[n_buckets + j] = (float)q;
  }
}

// tile_stats[2t], tile_stats[2t+1] = tile t's sum and sum of squares.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
row_sketch_tiles(const T* __restrict__ row, int64_t n, int64_t n_tiles,
                 double* __restrict__ tile_stats) {
  __shared__ double s_red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    float a[kPer];
    load_tile<T, VEC>(row, n, t, a);
    double s = 0.0, q = 0.0;
    add_tile(a, s, q);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      s_red[0][warp] = s;
      s_red[1][warp] = q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double ss = 0.0, qq = 0.0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        ss += s_red[0][i];
        qq += s_red[1][i];
      }
      tile_stats[2 * t] = ss;
      tile_stats[2 * t + 1] = qq;
    }
    __syncthreads();  // s_red is reused by the next tile
  }
}

// out[0, j], out[1, j] = the stats of the slice's tiles whose row tile falls
// in bucket j, added in tile order.
__global__ void row_sketch_shard_finish(const double* __restrict__ tile_stats, int64_t n_tiles,
                                        int64_t shard, int64_t n_shards, int64_t tpb,
                                        int n_buckets, float* __restrict__ out) {
  for (int j = threadIdx.x; j < n_buckets; j += blockDim.x) {
    double s = 0.0, q = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) {
      const int64_t g = ((t / tpb) * n_shards + shard) * tpb + t % tpb;
      if (g % n_buckets == j) {
        s += tile_stats[2 * t];
        q += tile_stats[2 * t + 1];
      }
    }
    out[j] = (float)s;
    out[n_buckets + j] = (float)q;
  }
}

template <typename T>
void launch(const void* row, int64_t n, int vec, int grid, void* partial, cudaStream_t stream) {
  const int64_t n_tiles = (n + kLane - 1) / kLane;
  if (vec)
    row_sketch_partial<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(row), n, n_tiles, static_cast<double*>(partial));
  else
    row_sketch_partial<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(row), n, n_tiles, static_cast<double*>(partial));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 = the row is 16-byte aligned
// (whole tiles take the 16-byte path).  grid must be a positive multiple of
// n_buckets; partial holds 2 * grid doubles; out is [2, n_buckets] f32.
// Returns cudaGetLastError() after both launches (0 on success).
int row_sketch_launch(const void* row, long long n, int dtype, int vec, int n_buckets, int grid,
                      void* partial, void* out, void* stream_ptr) {
  if (n < 0 || n_buckets < 1 || grid < 1 || grid % n_buckets != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) launch<float>(row, n, vec, grid, partial, stream);
  else launch<__nv_bfloat16>(row, n, vec, grid, partial, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sketch_finish<<<1, 256, 0, stream>>>(static_cast<const double*>(partial), grid, n_buckets,
                                           static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One shard's partial: row is the shard's [n] slice (n a multiple of 1024),
// tile_stats holds 2 * n / 1024 doubles, out is [2, n_buckets] f32; grid is
// the first kernel's block count.  Returns cudaGetLastError() after both
// launches (0 on success).
int row_sketch_shard_launch(const void* row, long long n, int dtype, int vec, long long shard,
                            long long n_shards, long long tpb, int n_buckets, int grid,
                            void* tile_stats, void* out, void* stream_ptr) {
  if (n < 0 || n % kLane != 0 || n_buckets < 1 || grid < 1 || dtype < 0 || dtype > 1 ||
      n_shards < 1 || shard < 0 || shard >= n_shards || tpb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n_tiles = n / kLane;
  double* stats = static_cast<double*>(tile_stats);
  if (n_tiles > 0) {
    if (dtype == 0) {
      if (vec) row_sketch_tiles<float, true><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(row), n, n_tiles, stats);
      else row_sketch_tiles<float, false><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(row), n, n_tiles, stats);
    } else {
      if (vec) row_sketch_tiles<__nv_bfloat16, true><<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(row), n, n_tiles, stats);
      else row_sketch_tiles<__nv_bfloat16, false><<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(row), n, n_tiles, stats);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  row_sketch_shard_finish<<<1, 256, 0, stream>>>(stats, n_tiles, shard, n_shards, tpb, n_buckets,
                                                 static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* row_sketch_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
