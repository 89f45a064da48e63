// flash_decode — split-K attention for few query rows per kv head (decode),
// bf16 or f32, for Hopper (sm_90a).  The decode route of the port's
// flash_attention (kernels/flash_attention.py picks it when Sq * Hq / Hkv
// <= DECODE_ROWS, which covers one generated token of every model here).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (launched by flash_attention) at decode shapes.  For q [B, Sq, Hq, hd] and
// k, v [B, Sk, Hkv, hd] (contiguous; query head h reads kv head
// h / (Hq / Hkv)) it computes, in f32,
//
//     s[i, j] = (q_i . k_j) * hd^-0.5          over the visible keys j
//     o_i     = sum_j softmax_j(s[i, :]) v_j    (0 where no key is visible)
//
// with key j visible from the query at absolute position p_i = q_offset + i
// when j < Sk, j <= p_i (causal) and j > p_i - window (window > 0), and
// writes o in q's dtype.
//
// What bounds it: the bytes of the visible cache.  At gemma3-1b's decode
// shape (B=4, one token, Hq=4 on Hkv=1, hd=256, bf16, q_offset 1100 in a
// 1280-slot cache) a global layer reads 4.5 MB of K/V, 1.3 us at
// 3.35 TB/s, for 9 MFLOP; a local layer (window 512) 2.1 MB.  At that size
// the launches' own latency is most of the time, so the design spreads the
// cache over the whole card and keeps the merge cheap:
// * Split K: one block per (split of the visible key range, kv head,
//   batch).  The wrapper's plan (flash_attention.decode_plan) cuts the
//   visible range [k_lo, k_hi) into n_splits chunks of `chunk` keys, so
//   the grid has about two blocks per SM at gemma3's decode shape; chunk
//   edges need not fall on any tile.
// * All Hq / Hkv query heads (times Sq rows, R <= 8 in all) of a kv head
//   sit in one block, so each K/V byte is read once.  Every lane works on
//   keys: a key row is read by G lanes, 16 bytes each (G = 32 at hd 256
//   bf16), 128 / G keys at a time per block, U keys per group in flight.
//   At hd 160 (= 32 x 5) a row is 16 lanes x 5 loads of 2 elements
//   (vec_elems): G has to be a power of two for the dot product's
//   butterfly, and 16-byte loads would leave 4 lanes and 32 key groups,
//   whose merge buffer overflows static shared memory.
// * Each group of G lanes runs the online softmax over its keys in f32
//   registers (m, l, acc per row); the block merges its groups through
//   shared memory and writes one f32 partial (m, l, acc) per row.
// * A second small kernel merges the splits of each row by log-sum-exp and
//   writes o in q's dtype, its loads spread over 1024 threads and issued
//   before the split weights are known, so that they are in flight
//   together.  A row that sees no key has l = 0 in every split and writes
//   0.
//
// Context-parallel decode (a cache whose sequence is split over several
// slots, each holding one block of it) takes the same two kernels through
// two more entries: flash_decode_partials_launch runs the split kernel over
// one slot's block and leaves its f32 partials unmerged, packed one row
// after another as (m, l, acc[hd]); flash_decode_merge_launch runs the
// combine kernel over the partials of all the slots, concatenated along
// the split axis.  A block that holds no visible key gives one empty split
// (m = -1e30, l = 0, acc = 0), which carries weight 0 in the merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInit = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };

// E elements of T in one aligned load (4, 8 or 16 bytes), widened to floats
template <typename T, int E>
struct Vec {
  using raw = typename Raw<E * static_cast<int>(sizeof(T))>::type;
  __device__ __forceinline__ static void widen(const raw& x, float* out) {
    if constexpr (std::is_same<T, float>::value) {
      const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = f[e];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < E / 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        out[2 * e] = f.x;
        out[2 * e + 1] = f.y;
      }
    }
  }
};

constexpr int pow2_factor(int n) { return n & -n; }  // the largest power of two dividing n

// Elements per vector load: 16 bytes where a key row is a power-of-two
// number of them (hd 32-256); 2 elements at hd 160 (= 32 x 5), so that a
// row spans 16 lanes x 5 vectors and the block's merge buffer (KG x R x HD
// floats) stays within static shared memory.
template <int HD, typename T>
constexpr int vec_elems() {
  constexpr int e16 = 16 / static_cast<int>(sizeof(T));
  return (HD / e16) == pow2_factor(HD / e16) ? e16 : 2;
}

template <int HD, typename T, int R>
struct DecodeCfg {
  static constexpr int E = vec_elems<HD, T>();           // elements per vector
  // lanes per key row: a power of two (the dot product's butterfly runs
  // within them) that divides the row's vectors, at most a warp
  static constexpr int G = pow2_factor(HD / E) < 32 ? pow2_factor(HD / E) : 32;
  static constexpr int NV = HD / (G * E);                // vectors per lane and row
  static constexpr int W = NV * E;                       // elements per lane and row
  static constexpr int KG = kThreads / G;                // key groups per block
  static constexpr int U = R * W <= 32 ? 4 : 2;          // keys per group in flight
  static_assert(G * NV * E == HD, "a key row must split evenly over G lanes");
  static_assert(KG * R * (HD + 2) * 4 <= 48 * 1024,
                "the merge buffer must fit static shared memory");
};

template <int HD, typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int Sq, int Sk, int Hq, int Hkv,
                          int causal, int window, int q_offset, float scale_log2, int k_lo,
                          int k_hi, int chunk, int ml_stride, int acc_stride) {
  using C = DecodeCfg<HD, T, R>;
  using V = Vec<T, C::E>;
  using raw = typename V::raw;
  constexpr int G = C::G, NV = C::NV, W = C::W, E = C::E, KG = C::KG, U = C::U;
  __shared__ float sm_m[KG][R], sm_l[KG][R];
  __shared__ float sm_acc[KG][R][HD];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, n_splits = gridDim.x;
  const int rep = Hq / Hkv, rows = Sq * rep;
  const int tid = threadIdx.x, grp = tid / G, sub = tid % G;

  // this lane's columns of every row: vector i covers (i * G + sub) * E + [0, E)
  float qv[R][W];
  int pos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pos[r] = q_offset + r / rep;
    if (r < rows) {
      const T* qr = q + ((static_cast<int64_t>(b) * Sq + r / rep) * Hq + hk * rep + r % rep) * HD;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        V::widen(*reinterpret_cast<const raw*>(qr + (i * G + sub) * E), qv[r] + i * E);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) qv[r][e] = 0.f;
    }
  }

  float m[R], l[R], acc[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInit;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[r][e] = 0.f;
  }

  const int k_start = k_lo + split * chunk, k_stop = min(k_start + chunk, k_hi);
  const int64_t row_stride = static_cast<int64_t>(Hkv) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD + sub * E;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD + sub * E;
  // the trip count is the same for every lane, so the shuffles below always
  // run on the whole warp
  for (int base = k_start; base < k_stop; base += KG * U) {
    raw kx[U][NV], vx[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * KG + grp;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (j < k_stop) {
          kx[u][i] = *reinterpret_cast<const raw*>(kb + j * row_stride + i * G * E);
          vx[u][i] = *reinterpret_cast<const raw*>(vb + j * row_stride + i * G * E);
        } else {
          kx[u][i] = vx[u][i] = raw{};
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * KG + grp;
      float kf[W], vf[W];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        V::widen(kx[u][i], kf + i * E);
        V::widen(vx[u][i], vf + i * E);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const bool vis = j < k_stop && (!causal || j <= pos[r]) &&
                         (window <= 0 || j > pos[r] - window);
        if (vis) {
          const float s = dot * scale_log2;
          const float mn = fmaxf(m[r], s);
          const float c = exp2f(m[r] - mn), p = exp2f(s - mn);
          l[r] = l[r] * c + p;
#pragma unroll
          for (int e = 0; e < W; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * c);
          m[r] = mn;
        }
      }
    }
  }

  // merge the block's key groups, then write this split's partial per row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (sub == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[grp][r][(i * G + sub) * E + e] = acc[r][i * E + e];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float M = kNegInit;
#pragma unroll 4
    for (int g = 0; g < KG; ++g) M = fmaxf(M, sm_m[g][r]);
    float a = 0.f, L = 0.f;
#pragma unroll 4
    for (int g = 0; g < KG; ++g) {
      const float w = exp2f(sm_m[g][r] - M);
      a = fmaf(w, sm_acc[g][r][d], a);
      L = fmaf(w, sm_l[g][r], L);
    }
    const int64_t row = ((static_cast<int64_t>(b) * Hkv + hk) * n_splits + split) * rows + r;
    part_acc[row * acc_stride + d] = a;
    if (d == 0) {
      part_ml[row * ml_stride] = M;
      part_ml[row * ml_stride + 1] = L;
    }
  }
}

// The max (kMax) or the sum of x over the block, returned to every thread.
// red holds one value per warp; the call ends in a barrier.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red may be written again
  return x;
}

// One block per (row, kv head, batch) of kCombineThreads threads: group
// g = tid / hd sums w_s * acc_s for column d = tid % hd over the splits
// s = g, g + groups, ...  Its first kPrefetch acc values are loaded before
// the weights w_s = exp2(m_s - M) are known, so every load of the block is
// in flight at once; then the groups' sums are added.  Where hd does not
// divide kCombineThreads (hd 160: 6 groups), the threads past the last
// whole group only join the block's reductions.
constexpr int kCombineThreads = 1024;
constexpr int kPrefetch = 16;
constexpr int kMaxSplits = 2048;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part_ml,
                            const float* __restrict__ part_acc, T* __restrict__ o, int Sq,
                            int Hq, int Hkv, int hd, int n_splits, int ml_stride,
                            int acc_stride) {
  __shared__ float sm_m[kMaxSplits], sm_w[kMaxSplits];
  __shared__ float sm_red[kCombineThreads / 32];
  __shared__ float sm_sum[kCombineThreads];
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rep = Hq / Hkv, rows = Sq * rep;
  const int groups = kCombineThreads / hd, g = tid / hd, d = tid % hd;
  const int mine = g < groups ? n_splits : 0;  // splits this thread's group may read
  const int64_t row0 = (static_cast<int64_t>(b) * Hkv + hk) * n_splits * rows + r;

  float pre[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int s = g + i * groups;
    pre[i] = s < mine ? part_acc[(row0 + static_cast<int64_t>(s) * rows) * acc_stride + d]
                      : 0.f;
  }
  float M = kNegInit;
  for (int s = tid; s < n_splits; s += kCombineThreads) {
    const int64_t row = row0 + static_cast<int64_t>(s) * rows;
    sm_m[s] = part_ml[row * ml_stride];
    sm_w[s] = part_ml[row * ml_stride + 1];  // l_s until it is replaced by w_s below
    M = fmaxf(M, sm_m[s]);
  }
  M = block_reduce<true>(M, sm_red);
  float L = 0.f;
  for (int s = tid; s < n_splits; s += kCombineThreads) {
    const float w = exp2f(sm_m[s] - M);
    L = fmaf(w, sm_w[s], L);
    sm_w[s] = w;
  }
  L = block_reduce<false>(L, sm_red);  // its barriers also publish sm_w

  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int s = g + i * groups;
    if (s < mine) a = fmaf(sm_w[s], pre[i], a);
  }
  for (int s = g + kPrefetch * groups; s < mine; s += groups)
    a = fmaf(sm_w[s], part_acc[(row0 + static_cast<int64_t>(s) * rows) * acc_stride + d], a);
  sm_sum[tid] = a;
  __syncthreads();
  if (g == 0) {
    for (int j = 1; j < groups; ++j) a += sm_sum[j * hd + d];
    o[((static_cast<int64_t>(b) * Sq + r / rep) * Hq + hk * rep + r % rep) * hd + d] =
        from_f32<T>(L > 0.f ? a / L : 0.f);
  }
}

// One call's arguments.  The partials of row r of split s of (batch b, kv
// head hk) sit at ((b * Hkv + hk) * n_splits + s) * rows + r, times
// ml_stride floats into part_ml (m, then l) and acc_stride into part_acc.
// o == nullptr leaves them unmerged.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  float* part_ml;
  float* part_acc;
  void* o;
  int B, Sq, Sk, Hq, Hkv, causal, window, q_offset;
  float scale_log2;
  int k_lo, k_hi, chunk, n_splits, ml_stride, acc_stride;
  cudaStream_t stream;
};

template <typename T>
cudaError_t combine(const float* part_ml, const float* part_acc, void* o, int B, int Sq, int Hq,
                    int Hkv, int hd, int n_splits, int ml_stride, int acc_stride,
                    cudaStream_t stream) {
  flash_decode_combine_kernel<T><<<dim3(Sq * (Hq / Hkv), Hkv, B), kCombineThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(o), Sq, Hq, Hkv, hd, n_splits, ml_stride, acc_stride);
  return cudaGetLastError();
}

template <int HD, typename T, int R>
cudaError_t launch(const DecodeArgs& a) {
  flash_decode_split_kernel<HD, T, R><<<dim3(a.n_splits, a.Hkv, a.B), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.part_ml, a.part_acc, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window, a.q_offset,
      a.scale_log2, a.k_lo, a.k_hi, a.chunk, a.ml_stride, a.acc_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.o == nullptr) return err;
  return combine<T>(a.part_ml, a.part_acc, a.o, a.B, a.Sq, a.Hq, a.Hkv, HD, a.n_splits,
                    a.ml_stride, a.acc_stride, a.stream);
}

template <int HD, typename T>
cudaError_t by_rows(int rows, const DecodeArgs& a) {
  if (rows <= 1) return launch<HD, T, 1>(a);
  if (rows <= 2) return launch<HD, T, 2>(a);
  if (rows <= 4) return launch<HD, T, 4>(a);
  if (rows <= 8) return launch<HD, T, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_hd(int hd, int rows, const DecodeArgs& a) {
  switch (hd) {
    case 32: return by_rows<32, T>(rows, a);
    case 64: return by_rows<64, T>(rows, a);
    case 128: return by_rows<128, T>(rows, a);
    case 160: return by_rows<160, T>(rows, a);
    case 256: return by_rows<256, T>(rows, a);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int Sq, int Sk, int Hq, int Hkv, int hd) {
  return B >= 1 && Sq >= 1 && Sk >= 0 && Hq >= 1 && Hkv >= 1 && Hq % Hkv == 0 &&
         Hkv <= 65535 && B <= 65535 && (hd == 32 || hd == 64 || hd == 128 || hd == 160 ||
                                        hd == 256);
}

int run(const DecodeArgs& a, int hd, int is_bf16) {
  if (!valid_shape(a.B, a.Sq, a.Sk, a.Hq, a.Hkv, hd) || a.n_splits < 1 ||
      a.n_splits > kMaxSplits || a.chunk < 1 || a.k_hi > a.Sk || a.Sq * (a.Hq / a.Hkv) > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = a.Sq * (a.Hq / a.Hkv);
  return static_cast<int>(is_bf16 ? by_hd<__nv_bfloat16>(hd, rows, a) : by_hd<float>(hd, rows, a));
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd], o like q; all contiguous, 16-byte
// aligned, of one dtype (is_bf16: bf16, else f32).  hd in {32, 64, 128,
// 160, 256}, Hq a multiple of Hkv, 1 <= Sq * Hq / Hkv <= 8.  part_ml
// [B, Hkv, n_splits, Sq * Hq / Hkv, 2] and part_acc [..., hd] are f32
// scratch.  Split s covers keys [k_lo + s * chunk, min(k_lo + (s + 1) *
// chunk, k_hi)) with k_hi <= Sk.  window <= 0 means no window; scale_log2
// is hd^-0.5 * log2(e).  Launches the split kernel, then the combine
// kernel; returns the first CUDA error (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v, void* part_ml,
                        void* part_acc, void* o, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                        int causal, int window, int q_offset, float scale_log2, int k_lo,
                        int k_hi, int chunk, int n_splits, int is_bf16, void* stream_ptr) {
  if (o == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k, v, static_cast<float*>(part_ml), static_cast<float*>(part_acc), o,
                     B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2, k_lo, k_hi,
                     chunk, n_splits, 2, hd, static_cast<cudaStream_t>(stream_ptr)};
  return run(a, hd, is_bf16);
}

// The split kernel alone, over the keys of one block of a cache (the
// arguments as flash_decode_launch's, positions relative to the block):
// part [B, Hkv, n_splits, Sq * Hq / Hkv, hd + 2] f32, each row (m, l,
// acc[hd]) with m in log2 units (the largest visible score times
// scale_log2), l = sum of exp2(score - m), acc the same weights' sum of v.
// A row that sees no key of a split writes m = -1e30, l = 0, acc = 0.
int flash_decode_partials_launch(const void* q, const void* k, const void* v, void* part, int B,
                                 int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
                                 int q_offset, float scale_log2, int k_lo, int k_hi, int chunk,
                                 int n_splits, int is_bf16, void* stream_ptr) {
  float* p = static_cast<float*>(part);
  const DecodeArgs a{q, k, v, p, p + 2, nullptr, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                     scale_log2, k_lo, k_hi, chunk, n_splits, hd + 2, hd + 2,
                     static_cast<cudaStream_t>(stream_ptr)};
  return run(a, hd, is_bf16);
}

// The combine kernel over partials laid out as flash_decode_partials_launch
// writes them, n_splits of them a row (the several slots' splits
// concatenated along the split axis): o [B, Sq, Hq, hd] in bf16 (is_bf16)
// or f32, the log-sum-exp merge of the splits, 0 where every l is 0.
int flash_decode_merge_launch(const void* part, void* o, int B, int Sq, int Hq, int Hkv, int hd,
                              int n_splits, int is_bf16, void* stream_ptr) {
  if (!valid_shape(B, Sq, 0, Hq, Hkv, hd) || n_splits < 1 || n_splits > kMaxSplits ||
      Sq * (Hq / Hkv) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(part);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(
      is_bf16 ? combine<__nv_bfloat16>(p, p + 2, o, B, Sq, Hq, Hkv, hd, n_splits, hd + 2, hd + 2,
                                       stream)
              : combine<float>(p, p + 2, o, B, Sq, Hq, Hkv, hd, n_splits, hd + 2, hd + 2, stream));
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
