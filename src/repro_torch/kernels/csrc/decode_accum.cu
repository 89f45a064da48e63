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
// Offsets outside [0, block) are dropped from acc (the payload loader
// refuses them before they get here).
//
// What bounds it: bytes, in principle.  It reads the payloads as they are
// stored (3 bytes an entry plus 4 a block and contributor) and writes the
// f32 accumulator once: 94.9 MB + 495.9 MB = 590.8 MB at C=4 over the
// RoBERTa-base body (N=123,969,792, block 1024, kb 64), 0.176 ms at 3.35
// TB/s; at C=64, 2.01 GB, 0.60 ms.  A codec block's payload is small (768 B
// at C=4), so a kernel that reads contributor c only after adding c-1 pays
// C dependent round trips per codec block; and every entry is a scattered
// add into shared memory, whose bank conflicts set the pace at large C.
//
// Design:
// * A warp adds G whole codec blocks at once (`layout` in
//   kernels/decode_accum.py): 32/G lanes to a codec block's row, E
//   consecutive entries a lane, read with one load of offsets and one of
//   values (kb 64, the service's codec: G = 2, E = 4, 8- and 4-byte loads;
//   else one entry a lane).  Each codec block's
//   slice of acc lives in shared memory (block*4 bytes), and the warp adds
//   the C rows into it in the order c = 0..C-1, one row-round (32*E
//   entries) at a time, so contributors meet in program order inside one
//   warp, with no block-wide barrier.
// * Repeated offsets in a row are found exactly before any add: every entry
//   of a row-round writes its own byte tag at its position in a tag slice,
//   the warp syncs, and reads it back; a tag not its own means a repeat.
//   A row-round without repeats (the codec's top-k never repeats) adds
//   with plain loads and stores, all loads first.  In one with repeats, an
//   entry that lost its tag marks the position shared; entries at
//   positions of their own add plainly, and those at shared positions one
//   lane of each group at a time, in lane order.  So every element of acc
//   takes its adds in the order (c, j), contributor by contributor and
//   slot by slot: two calls on the same inputs give the same bits, by
//   construction.  Four shared-memory accesses an entry, at random banks,
//   are what bounds it at large C.
// * The warp's work is a sequence of steps (G codec blocks) of C*rounds
//   row-rounds, loaded a slab of S row-rounds at a time into registers; the
//   next slab's loads go out before the current one is added, so a codec
//   block costs one round trip (at C=4 a slab is a whole step) and large C
//   takes more slabs, always one ahead.
// * When a step's last row is added, the warp copies its G slices out with
//   16-byte streaming stores and zeroes them in the same pass (masked at
//   `size` on the last codec block); every element of acc is written once.
// * Persistent blocks: about one wave of blocks of W warps (W and the
//   blocks per SM from the occupancy query, `decode_accum_plan`), each
//   walking a contiguous range of `per` codec blocks (`partition` in
//   kernels/decode_accum.py), its warps taking every W-th step of it.
// * sq: a row's squares are scale^2 times the sum of its int8 values
//   squared, an integer the lanes add exactly (at most 32768 * 127^2 <
//   2^31) and meet by a butterfly; the group's first lane adds scale^2 *
//   sum into the group's [C] doubles in shared memory; the block adds its
//   warps' groups in order and writes its C partials to a [C, grid] scratch;
//   the last block to finish (a __threadfence and an atomic ticket, which it
//   resets for the next call) adds them over the grid in a fixed order, in
//   double, and writes sq.  One launch, no second kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
// a row-round's tag at a position two or more of its entries share; the
// entries' own tags are their indices in the row-round, below 64
constexpr unsigned char kShared = 0xff;

// E entries of one lane, as loaded: E int16 offsets in (E+1)/2 words, E int8
// values in (E+3)/4 words, and the row's scale.
template <int E>
struct Slot {
  unsigned ow[(E + 1) / 2];
  unsigned vw[(E + 3) / 4];
  float scl;
};

template <int E>
__device__ __forceinline__ void load_entries(Slot<E>& s, const int16_t* pi, const int8_t* pv) {
  if constexpr (E == 4) {
    const uint2 o = __ldg(reinterpret_cast<const uint2*>(pi));
    s.ow[0] = o.x; s.ow[1] = o.y;
    s.vw[0] = __ldg(reinterpret_cast<const unsigned*>(pv));
  } else {
    static_assert(E == 1, "the built layouts load 4 or 1 entries a lane");
    s.ow[0] = (unsigned short)__ldg(pi);
    s.vw[0] = (unsigned char)__ldg(pv);
  }
}

template <int E>
__device__ __forceinline__ int offset_at(const Slot<E>& s, int k) {
  return (int)(int16_t)(s.ow[k >> 1] >> (16 * (k & 1)));
}

template <int E>
__device__ __forceinline__ int value_at(const Slot<E>& s, int k) {
  return (int)(int8_t)(s.vw[k >> 2] >> (8 * (k & 3)));
}

// What a warp needs to walk its work: the codec blocks of its steps, the
// rows and rounds of a step, and the arrays.
struct Walk {
  const int16_t* idx;
  const int8_t* val;
  const float* scl;
  int nb, kb, n_contrib, rounds, slabs, first, stride, b_end;
  // codec block of this lane's group in step k (live when < b_end)
  __device__ __forceinline__ int block_of(int k, int grp) const {
    return first + k * stride + grp;
  }
  // row c and round r of a step's row-round rr, and the one after (c, r)
  __device__ __forceinline__ void row_round(int rr, int& c, int& r) const {
    if (rounds == 1) {
      c = rr;
      r = 0;
    } else {
      c = rr / rounds;
      r = rr - c * rounds;
    }
  }
  __device__ __forceinline__ void next_round(int& c, int& r) const {
    if (++r == rounds) {
      r = 0;
      ++c;
    }
  }
};

// Loads slab j of step k: row-rounds j*S .. j*S+S-1 of the step, each lane
// E entries of its group's codec block.
template <int E, int G, int S>
__device__ __forceinline__ void load_slab(Slot<E> (&buf)[S], const Walk& wk, int k, int j,
                                          int grp, int gl) {
  constexpr int LPR = 32 / G;
  const int b = wk.block_of(k, grp);
  const bool live = b < wk.b_end;
  int c, r;
  wk.row_round(j * S, c, r);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (c < wk.n_contrib) {  // uniform across the warp
      const int e = r * LPR * E + gl * E;
      if (live && (E > 1 || e < wk.kb)) {
        const int64_t row = (int64_t)c * wk.nb + b;
        buf[s].scl = __ldg(wk.scl + row);
        load_entries<E>(buf[s], wk.idx + row * wk.kb + e, wk.val + row * wk.kb + e);
      }
    }
    wk.next_round(c, r);
  }
}

// The group's slices out to acc (16-byte streaming stores on a whole codec
// block, masked at `size` on the ragged last one), zeroed in the same pass.
__device__ __forceinline__ void copy_out(float* __restrict__ s_slice, float* __restrict__ acc,
                                         int b, int block, int64_t size, int lane) {
  const int64_t start = (int64_t)b * block;
  if (start + block <= size) {
    // acc + start is 16-byte aligned: block is a multiple of 1024
    float4* src = reinterpret_cast<float4*>(s_slice);
    float4* dst = reinterpret_cast<float4*>(acc + start);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = lane; i < block / 4; i += 32) {
      const float4 v = src[i];
      src[i] = zero;
      __stcs(dst + i, v);
    }
  } else {
    for (int i = lane; i < block; i += 32) {
      if (start + i < size) acc[start + i] = s_slice[i];
      s_slice[i] = 0.f;
    }
  }
}

// Adds slab j of step k into the group's slice; at the end of each row its
// sum of squares goes to the warp's s_sq[c]; after the step's last slab the
// warp's G slices go out.
template <int E, int G, int S>
__device__ __forceinline__ void add_slab(const Slot<E> (&buf)[S], const Walk& wk, int k, int j,
                                         unsigned& vsq, float* __restrict__ s_warp,
                                         unsigned char* __restrict__ s_tag_warp,
                                         double* __restrict__ s_sq,
                                         const float* __restrict__ s_w,
                                         float* __restrict__ acc, int64_t size, int block,
                                         int lane, int grp, int gl) {
  constexpr int LPR = 32 / G;
  const int b = wk.block_of(k, grp);
  const bool live = b < wk.b_end;
  float* s_acc = s_warp + (size_t)grp * block;
  unsigned char* s_tag = s_tag_warp + (size_t)grp * block;
  int c, r;
  wk.row_round(j * S, c, r);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (c >= wk.n_contrib) break;  // uniform across the warp
    const float wc = s_w[c];
    const bool valid = live && (E > 1 || r * LPR * E + gl * E < wk.kb);
    int off[E];
    float x[E];
    bool add[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int v = valid ? value_at<E>(buf[s], q) : 0;
      vsq += (unsigned)(v * v);
      off[q] = offset_at<E>(buf[s], q);
      add[q] = valid && wc != 0.f && (unsigned)off[q] < (unsigned)block;
      x[q] = wc * ((float)v * buf[s].scl);
      // each entry writes its own tag at its position; reading another's
      // back below means two entries of the row-round share the position
      if (add[q]) s_tag[off[q]] = (unsigned char)(gl * E + q);
    }
    __syncwarp();
    bool lost[E], dup = false;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      lost[q] = add[q] && s_tag[off[q]] != (unsigned char)(gl * E + q);
      dup |= lost[q];
    }
    if (!__any_sync(0xffffffffu, dup)) {
      // every position of the row-round distinct: plain adds, loads first
      float cur[E];
#pragma unroll
      for (int q = 0; q < E; ++q) cur[q] = add[q] ? s_acc[off[q]] : 0.f;
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (add[q]) s_acc[off[q]] = cur[q] + x[q];
    } else {
      // repeats: an entry that lost its tag marks the position shared (no
      // entry's own tag is kShared), so every entry at it sees the mark
      __syncwarp();  // every tag read before a mark
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (lost[q]) s_tag[off[q]] = kShared;
      __syncwarp();
      bool shared[E], any_shared = false;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        shared[q] = add[q] && s_tag[off[q]] == kShared;
        any_shared |= shared[q];
        if (add[q] && !shared[q]) s_acc[off[q]] += x[q];  // a position of its own
      }
      // the shared positions one lane of each group at a time, in lane
      // order and each lane's entries in order, so a position takes its
      // adds in slot order
      const unsigned all = __ballot_sync(0xffffffffu, any_shared);
      int turns = 0;
#pragma unroll
      for (int g = 0; g < G; ++g)
        turns = max(turns, __popc(all & ((0xffffffffu >> (32 - LPR)) << (g * LPR))));
      unsigned mine = all & ((0xffffffffu >> (32 - LPR)) << (grp * LPR));
      for (int t = 0; t < turns; ++t) {
        if (lane == __ffs(mine) - 1) {
#pragma unroll
          for (int q = 0; q < E; ++q)
            if (shared[q]) s_acc[off[q]] += x[q];
        }
        mine &= mine - 1u;
        __syncwarp();
      }
    }
    __syncwarp();  // this row-round's adds and tag reads before the next one's
    if (r == wk.rounds - 1) {
      // the row is done: scale^2 times its exact integer sum of value^2, the
      // group's lanes met by a butterfly; the group's first lane adds it to
      // the group's sum for contributor c
#pragma unroll
      for (int m = LPR / 2; m > 0; m >>= 1) vsq += __shfl_xor_sync(0xffffffffu, vsq, m);
      if (gl == 0 && live) {
        const double sc = buf[s].scl;
        s_sq[c] += sc * sc * (double)vsq;
      }
      vsq = 0u;
    }
    wk.next_round(c, r);
  }
  if (j == wk.slabs - 1) {  // the step is done
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int bg = wk.block_of(k, g);
      if (bg < wk.b_end) copy_out(s_warp + (size_t)g * block, acc, bg, block, size, lane);
    }
    __syncwarp();
  }
}

template <int E, int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_accum_kernel(const int16_t* __restrict__ idx, const int8_t* __restrict__ val,
                    const float* __restrict__ scl, const float* __restrict__ w,
                    float* __restrict__ acc, float* __restrict__ sq, double* __restrict__ part,
                    unsigned* __restrict__ ticket, int64_t size, int nb, int kb, int n_contrib,
                    int block, int per) {
  constexpr int LPR = 32 / G;
  constexpr int S = 8;  // row-rounds a slab
  extern __shared__ float4 s_dyn[];  // float4: the copy-out reads it 16 bytes at a time
  __shared__ unsigned s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int grp = lane / LPR, gl = lane % LPR;
  float* s_warp = reinterpret_cast<float*>(s_dyn) + (size_t)warp * G * block;
  double* s_sq_all =
      reinterpret_cast<double*>(reinterpret_cast<float*>(s_dyn) + (size_t)W * G * block);
  double* s_sq = s_sq_all + (size_t)(warp * G + grp) * n_contrib;
  float* s_w = reinterpret_cast<float*>(s_sq_all + (size_t)W * G * n_contrib);
  unsigned char* s_tag =  // the warp's G tag slices of block bytes, after s_w
      reinterpret_cast<unsigned char*>(s_w + n_contrib) + (size_t)warp * G * block;

  for (int c = tid; c < n_contrib; c += blockDim.x) s_w[c] = w[c];
  for (int i = tid; i < W * G * n_contrib; i += blockDim.x) s_sq_all[i] = 0.0;
  for (int i = lane; i < G * block; i += 32) s_warp[i] = 0.f;
  __syncthreads();

  // the block's codec blocks [b_begin, b_end) in steps of G, step i of the
  // range to warp i % W
  Walk wk;
  wk.idx = idx; wk.val = val; wk.scl = scl;
  wk.nb = nb; wk.kb = kb; wk.n_contrib = n_contrib;
  wk.rounds = (kb + LPR * E - 1) / (LPR * E);
  wk.slabs = (n_contrib * wk.rounds + S - 1) / S;
  const int b_begin = blockIdx.x * per;
  wk.b_end = min(nb, b_begin + per);
  wk.first = b_begin + warp * G;
  wk.stride = W * G;
  const int n_steps =
      wk.first < wk.b_end ? (wk.b_end - wk.first + wk.stride - 1) / wk.stride : 0;

  unsigned vsq = 0u;
  Slot<E> a[S], bb[S];
  int lk = 0, lj = 0;  // the next slab to load
  auto next = [&](int& k, int& j) { if (++j == wk.slabs) { j = 0; ++k; } };
  if (n_steps > 0) {
    load_slab<E, G, S>(a, wk, lk, lj, grp, gl);
    next(lk, lj);
  }
  for (int k = 0, j = 0; k < n_steps;) {
    if (lk < n_steps) { load_slab<E, G, S>(bb, wk, lk, lj, grp, gl); next(lk, lj); }
    add_slab<E, G, S>(a, wk, k, j, vsq, s_warp, s_tag, s_sq, s_w, acc, size, block, lane, grp,
                      gl);
    next(k, j);
    if (k >= n_steps) break;
    if (lk < n_steps) { load_slab<E, G, S>(a, wk, lk, lj, grp, gl); next(lk, lj); }
    add_slab<E, G, S>(bb, wk, k, j, vsq, s_warp, s_tag, s_sq, s_w, acc, size, block, lane, grp,
                      gl);
    next(k, j);
  }

  // the block's sq partials, its warps' groups added in order
  __syncthreads();
  for (int c = tid; c < n_contrib; c += blockDim.x) {
    double t = 0.0;
    for (int v = 0; v < W * G; ++v) t += s_sq_all[(size_t)v * n_contrib + c];
    part[(int64_t)c * gridDim.x + blockIdx.x] = t;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: sq[c] over the grid, a warp per contributor, each lane
  // adding blocks lane, lane + 32, ... in order (8 loads in flight), then a
  // butterfly, in double
  __threadfence();
  const int grid = gridDim.x;
  for (int c = warp; c < n_contrib; c += W) {
    const double* pc = part + (int64_t)c * grid;
    double t = 0.0;
    for (int g0 = lane; g0 < grid; g0 += 32 * 8) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = g0 + 32 * u < grid ? __ldcg(pc + g0 + 32 * u) : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u) t += v[u];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
    if (lane == 0) sq[c] = (float)t;
  }
  if (tid == 0) *ticket = 0u;
}

size_t smem_bytes(int warps, int groups, int block, int n_contrib) {
  return (size_t)warps * groups * block * sizeof(float) +
         (size_t)warps * groups * n_contrib * sizeof(double) +
         (size_t)n_contrib * sizeof(float) + (size_t)warps * groups * block;  // the tags
}

template <int E, int G>
int plan(int block, int n_contrib, int* warps, int* blocks_per_sm) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, decode_accum_kernel<E, G>);
  if (err != cudaSuccess) return (int)err;
  const int dyn_max = optin - (int)attr.sharedSizeBytes;  // the rest is the static s_last
  err = cudaFuncSetAttribute(decode_accum_kernel<E, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_accum_kernel<E, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // blocks of at least kMinWarps warps where they fit, so that the last
  // block's reduction of sq has that many warps; the most resident warps
  int best = 0;
  for (int wn = kMaxWarps; wn >= 1; --wn) {
    if (best > 0 && wn < kMinWarps) break;
    const size_t smem = smem_bytes(wn, G, block, n_contrib);
    if (smem > (size_t)dyn_max) continue;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_accum_kernel<E, G>, wn * 32,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if (n * wn > best) {
      best = n * wn;
      *warps = wn;
      *blocks_per_sm = n;
    }
  }
  return best > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// The layouts the kernel is built for: (entries a lane loads, codec blocks a
// warp adds at once).
#define DECODE_ACCUM_LAYOUTS(X) X(4, 2) X(1, 1)

bool layout_fits(int vec, int groups, int kb) {
  return vec == 1 || kb == (32 / groups) * vec;
}

}  // namespace

extern "C" {

// Once per card, layout and size class: sets the kernel's shared-memory
// attributes and picks the warps per block (at most 8) and the blocks per SM
// that give the most resident warps.  Returns a CUDA error (0 on success;
// cudaErrorInvalidValue for a layout not built or when no block fits).
int decode_accum_plan(int vec, int groups, int block, int n_contrib, int* warps,
                      int* blocks_per_sm) {
  if (block < 1024 || block % 1024 != 0 || block > 32768 || n_contrib < 1)
    return (int)cudaErrorInvalidValue;
#define DECODE_ACCUM_PLAN(E, G) \
  if (vec == E && groups == G) return plan<E, G>(block, n_contrib, warps, blocks_per_sm);
  DECODE_ACCUM_LAYOUTS(DECODE_ACCUM_PLAN)
#undef DECODE_ACCUM_PLAN
  return (int)cudaErrorInvalidValue;
}

// idx/val/scl/w/acc/sq as above (contiguous; acc 16-byte aligned; idx and
// val aligned to 2*vec and vec bytes).  (vec, groups) is a built layout that
// fits kb: one entry a lane, or kb == (32/groups)*vec.  part holds grid *
// n_contrib doubles; ticket is one unsigned that is 0 between calls, and
// both belong to `stream` alone while the launch runs.  Block g takes codec blocks
// [g*per, min(nb, (g+1)*per)); `warps` is decode_accum_plan's.  Returns the
// launch's CUDA error (0 on success).
int decode_accum_launch(const void* idx, const void* val, const void* scl, const void* w,
                        void* acc, void* sq, void* part, void* ticket, long long size, int nb,
                        int kb, int n_contrib, int block, int vec, int groups, int warps,
                        int grid, int per, void* stream_ptr) {
  if (size < 1 || nb < 1 || kb < 1 || n_contrib < 1 || block < 1024 || block % 1024 != 0 ||
      block > 32768 || (long long)nb * block < size || warps < 1 || warps > kMaxWarps ||
      grid < 1 || per < 1 || (long long)grid * per < nb || (long long)(grid - 1) * per >= nb ||
      !layout_fits(vec, groups, kb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = smem_bytes(warps, groups, block, n_contrib);
#define DECODE_ACCUM_LAUNCH(E, G)                                                            \
  if (vec == E && groups == G) {                                                            \
    decode_accum_kernel<E, G><<<grid, warps * 32, smem, stream>>>(                          \
        static_cast<const int16_t*>(idx), static_cast<const int8_t*>(val),                  \
        static_cast<const float*>(scl), static_cast<const float*>(w), static_cast<float*>(acc), \
        static_cast<float*>(sq), static_cast<double*>(part), static_cast<unsigned*>(ticket),    \
        size, nb, kb, n_contrib, block, per);                                               \
    return (int)cudaGetLastError();                                                         \
  }
  DECODE_ACCUM_LAYOUTS(DECODE_ACCUM_LAUNCH)
#undef DECODE_ACCUM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* decode_accum_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
