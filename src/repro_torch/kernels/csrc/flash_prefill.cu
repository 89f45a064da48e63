// flash_prefill — bf16 causal / sliding-window attention with GQA on the
// tensor cores, for Hopper (sm_90a).  The prefill route of the port's
// flash_attention (kernels/flash_attention.py picks it for bf16 q, k, v
// with more than DECODE_ROWS query rows per kv head).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (launched by flash_attention) for bf16.  For q [B, Sq, Hq, hd] and k, v
// [B, Sk, Hkv, hd] (contiguous; query head h reads kv head h / (Hq / Hkv))
// it computes, in f32,
//
//     s[i, j] = (q_i . k_j) * hd^-0.5          over the visible keys j
//     o_i     = sum_j softmax_j(s[i, :]) v_j    (0 where no key is visible)
//
// with key j visible from the query at absolute position p_i = q_offset + i
// when j < Sk, j <= p_i (causal) and j > p_i - window (window > 0), and
// writes o in bf16.
//
// What bounds it: at gemma3-1b's prefill shape (B=4, Sq=1024, Sk=1280,
// Hq=4, Hkv=1, hd=256) the visible score entries need 4 * hd FLOPs each,
// 8.6 GFLOP on a global layer, 8.7 us at the tensor cores' 989 TFLOP/s;
// the bytes (q, k, v read once, o written once: 22 MB) take 6.6 us at
// 3.35 TB/s.  So the tensor cores bound it, and everything else (the
// softmax on the CUDA cores, loads, barriers) has to hide behind or
// between the products.
//
// Design:
// * One warpgroup (128 threads) per 64-row q-tile of one (batch, query
//   head); two blocks per SM, so one block's softmax overlaps the other's
//   products.  The 1-D grid issues the late (heaviest) q-tiles first.
// * Q, K and V tiles stay bf16 in shared memory, in 128-byte rows of 64
//   elements with the 128-byte swizzle that wgmma's descriptors name
//   (chunk c of row r at chunk c ^ (r % 8)); hd 32 is padded to 64 and
//   hd 160 to 192 with zeros.  K and V tiles (64 keys, 32 at hd 160 and
//   256) arrive by cp.async into a ring of two stages: tile t + 1 is in
//   flight while tile t is used.  At hd 160 a block holds 74 KB (Q 24 KB,
//   the K/V ring 48 KB), so two blocks still fit an SM.
// * S = Q K^T is wgmma m64nBKk16 with both operands K-major in shared
//   memory; O += P V is wgmma m64n(padded hd)k16 with P in registers (the S
//   accumulator's layout is wgmma's A-fragment layout) and V read
//   transposed (N-major) from the same tiles.  O (64 x hd f32, hd/2
//   registers a thread) stays in registers for the whole key loop.
// * Numerics: the scale hd^-0.5 (times log2 e, for exp2) is applied in
//   f32 to S.  P is not rounded to bf16 once: P = P_hi + P_lo, both bf16,
//   and both products are accumulated in f32, so P V carries about 16
//   bits of each probability (one bf16 rounding would lose 2^-9
//   relative, more than the 1 ulp + 2e-5 that the plain version allows).
//   The row sums l use the f32 P.
// * Key tiles hidden from every row of the q-tile by the causal or window
//   mask are skipped; only tiles that cross a mask edge or Sk are masked
//   elementwise.  A row with no visible key keeps l = 0 and writes 0.
//   q_offset, Sq and Sk are runtime values; ragged edges are zero-filled
//   by cp.async's source size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one warpgroup
constexpr int kBQ = 64;         // query rows per block (one wgmma M)
constexpr float kNegInit = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int HDP = (HD + 63) / 64 * 64;      // columns held in shared memory
  static constexpr int BK = HDP >= 192 ? 32 : 64;      // keys per tile
  static constexpr int Q_BYTES = kBQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;
  // 1024 bytes of slack to align the swizzled tiles to 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// makes this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching wgmma's registers across the async region
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B N-major (transposed)
  // in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B N-major (transposed)
  // in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  // D[64 x 192] += A[64 x 16] B[16 x 192], A in registers, B N-major (transposed)
  // in shared memory (hd 160 padded to 192 columns)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // D[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B N-major (transposed)
  // in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};


// Rows [0, ROWS) of a [ROWS, HDP] bf16 tile into shared memory at sbase
// (1024-byte aligned): global row r at g + r * ld; rows >= nrows and
// columns >= HD are zero-filled.  Layout: column block cb (64 elements) at
// cb * ROWS * 128, row r at r * 128 within it, 16-byte chunk c at
// (c ^ (r % 8)) * 16 within the row.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t sbase, const __nv_bfloat16* base,
                                          const __nv_bfloat16* g, int64_t ld, int nrows,
                                          int tid) {
  constexpr int HDP = Cfg<HD>::HDP, CH = HDP / 8;
  static_assert(ROWS * CH % kThreads == 0, "tile chunks must split evenly over the threads");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int i = it * kThreads + tid, r = i / CH, c = i % CH;
    const bool full = r < nrows && c * 8 < HD;
    const uint32_t off = (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(sbase + off, full ? g + r * ld + c * 8 : base, full);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int B,
                     int Sq, int Sk, int Hq, int Hkv, int causal, int window, int q_offset,
                     float scale_log2) {
  using C = Cfg<HD>;
  constexpr int HDP = C::HDP, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;         // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + 2 * C::KV_BYTES;

  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / (B * Hq));  // heaviest first
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ, nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qlo = q_offset + q0, qhi = qlo + nq - 1;

  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, qlo - window + 1);
  if (causal) k_end = min(Sk, qhi + 1);
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const int64_t kv_ld = static_cast<int64_t>(Hkv) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;
  load_tile<HD, kBQ>(sQ, q, q + ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * HD,
                     static_cast<int64_t>(Hq) * HD, nq, tid);
  if (n_tiles > 0) {
    load_tile<HD, BK>(sK, k, kb + k_begin * kv_ld, kv_ld, Sk - k_begin, tid);
    load_tile<HD, BK>(sV, v, vb + k_begin * kv_ld, kv_ld, Sk - k_begin, tid);
  }
  cp_async_commit();

  // this thread's rows of the accumulators: r0 = 16 * warp + lane / 4 and r0 + 8;
  // its columns: 8 * j + 2 * (lane % 4) + {0, 1} for each 8-column group j
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int p0 = qlo + r0, p1 = p0 + 8;  // absolute positions of the two rows
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInit, m1 = kNegInit, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK, st = t & 1;
    if (t + 1 < n_tiles) {
      const int kn = k0 + BK;
      load_tile<HD, BK>(sK + (st ^ 1) * C::KV_BYTES, k, kb + kn * kv_ld, kv_ld, Sk - kn, tid);
      load_tile<HD, BK>(sV + (st ^ 1) * C::KV_BYTES, v, vb + kn * kv_ld, kv_ld, Sk - kn, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile t (and Q) landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t kT = sK + st * C::KV_BYTES, vT = sV + st * C::KV_BYTES;
    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (HD + 15) / 16; ++kk) {  // the zero-padded columns add nothing
      const uint32_t col = (kk >> 2), within = (kk & 3) * 32;
      Wgmma<BK>::ss(s, desc_sw128(sQ + col * (kBQ * 128) + within, 16, 1024),
                    desc_sw128(kT + col * (BK * 128) + within, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale (log2 domain), mask the tiles that cross an edge, row maxima
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= qlo) &&
                      (window <= 0 || k0 > qhi - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (!full) {
          const int key = k0 + 8 * j + cq + (e & 1), p = e < 2 ? p0 : p1;
          const bool vis = key < Sk && (!causal || key <= p) && (window <= 0 || key > p - window);
          x = vis ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(s - m) in f32; its bf16 hi and lo parts as wgmma A fragments
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float mrow = (r & 1) ? mn1 : mn0;
        const float x0 = exp2f(s[i] - mrow), x1 = exp2f(s[i + 1] - mrow);
        if (r & 1) sum1 += x0 + x1; else sum0 += x0 + x1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
    }
    l0 = l0 * c0 + sum0;  // this thread's share of the row sums (the 4 lanes
    l1 = l1 * c1 + sum1;  // of a row are added after the loop)
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }

    fence_regs(acc);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // keys 16 kk .. 16 kk + 15: rows of 128 bytes, 8-row groups 1024 bytes
      // apart, 64-column blocks BK * 128 bytes apart
      const uint64_t dv = desc_sw128(vT + kk * 16 * 128, BK * 128, 1024);
      Wgmma<HDP>::rs(acc, phi[kk], dv);
      Wgmma<HDP>::rs(acc, plo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* out0 = o + ((static_cast<int64_t>(b) * Sq + q0 + r0) * Hq + h) * HD + cq;
  __nv_bfloat16* out1 = out0 + static_cast<int64_t>(8) * Hq * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r0 + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int Hq, int Hkv, int causal, int window, int q_offset, float scale_log2,
                   cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>((Sq + kBQ - 1) / kBQ) * B * Hq;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_prefill_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, Sq, Sk, Hq, Hkv,
      causal, window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd], o like q; all bf16, contiguous,
// 16-byte aligned.  hd in {32, 64, 128, 160, 256}, Hq a multiple of Hkv, B, Sq,
// Hq >= 1 and Sk >= 0 (the caller checked).  window <= 0 means no window;
// scale_log2 is hd^-0.5 * log2(e).  Returns the first CUDA error of the
// attribute call or the launch (0 on success).
int flash_prefill_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int Hq, int Hkv, int hd, int causal, int window, int q_offset,
                         float scale_log2, void* stream_ptr) {
  if (B < 1 || Sq < 1 || Sk < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2,
                         stream);
    case 160:
      return launch<160>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2,
                         stream);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale_log2,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
