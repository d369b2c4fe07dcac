// Parts shared by the port's tensor-core kernels for Hopper (sm_90a):
// gmm.cu (gmm_tc_kernel), flash_attention_fwd.cu (flash_fwd_tc_kernel),
// flash_attention_bwd.cu (flash_dq_tc_kernel, flash_dkv_tc_kernel),
// ssd_scan.cu (ssd_scan_tc_kernel) and wkv6_scan.cu (wkv6_scan_tc_kernel).
//
// All stage bf16 tiles in shared memory (by TMA, or, in ssd_scan.cu and
// wkv6_scan.cu, by the threads' own copies), as rows 128 bytes (64 bf16) wide in the
// 128-byte swizzle, and multiply them with wgmma.mma_async (f32 += bf16 x
// bf16) reading the operands through shared-memory matrix descriptors.
// What lives here:
//   - for both compilers: the descriptor builder, the accumulator fragment
//     layout and the A fragment of a 16-bit operand in registers, the
//     128-byte swizzle, bf16 packing and a bf16 pair store, the split of a
//     float32 fragment into bf16 terms, float32 operations rounded once
//     (no fused multiply-add), the tensor map's shape (MapSpec);
//   - with nvcc: mbarriers, the 3-D TMA load, cp.async, a flag's acquire
//     and release, the wgmma fences, the m64n128k16 and
//     m64n64k16 products with both operands in shared memory and with A
//     from registers, and
//     cuTensorMapEncodeTiled found through cudaGetDriverEntryPoint (no
//     -lcuda);
//   - without nvcc (the CPU emulation in the tests): SmemModel, which lays
//     TMA boxes (or a thread's stores) into a byte array with the zero
//     fill and the swizzle written out, and reads each wgmma operand
//     through its descriptor as
//     the tensor cores address the swizzled layouts, model_wgmma, one
//     product in k order, and the fragments of a whole warpgroup as
//     matrices (to_frags, a_from_regs). They cannot show the PTX, the
//     barriers or the tensor cores' own order of sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include <cstring>

#ifdef __CUDACC__
#include <cuda.h>
#else
#include <vector>
#endif

namespace tc {

constexpr int kRowBytes = 128;      // one box row of 64 bf16: the swizzle's span
constexpr int kSwizzleAtom = 1024;  // 8 rows of 128 bytes
constexpr int kMmaM = 64;           // rows of one wgmma: a warpgroup's
constexpr int kMmaK = 16;           // depth of one bf16 wgmma

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1.
__host__ __device__ inline std::uint64_t sw128_desc(std::uint32_t addr,
                                                    std::uint32_t lbo,
                                                    std::uint32_t sbo) {
  return (std::uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((std::uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((std::uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// The wgmma accumulator fragment (m64nN, f32): thread t of the warpgroup
// holds, in register i, row frag_row(t, i) and column frag_col(t, i).
__host__ __device__ constexpr int frag_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__host__ __device__ constexpr int frag_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4) + i % 2;
}

__host__ __device__ inline void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
#ifdef __CUDACC__
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
#else
  p[0] = __float2bfloat16_rn(a);
  p[1] = __float2bfloat16_rn(b);
#endif
}

__host__ __device__ inline float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as a bf16 pair in one register, a in the low half
__host__ __device__ inline std::uint32_t pack_bf16(float a, float b) {
#ifdef __CUDACC__
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const std::uint32_t*>(&h);
#else
  const __nv_bfloat16 x = __float2bfloat16_rn(a), y = __float2bfloat16_rn(b);
  std::uint16_t lo, hi;
  std::memcpy(&lo, &x, 2);
  std::memcpy(&hi, &y, 2);
  return lo | (std::uint32_t)hi << 16;
#endif
}

// the low (h 0) or high (h 1) bf16 of a register as a float
__host__ __device__ inline float half_of(std::uint32_t reg, int h) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(h ? reg & 0xFFFF0000u : reg << 16);
#else
  const std::uint32_t bits = h ? reg & 0xFFFF0000u : reg << 16;
  float x;
  std::memcpy(&x, &bits, 4);
  return x;
#endif
}

// float32 products, sums and differences rounded once, with no fused
// multiply-add (the plain version's roundings), for both compilers.
__host__ __device__ inline float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ inline float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ inline float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// The A operand of a wgmma m64k16 from registers (16-bit types, PTX ISA):
// thread t's register r holds row a_row(t, r) and columns a_col(t, r, 0)
// (low half) and a_col(t, r, 1) (high half) of the slice. For such an A,
// the accumulator registers 8 kk .. 8 kk + 7 of an m64nN fragment are, pair
// by pair, the A fragment of its columns 16 kk .. 16 kk + 15.
__host__ __device__ constexpr int a_row(int t, int r) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * (r % 2);
}
__host__ __device__ constexpr int a_col(int t, int r, int h) {
  return 2 * (t % 4) + 8 * (r / 2) + h;
}

// x[first ..] of a fragment as T bf16 terms of R registers, each the
// rounding of what the terms before it left (x_hi = bf16(x), x_mid =
// bf16(x - x_hi), x_lo = ...): three terms of 8 bits hold the 24 of a
// float32 exactly. Packed pair by pair: register j of a term holds
// x[first + 2j] and the next, so that registers 4 s .. 4 s + 3 are the A
// fragment of the s-th 16 columns from first on.
// (What a term leaves is read back from the packed pair itself: one
// conversion per pair and term.)
template <int T, int R>
__host__ __device__ inline void split_terms(const float* x, int first,
                                            std::uint32_t (&terms)[T][R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float a = x[first + 2 * j], b = x[first + 2 * j + 1];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      terms[u][j] = pack_bf16(a, b);
      a -= half_of(terms[u][j], 0);
      b -= half_of(terms[u][j], 1);
    }
  }
}

// The 128-byte swizzle on a shared-memory byte address (or an offset from
// a 1,024-byte aligned base): its 16-byte chunk (bits 4-6) XOR its 128-byte
// row within the 1,024-byte atom (bits 7-9). TMA lays a box so; a thread
// that reads a box element by element applies it to the element's offset.
__host__ __device__ constexpr std::uint32_t swizzle128(std::uint32_t a) {
  return a ^ (((a >> 7) & 7u) << 4);
}

// A tensor map's shape: dims and byte strides innermost first, the box.
struct MapSpec {
  std::uint64_t dims[3];
  std::uint64_t strides[2];
  std::uint32_t box[3];
};

#ifdef __CUDACC__

__device__ __forceinline__ std::uint32_t smem_u32(const void* p) {
  return (std::uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(std::uint32_t bar,
                                          std::uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(std::uint32_t bar,
                                          std::uint32_t parity) {
  std::uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(std::uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(std::uint32_t bar,
                                                      std::uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(std::uint32_t dst,
                                            std::uint64_t map,
                                            std::uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product reads or writes (its accumulators, its A fragments)
// across the product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(std::uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float smem_bf16(const unsigned char* sm,
                                           std::uint32_t at) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(sm + swizzle128(at)));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// cp.async of `Bytes` (4, 8 or 16) from src into shared memory at dst, zero
// fill where `live` is false (nothing is read then; src must still be a
// valid address)
template <int Bytes>
__device__ __forceinline__ void cp_async(std::uint32_t dst, const void* src,
                                         bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(Bytes), "r"(live ? Bytes : 0)
               : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
template <int T, int R>
__device__ __forceinline__ void fence_terms(std::uint32_t (&terms)[T][R]) {
#pragma unroll
  for (int u = 0; u < T; ++u) fence_regs(terms[u]);
}

// d (+)= A B, one m64n128k16 with both operands in shared memory: A
// K-major, B K-major (TransB 0) or MN-major (TransB 1); accumulate 0
// overwrites d.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    std::uint64_t da,
                                                    std::uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TransB));
}

// d += A B, one m64n128k16 with A (16 columns of bf16 pairs, a_row /
// a_col) from registers and B in shared memory, K-major (TransB 0) or
// MN-major (TransB 1).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    std::uint32_t a0,
                                                    std::uint32_t a1,
                                                    std::uint32_t a2,
                                                    std::uint32_t a3,
                                                    std::uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TransB));
}

// d (+)= A B, one m64n64k16 with both operands in shared memory: A
// K-major, B K-major (TransB 0) or MN-major (TransB 1); accumulate 0
// overwrites d.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   std::uint64_t da,
                                                   std::uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TransB));
}

// d += A B, one m64n64k16 with A (16 columns of bf16 pairs, a_row /
// a_col) from registers and B in shared memory, K-major (TransB 0) or
// MN-major (TransB 1).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   std::uint32_t a0,
                                                   std::uint32_t a1,
                                                   std::uint32_t a2,
                                                   std::uint32_t a3,
                                                   std::uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TransB));
}

// blockIdx.x, read anew: a consumer works its block's coordinates out again
// where it needs them rather than keep them in registers through its loop
// (ptxas spilled them)
__device__ __forceinline__ int block_index() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return x;
}

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 map in the 128-byte swizzle, zero fill outside the tensor: 0, or
// -2 where cuTensorMapEncodeTiled refuses it (a pointer not 16-byte aligned)
inline int encode_map(CUtensorMap* m, const MapSpec& s, const void* base) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {s.dims[0], s.dims[1], s.dims[2]};
  const cuuint64_t strides[2] = {s.strides[0], s.strides[1]};
  const cuuint32_t box[3] = {s.box[0], s.box[1], s.box[2]};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

#else  // the host model's shared memory

struct SmemModel {
  std::vector<unsigned char> smem;  // address 0 is the aligned start
  bool ok = true;

  float at(std::uint32_t addr) {
    addr = swizzle128(addr);
    if (addr + 2 > smem.size()) {
      ok = false;
      return 0.f;
    }
    __nv_bfloat16 h;
    std::memcpy(&h, &smem[addr], 2);
    return __bfloat162float(h);
  }

  // a TMA box load: zero outside the tensor on every axis, the box's rows
  // of 128 bytes laid at dst on, swizzled
  void copy(const MapSpec& m, const void* src, std::uint32_t dst, int c0,
            int c1, int c2) {
    const unsigned char* g = static_cast<const unsigned char*>(src);
    for (std::uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (std::uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (std::uint32_t i0 = 0; i0 < m.box[0]; ++i0) {
          const std::int64_t g0 = (std::int64_t)c0 + i0,
                             g1 = (std::int64_t)c1 + i1,
                             g2 = (std::int64_t)c2 + i2;
          unsigned char v[2] = {0, 0};
          if (g0 >= 0 && g1 >= 0 && g2 >= 0 &&
              (std::uint64_t)g0 < m.dims[0] &&
              (std::uint64_t)g1 < m.dims[1] && (std::uint64_t)g2 < m.dims[2])
            std::memcpy(v, g + g0 * 2 + g1 * m.strides[0] + g2 * m.strides[1],
                        2);
          const std::uint32_t a =
              swizzle128(dst + ((i2 * m.box[1] + i1) * m.box[0] + i0) * 2);
          if (a + 2 > smem.size()) {
            ok = false;
            continue;
          }
          std::memcpy(&smem[a], v, 2);
        }
  }

  // a thread's store of `bytes` bytes (2, 4 or 8, within one 16-byte
  // chunk) at addr, swizzled
  void store(std::uint32_t addr, const void* src, int bytes) {
    addr = swizzle128(addr);
    if (addr + bytes > smem.size()) {
      ok = false;
      return;
    }
    std::memcpy(&smem[addr], src, bytes);
  }

  struct Desc {
    std::uint32_t start, lbo, sbo, base, layout;
  };

  // a descriptor's fields; false (and the model marked failed) unless it
  // is a 128-byte-swizzle descriptor with base offset 0
  bool decode(std::uint64_t d, Desc& out) {
    out = Desc{(std::uint32_t)(d & 0x3FFF) << 4,
               (std::uint32_t)((d >> 16) & 0x3FFF) << 4,
               (std::uint32_t)((d >> 32) & 0x3FFF) << 4,
               (std::uint32_t)((d >> 49) & 7), (std::uint32_t)(d >> 62)};
    if (out.layout != 1 || out.base != 0) ok = false;
    return ok;
  }

  // The A operand of one wgmma (64 rows x 16 deep), K-major: A(m, k) at
  // start + (m / 8) SBO + (m % 8) 128 + 2 k.
  bool read_a(std::uint64_t da, float (&A)[kMmaM][kMmaK]) {
    Desc a;
    if (!decode(da, a)) return false;
    for (int m = 0; m < kMmaM; ++m)
      for (int k = 0; k < kMmaK; ++k)
        A[m][k] = at(a.start + (m / 8) * a.sbo + (m % 8) * 128 + 2 * k);
    return ok;
  }

  // The B operand of one wgmma (16 deep x n columns) into B[k * n + col]:
  // K-major (trans_b 0), B(k, c) at start + (c / 8) SBO + (c % 8) 128 + 2 k;
  // MN-major (trans_b 1), B(k, c) at start + (c / 64) LBO + (k / 8) SBO +
  // (k % 8) 128 + 2 (c % 64).
  bool read_b(std::uint64_t db, int trans_b, int n, float* B) {
    Desc b;
    if (!decode(db, b)) return false;
    for (int k = 0; k < kMmaK; ++k)
      for (int c = 0; c < n; ++c)
        B[k * n + c] =
            trans_b ? at(b.start + (c / 64) * b.lbo + (k / 8) * b.sbo +
                         (k % 8) * 128 + 2 * (c % 64))
                    : at(b.start + (c / 8) * b.sbo + (c % 8) * 128 + 2 * k);
    return ok;
  }
};

// One m64nNk16 into acc[64][n] (row major) in k order: A the matrix a, B
// read through its descriptor.
inline void model_wgmma(SmemModel& model, const float (*a)[kMmaK],
                        std::uint64_t db, int trans_b, int n, float* acc) {
  std::vector<float> B(kMmaK * n);
  if (!model.read_b(db, trans_b, n, B.data())) return;
  for (int r = 0; r < kMmaM; ++r)
    for (int c = 0; c < n; ++c) {
      float s = acc[r * n + c];
      for (int k = 0; k < kMmaK; ++k) s += a[r][k] * B[k * n + c];
      acc[r * n + c] = s;
    }
}

// An m64nN accumulator as a [64][N] row-major matrix, to the warpgroup's
// fragments (R = N / 2 registers a thread).
using Mat = std::vector<float>;
template <int R>
inline void to_frags(const Mat& m, float (*f)[R]) {
  for (int t = 0; t < 128; ++t)
    for (int i = 0; i < R; ++i)
      f[t][i] = m[frag_row(t, i) * (2 * R) + frag_col(t, i)];
}

// An A operand from the warpgroup's registers: register r of thread t
// holds row a_row(t, r), columns a_col(t, r, 0) and a_col(t, r, 1).
inline void a_from_regs(const std::uint32_t (*regs)[4], float (*a)[kMmaK]) {
  for (int t = 0; t < 128; ++t)
    for (int r = 0; r < 4; ++r)
      for (int h = 0; h < 2; ++h)
        a[a_row(t, r)][a_col(t, r, h)] = half_of(regs[t][r], h);
}

#endif  // __CUDACC__

}  // namespace tc
