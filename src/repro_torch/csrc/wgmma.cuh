// The bfloat16 tensor-core helpers that the port's Hopper (sm_90a) kernels
// share: cp.async staging, the 128-byte-swizzled shared-memory layout that
// a wgmma descriptor reads, the descriptors themselves, the fences and
// waits of an asynchronous wgmma, and the wgmma shapes the kernels issue.
// Included by attention.cu, attention_bwd.cu and ssd_bwd.cu; the build
// (kernels/_cuda.py) hashes this file into each includer's library name.
//
// Layout: a tile of `rows` bfloat16 rows is kept in panels of 64 columns
// (128 bytes a row); panel c / 64 holds rows * 128 bytes, row r starts at
// 128 r, and its 16-byte chunk (c % 64) / 8 sits at chunk ((c % 64) / 8) ^
// (r % 8).  Every panel starts on a 1,024-byte boundary (kAtom: 8 swizzled
// rows), so a descriptor's base offset stays 0.
//
// Operands: "K-major" holds the reduction dimension along a row (a tile
// stored [m or n][k]); "MN-major" holds it down the rows ([k][m or n]) and
// is read through the descriptor's transpose bit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kAtom = 1024;  // 8 swizzled rows of 128 bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of element (r, c) in a swizzled tile of `rows` rows
__device__ __forceinline__ int sw128(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// Stage `rows` rows of `width` bfloat16 (row stride rs) into dst in the
// swizzled layout of width W, zero-filling the columns up to W and the rows
// from `nvalid` on: 16-byte cp.async chunks where vec16 allows them, else
// one element at a time by plain loads and stores (cp.async has no 2-byte
// copy).
template <int W>
__device__ __forceinline__ void stage_sw128(unsigned char* dst, int rows, const __nv_bfloat16* src,
                                            long long rs, int nvalid, int width, bool vec16) {
  if (vec16) {
    constexpr int kChunks = W / 8;  // per row
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      const bool ok = r < nvalid && c < width;
      cp_async16(dst + sw128(rows, r, c), ok ? src + r * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
      const int r = i / W;
      const int c = i - r * W;
      const bool ok = r < nvalid && c < width;
      *reinterpret_cast<__nv_bfloat16*>(dst + sw128(rows, r, c)) =
          ok ? src[r * rs + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: the
// start address, leading and stride byte offsets (each >> 4) and the
// swizzle mode (1: 128 bytes) in bits 62-63.  The base offset (bits 49-51)
// stays 0: every panel starts on a 1,024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// A K-major operand's k16 slice j: 32 bytes apart inside a 64-column panel,
// panels `rows` * 128 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int rows, int j) {
  return sw128_desc(addr + (j >> 2) * rows * 128 + (j & 3) * 32, 16, kAtom);
}

// An MN-major operand (a tile of `rows` rows read as k x width, the
// transpose bit set) from row `row` on: panels `rows` * 128 bytes apart,
// 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows, int row) {
  return sw128_desc(addr + row * 128, rows * 128, kAtom);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching a wgmma's registers across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Make this thread's generic-proxy writes to shared memory (cp.async, st)
// visible to wgmma's async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// d (64 x 64, float32) = [d +] a b over one k16 slice, both operands from
// shared memory: a (64 x 16) K-major (TA 0) or MN-major (TA 1, stored
// [k][m]), b (16 x 64) K-major (TB 0, stored [n][k]) or MN-major (TB 1,
// stored [k][n])
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_t(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, float32) = [d +] a b^T over one k16 slice: a (64 x 16) and b
// (64 x 16) bfloat16 from shared memory, both K-major; scale_d 0 drops d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  wgmma_ss_n64_t<0, 0>(d, a, b, scale_d);
}

// d (64 x 32, float32) = [d +] a b^T over one k16 slice: as wgmma_ss_n64
// with b (32 x 16)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, float32) = [d +] a b^T over one k16 slice: as wgmma_ss_n64
// with b (128 x 16)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, float32) += a b over one k16 slice: a (64 x 16) bfloat16 in
// registers (the m64k16 A fragment), b (16 x 64) bfloat16 from shared
// memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, float32) += a b over one k16 slice: as wgmma_rs_n64 with b
// (16 x 128)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (W == 64)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n128(d, a, b);
}

// x = hi + lo as bfloat16 A fragments of NS k16 slices: slice j's register
// r holds columns 16j + 8 (r >> 1) + 2t, + 1 of row g + 8 (r & 1), which
// is x[8j + 2r], x[8j + 2r + 1] of the accumulator layout.  hi = bf16(x),
// lo = bf16(x - hi): what lo drops is at most 2^-16 |x|.
template <int NS>
__device__ __forceinline__ void split_frags(const float* x, uint32_t (&hi)[NS][4],
                                            uint32_t (&lo)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * j + 2 * r], x1 = x[8 * j + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[j][r] = bits(h);
      lo[j][r] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
  }
}

}  // namespace
