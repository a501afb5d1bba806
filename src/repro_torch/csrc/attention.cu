// Online-softmax attention for Hopper (sm_90a) on the tensor cores, float32
// or bfloat16 I/O, float32 arithmetic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/kernel.py
// (flash_attention_kernel, line 38): out = softmax(q k^T / sqrt(D) + mask) v
// over (B, H, S, D) operands, with
//   * causal masking of key j for query row i at absolute position
//     q_offset + i (j <= q_offset + i);
//   * optional segment ids (B, Sk): a row sees only keys of its own
//     segment; a row whose absolute position is past Sk has segment -2;
//   * rows that see no key finalizing to 0;
//   * Sq != Sk and a value width Dv != D (both 1..128);
//   * optionally, each row's log-sum-exp in base 2, lse = m + log2(l) in
//     the units of the scores it exponentiates (scale * log2(e) folded
//     in, see below), for the backward (attention_bwd.cu): P = 2^(s - lse).
//     A row that sees no key gets +inf, so that 2^(s - lse) is 0 there as
//     its output is.  With a null lse pointer nothing else changes.
// q, k and v are read at the strides they come with (the last dimension
// contiguous), and out is written at the strides the caller gives, so the
// Tao block hands over views of its packed (B, S, 3, H, D) projection and
// gets its (B, S, H, Dv) output with no copy on either side.
//
// Arithmetic: 3xTF32.  Both products, S = Q K^T and O += P V, run as
// mma.sync.m16n8k8 TF32 tensor-core instructions.  Each float32 operand x
// is split into x = hi + lo, hi = x rounded to TF32 (to nearest, ties away
// from zero: add half a TF32 ulp to the bits and mask) and lo = x - hi
// (exact) cut to TF32, and lo*hi + hi*lo + hi*hi is accumulated in float32:
// the dropped lo*lo and lo's cut are ~2^-21 of |x y|, float32-level error.
// Plain TF32 keeps 10 mantissa bits (~5e-4 relative) and would break the
// port's parity rule (float32 products at full precision) and the
// 1e-5 + 1e-5|ref| the kernel is held to.  (cvt.rna.tf32.f32 has no single
// instruction on sm_90: it compiles to ~4 with an infinity check, which
// finite inputs do not need.)  Exponents are ex2.approx of scores that
// carry scale * log2(e), folded into Q's fragments as they are loaded; the
// plain version takes expf of the unfolded scores, which the tolerance
// covers (a few ulp of |s| <= ~10).
//
// bfloat16 I/O (dtype 1; q, k and v all bfloat16) computes what the TPU
// kernel computes for bfloat16 operands (kernel.py:81-82, 102, 113): the
// inputs upcast to float32, both products accumulated in float32, P kept
// in float32, the output rounded once to bfloat16 (to nearest even); lse
// stays float32.  Every bfloat16 value is exact in TF32 (8 significant
// bits of 11), so an operand read from memory has lo = 0 (as in ssd.cu):
// S = Q K^T is one TF32 mma per step on the raw operands, scaled by
// scale * log2(e) afterwards (Q * scale is not exact in TF32, so the
// scale is not folded into Q here), and O += P V is two, P_hi V + P_lo V.
// Tiles are staged in shared memory as bfloat16 (16-byte cp.async of 8
// elements where widths, strides and addresses allow it, else one element
// at a time by plain loads) and widened when the fragments are built, by
// a 16-bit shift.
//
// Tiles: a warp owns 16 query rows; a block owns 16 * nwarps consecutive
// rows of one (batch, head), nwarps <= 9 (<= 4 for Dv > 64), cut into
// equal blocks, the heaviest causal block launched first.  (The counts
// below are the float32 build's.)  A Tao window of
// 129 rows is one block of 9 warps: the grid is 256 blocks of 288
// threads, 57,600 bytes of shared memory each, 95 registers, no spills
// (ptxas -v), two blocks per SM: one wave over the 132 SMs.  Row tiles are
// dealt to warps heaviest first, snaking over the four schedulers
// (warp % 4), so each scheduler gets an even share of the causal keys.
// Keys stream through shared memory 64 at a time, staged with 16-byte
// cp.async (4-byte where strides or widths are not multiples of 4),
// double-buffered so the next tile loads while this one computes; q, k
// and v are read from device memory once per block.  Rows are zero-padded
// (K to a multiple of 8 elements, V to the template's 32, 64 or 128) and
// pitched at that + 4 floats, or, in bfloat16, at that rounded up to 16
// elements + 8: a pitch of 4 mod 8 words, so every fragment load of a
// warp hits distinct banks (two lanes reading one word share it).
// The score tile lives in registers in the mma C layout, where a query row
// sits in one quad of lanes: the row max costs 2 __shfl_xor_sync per row
// per key tile and the row sum stays lane-partial until the end.  The C
// layout of the scores is fed to P V as its A operand unchanged, by
// permuting the keys of each 8-key step (A column c <-> key 2c, c + 4 <->
// key 2c + 1, V's rows read in the same order): no shuffle, no staging.
// Causal tiles past a warp's last row are skipped, and a tile runs as 2,
// 4 or 8 eight-key steps, a template argument: a branch around an
// mma.sync is a convergence point, and guarded steps ran one by one.  Only
// tiles that cross the diagonal, the end of Sk or a segment are masked.
//
// What bounds it on the H100: at the Tao shape (64, 4, 129, 32) 16.9 MB of
// q/k/v/out over 3.35 TB/s is 5.0 us and the 2.1 M visible (query, key)
// pairs at 4·D float32 FLOPs each over 67 TFLOP/s is 4.1 us.  Neither
// binds: every block reads its q and first K/V tile before it can start,
// all at once, and then the time is the latency of the longest warp's
// chain of dependent steps (split, mma, max, exp, mma) with ~4.5 warps per
// scheduler to hide it.  The tensor cores are not the limit: the Tao
// shape's 3xTF32 products are 1.2 GFLOP of TF32, 2.4 us at the data
// sheet's dense TF32 peak of 495 TFLOP/s.  mma.sync does not reach that
// peak (wgmma is Hopper's full-rate path); at half of it the products
// take 4.9 us, still well under the kernel's time.  PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kRows = 16;       // query rows per warp (the mma's M)
constexpr int kPad = 4;         // float32 row pitch = width padded to 8, + 4 floats
constexpr int kPadBf16 = 8;     // bfloat16 row pitch = width padded to 16, + 8
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Warps per block at most, by output column tiles: a 129-row Tao window
// (9 row tiles) is one block; the widest accumulators (Dv > 64) get 4
// warps, so that ptxas can give them their registers without spilling.
constexpr int max_warps(int dv8) { return dv8 <= 8 ? 9 : 4; }

struct Params {
  const void* q;        // float or __nv_bfloat16, as the kernel's T
  const void* k;
  const void* v;
  const int32_t* seg;
  void* out;            // T
  float* lse;           // (B, H, Sq) contiguous, or null
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  int H, Sq, Sk, D, Dv;
  int dk;               // D padded to a multiple of 8
  int pq;               // Q / K row pitch in elements
  int causal, q_offset;
  int vec16;            // 16-byte copies: widths, strides, pointers allow it
  int vec2;             // float2 stores of the output
  int nqb;              // query blocks per (batch, head)
  float qscale;         // 1/sqrt(D) * log2(e): on Q's fragments (float32) or the scores
};

// Row pitch in elements of a staged tile of `width` (a multiple of 8) T.
template <typename T>
__host__ __device__ constexpr int pitch(int width) {
  return sizeof(T) == 4 ? width + kPad : (width + 15) / 16 * 16 + kPadBf16;
}

// A bfloat16 value as a TF32 operand: its bits widened to float32, exact.
__device__ __forceinline__ uint32_t tf32_of(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* o, float a) { *o = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float a) { *o = __float2bfloat16_rn(a); }

// x = hi + lo in TF32: hi rounded to nearest (ties away), lo the exact
// remainder cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// 2^x in one MUFU instruction (approximate to a few float32 ulp; results
// below 2^-126 flush to 0, far under the tolerance)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float* c, const uint32_t* ahi, const uint32_t* alo,
                                     const uint32_t* bhi, const uint32_t* blo) {
  mma(c, alo, bhi);
  mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

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

// Stage nrows rows of `width` elements (row stride rs) into dst at `pitch`,
// zero-filling the columns up to `wpad` and the rows from `nvalid` on:
// 16-byte cp.async chunks where vec16 allows them, else float32 one
// element at a time by 4-byte cp.async and bfloat16 by plain loads.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src, long long rs,
                                           int nvalid, int nrows, int width, int wpad,
                                           bool vec16) {
  if (vec16) {
    constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
    const int cpr = wpad / kE;          // chunks per row
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * kE;
      const bool ok = r < nvalid && c < width;
      cp_async16(dst + r * pitch + c, ok ? src + r * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * wpad; i += blockDim.x) {
      const int r = i / wpad;
      const int c = i - r * wpad;
      const bool ok = r < nvalid && c < width;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + r * pitch + c, ok ? src + r * rs + c : src, ok ? 4 : 0);
      else
        dst[r * pitch + c] = ok ? src[r * rs + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// A warp's running state: the output accumulators in the mma C layout
// (o[n]: rows g, g + 8 at columns 8n + 2t, + 1), each row's running max and
// lane-partial sum, and what decides its masks.
template <int DV8>
struct Warp {
  float o[DV8][4];
  float m0, m1, l0, l1;
  int r0;            // first query row
  int pos0, pos1;    // absolute positions of rows g, g + 8
  int segq0, segq1;  // their segments
};

// One key tile of NN 8-key steps for one warp.  NN and DV8 are template
// arguments so that no branch sits around an mma.sync: a guarded mma.sync
// is a convergence point, and the steps would run one by one.
template <int NN, int DV8, typename T>
__device__ __forceinline__ void key_tile(Warp<DV8>& w, const Params& p, const T* qa,
                                         const T* ks, const T* vs, const int* ss,
                                         bool segmented, int kt, int g, int t) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int pq = p.pq;
  constexpr int pv = pitch<T>(DV8 * 8);

  // ---- S = Q K^T (16 x 8NN), C layout: s[n] = rows g / g + 8, keys 8n + 2t, + 1
  float s[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const T* kb = ks + g * pq + t;
  for (int kk = 0; kk < p.dk; kk += 8) {
    if constexpr (kF32) {
      uint32_t ah[4], al[4];
      split(qa[kk] * p.qscale, ah[0], al[0]);
      split(qa[kk + 8 * pq] * p.qscale, ah[1], al[1]);
      split(qa[kk + 4] * p.qscale, ah[2], al[2]);
      split(qa[kk + 4 + 8 * pq] * p.qscale, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        uint32_t bh[2], bl[2];
        split(kb[n * 8 * pq + kk], bh[0], bl[0]);
        split(kb[n * 8 * pq + kk + 4], bh[1], bl[1]);
        mma3(s[n], ah, al, bh, bl);
      }
    } else {  // exact TF32 operands: one product
      const uint32_t a[4] = {tf32_of(qa[kk]), tf32_of(qa[kk + 8 * pq]), tf32_of(qa[kk + 4]),
                             tf32_of(qa[kk + 4 + 8 * pq])};
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const uint32_t b[2] = {tf32_of(kb[n * 8 * pq + kk]), tf32_of(kb[n * 8 * pq + kk + 4])};
        mma(s[n], a, b);
      }
    }
  }
  if constexpr (!kF32) {
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      s[n][0] *= p.qscale;
      s[n][1] *= p.qscale;
      s[n][2] *= p.qscale;
      s[n][3] *= p.qscale;
    }
  }

  // ---- masks: only tiles that cross the diagonal, Sk or a segment
  if (segmented || kt + 8 * NN > p.Sk || (p.causal && kt + 8 * NN - 1 > p.q_offset + w.r0)) {
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * n + 2 * t + (e & 1);
        bool ok = key < p.Sk && (!p.causal || key <= (e < 2 ? w.pos0 : w.pos1));
        if (segmented) ok = ok && ss[key - kt] == (e < 2 ? w.segq0 : w.segq1);
        if (!ok) s[n][e] = kNegInf;
      }
    }
  }

  // ---- online softmax: a row lives in one quad of lanes
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float mn0 = fmaxf(w.m0, mx0);
  const float mn1 = fmaxf(w.m1, mx1);
  const float c0 = ex2(w.m0 - mn0);
  const float c1 = ex2(w.m1 - mn1);
  w.m0 = mn0;
  w.m1 = mn1;
  // a row that has seen no key yet keeps p = 0 (its max is still -1e30)
  const bool live0 = mn0 > kNegInf;
  const bool live1 = mn1 > kNegInf;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    s[n][0] = live0 ? ex2(s[n][0] - mn0) : 0.0f;
    s[n][1] = live0 ? ex2(s[n][1] - mn0) : 0.0f;
    s[n][2] = live1 ? ex2(s[n][2] - mn1) : 0.0f;
    s[n][3] = live1 ? ex2(s[n][3] - mn1) : 0.0f;
    ps0 += s[n][0] + s[n][1];
    ps1 += s[n][2] + s[n][3];
  }
  w.l0 = w.l0 * c0 + ps0;
  w.l1 = w.l1 * c1 + ps1;
#pragma unroll
  for (int n = 0; n < DV8; ++n) {
    w.o[n][0] *= c0;
    w.o[n][1] *= c0;
    w.o[n][2] *= c1;
    w.o[n][3] *= c1;
  }

  // ---- O += P V: the scores' C fragment is P's A fragment, with the keys
  // of step kk taken in the order 2t (column t), 2t + 1 (column t + 4)
  const T* vb = vs + 2 * t * pv + g;
#pragma unroll
  for (int kk = 0; kk < NN; ++kk) {
    uint32_t ah[4], al[4];
    split(s[kk][0], ah[0], al[0]);
    split(s[kk][2], ah[1], al[1]);
    split(s[kk][1], ah[2], al[2]);
    split(s[kk][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DV8; ++n) {
      if constexpr (kF32) {
        uint32_t bh[2], bl[2];
        split(vb[8 * kk * pv + 8 * n], bh[0], bl[0]);
        split(vb[(8 * kk + 1) * pv + 8 * n], bh[1], bl[1]);
        mma3(w.o[n], ah, al, bh, bl);
      } else {  // V exact in TF32: P_lo V, then P_hi V
        const uint32_t b[2] = {tf32_of(vb[8 * kk * pv + 8 * n]),
                               tf32_of(vb[(8 * kk + 1) * pv + 8 * n])};
        mma(w.o[n], al, b);
        mma(w.o[n], ah, b);
      }
    }
  }
}

// DV8: output column tiles of 8 a warp holds (4, 8 or 16); T: float or
// __nv_bfloat16, the type of q, k, v and out
template <int DV8, typename T>
__global__ void __launch_bounds__(max_warps(DV8) * 32, DV8 <= 4 ? 2 : 1)
attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the mma's group: rows g and g + 8
  const int t = lane & 3;   // thread in group
  const int pq = p.pq;
  constexpr int pv = pitch<T>(DV8 * 8);
  const int nw = blockDim.x >> 5;
  const int rows = nw * kRows;
  T* q_s = reinterpret_cast<T*>(smem_raw);            // [rows][pq]
  T* k_s = q_s + rows * pq;                           // [2][kKeys][pq]
  T* v_s = k_s + 2 * kKeys * pq;                      // [2][kKeys][pv]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * kKeys * pv);  // [2][kKeys]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (p.nqb - 1 - (int)blockIdx.y) * rows;  // heaviest causal block first
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh + q0 * p.sqs;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const int32_t* segb = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.Sk;
  const bool segmented = segb != nullptr;

  const int q_rows = min(rows, p.Sq - q0);
  const int kend = p.causal ? min(p.Sk, p.q_offset + q0 + q_rows) : p.Sk;
  const int ntiles = (kend + kKeys - 1) / kKeys;

  auto issue = [&](int it) {
    const int kt = it * kKeys;
    const int kn = min(kKeys, p.Sk - kt);
    const int buf = it & 1;
    stage_rows(k_s + buf * kKeys * pq, pq, kg + kt * p.sks, p.sks, kn, kKeys, p.D, p.dk, p.vec16);
    stage_rows(v_s + buf * kKeys * pv, pv, vg + kt * p.svs, p.svs, kn, kKeys, p.Dv, DV8 * 8,
               p.vec16);
    if (segmented)
      for (int i = threadIdx.x; i < kKeys; i += blockDim.x)
        cp_async4(seg_s + buf * kKeys + i, i < kn ? segb + kt + i : segb, i < kn ? 4 : 0);
    cp_async_commit();
  };
  stage_rows(q_s, pq, qg, p.sqs, q_rows, rows, p.D, p.dk, p.vec16);
  issue(0);  // one group: Q and the first K/V tile
  if (ntiles > 1) issue(1);

  // This warp's row tile, dealt heaviest first and snaking over the four
  // schedulers (warp % 4), so that each scheduler gets an even share of
  // the causal keys: at 9 tiles, 23 / 22 / 22 / 22 of the block's 89
  // 8-key steps.
  const int round = warp >> 2, slot = warp & 3;
  const int in_round = min(4, nw - round * 4);  // warps dealt in this round
  const int tile = nw - 1 - (round * 4 + ((round & 1) ? in_round - 1 - slot : slot));
  Warp<DV8> w;
  w.r0 = q0 + tile * kRows;
  const bool active = w.r0 < p.Sq;
  const int wend = p.causal ? min(p.Sk, p.q_offset + min(w.r0 + kRows, p.Sq)) : p.Sk;
  w.pos0 = p.q_offset + w.r0 + g;
  w.pos1 = w.pos0 + 8;
  w.segq0 = w.segq1 = 0;
  if (segmented && active) {
    w.segq0 = w.pos0 < p.Sk ? segb[w.pos0] : -2;
    w.segq1 = w.pos1 < p.Sk ? segb[w.pos1] : -2;
  }
#pragma unroll
  for (int n = 0; n < DV8; ++n) w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.0f;
  w.m0 = w.m1 = kNegInf;
  w.l0 = w.l1 = 0.0f;
  const T* qa = q_s + (tile * kRows + g) * pq + t;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int kt = it * kKeys;
    if (active && kt < wend) {
      const T* ks = k_s + (it & 1) * kKeys * pq;
      const T* vs = v_s + (it & 1) * kKeys * pv;
      const int* ss = seg_s + (it & 1) * kKeys;
      const int nn = (wend - kt + 7) >> 3;  // 8-key steps holding a key this warp sees
      if (nn > 4)
        key_tile<8>(w, p, qa, ks, vs, ss, segmented, kt, g, t);
      else if (nn > 2)
        key_tile<4>(w, p, qa, ks, vs, ss, segmented, kt, g, t);
      else
        key_tile<2>(w, p, qa, ks, vs, ss, segmented, kt, g, t);
    }
    __syncthreads();  // every warp is done with this buffer
    if (it + 2 < ntiles) issue(it + 2);
  }

  if (!active) return;
  float l0 = w.l0, l1 = w.l1;
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);  // a row that saw no key: 0 / 1e-30
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  T* ob = static_cast<T*>(p.out) + b * p.sob + h * p.soh;
  const int ra = w.r0 + g, rb = w.r0 + g + 8;
  if (p.lse != nullptr && t == 0) {
    float* lb = p.lse + (long long)bh * p.Sq;
    if (ra < p.Sq) lb[ra] = l0 > 0.0f ? w.m0 + log2f(l0) : __int_as_float(0x7f800000);
    if (rb < p.Sq) lb[rb] = l1 > 0.0f ? w.m1 + log2f(l1) : __int_as_float(0x7f800000);
  }
#pragma unroll
  for (int n = 0; n < DV8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= p.Dv) continue;
    if (p.vec2) {
      if (ra < p.Sq) store2(ob + ra * p.sos + c, w.o[n][0] * inv0, w.o[n][1] * inv0);
      if (rb < p.Sq) store2(ob + rb * p.sos + c, w.o[n][2] * inv1, w.o[n][3] * inv1);
    } else {
      const bool c1ok = c + 1 < p.Dv;
      if (ra < p.Sq) {
        store1(ob + ra * p.sos + c, w.o[n][0] * inv0);
        if (c1ok) store1(ob + ra * p.sos + c + 1, w.o[n][1] * inv0);
      }
      if (rb < p.Sq) {
        store1(ob + rb * p.sos + c, w.o[n][2] * inv1);
        if (c1ok) store1(ob + rb * p.sos + c + 1, w.o[n][3] * inv1);
      }
    }
  }
}

// The launch a problem gets: kernel, warps per block, query blocks per
// (batch, head) and dynamic shared memory.
struct Config {
  void (*kernel)(Params);
  int dk, dv, pq, nwarps, nqb;
  size_t smem;
};

template <typename T>
Config configure_as(int Sq, int D, int Dv, bool segmented) {
  Config c;
  c.dk = (D + 7) / 8 * 8;
  c.pq = pitch<T>(c.dk);
  c.dv = Dv <= 32 ? 32 : Dv <= 64 ? 64 : 128;  // the template's column width
  c.kernel = c.dv == 32 ? attention_kernel<4, T> : c.dv == 64 ? attention_kernel<8, T>
                                                              : attention_kernel<16, T>;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int mw = max_warps(c.dv / 8);
  c.nqb = (tiles + mw - 1) / mw;
  c.nwarps = (tiles + c.nqb - 1) / c.nqb;  // equal blocks, none left with one tile
  c.smem = sizeof(T) * ((size_t)c.nwarps * kRows * c.pq + 2 * kKeys * c.pq +
                        2 * kKeys * pitch<T>(c.dv)) +
           (segmented ? 2 * kKeys * sizeof(int) : 0);
  return c;
}

// dtype: 0 float32, 1 bfloat16
Config configure(int Sq, int D, int Dv, bool segmented, int dtype) {
  return dtype == 1 ? configure_as<__nv_bfloat16>(Sq, D, Dv, segmented)
                    : configure_as<float>(Sq, D, Dv, segmented);
}

int allow_smem(const Config& c) {
  if (c.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (c.smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)c.smem);
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B,H,Sq,D), k (B,H,Sk,D), v (B,H,Sk,Dv), out (B,H,Sq,Dv): device
// pointers of one dtype (0 float32, 1 bfloat16) with element strides
// (batch, head, sequence) and a contiguous last dimension; seg (B,Sk)
// int32 contiguous or null; lse (B,H,Sq) float32 contiguous or null.
// 1 <= D, Dv <= 128.
extern "C" int tao_flash_attention(
    const void* q, const void* k, const void* v, const int32_t* seg, void* out,
    float* lse, long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs, long long sob,
    long long soh, long long sos, int B, int H, int Sq, int Sk, int D, int Dv,
    int causal, int q_offset, int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || Dv < 1 ||
      Dv > 128 || q_offset < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Config c = configure(Sq, D, Dv, seg != nullptr, dtype);
  if (c.nqb > 65535) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(c);
  if (err != 0) return err;
  const long long strides = sqb | sqh | sqs | skb | skh | sks | svb | svh | svs;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int ev = dtype == 1 ? 8 : 4;  // elements per 16-byte copy
  const int esize = dtype == 1 ? 2 : 4;
  Params p{q, k, v, seg, out, lse,
           sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
           H, Sq, Sk, D, Dv, c.dk, c.pq, causal, q_offset,
           D % ev == 0 && Dv % ev == 0 && strides % ev == 0 && ptrs % 16 == 0,
           Dv % 2 == 0 && (sob | soh | sos) % 2 == 0 && (uintptr_t)out % (2 * esize) == 0,
           c.nqb, scale * kLog2e};
  const dim3 grid(B * H, c.nqb);
  c.kernel<<<grid, c.nwarps * 32, c.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What a launch for this problem gets, without launching: info[0]
// registers per thread, [1] dynamic shared bytes per block, [2] threads
// per block, [3] resident blocks per SM, [4] local (spill) bytes per
// thread, [5] query blocks per (batch, head).
extern "C" int tao_flash_attention_info(int Sq, int D, int Dv, int segmented, int dtype,
                                        int* info, void* stream) {
  (void)stream;
  if (Sq < 1 || D < 1 || D > 128 || Dv < 1 || Dv > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Config c = configure(Sq, D, Dv, segmented != 0, dtype);
  int err = allow_smem(c);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, c.kernel);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, c.nwarps * 32,
                                                           c.smem);
  if (err != 0) return err;
  info[0] = attr.numRegs;
  info[1] = (int)c.smem;
  info[2] = c.nwarps * 32;
  info[3] = blocks;
  info[4] = (int)attr.localSizeBytes;
  info[5] = c.nqb;
  return 0;
}
