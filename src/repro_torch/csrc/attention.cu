// Online-softmax attention for Hopper (sm_90a) on the tensor cores: float32
// I/O on mma.sync (3xTF32), bfloat16 I/O on wgmma.  Both compute in float32.
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
// gets its (B, S, H, Dv) output with no copy on either side.  Exponents are
// ex2.approx of scores that carry scale * log2(e); the plain version takes
// expf of the unscaled scores, which the tolerances cover (a few ulp of
// |s| <= ~10).  Only key tiles that cross the diagonal, the end of Sk or a
// segment are masked; causal tiles past a row tile's last row are skipped.
// A score tile lives in registers in the tensor cores' accumulator layout,
// where a query row sits in one quad of lanes: the row max costs 2
// __shfl_xor_sync per row per key tile and the row sum stays lane-partial
// until the end.
//
// ---- float32: attention_kernel, 3xTF32 mma.sync ----
// Both products, S = Q K^T and O += P V, run as mma.sync.m16n8k8 TF32
// tensor-core instructions.  Each float32 operand x is split into x = hi +
// lo, hi = x rounded to TF32 (to nearest, ties away from zero: add half a
// TF32 ulp to the bits and mask) and lo = x - hi (exact) cut to TF32, and
// lo*hi + hi*lo + hi*hi is accumulated in float32: the dropped lo*lo and
// lo's cut are ~2^-21 of |x y|, float32-level error.  Plain TF32 keeps 10
// mantissa bits (~5e-4 relative) and would break the port's parity rule
// (float32 products at full precision) and the 1e-5 + 1e-5|ref| the kernel
// is held to.  (cvt.rna.tf32.f32 has no single instruction on sm_90: it
// compiles to ~4 with an infinity check, which finite inputs do not need.)
// scale * log2(e) is folded into Q's fragments as they are loaded.
//
// Tiles: a warp owns 16 query rows; a block owns 16 * nwarps consecutive
// rows of one (batch, head), nwarps <= 9 (<= 4 for Dv > 64), cut into
// equal blocks, the heaviest causal block launched first.  A Tao window of
// 129 rows is one block of 9 warps: the grid is 256 blocks of 288
// threads, 57,600 bytes of shared memory each, 95 registers, no spills
// (ptxas -v), two blocks per SM: one wave over the 132 SMs.  Row tiles are
// dealt to warps heaviest first, snaking over the four schedulers
// (warp % 4), so each scheduler gets an even share of the causal keys.
// Keys stream through shared memory 64 at a time, staged with 16-byte
// cp.async (4-byte where strides or widths are not multiples of 4),
// double-buffered so the next tile loads while this one computes; q, k
// and v are read from device memory once per block.  Rows are zero-padded
// (K to a multiple of 8 floats, V to the template's 32, 64 or 128) and
// pitched at that + 4 floats: a pitch of 4 mod 8 words, so every fragment
// load of a warp hits distinct banks (two lanes reading one word share it).
// The C layout of the scores is fed to P V as its A operand unchanged, by
// permuting the keys of each 8-key step (A column c <-> key 2c, c + 4 <->
// key 2c + 1, V's rows read in the same order): no shuffle, no staging.
// A tile runs as 2, 4 or 8 eight-key steps, a template argument: a branch
// around an mma.sync is a convergence point, and guarded steps ran one by
// one.
//
// What bounds it on the H100: at the Tao shape (64, 4, 129, 32) 16.9 MB of
// q/k/v/out over 3.35 TB/s is 5.0 us and the 2.1 M visible (query, key)
// pairs at 4·D float32 FLOPs each over 67 TFLOP/s is 4.1 us.  Neither
// binds: every block reads its q and first K/V tile before it can start,
// all at once, and then the time is the latency of the longest warp's
// chain of dependent steps (split, mma, max, exp, mma) with ~4.5 warps per
// scheduler to hide it.  The tensor cores are not the limit: the Tao
// shape's 3xTF32 products are 1.2 GFLOP of TF32, 2.4 us at the data
// sheet's dense TF32 peak of 495 TFLOP/s.  PERF.md has the times.
//
// ---- bfloat16: attention_kernel_wgmma, wgmma ----
// bfloat16 I/O (dtype 1; q, k and v all bfloat16) computes what the TPU
// kernel computes for bfloat16 operands (kernel.py:80-81, 102, 110-113):
// the inputs upcast to float32, both products accumulated in float32, P
// kept in float32, the output rounded once to bfloat16 (to nearest even);
// lse stays float32.
//
// What bounds the function on the H100: its operations.  At qwen2-0.5b's prefill
// (4, 14, 2048, 64), causal, the 117 M visible (query, key) pairs need
// 4·D FLOPs each, 30.1 GFLOP: 0.0304 ms at the data sheet's dense bf16
// rate of 989 TFLOP/s, against 0.0175 ms for the 58.7 MB of q/k/v/out at
// 3.35 TB/s.  Only wgmma reaches that rate; mma.sync (the float32 path's
// instruction) does not, and TF32 runs at half of it.  Next come the
// exponentials: one ex2 per visible pair, 117 M on the SMs' MUFU units.
//
// The design: a block is two warpgroups (256 threads), each owning 64
// query rows (wgmma's M) of one (batch, head): 128 rows a block, the grid
// (B·H, ceil(Sq / 128)), the heaviest causal block first.
//   * Staging.  Q (128 rows, once) and 64-key K and V tiles (double-
//     buffered, so the next tile loads while this one computes) go to
//     shared memory by 16-byte cp.async where widths, strides and pointers
//     allow it, element by element otherwise, in the 128-byte-swizzled
//     layout that a wgmma shared-memory descriptor reads: rows of 64
//     bfloat16 (128 bytes), 16-byte chunk c of row r at chunk c ^ (r % 8),
//     a second 64-column panel at width 128, every panel on a 1,024-byte
//     boundary.  Widths up to 64 are zero-padded to 64 and widths up to 128
//     to 128 (the template's W = max(D, Dv) rounded up).  Each thread fences
//     its copies into the async proxy (fence.proxy.async) before the
//     block's barrier.
//   * S = Q K^T: one chain of W / 16 wgmma.m64n64k16 per 64-key tile, Q and
//     K both from shared memory, both K-major (a K-slice is the next 32
//     bytes of the swizzled row: the descriptor's start address advances
//     by 2 inside a panel).  bfloat16 products are exact, the sums float32.
//     The scale is applied to the scores, not to Q (Q * scale is not exact
//     in bfloat16): the row max is taken unscaled and scaled once, and each
//     exponent is ex2 of one FFMA, s * scale - m.
//   * Online softmax on the accumulator: wgmma's m64nN float32 layout gives
//     each warp 16 rows in mma.sync's C layout, so the float32 path's row
//     max, lane-partial sums, ex2 and masks carry over.
//   * O += P V with P in float32: P = P_hi + P_lo, P_hi = bf16(P), P_lo =
//     bf16(P - P_hi) (the difference is exact in float32), and two wgmma
//     chains of 4 m64nWk16 each, P_lo V then P_hi V.  P's k16 slices come
//     from registers: the accumulator's fragment pairs of keys (2t, 2t + 1)
//     and (2t + 8, 2t + 9) are the A fragment of that slice as they are, no
//     shuffle.  V is (keys x D) with D contiguous, MN-major for this
//     product: it is staged as K is and read through the descriptor's
//     transpose bit (imm-trans-b = 1; leading byte offset = the 64-column
//     panel's 8 KB, stride byte offset = 8 keys' 1 KB).  What P's split
//     leaves out, P - P_hi - P_lo, is at most 2^-16 |P| (bfloat16's
//     relative rounding of 2^-8, twice), so a row's P V is within 2^-15
//     sum |P||V| of float32 P V (tests/test_torch_attention.py holds the
//     split to that on the CPU), far below the output's bfloat16 rounding
//     (2^-9).  It costs 1.5x the tensor FLOPs of one bfloat16 P V.
//   * Fences: wgmma.fence before each chain (its registers were written
//     since the last one), commit, and wait for the chain before its
//     accumulator is read; both chains are waited for before the barrier
//     that lets the next cp.async overwrite their tiles.
// Every product of a warpgroup waits for its chain, so what overlaps one
// warpgroup's softmax with tensor work is other warpgroups: at W = 64 two
// blocks share an SM (four warpgroups, at most 128 registers); at W = 128
// one block does (O alone takes 64 registers), and its two warpgroups,
// meeting at the tile's barriers, mostly run the same phase at once.  At
// W = 64 the softmax's work on the SMs' ALUs (max, exponent, sum, O's
// rescale and P's split: about 8 instructions a score) outweighs the
// tensor work; at W = 128 the products (1.5x of one bfloat16 P V) do.  A
// producer warp with TMA, deeper buffering and GQA inside the kernel are
// later changes (ROADMAP §B).  PERF.md has the times, registers and
// blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma.cuh"

namespace {

constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kRows = 16;       // query rows per warp (the mma's M)
constexpr int kPad = 4;         // float32 row pitch = width padded to 8, + 4 floats
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Warps per block at most, by output column tiles: a 129-row Tao window
// (9 row tiles) is one block; the widest accumulators (Dv > 64) get 4
// warps, so that ptxas can give them their registers without spilling.
constexpr int max_warps(int dv8) { return dv8 <= 8 ? 9 : 4; }

struct Params {
  const void* q;        // float or __nv_bfloat16, as the dtype
  const void* k;
  const void* v;
  const int32_t* seg;
  void* out;            // q's dtype
  float* lse;           // (B, H, Sq) contiguous, or null
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  int H, Sq, Sk, D, Dv;
  int dk;               // float32: D padded to a multiple of 8
  int pq;               // float32: Q / K row pitch in elements
  int causal, q_offset;
  int vec16;            // 16-byte copies: widths, strides, pointers allow it
  int vec2;             // two-element stores of the output
  int nqb;              // query blocks per (batch, head)
  float qscale;         // 1/sqrt(D) * log2(e): on Q's fragments (float32) or the scores
};

// Row pitch in floats of a staged tile of `width` (a multiple of 8).
__host__ __device__ constexpr int pitch(int width) { return width + kPad; }

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

// Stage nrows rows of `width` floats (row stride rs) into dst at `pitch`,
// zero-filling the columns up to `wpad` and the rows from `nvalid` on:
// 16-byte cp.async chunks where vec16 allows them, else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, int pitch, const float* src, long long rs,
                                           int nvalid, int nrows, int width, int wpad,
                                           bool vec16) {
  if (vec16) {
    const int cpr = wpad / 4;  // chunks per row
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * 4;
      const bool ok = r < nvalid && c < width;
      cp_async16(dst + r * pitch + c, ok ? src + r * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * wpad; i += blockDim.x) {
      const int r = i / wpad;
      const int c = i - r * wpad;
      const bool ok = r < nvalid && c < width;
      cp_async4(dst + r * pitch + c, ok ? src + r * rs + c : src, ok ? 4 : 0);
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
template <int NN, int DV8>
__device__ __forceinline__ void key_tile(Warp<DV8>& w, const Params& p, const float* qa,
                                         const float* ks, const float* vs, const int* ss,
                                         bool segmented, int kt, int g, int t) {
  const int pq = p.pq;
  constexpr int pv = pitch(DV8 * 8);

  // ---- S = Q K^T (16 x 8NN), C layout: s[n] = rows g / g + 8, keys 8n + 2t, + 1
  float s[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const float* kb = ks + g * pq + t;
  for (int kk = 0; kk < p.dk; kk += 8) {
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
  const float* vb = vs + 2 * t * pv + g;
#pragma unroll
  for (int kk = 0; kk < NN; ++kk) {
    uint32_t ah[4], al[4];
    split(s[kk][0], ah[0], al[0]);
    split(s[kk][2], ah[1], al[1]);
    split(s[kk][1], ah[2], al[2]);
    split(s[kk][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DV8; ++n) {
      uint32_t bh[2], bl[2];
      split(vb[8 * kk * pv + 8 * n], bh[0], bl[0]);
      split(vb[(8 * kk + 1) * pv + 8 * n], bh[1], bl[1]);
      mma3(w.o[n], ah, al, bh, bl);
    }
  }
}

// DV8: output column tiles of 8 a warp holds (4, 8 or 16)
template <int DV8>
__global__ void __launch_bounds__(max_warps(DV8) * 32, DV8 <= 4 ? 2 : 1)
attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the mma's group: rows g and g + 8
  const int t = lane & 3;   // thread in group
  const int pq = p.pq;
  constexpr int pv = pitch(DV8 * 8);
  const int nw = blockDim.x >> 5;
  const int rows = nw * kRows;
  float* q_s = reinterpret_cast<float*>(smem_raw);    // [rows][pq]
  float* k_s = q_s + rows * pq;                       // [2][kKeys][pq]
  float* v_s = k_s + 2 * kKeys * pq;                  // [2][kKeys][pv]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * kKeys * pv);  // [2][kKeys]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (p.nqb - 1 - (int)blockIdx.y) * rows;  // heaviest causal block first
  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh + q0 * p.sqs;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
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
  const float* qa = q_s + (tile * kRows + g) * pq + t;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int kt = it * kKeys;
    if (active && kt < wend) {
      const float* ks = k_s + (it & 1) * kKeys * pq;
      const float* vs = v_s + (it & 1) * kKeys * pv;
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
  float* ob = static_cast<float*>(p.out) + b * p.sob + h * p.soh;
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma (the header's second part)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                    // query rows per warpgroup: wgmma's M
constexpr int kWgs = 2;                        // warpgroups per block
constexpr int kBlockRows = kWgs * kWgRows;     // query rows per block

// The swizzled layout, its descriptors, fences and wgmma wrappers: wgmma.cuh.

// A warpgroup's running state: O (64 x W) in the wgmma accumulator layout
// (warp w, lane 4g + t: o[4n + e] is row 16w + g + 8 (e >> 1), column 8n +
// 2t + (e & 1)), this thread's two rows' running max and lane-partial sum,
// and what decides its masks.
template <int W>
struct WgState {
  float o[W / 2];
  float m0, m1, l0, l1;
  int r0;            // the warpgroup's first query row
  int pos0, pos1;    // absolute positions of this thread's rows
  int segq0, segq1;  // their segments
};

// One 64-key tile for one warpgroup: q_addr, k_addr and v_addr are the
// shared addresses of its 64 Q rows and of the tile's K and V.
template <int W>
__device__ __forceinline__ void key_tile_wgmma(WgState<W>& w, const Params& p, uint32_t q_addr,
                                               uint32_t k_addr, uint32_t v_addr, const int* ss,
                                               bool segmented, int kt, int t) {
  // ---- S = Q K^T (64 x 64), unscaled: s[4n + e] row g + 8 (e >> 1), key
  // 8n + 2t + (e & 1)
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < W / 16; ++j)  // K-slices: 32 bytes apart in a panel
    wgmma_ss_n64(s, sw128_desc(q_addr + (j >> 2) * kBlockRows * 128 + (j & 3) * 32, 16, kAtom),
                 sw128_desc(k_addr + (j >> 2) * kKeys * 128 + (j & 3) * 32, 16, kAtom), j);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);

  // ---- masks: only tiles that cross the diagonal, Sk or a segment
  if (segmented || kt + kKeys > p.Sk || (p.causal && kt + kKeys - 1 > p.q_offset + w.r0)) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * n + 2 * t + (e & 1);
        bool ok = key < p.Sk && (!p.causal || key <= (e < 2 ? w.pos0 : w.pos1));
        if (segmented) ok = ok && ss[key - kt] == (e < 2 ? w.segq0 : w.segq1);
        if (!ok) s[4 * n + e] = kNegInf;
      }
    }
  }

  // ---- online softmax: a row lives in one quad of lanes.  The running max
  // is kept in scaled units; the scale goes into each exponent's FFMA.
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  // a row that sees no key in this tile keeps its max (-1e30 until it does)
  const float mn0 = mx0 > kNegInf ? fmaxf(w.m0, mx0 * p.qscale) : w.m0;
  const float mn1 = mx1 > kNegInf ? fmaxf(w.m1, mx1 * p.qscale) : w.m1;
  const float c0 = ex2(w.m0 - mn0);
  const float c1 = ex2(w.m1 - mn1);
  w.m0 = mn0;
  w.m1 = mn1;
  // A masked score gives 2^(-1e30 scale - m) = 0.  A row that has seen no
  // key yet (its max still -1e30) has only masked scores so far: it
  // subtracts 0 instead, and its p stays 0.
  const float sub0 = mn0 > kNegInf ? mn0 : 0.0f;
  const float sub1 = mn1 > kNegInf ? mn1 : 0.0f;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[4 * n] = ex2(fmaf(s[4 * n], p.qscale, -sub0));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], p.qscale, -sub0));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], p.qscale, -sub1));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], p.qscale, -sub1));
    ps0 += s[4 * n] + s[4 * n + 1];
    ps1 += s[4 * n + 2] + s[4 * n + 3];
  }
  w.l0 = w.l0 * c0 + ps0;
  w.l1 = w.l1 * c1 + ps1;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    w.o[4 * n] *= c0;
    w.o[4 * n + 1] *= c0;
    w.o[4 * n + 2] *= c1;
    w.o[4 * n + 3] *= c1;
  }

  // ---- P = P_hi + P_lo as the A fragments of the four k16 slices: slice
  // j's register r holds keys 16j + 8 (r >> 1) + 2t, + 1 of row g + 8 (r & 1),
  // which is s[8j + 2r], s[8j + 2r + 1]
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * j + 2 * r], x1 = s[8 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      ph[j][r] = bits(hi);
      pl[j][r] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
  }

  // ---- O += P_lo V, then P_hi V; V's k16 slice j: keys 16j.., 2 KB into the tile
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs<W>(w.o, pl[j], sw128_desc(v_addr + j * 16 * 128, kKeys * 128, kAtom));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs<W>(w.o, ph[j], sw128_desc(v_addr + j * 16 * 128, kKeys * 128, kAtom));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<W / 2>(w.o);
}

// W: the padded width of q/k and v, 64 or 128.  At 64, two blocks share an
// SM (ptxas holds it to 128 registers, without spilling): the two blocks'
// warpgroups overlap one's softmax with another's products, where the two
// warpgroups of one block, meeting at a barrier every tile, mostly run the
// same phase at once.  At 128, O alone takes 64 registers: one block.
template <int W>
__global__ void __launch_bounds__(kWgs * 128, W == 64 ? 2 : 1)
    attention_kernel_wgmma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kQBytes = kBlockRows * W * 2;
  constexpr int kTileBytes = kKeys * W * 2;
  // the panels on 1,024-byte boundaries (the launch adds kAtom bytes for it)
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* q_s = smem_raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));  // [128 rows]
  unsigned char* k_s = q_s + kQBytes;                                           // [2][64 keys]
  unsigned char* v_s = k_s + 2 * kTileBytes;                                    // [2][64 keys]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * kTileBytes);                    // [2][64]
  const uint32_t q_addr = (uint32_t)__cvta_generic_to_shared(q_s);
  const uint32_t k_addr = q_addr + kQBytes;
  const uint32_t v_addr = k_addr + 2 * kTileBytes;

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;  // in the warpgroup: rows 16 warp ..
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (p.nqb - 1 - (int)blockIdx.y) * kBlockRows;  // heaviest causal block first
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh + q0 * p.sqs;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + h * p.skh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + h * p.svh;
  const int32_t* segb = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.Sk;
  const bool segmented = segb != nullptr;

  const int q_rows = min(kBlockRows, p.Sq - q0);
  const int kend = p.causal ? min(p.Sk, p.q_offset + q0 + q_rows) : p.Sk;
  const int ntiles = (kend + kKeys - 1) / kKeys;

  auto issue = [&](int it) {
    const int kt = it * kKeys;
    const int kn = min(kKeys, p.Sk - kt);
    const int buf = it & 1;
    stage_sw128<W>(k_s + buf * kTileBytes, kKeys, kg + kt * p.sks, p.sks, kn, p.D, p.vec16);
    stage_sw128<W>(v_s + buf * kTileBytes, kKeys, vg + kt * p.svs, p.svs, kn, p.Dv, p.vec16);
    if (segmented)
      for (int i = threadIdx.x; i < kKeys; i += blockDim.x)
        cp_async4(seg_s + buf * kKeys + i, i < kn ? segb + kt + i : segb, i < kn ? 4 : 0);
    cp_async_commit();
  };
  stage_sw128<W>(q_s, kBlockRows, qg, p.sqs, q_rows, p.D, p.vec16);
  issue(0);  // one group: Q and the first K/V tile
  if (ntiles > 1) issue(1);

  WgState<W> w;
  w.r0 = q0 + wg * kWgRows;
  const bool active = w.r0 < p.Sq;  // uniform over the warpgroup, as wgmma needs
  const int wend = p.causal ? min(p.Sk, p.q_offset + min(w.r0 + kWgRows, p.Sq)) : p.Sk;
  const int ra = w.r0 + 16 * warp + g, rb = ra + 8;
  w.pos0 = p.q_offset + ra;
  w.pos1 = w.pos0 + 8;
  w.segq0 = w.segq1 = 0;
  if (segmented && active) {
    w.segq0 = w.pos0 < p.Sk ? segb[w.pos0] : -2;
    w.segq1 = w.pos1 < p.Sk ? segb[w.pos1] : -2;
  }
#pragma unroll
  for (int i = 0; i < W / 2; ++i) w.o[i] = 0.0f;
  w.m0 = w.m1 = kNegInf;
  w.l0 = w.l1 = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    const int kt = it * kKeys;
    if (active && kt < wend) {
      const int buf = it & 1;
      key_tile_wgmma<W>(w, p, q_addr + wg * kWgRows * 128, k_addr + buf * kTileBytes,
                        v_addr + buf * kTileBytes, seg_s + buf * kKeys, segmented, kt, t);
    }
    __syncthreads();  // both warpgroups' products are done with this buffer
    if (it + 2 < ntiles) issue(it + 2);
  }

  // The float32 kernel's epilogue on wgmma's fragments.  It is not shared
  // through an inline helper: every such helper tried changed the float32
  // kernel's machine code (same registers, other instructions).
  if (!active) return;
  float l0 = w.l0, l1 = w.l1;
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);  // a row that saw no key: 0 / 1e-30
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + b * p.sob + h * p.soh;
  if (p.lse != nullptr && t == 0) {
    float* lb = p.lse + (long long)bh * p.Sq;
    if (ra < p.Sq) lb[ra] = l0 > 0.0f ? w.m0 + log2f(l0) : __int_as_float(0x7f800000);
    if (rb < p.Sq) lb[rb] = l1 > 0.0f ? w.m1 + log2f(l1) : __int_as_float(0x7f800000);
  }
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= p.Dv) continue;
    if (p.vec2) {
      if (ra < p.Sq) store2(ob + ra * p.sos + c, w.o[4 * n] * inv0, w.o[4 * n + 1] * inv0);
      if (rb < p.Sq) store2(ob + rb * p.sos + c, w.o[4 * n + 2] * inv1, w.o[4 * n + 3] * inv1);
    } else {
      const bool c1ok = c + 1 < p.Dv;
      if (ra < p.Sq) {
        store1(ob + ra * p.sos + c, w.o[4 * n] * inv0);
        if (c1ok) store1(ob + ra * p.sos + c + 1, w.o[4 * n + 1] * inv0);
      }
      if (rb < p.Sq) {
        store1(ob + rb * p.sos + c, w.o[4 * n + 2] * inv1);
        if (c1ok) store1(ob + rb * p.sos + c + 1, w.o[4 * n + 3] * inv1);
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

// float32: mma.sync, up to 9 warps of 16 rows a block
Config configure_f32(int Sq, int D, int Dv, bool segmented) {
  Config c;
  c.dk = (D + 7) / 8 * 8;
  c.pq = pitch(c.dk);
  c.dv = Dv <= 32 ? 32 : Dv <= 64 ? 64 : 128;  // the template's column width
  c.kernel = c.dv == 32 ? attention_kernel<4> : c.dv == 64 ? attention_kernel<8>
                                                          : attention_kernel<16>;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int mw = max_warps(c.dv / 8);
  c.nqb = (tiles + mw - 1) / mw;
  c.nwarps = (tiles + c.nqb - 1) / c.nqb;  // equal blocks, none left with one tile
  c.smem = sizeof(float) * ((size_t)c.nwarps * kRows * c.pq + 2 * kKeys * c.pq +
                            2 * kKeys * pitch(c.dv)) +
           (segmented ? 2 * kKeys * sizeof(int) : 0);
  return c;
}

// bfloat16: wgmma, two warpgroups of 64 rows a block, at W = max(D, Dv)
// padded to 64 or 128
Config configure_bf16(int Sq, int D, int Dv, bool segmented) {
  Config c;
  c.dk = c.dv = D <= 64 && Dv <= 64 ? 64 : 128;
  c.pq = 0;
  c.kernel = c.dv == 64 ? attention_kernel_wgmma<64> : attention_kernel_wgmma<128>;
  c.nwarps = kWgs * 4;
  c.nqb = (Sq + kBlockRows - 1) / kBlockRows;
  c.smem = kAtom + sizeof(__nv_bfloat16) * (size_t)(kBlockRows + 4 * kKeys) * c.dv +
           (segmented ? 2 * kKeys * sizeof(int) : 0);
  return c;
}

// dtype: 0 float32, 1 bfloat16
Config configure(int Sq, int D, int Dv, bool segmented, int dtype) {
  return dtype == 1 ? configure_bf16(Sq, D, Dv, segmented) : configure_f32(Sq, D, Dv, segmented);
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
