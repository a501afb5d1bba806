// The backward of the online-softmax attention (attention.cu), for Hopper
// (sm_90a), on the tensor cores: float32 I/O on mma.sync (3xTF32), bfloat16
// I/O on wgmma.  Both compute in float32.
//
// The port's own kernel: the reference has no backward of its attention
// kernel (no custom_vjp under src/repro/kernels/); its trainers
// differentiate the jnp attention of src/repro/core/model.py:217 (Tao,
// float32) and flash_ref, src/repro/models/attention.py:122 (the LLM zoo,
// bfloat16).  This gives the same gradients from the forward's output and
// its per-row log-sum-exp, the FlashAttention-2 way, recomputing the
// probabilities instead of storing them:
//
//   s = q k^T * scale, P = 2^(s * log2(e) - lse)      (lse in base 2, as the
//                                                       forward stores it)
//   delta_i = sum_c dO_ic O_ic
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// What it takes: causal or not, no segment ids, q_offset 0, Sq == Sk = S,
// D == Dv <= 128; q, k, v, o, dO read and dq, dk, dv written at their
// (batch, head, sequence) strides with the last dimension contiguous, all
// float32 or all bfloat16 (dtype 0 or 1); lse and delta float32.
//
// Two kernels on one stream, no atomics, so two calls give the same bits:
//   * bwd_delta: one warp per row, delta = rowsum(dO o) by a fixed
//     shuffle tree;
//   * the two passes in one grid, side by side: the dK / dV pass, whose
//     rows own keys, keep their dK and dV in registers and walk the queries
//     that see them (under causal masking, from their diagonal on), and the
//     dQ pass, whose rows own queries, keep their dQ and walk the keys they
//     see (up to their diagonal).  Both recompute the scores and dP (the
//     cost of having no atomics: every output element is summed by one
//     thread in a fixed order).
//
// ---- float32: bwd_dkdv_dq<float, W>, 3xTF32 mma.sync ----
// In the dK / dV pass a warp owns 16 keys, in the dQ pass 16 query rows;
// each walks the other side in steps of 8.  All five products (S^T or S,
// dP^T or dP, dV, dK, dQ) run as mma.sync.m16n8k8 TF32 tensor-core
// instructions with each float32 operand split into a TF32 high part and
// its TF32 remainder, three products accumulated in float32 (see
// attention.cu).  A step's two score tiles (16 own rows x 8 streamed rows)
// stay in registers in the mma C layout, where P and dS are formed in
// place, and are fed unchanged as the A operand of the next products by
// taking the 8 streamed rows of a step in the order 2c <-> column c, 2c + 1
// <-> column c + 4 (the other operand's rows read in the same order): no
// shuffle, no staging of P or dS in shared memory, no barrier per step.
// Exponents are ex2.approx of s * scale * log2(e) - lse, one FMA from the
// product.  The gradients' sums run over up to S rows, and the tensor
// cores add an addend cut to the accumulator's alignment (no rounding), so
// a chain of mma.sync through the running sum lets that error grow with S;
// each chunk of steps therefore sums into a zeroed tile that is then added
// to the running sum in float32.
//
// Tiles: 16 own rows per warp, so a 129-row window is 9 row tiles and only
// the last carries padding; causal 8-row steps above a warp's diagonal are
// skipped.  At S = 129, causal, a pass computes 81 steps of 16 x 8 pairs
// per (batch, head), 10,368 pairs for 8,385 visible ones (a 64-row tile
// took 24,576).  The other pair of operands streams through shared memory
// 64 rows at a time, staged with 16-byte cp.async (4-byte where strides or
// widths are not multiples of 4) as far as the steps read them (a partial
// tile to its next 8 rows), double-buffered; rows are zero-padded to
// the template's width (32, 64 or 128) and pitched at that + 4 floats, so
// every fragment load of a warp hits 32 banks.  Steps run in chunks of 1,
// 2 or 4 (2 at width 128, for registers), a template argument: a branch
// around an mma.sync is a convergence point.  A block holds up to 4 warps,
// one per scheduler, and each pass gets at least one block per SM where
// the row tiles allow it: at batch 16 (64 (batch, head)) the grid is 384
// blocks of 3 warps, 4 resident per SM, one wave.  The heaviest blocks of
// both passes come first: block 0 of a (batch, head) holds the first keys
// (dK / dV) or the last query rows (dQ).  ptxas -v for sm_90a: 157
// registers at width 32 and no spills; 253 at 64, no spills; 255 at 128
// with a 168-byte stack frame of spills.
//
// What bounds it on the H100: at the Tao training shape (16, 4, 129, 32),
// causal, it must move 7 tensors of B*H*S*D floats (q, k, v, o, dO in; dq,
// dk, dv out), 7.4 MB, 2.2 us at 3.35 TB/s, and do ~10 D FLOPs per visible
// (query, key) pair (8,385 per (batch, head)), 172 MFLOP, 2.6 us at 67
// TFLOP/s float32.  Neither binds, nor do the tensor cores: the two
// passes' 3xTF32 products are 0.9 GFLOP of TF32, 1.8 us at the dense 495
// TFLOP/s.  What is left is latency: every block first reads its own rows
// and a streamed tile, then the longest warp's chain of dependent steps
// (the warp of keys 0-15, or of rows 128-143, 17 steps of split, mma,
// exponent, split, mma) runs with two or three warps per scheduler to
// hide it, so one (batch, head) alone takes most of batch 16's time.
//
// ---- bfloat16: bwd_dkdv_dq_wgmma<W>, wgmma ----
// bfloat16 I/O (the LLM trainer's) computes what the float32 path computes
// on the upcast operands, in float32, and rounds each gradient once to
// bfloat16 (to nearest even).
//
// What bounds the function on the H100: its operations.  At qwen2-0.5b's
// training shape (4, 14, 2048, 64), causal, the 117.5 M visible (query,
// key) pairs (2.1 M a (batch, head)) take 10 D FLOPs each (five
// products), 75.2 GFLOP: 0.076 ms at the data sheet's dense bf16 rate of
// 989 TFLOP/s, against 0.035 ms for the eight bfloat16 tensors and the lse
// at 3.35 TB/s.  Only wgmma reaches that rate.
//
// The design (the forward's attention_kernel_wgmma, attention.cu, turned
// round): a warpgroup owns 64 rows (wgmma's M) of one (batch, head);
// blockIdx.y even the dK / dV pass (own rows keys, streamed Q and dO with
// their lse and delta), odd the dQ pass (own rows queries, streamed K and
// V), the heaviest causal block of each first.
//   * Staging.  The own pair (K and V, or Q and dO: 64 or 128 rows, once) and
//     64-row tiles of the streamed pair (double-buffered, so the next tile
//     loads while this one computes) go to shared memory by 16-byte
//     cp.async where widths, strides and pointers allow it, element by
//     element otherwise, in the 128-byte-swizzled layout a wgmma
//     descriptor reads (the forward's): rows of 64 bfloat16, 16-byte chunk
//     c of row r at chunk c ^ (r % 8), a second 64-column panel at width
//     128, every panel on a 1,024-byte boundary; widths up to 64 zero-
//     padded to 64, up to 128 to 128 (W).  D = 80 runs at W = 128.
//   * S^T = K Q^T and dP^T = V dO^T (dK / dV pass, 32 queries a step:
//     wgmma N = 32), or S = Q K^T and dP = dO V^T (dQ pass, a 64-key tile):
//     one wgmma chain of W / 16 k16 slices each, both operands from shared
//     memory and K-major.  bfloat16 products are exact, the sums float32.
//   * P = 2^(s * scale * log2(e) - lse) and dS = P (dP - delta) in the
//     accumulator registers (wgmma's m64nN layout gives each warp 16 rows
//     in mma.sync's C layout: a thread holds two rows, columns 8n + 2t,
//     + 1), one ex2 of one FFMA each; masks only on a tile that crosses
//     the causal diagonal or S.
//   * dV += P^T dO and dK += dS^T Q, or dQ += dS K, with P and dS kept in
//     float32 as two bfloat16 terms, x = hi + lo, hi = bf16(x), lo =
//     bf16(x - hi) (what lo drops is at most 2^-16 |x|): two wgmma chains a
//     product, the lo term first, the A fragments from the accumulator
//     registers as they are (no shuffle), the B operand the staged tile
//     read MN-major through the descriptor's transpose bit, as the forward
//     reads V.  That is 10 k-chains a pair of 64-row tiles over both passes,
//     where five bfloat16 products would take 5.
//   * Overlap.  S and dP are two commit groups: P's exponentials run while
//     the dP chain does, and dS (with its split) while the dV chain does.
//     Each warpgroup otherwise waits for its own chains, so what fills the
//     tensor cores while it computes exponentials is another warpgroup.
//   * Blocks and registers.  At W = 64 a block is one warpgroup and three
//     share an SM (144 registers a thread, no spill): they meet at no
//     barrier, so one's exponentials overlap another's products.  At W =
//     128 dK and dV alone take 128 registers a thread, so one block of two
//     warpgroups (128 rows) per SM.  32-query steps keep the dK / dV pass's
//     score tiles at 16 registers each; at W = 64 they are what lets three
//     blocks fit (with 64-query steps only one block of two warpgroups
//     did, and it ran slower).
//   * Long sums.  dK, dV and dQ sum over up to S rows through one wgmma
//     chain into the running accumulator, 2 S / 16 k16 additions; the
//     tensor cores may cut an addend to the accumulator's alignment (as
//     mma.sync does, see the float32 part), an error that grows with S.
//     On the card every element stays within one bfloat16 rounding of the
//     plain version at S = 2048 and 4096, while the share of elements
//     bitwise it falls with S (PERF.md); summing groups of tiles into
//     zeroed registers would take W / 2 more registers a thread, which
//     W = 128 does not have.
//   * Fences: wgmma.fence before each group of chains (their registers
//     were written since the last), commit, and wait before the
//     accumulator is read; every chain is waited for before the barrier
//     that lets the next cp.async overwrite its tiles.
// A producer warp with TMA, deeper buffering, GQA inside the kernel and a
// W = 96 instantiation for D = 80 are later changes (ROADMAP §B).  PERF.md
// has the times, registers and blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma.cuh"

namespace {

constexpr int kTile = 64;        // streamed rows per shared-memory tile
constexpr int kSteps = kTile / 8;
constexpr int kRows = 16;        // own rows per warp (the mma's M)
constexpr int kMaxWarps = 4;     // warps per block at most: one per scheduler
constexpr int kPadBytes = 16;    // row pitch = template width + 16 bytes
constexpr int kDeltaThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const float* lse;  // (B, H, S) contiguous, base 2
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  float* delta;      // (B, H, S) contiguous scratch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, S, D;
  int causal;
  int vec16;         // 16-byte copies of q, k, v, dO: widths, strides, pointers allow it
  int vec2;          // two-element stores of dq, dk, dv
  float scale;       // 1 / sqrt(D)
  float qscale;      // scale * log2(e)
};

// x = hi + lo in TF32: hi rounded to nearest (ties away), lo the exact
// remainder cut to TF32 (attention.cu)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// What the element type gives the kernels: the float32 path's fragment
// loads (split as above) and row padding; both types' widening and stores.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPad = kPadBytes / 4;  // row pitch padding in elements
  __device__ static __forceinline__ float widen(float x) { return x; }
  __device__ static __forceinline__ void tf32(const float* p, uint32_t& hi, uint32_t& lo) {
    split(*p, hi, lo);
  }
  __device__ static __forceinline__ void store2(float* o, float a, float b) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  }
  __device__ static __forceinline__ void store1(float* o, float a) { *o = a; }
};
template <>
struct Elem<__nv_bfloat16> {
  __device__ static __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ void store1(__nv_bfloat16* o, float a) {
    *o = __float2bfloat16_rn(a);
  }
};

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
// 16-byte cp.async chunks where vec16 allows them, 4-byte ones otherwise.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src,
                                           long long rs, int nvalid, int nrows,
                                           int width, int wpad, bool vec16) {
  constexpr int epc = 16 / sizeof(T);  // elements per 16-byte chunk
  if (vec16) {
    // a thread keeps one 16-byte column of every step-th row: 4 to 32
    // chunks per row divide the block's threads
    const int cpr = wpad / epc;
    const int step = blockDim.x / cpr;
    const int c = (threadIdx.x % cpr) * epc;
    int r = threadIdx.x / cpr;
    const T* s = src + r * rs + c;
    T* d = dst + r * pitch + c;
    for (; r < nrows; r += step, s += step * rs, d += step * pitch) {
      const bool ok = r < nvalid && c < width;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
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

// delta = rowsum(dO o): one warp per row
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads) bwd_delta(const Params<T> p, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int bh = row / p.S;
  const int s = row - bh * p.S;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const T* o = p.o + b * p.so.b + h * p.so.h + s * p.so.s;
  const T* d = p.dout + b * p.sdo.b + h * p.sdo.h + s * p.sdo.s;
  float acc = 0.0f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(Elem<T>::widen(d[c]), Elem<T>::widen(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// One chunk of NN 8-row steps of the streamed pair (u, z) against a warp's
// 16 own rows (x, y).  s = x u^T and dp = y z^T are 16 x 8NN C tiles (s[n]:
// own rows g, g + 8 at streamed rows 8n + 2t, + 1).  KV, the dK / dV pass:
// own (K, V), streamed (Q, dO) with each streamed row's lse and delta in
// `st`; P^T and dS^T in place, then acc1 (dV) += P^T dO and acc2 (dK) +=
// dS^T Q.  Otherwise the dQ pass: own (Q, dO) with their lse and delta in
// registers, streamed (K, V); then acc1 (dQ) += dS K.  `masked`: some pair
// of the chunk lies past S or across the causal diagonal.
template <typename T, bool KV, int NN, int W8>
__device__ __forceinline__ void chunk(float (&acc1)[W8][4], float (&acc2)[KV ? W8 : 1][4],
                                      const T* xa, const T* ya, const T* us,
                                      const T* zs, const float* st, const float (&own_lse)[2],
                                      const float (&own_delta)[2], bool masked, int own0,
                                      int str0, const Params<T>& p, int g, int t) {
  using E = Elem<T>;
  constexpr int pitch = W8 * 8 + E::kPad;

  // ---- s = x u^T and dp = y z^T: x's and y's fragments once per 8 columns
  float s[NN][4], dp[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
  const T* ub = us + g * pitch + t;
  const T* zb = zs + g * pitch + t;
#pragma unroll
  for (int kk = 0; kk < W8 * 8; kk += 8) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    E::tf32(xa + kk, xh[0], xl[0]);
    E::tf32(xa + kk + 8 * pitch, xh[1], xl[1]);
    E::tf32(xa + kk + 4, xh[2], xl[2]);
    E::tf32(xa + kk + 4 + 8 * pitch, xh[3], xl[3]);
    E::tf32(ya + kk, yh[0], yl[0]);
    E::tf32(ya + kk + 8 * pitch, yh[1], yl[1]);
    E::tf32(ya + kk + 4, yh[2], yl[2]);
    E::tf32(ya + kk + 4 + 8 * pitch, yh[3], yl[3]);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t bh[2], bl[2];
      E::tf32(ub + n * 8 * pitch + kk, bh[0], bl[0]);
      E::tf32(ub + n * 8 * pitch + kk + 4, bh[1], bl[1]);
      mma3(s[n], xh, xl, bh, bl);
      E::tf32(zb + n * 8 * pitch + kk, bh[0], bl[0]);
      E::tf32(zb + n * 8 * pitch + kk + 4, bh[1], bl[1]);
      mma3(dp[n], yh, yl, bh, bl);
    }
  }

  // ---- P = 2^(s scale log2(e) - lse) into s, dS = P (dp - delta) into dp
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float l[4], d[4];
    if constexpr (KV) {  // per streamed row: columns 2t, 2t + 1
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(st + kTile + 8 * n + 2 * t);
      l[0] = l[2] = l2.x;
      l[1] = l[3] = l2.y;
      d[0] = d[2] = d2.x;
      d[1] = d[3] = d2.y;
    } else {  // per own row: rows g, g + 8
      l[0] = l[1] = own_lse[0];
      l[2] = l[3] = own_lse[1];
      d[0] = d[1] = own_delta[0];
      d[2] = d[3] = own_delta[1];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = ex2(fmaf(s[n][e], p.qscale, -l[e]));
      if (masked) {
        const int own = own0 + g + (e >> 1) * 8;
        const int str = str0 + 8 * n + 2 * t + (e & 1);
        const bool ok = str < p.S && (!p.causal || (KV ? own <= str : str <= own));
        if (!ok) pr = 0.0f;
      }
      s[n][e] = pr;
      dp[n][e] = pr * (dp[n][e] - d[e]);
    }
  }

  // ---- the products with P and dS: their C fragments are the A fragments,
  // with the streamed rows of step n taken in the order 2t (column t),
  // 2t + 1 (column t + 4); the B operand's rows read in the same order.
  // Each output tile sums the chunk's steps from zero and is then added to
  // the running gradient in float32: the tensor cores' accumulation cuts
  // the bits an addend loses to alignment (no rounding), so an mma chain
  // through the running sum lets that error grow with the sequence, enough
  // to leave a 1,000-row window outside 1e-5; this way it grows with the
  // chunk.
  uint32_t dh[NN][4], dl[NN][4], ph[KV ? NN : 1][4], pl[KV ? NN : 1][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    split(dp[n][0], dh[n][0], dl[n][0]);
    split(dp[n][2], dh[n][1], dl[n][1]);
    split(dp[n][1], dh[n][2], dl[n][2]);
    split(dp[n][3], dh[n][3], dl[n][3]);
    if constexpr (KV) {
      split(s[n][0], ph[n][0], pl[n][0]);
      split(s[n][2], ph[n][1], pl[n][1]);
      split(s[n][1], ph[n][2], pl[n][2]);
      split(s[n][3], ph[n][3], pl[n][3]);
    }
  }
  const T* uc = us + 2 * t * pitch + g;
  const T* zc = zs + 2 * t * pitch + g;
#pragma unroll
  for (int m = 0; m < W8; ++m) {
    float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t bh[2], bl[2];
      E::tf32(uc + 8 * n * pitch + 8 * m, bh[0], bl[0]);
      E::tf32(uc + (8 * n + 1) * pitch + 8 * m, bh[1], bl[1]);
      if constexpr (KV) {
        mma3(c2, dh[n], dl[n], bh, bl);  // dK += dS^T Q
        E::tf32(zc + 8 * n * pitch + 8 * m, bh[0], bl[0]);
        E::tf32(zc + (8 * n + 1) * pitch + 8 * m, bh[1], bl[1]);
        mma3(c1, ph[n], pl[n], bh, bl);  // dV += P^T dO
      } else {
        mma3(c1, dh[n], dl[n], bh, bl);  // dQ += dS K
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[m][e] += c1[e];
      if constexpr (KV) acc2[m][e] += c2[e];
    }
  }
}

// Write a warp's 16 rows (r0 + g, r0 + g + 8) of one gradient from its C
// fragments, times `mul`.
template <typename T, int W8>
__device__ __forceinline__ void store_rows(T* base, long long rs, const float (&acc)[W8][4],
                                           float mul, int r0, const Params<T>& p, int g, int t) {
  using E = Elem<T>;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int m = 0; m < W8; ++m) {
    const int c = 8 * m + 2 * t;
    if (c >= p.D) continue;
    if (p.vec2) {
      if (ra < p.S) E::store2(base + ra * rs + c, acc[m][0] * mul, acc[m][1] * mul);
      if (rb < p.S) E::store2(base + rb * rs + c, acc[m][2] * mul, acc[m][3] * mul);
    } else {
      const bool c1ok = c + 1 < p.D;
      if (ra < p.S) {
        E::store1(base + ra * rs + c, acc[m][0] * mul);
        if (c1ok) E::store1(base + ra * rs + c + 1, acc[m][1] * mul);
      }
      if (rb < p.S) {
        E::store1(base + rb * rs + c, acc[m][2] * mul);
        if (c1ok) E::store1(base + rb * rs + c + 1, acc[m][3] * mul);
      }
    }
  }
}

// Block `blk` of `nb` of one pass: KV the dK / dV pass, otherwise the dQ
// pass.  The block owns nw row tiles of 16 of one (batch, head) and streams
// the other pair of operands through shared memory in 64-row tiles.
template <typename T, bool KV, int W>
__device__ __forceinline__ void bwd_pass(const Params<T>& p, int blk, int nb) {
  constexpr int W8 = W / 8;
  constexpr int pitch = W + Elem<T>::kPad;
  constexpr int kMaxNN = W8 <= 8 ? 4 : 2;  // steps per chunk at most (registers)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the mma's group: rows g and g + 8
  const int t = lane & 3;   // thread in group
  const int nw = blockDim.x >> 5;
  const int rows = nw * kRows;
  T* x_s = smem;                        // [rows][pitch]: K (KV) or Q
  T* y_s = x_s + rows * pitch;          // V or dO
  T* u_s = y_s + rows * pitch;          // [2][kTile][pitch]: Q (KV) or K
  T* z_s = u_s + 2 * kTile * pitch;     // dO or V
  float* st_s = reinterpret_cast<float*>(z_s + 2 * kTile * pitch);  // KV: [2][lse, delta][kTile]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heaviest causal block first: the first keys, or the last query rows
  const int base = (KV ? blk : nb - 1 - blk) * rows;
  const Strides& sx = KV ? p.sk : p.sq;
  const Strides& sy = KV ? p.sv : p.sdo;
  const Strides& su = KV ? p.sq : p.sk;
  const Strides& sz = KV ? p.sdo : p.sv;
  const T* xg = (KV ? p.k : p.q) + b * sx.b + h * sx.h;
  const T* yg = (KV ? p.v : p.dout) + b * sy.b + h * sy.h;
  const T* ug = (KV ? p.q : p.k) + b * su.b + h * su.h;
  const T* zg = (KV ? p.dout : p.v) + b * sz.b + h * sz.h;
  const float* lse_bh = p.lse + (long long)bh * p.S;
  const float* delta_bh = p.delta + (long long)bh * p.S;

  // streamed tiles: KV the queries from the block's first key on (all,
  // without causal masking); dQ the keys up to the block's last row
  const int it0 = KV && p.causal ? base / kTile : 0;
  const int send = KV || !p.causal ? p.S : min(p.S, base + rows);
  const int it1 = (send + kTile - 1) / kTile;

  auto issue = [&](int it) {
    const int r = it * kTile;
    const int n = min(kTile, p.S - r);
    const int n8 = (n + 7) & ~7;  // the steps read no row past these
    const int buf = (it - it0) & 1;
    stage_rows(u_s + buf * kTile * pitch, pitch, ug + r * su.s, su.s, n, n8, p.D, W, p.vec16);
    stage_rows(z_s + buf * kTile * pitch, pitch, zg + r * sz.s, sz.s, n, n8, p.D, W, p.vec16);
    if (KV) {
      float* st = st_s + buf * 2 * kTile;
      for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
        const int j = i & (kTile - 1);
        const float* src = (i < kTile ? lse_bh : delta_bh) + r + j;
        cp_async4(st + i, j < n ? src : lse_bh, j < n ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  const int own_n = min(rows, p.S - base);
  const int own16 = (own_n + kRows - 1) & ~(kRows - 1);  // the active warps' tiles
  stage_rows(x_s, pitch, xg + base * sx.s, sx.s, own_n, own16, p.D, W, p.vec16);
  stage_rows(y_s, pitch, yg + base * sy.s, sy.s, own_n, own16, p.D, W, p.vec16);
  issue(it0);  // one group: the own rows and the first streamed tile
  if (it0 + 1 < it1) issue(it0 + 1);

  // This warp's row tile, heaviest first
  const int tile = KV ? warp : nw - 1 - warp;
  const int r0 = base + tile * kRows;
  const bool active = r0 < p.S;
  // streamed rows this warp sees end here
  const int wend = KV || !p.causal ? p.S : min(p.S, r0 + kRows);

  float own_lse[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  float own_delta[2] = {0.0f, 0.0f};
  if (!KV && active) {  // a row past S keeps lse = +inf: P = 0 there
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < p.S) {
        own_lse[i] = lse_bh[row];
        own_delta[i] = delta_bh[row];
      }
    }
  }
  float acc1[W8][4], acc2[KV ? W8 : 1][4];
#pragma unroll
  for (int m = 0; m < W8; ++m) acc1[m][0] = acc1[m][1] = acc1[m][2] = acc1[m][3] = 0.0f;
#pragma unroll
  for (int m = 0; m < (KV ? W8 : 1); ++m) acc2[m][0] = acc2[m][1] = acc2[m][2] = acc2[m][3] = 0.0f;
  const T* xa = x_s + (tile * kRows + g) * pitch + t;
  const T* ya = y_s + (tile * kRows + g) * pitch + t;

  for (int it = it0; it < it1; ++it) {
    if (it + 1 < it1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int r = it * kTile;
    if (active && r < wend) {
      const int buf = (it - it0) & 1;
      const T* us = u_s + buf * kTile * pitch;
      const T* zs = z_s + buf * kTile * pitch;
      const float* st = st_s + buf * 2 * kTile;
      // steps of this tile holding a pair this warp sees: KV under causal
      // masking from its diagonal on; dQ up to it
      int s0 = KV && p.causal ? max(0, (r0 - r) >> 3) : 0;
      const int e = min(kSteps, (wend - r + 7) >> 3);
      while (s0 < e) {
        const int c = e - s0;
        const int str0 = r + 8 * s0;
        const T* u0 = us + 8 * s0 * pitch;
        const T* z0 = zs + 8 * s0 * pitch;
        const float* st0 = st + 8 * s0;
        const int nn = c >= kMaxNN ? kMaxNN : c >= 2 ? 2 : 1;
        const int str1 = str0 + 8 * nn;
        const bool masked = str1 > p.S ||
                            (p.causal && (KV ? str0 < r0 + kRows - 1 : str1 - 1 > r0));
        if (nn == kMaxNN)
          chunk<T, KV, kMaxNN, W8>(acc1, acc2, xa, ya, u0, z0, st0, own_lse, own_delta, masked, r0, str0, p, g, t);
        else if (nn == 2)
          chunk<T, KV, 2, W8>(acc1, acc2, xa, ya, u0, z0, st0, own_lse, own_delta, masked, r0, str0, p, g, t);
        else
          chunk<T, KV, 1, W8>(acc1, acc2, xa, ya, u0, z0, st0, own_lse, own_delta, masked, r0, str0, p, g, t);
        s0 += nn;
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (it + 2 < it1) issue(it + 2);
  }

  if (!active) return;
  if constexpr (KV) {
    store_rows<T, W8>(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.s, acc1, 1.0f, r0, p, g, t);
    store_rows<T, W8>(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.s, acc2, p.scale, r0, p, g, t);
  } else {
    store_rows<T, W8>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.s, acc1, p.scale, r0, p, g, t);
  }
}

// Both passes in one grid, so that they run side by side: even blocks
// (y = 2i) take the dK / dV pass's block i, odd ones the dQ pass's, the
// heaviest of each first.
template <typename T, int W>  // D padded to 32, 64 or 128
__global__ void __launch_bounds__(kMaxWarps * 32) bwd_dkdv_dq(const Params<T> p) {
  if (blockIdx.y & 1)
    bwd_pass<T, false, W>(p, blockIdx.y >> 1, gridDim.y >> 1);
  else
    bwd_pass<T, true, W>(p, blockIdx.y >> 1, gridDim.y >> 1);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma (the header's second part)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWgRows = 64;  // own rows per warpgroup: wgmma's M
constexpr int kKvCols = 32;  // streamed queries a step of the dK / dV pass takes: wgmma's N

// Warpgroups per block, by W: at 64 one, so that three blocks (at most 170
// registers a thread) share an SM and run out of phase; at 128 two, one
// block per SM (dK and dV alone take 128 registers a thread)
template <int W>
__host__ __device__ constexpr int wgs() {
  return W == 64 ? 1 : 2;
}

// The swizzled layout, its descriptors, fences and wgmma wrappers: wgmma.cuh.

// One streamed 64-row tile of the dK / dV pass for one warpgroup: k_addr
// and v_addr its 64 keys' K and V, q_addr and do_addr the tile's Q and dO,
// st the tile's lse (st[0..64)) and delta (st[64..128)); r the tile's first
// query, r0 the warpgroup's first key.  The tile is walked in steps of
// kKvCols queries: the score tiles take 16 registers each.
template <int W>
__device__ __forceinline__ void kv_tile(float* dv, float* dk, const Params<bf16>& p,
                                        uint32_t k_addr, uint32_t v_addr, uint32_t q_addr,
                                        uint32_t do_addr, const float* st, int r, int r0,
                                        int warp, int g, int t) {
  constexpr int N = kKvCols;
  constexpr int NS = N / 16;  // k16 slices of the products with P^T and dS^T
  constexpr int kOwnRows = wgs<W>() * kWgRows;
#pragma unroll
  for (int sub = 0; sub < kTile / N; ++sub) {
    const int c0 = r + sub * N;  // the step's first query
    // (uniform over the warpgroup) past S, or every query before every key
    if (c0 >= p.S || (p.causal && c0 + N <= r0)) continue;

    // ---- S^T = K Q^T and dP^T = V dO^T (64 keys x N queries), two groups:
    // s[4n + e] key 16 warp + g + 8 (e >> 1), query 8n + 2t + (e & 1)
    float s[N / 2], dp[N / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < W / 16; ++j)
      wgmma_ss_n32(s, kmajor(k_addr, kOwnRows, j), kmajor(q_addr + sub * N * 128, kTile, j), j);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < W / 16; ++j)
      wgmma_ss_n32(dp, kmajor(v_addr, kOwnRows, j), kmajor(do_addr + sub * N * 128, kTile, j), j);
    wgmma_commit();

    // ---- P^T = 2^(s qscale - lse) into s, lse per query (column), while
    // the dP^T chain runs
    wgmma_wait<1>();
    fence_regs<N / 2>(s);
    const bool masked = c0 + N > p.S || (p.causal && c0 < r0 + kWgRows - 1);
    const int key0 = r0 + 16 * warp + g;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + sub * N + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = ex2(fmaf(s[4 * n + e], p.qscale, -((e & 1) ? l2.y : l2.x)));
        if (masked) {
          const int query = c0 + 8 * n + 2 * t + (e & 1);
          if (query >= p.S || (p.causal && query < key0 + 8 * (e >> 1))) pr = 0.0f;
        }
        s[4 * n + e] = pr;
      }
    }

    // ---- dV += P^T dO: the lo term's chain, then the hi term's; slice j
    // of dO: queries sub N + 16 j ..
    uint32_t ph[NS][4], pl[NS][4];
    split_frags<NS>(s, ph, pl);
    fence_regs<W / 2>(dv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NS; ++j) wgmma_rs<W>(dv, pl[j], mnmajor(do_addr, kTile, sub * N + 16 * j));
#pragma unroll
    for (int j = 0; j < NS; ++j) wgmma_rs<W>(dv, ph[j], mnmajor(do_addr, kTile, sub * N + 16 * j));
    wgmma_commit();

    // ---- dS^T = P^T (dP^T - delta) into dp, delta per query, while the
    // dV chain runs; then dK += dS^T Q as dV
    wgmma_wait<1>();
    fence_regs<N / 2>(dp);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(st + kTile + sub * N + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
    }
    uint32_t dh[NS][4], dl[NS][4];
    split_frags<NS>(dp, dh, dl);
    fence_regs<W / 2>(dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NS; ++j) wgmma_rs<W>(dk, dl[j], mnmajor(q_addr, kTile, sub * N + 16 * j));
#pragma unroll
    for (int j = 0; j < NS; ++j) wgmma_rs<W>(dk, dh[j], mnmajor(q_addr, kTile, sub * N + 16 * j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<W / 2>(dv);
    fence_regs<W / 2>(dk);
  }
}

// One streamed 64-key tile of the dQ pass for one warpgroup: q_addr and
// do_addr its 64 query rows' Q and dO, k_addr and v_addr the tile's K and
// V; lse and delta of this thread's two rows; r the tile's first key, r0
// the warpgroup's first query.
template <int W>
__device__ __forceinline__ void q_tile(float* dq, const Params<bf16>& p, uint32_t q_addr,
                                       uint32_t do_addr, uint32_t k_addr, uint32_t v_addr,
                                       const float (&lse)[2], const float (&delta)[2], int r,
                                       int r0, int warp, int g, int t) {
  // ---- S = Q K^T and dP = dO V^T (64 queries x 64 keys), two groups:
  // s[4n + e] query 16 warp + g + 8 (e >> 1), key 8n + 2t + (e & 1)
  constexpr int kOwnRows = wgs<W>() * kWgRows;
  float s[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < W / 16; ++j)
    wgmma_ss_n64(s, kmajor(q_addr, kOwnRows, j), kmajor(k_addr, kTile, j), j);
  wgmma_commit();
#pragma unroll
  for (int j = 0; j < W / 16; ++j)
    wgmma_ss_n64(dp, kmajor(do_addr, kOwnRows, j), kmajor(v_addr, kTile, j), j);
  wgmma_commit();

  // ---- P = 2^(s qscale - lse) into s, lse per query (row), while the dP
  // chain runs; then dS = P (dP - delta) into dp
  wgmma_wait<1>();
  fence_regs<32>(s);
  const bool masked = r + kTile > p.S || (p.causal && r + kTile - 1 > r0);
  const int query0 = r0 + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = ex2(fmaf(s[4 * n + e], p.qscale, -lse[e >> 1]));
      if (masked) {
        const int key = r + 8 * n + 2 * t + (e & 1);
        if (key >= p.S || (p.causal && key > query0 + 8 * (e >> 1))) pr = 0.0f;
      }
      s[4 * n + e] = pr;
    }
  }
  wgmma_wait<0>();
  fence_regs<32>(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]);

  // ---- dQ += dS K: the lo term's chain, then the hi term's; slice j of K:
  // keys 16 j ..
  uint32_t dh[4][4], dl[4][4];
  split_frags<4>(dp, dh, dl);
  fence_regs<W / 2>(dq);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<W>(dq, dl[j], mnmajor(k_addr, kTile, 16 * j));
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<W>(dq, dh[j], mnmajor(k_addr, kTile, 16 * j));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<W / 2>(dq);
}

// Write a warpgroup's rows ra and ra + 8 (this thread's) of one gradient
// from its accumulator (acc[4n + e]: column 8n + 2t + (e & 1)), times `mul`.
template <int W>
__device__ __forceinline__ void store_wg(bf16* base, long long rs, const float* acc, float mul,
                                         int ra, const Params<bf16>& p, int t) {
  using E = Elem<bf16>;
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= p.D) continue;
    if (p.vec2) {
      if (ra < p.S) E::store2(base + ra * rs + c, acc[4 * n] * mul, acc[4 * n + 1] * mul);
      if (rb < p.S) E::store2(base + rb * rs + c, acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
    } else {
      const bool c1ok = c + 1 < p.D;
      if (ra < p.S) {
        E::store1(base + ra * rs + c, acc[4 * n] * mul);
        if (c1ok) E::store1(base + ra * rs + c + 1, acc[4 * n + 1] * mul);
      }
      if (rb < p.S) {
        E::store1(base + rb * rs + c, acc[4 * n + 2] * mul);
        if (c1ok) E::store1(base + rb * rs + c + 1, acc[4 * n + 3] * mul);
      }
    }
  }
}

// Block `blk` of `nb` of one pass: KV the dK / dV pass, otherwise the dQ
// pass.  The block owns wgs<W>() * 64 rows of one (batch, head), 64 a
// warpgroup, and streams the other pair of operands through shared memory
// in 64-row tiles.
template <int W, bool KV>
__device__ __forceinline__ void wg_pass(const Params<bf16>& p, int blk, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBlockRows = wgs<W>() * kWgRows;
  constexpr int kOwnBytes = kBlockRows * W * 2;
  constexpr int kTileBytes = kTile * W * 2;
  // the panels on 1,024-byte boundaries (the launch adds kAtom bytes for it)
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* x_s = smem_raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));  // K (KV) or Q
  unsigned char* y_s = x_s + kOwnBytes;                                          // V or dO
  unsigned char* u_s = y_s + kOwnBytes;           // [2][kTile rows]: Q (KV) or K
  unsigned char* z_s = u_s + 2 * kTileBytes;      // dO or V
  float* st_s = reinterpret_cast<float*>(z_s + 2 * kTileBytes);  // KV: [2][lse, delta][kTile]
  const uint32_t x_addr = (uint32_t)__cvta_generic_to_shared(x_s);
  const uint32_t y_addr = x_addr + kOwnBytes;
  const uint32_t u_addr = y_addr + kOwnBytes;
  const uint32_t z_addr = u_addr + 2 * kTileBytes;

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;  // in the warpgroup: rows 16 warp ..
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heaviest causal block first: the first keys, or the last query rows
  const int base = (KV ? blk : nb - 1 - blk) * kBlockRows;
  const Strides& sx = KV ? p.sk : p.sq;
  const Strides& sy = KV ? p.sv : p.sdo;
  const Strides& su = KV ? p.sq : p.sk;
  const Strides& sz = KV ? p.sdo : p.sv;
  const bf16* xg = (KV ? p.k : p.q) + b * sx.b + h * sx.h;
  const bf16* yg = (KV ? p.v : p.dout) + b * sy.b + h * sy.h;
  const bf16* ug = (KV ? p.q : p.k) + b * su.b + h * su.h;
  const bf16* zg = (KV ? p.dout : p.v) + b * sz.b + h * sz.h;
  const float* lse_bh = p.lse + (long long)bh * p.S;
  const float* delta_bh = p.delta + (long long)bh * p.S;

  // streamed tiles: KV the queries from the block's first key on (all,
  // without causal masking); dQ the keys up to the block's last row
  const int it0 = KV && p.causal ? base / kTile : 0;
  const int send = KV || !p.causal ? p.S : min(p.S, base + kBlockRows);
  const int it1 = (send + kTile - 1) / kTile;

  auto issue = [&](int it) {
    const int r = it * kTile;
    const int n = min(kTile, p.S - r);
    const int buf = (it - it0) & 1;
    stage_sw128<W>(u_s + buf * kTileBytes, kTile, ug + r * su.s, su.s, n, p.D, p.vec16);
    stage_sw128<W>(z_s + buf * kTileBytes, kTile, zg + r * sz.s, sz.s, n, p.D, p.vec16);
    if (KV) {
      float* st = st_s + buf * 2 * kTile;
      for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
        const int j = i & (kTile - 1);
        const float* src = (i < kTile ? lse_bh : delta_bh) + r + j;
        cp_async4(st + i, j < n ? src : lse_bh, j < n ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  const int own_n = min(kBlockRows, p.S - base);
  stage_sw128<W>(x_s, kBlockRows, xg + base * sx.s, sx.s, own_n, p.D, p.vec16);
  stage_sw128<W>(y_s, kBlockRows, yg + base * sy.s, sy.s, own_n, p.D, p.vec16);
  issue(it0);  // one group: the own rows and the first streamed tile
  if (it0 + 1 < it1) issue(it0 + 1);

  // This warpgroup's rows (uniform over it, as wgmma needs) and the
  // streamed rows it sees: KV under causal masking the queries from its
  // first key on; dQ the keys up to its last row
  const int r0 = base + wg * kWgRows;
  const bool active = r0 < p.S;
  const int wbeg = KV && p.causal ? r0 : 0;
  const int wend = KV || !p.causal ? p.S : min(p.S, r0 + kWgRows);
  const int ra = r0 + 16 * warp + g;  // this thread's rows ra, ra + 8

  float lse[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  float delta[2] = {0.0f, 0.0f};
  if (!KV && active) {  // a row past S keeps lse = +inf: P = 0 there
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ra + 8 * i < p.S) {
        lse[i] = lse_bh[ra + 8 * i];
        delta[i] = delta_bh[ra + 8 * i];
      }
    }
  }
  float acc1[W / 2], acc2[KV ? W / 2 : 1];  // dV and dK, or dQ
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (KV ? W / 2 : 1); ++i) acc2[i] = 0.0f;
  const uint32_t own = wg * kWgRows * 128;  // the warpgroup's rows in each panel

  for (int it = it0; it < it1; ++it) {
    if (it + 1 < it1) cp_async_wait<1>(); else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    const int r = it * kTile;
    if (active && r < wend && r + kTile > wbeg) {
      const int buf = (it - it0) & 1;
      const uint32_t ut = u_addr + buf * kTileBytes, zt = z_addr + buf * kTileBytes;
      if constexpr (KV)
        kv_tile<W>(acc1, acc2, p, x_addr + own, y_addr + own, ut, zt, st_s + buf * 2 * kTile, r,
                   r0, warp, g, t);
      else
        q_tile<W>(acc1, p, x_addr + own, y_addr + own, ut, zt, lse, delta, r, r0, warp, g, t);
    }
    __syncthreads();  // both warpgroups' products are done with this buffer
    if (it + 2 < it1) issue(it + 2);
  }

  if (!active) return;
  if constexpr (KV) {
    store_wg<W>(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.s, acc1, 1.0f, ra, p, t);
    store_wg<W>(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.s, acc2, p.scale, ra, p, t);
  } else {
    store_wg<W>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.s, acc1, p.scale, ra, p, t);
  }
}

// Both passes in one grid, as the float32 kernel's: even blocks (y = 2i)
// take the dK / dV pass's block i, odd ones the dQ pass's.  W: D padded to
// 64 or 128.
template <int W>
__global__ void __launch_bounds__(wgs<W>() * 128, W == 64 ? 3 : 1)
    bwd_dkdv_dq_wgmma(const Params<bf16> p) {
  if (blockIdx.y & 1)
    wg_pass<W, false>(p, blockIdx.y >> 1, gridDim.y >> 1);
  else
    wg_pass<W, true>(p, blockIdx.y >> 1, gridDim.y >> 1);
}

// The launch a call gets: kernel, warps per block, blocks per pass and
// (batch, head), dynamic shared memory (float32: the dK / dV pass's, the
// larger).
template <typename T>
struct Config {
  void (*kernel)(Params<T>);
  int nw, nb;
  size_t smem;
};

// float32: mma.sync, up to 4 warps of 16 own rows a block
template <typename T>
Config<T> configure(long long bhs, int S, int D, int sms) {
  const int w = D <= 32 ? 32 : D <= 64 ? 64 : 128;
  Config<T> c;
  c.kernel = w == 32 ? bwd_dkdv_dq<T, 32> : w == 64 ? bwd_dkdv_dq<T, 64> : bwd_dkdv_dq<T, 128>;
  const int tiles = (S + kRows - 1) / kRows;
  int nb = (tiles + kMaxWarps - 1) / kMaxWarps;
  while (nb < tiles && bhs * nb < sms) ++nb;  // each pass a block per SM where the tiles allow it
  c.nw = (tiles + nb - 1) / nb;
  c.nb = (tiles + c.nw - 1) / c.nw;         // equal blocks
  const int pitch = w + Elem<T>::kPad;
  c.smem = sizeof(T) * ((size_t)2 * c.nw * kRows * pitch + 2 * 2 * kTile * pitch) +
           sizeof(float) * 2 * kTile * 2;
  return c;
}

// bfloat16: wgmma, wgs<W>() warpgroups of 64 own rows a block, at W = D
// padded to 64 or 128; the own pair, two buffers of the streamed pair (64
// rows) and of the streamed rows' lse and delta, and kAtom bytes to put
// the panels on 1,024-byte boundaries
template <>
Config<bf16> configure<bf16>(long long, int S, int D, int) {
  const int w = D <= 64 ? 64 : 128;
  const int rows = (w == 64 ? wgs<64>() : wgs<128>()) * kWgRows;
  Config<bf16> c;
  c.kernel = w == 64 ? bwd_dkdv_dq_wgmma<64> : bwd_dkdv_dq_wgmma<128>;
  c.nw = rows / 16;
  c.nb = (S + rows - 1) / rows;
  c.smem = kAtom + sizeof(bf16) * (size_t)(2 * rows + 2 * 2 * kTile) * w +
           sizeof(float) * 2 * kTile * 2;
  return c;
}

template <typename T>
int allow_smem(const Config<T>& c) {
  if (c.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (c.smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)c.smem);
}

int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

bool valid(int B, int H, int S, int D, int dtype) {
  return B >= 1 && H >= 1 && S >= 1 && D >= 1 && D <= 128 && (long long)B * H <= 2147483647LL &&
         (dtype == 0 || dtype == 1);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* delta,
           const long long* strides, int B, int H, int S, int D, int causal, float scale,
           cudaStream_t s) {
  constexpr int epc = 16 / sizeof(T);  // elements per 16-byte copy
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const long long bhs = (long long)B * H;
  const Config<T> c = configure<T>(bhs, S, D, sms);
  if (2 * c.nb > 65535) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(c)) != 0) return err;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  long long in_strides = 0, out_strides = 0;  // q, k, v, dout; dq, dk, dv
  for (int i = 0; i < 8; ++i) {
    const long long all = st[i].b | st[i].h | st[i].s;
    if (i < 3 || i == 4) in_strides |= all;
    if (i > 4) out_strides |= all;
  }
  const uintptr_t in_ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  const uintptr_t out_ptrs = (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv;
  Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
              static_cast<const T*>(o), lse, static_cast<const T*>(dout),
              static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), delta,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
              H, S, D, causal,
              D % epc == 0 && in_strides % epc == 0 && in_ptrs % 16 == 0,
              D % 2 == 0 && out_strides % 2 == 0 && out_ptrs % (2 * sizeof(T)) == 0,
              scale, scale * kLog2e};
  const int rows = B * H * S;
  bwd_delta<T><<<(rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32), kDeltaThreads, 0, s>>>(p, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  c.kernel<<<dim3((unsigned)bhs, 2 * c.nb), c.nw * 32, c.smem, s>>>(p);
  return (int)cudaGetLastError();
}

// What the two kernels of a call for (B, H, S, D) get, without launching:
// for bwd_delta and the passes' kernel (bwd_dkdv_dq in float32,
// bwd_dkdv_dq_wgmma in bfloat16) in turn, 6 ints each: registers per
// thread, dynamic shared bytes per block, threads per block, resident
// blocks per SM, local (spill) bytes per thread, blocks per call.
template <typename F>
int report(F* kernel, int threads, size_t smem, long long blocks_per_call, int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  out[2] = threads;
  out[3] = blocks;
  out[4] = (int)attr.localSizeBytes;
  out[5] = (int)blocks_per_call;
  return 0;
}

template <typename T>
int info(int B, int H, int S, int D, int* out) {
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const long long bhs = (long long)B * H;
  const int rows_per_block = kDeltaThreads / 32;
  err = report(bwd_delta<T>, kDeltaThreads, 0, (bhs * S + rows_per_block - 1) / rows_per_block, out);
  if (err != 0) return err;
  const Config<T> c = configure<T>(bhs, S, D, sms);
  if ((err = allow_smem(c)) != 0) return err;
  return report(c.kernel, c.nw * 32, c.smem, bhs * 2 * c.nb, out + 6);
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, o, dout, dq, dk, dv: (B, H, S, D) device pointers, all float32
// (dtype 0) or all bfloat16 (dtype 1), with element strides (batch, head,
// sequence) given as 8 triples in that order and a contiguous last
// dimension; lse (B, H, S) float32 contiguous, base 2, as
// tao_flash_attention writes it; delta (B, H, S) float32 scratch.
// 1 <= D <= 128, no segment ids, q_offset 0.
extern "C" int tao_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dout, void* dq, void* dk, void* dv, float* delta, const long long* strides,
    int B, int H, int S, int D, int causal, int dtype, float scale, void* stream) {
  if (!valid(B, H, S, D, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, strides, B, H, S, D,
                                 causal, scale, s);
  return launch<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, strides, B, H, S, D, causal,
                       scale, s);
}

// What the two kernels of a call for (B, H, S, D) in `dtype` get (see
// report), without launching.
extern "C" int tao_flash_attention_bwd_info(int B, int H, int S, int D, int dtype, int* out,
                                            void* stream) {
  (void)stream;
  if (!valid(B, H, S, D, dtype)) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? info<__nv_bfloat16>(B, H, S, D, out) : info<float>(B, H, S, D, out);
}
