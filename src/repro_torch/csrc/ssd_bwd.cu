// Backward of the Mamba-2 chunked SSD scan (csrc/ssd.cu) for Hopper
// (sm_90a), float32 or bfloat16 I/O, float32 arithmetic.
//
// Replaces no TPU kernel: the reference trains Mamba-2 by differentiating
// its jnp chunked oracle (src/repro/models/mamba2.py, ssd_chunked_ref,
// line 96) and has no backward of ssd_kernel.  The port's forward on the
// card is the hand-written B5, so its gradient is this kernel, held to the
// plain version kernels/ssd/ref.py::ssd_chunked_bwd_plain.  For xh
// (B,S,H,P), dt (B,S,H), Bm and Cm (B,S,G,N), dy (B,S,H,P), all of one
// dtype, and A (H,) float32, it writes dx, ddt, dB, dC in that dtype and
// dA (H,) float32.  Per (batch, head) and chunk of c rows, with cums the
// inclusive prefix sum of dt·A over the chunk, L[i,j] = exp(cums_i −
// cums_j) for j ≤ i, e_j = exp(cums_last − cums_j), S0 the state entering
// the chunk and dS the gradient of the state leaving it:
//
//   dx_j = dt_j [Σ_{i≥j} L_ij (C_i·B_j) dy_i + e_j B_j dS]
//   dC_i = Σ_{j≤i} M_ij B_j + exp(cums_i) S0 dy_i,  M_ij = L_ij dt_j (dy_i·x_j)
//   dB_j = Σ_{i≥j} M_ij C_i + dt_j e_j dS x_j
//   dcums_i = Σ_j M_ij (C_i·B_j) − dt_i Σ_k K_ki + exp(cums_i)(C_i S0)·dy_i
//             − e_i dt_i q_i   (+ exp(cums_last)⟨S0, dS⟩ + Σ_j e_j dt_j q_j
//             on the last row),  K_ij = L_ij (C_i·B_j)(dy_i·x_j),
//             q_j = B_j·(dS x_j)
//   ddt_j = Σ_i K_ij + e_j q_j + A r_j,  dA = Σ dt_j r_j,  r_j = Σ_{i≥j} dcums_i
//
// What bounds it on the H100: per (batch, chunk) the function needs the
// causal score tiles C Bᵀ once per group and, per head, dy xᵀ, Wᵀ dy, M B
// and Mᵀ C over the triangle (c(c+1)/2 entries each) and five c·N·P
// products (the two state recurrences and the state terms of dx, dB, dC).
// At mamba2-1.3b's training microbatch (B 2, S 2048, H 64, P 64, G 1, N
// 128, c 256, bf16) that is ~47 GFLOP against ~105 MB of inputs and
// outputs: 0.048 ms at the 989 TFLOP/s bf16 tensor rate, 0.031 ms at 3.35
// TB/s, so the operations bound it (chip_smoke.py counts both from the
// shapes), and only wgmma reaches that rate.
//
// Five kernels, one C call, no atomics (two calls are bitwise equal):
//
//   ssd_bwd_local   a block per (batch, chunk, head, direction): the chunk's
//                   own share of each state recurrence, Σ_j w_j V_jᵀ U_j
//                   (N × P): forward V = B, w = dt·e, U = x (what the chunk
//                   adds to the state it passes on), backward V = C, w =
//                   exp(cums), U = dy (what it adds to the gradient it
//                   passes back).  Every chunk at once, none waiting for
//                   another.  Forward blocks also write the chunk's cums and
//                   dt (float32) for the later kernels.
//   ssd_bwd_recur   a thread per state element and (batch, head,
//                   direction) applies state ← exp(cums_last)·state + local
//                   over the chunks in order (backward: in reverse),
//                   writing the state entering each chunk, S0, and the
//                   gradient of the one leaving it, dS, in the format the
//                   chunk kernel reads.  The state S0 is recomputed rather
//                   than saved by the forward: 67 MB a layer at the training
//                   shape would be held for every layer until the backward.
//   ssd_bwd_chunk   the gradients inside each chunk (below).  It writes dx,
//                   dB and dC summed over a block's heads ((B, S, H / hpb,
//                   N) float32; hpb heads a block: float32 1, bfloat16 up
//                   to 4 of a group), and per chunk row the sums that
//                   dcums needs: Σ_i K_ij, q_j, (C_i S0)·dy_i and Σ_j K_ij
//                   dt_j (as partial sums), and ⟨S0, dS⟩.
//   ssd_bwd_tail    a warp per (batch, chunk, head): dcums, its reverse
//                   prefix sum r by a warp-parallel scan in a fixed order
//                   (each lane's rows, then a shuffle scan of the lanes'
//                   totals), ddt and the chunk's share of dA.
//   ssd_bwd_reduce  sums dB's and dC's partial sums over each group and the
//                   shares of dA over batch and chunks, each in a fixed
//                   order.
//
// ---- bfloat16 (the trainer's): wgmma ----
//   * ssd_bwd_local: two warpgroups a block, each 64 rows of N; 64-row tiles
//     of V staged by cp.async in the 128-byte-swizzled layout (wgmma.cuh),
//     double-buffered, and w ⊙ U written beside them as two bfloat16 terms,
//     hi = bf16(v), lo = bf16(v − hi) (what lo drops is at most 2⁻¹⁶ |v|),
//     from U's rows read into registers up front (one latency a chunk).
//     The product Vᵀ (w U) is a wgmma chain per term with both operands
//     MN-major (the transpose bits): V exact, w ⊙ U to float32 precision.
//   * ssd_bwd_recur writes S0 and dS as two bfloat16 terms each (hi, then
//     lo, per (batch, chunk, head)), ready for cp.async.
//   * ssd_bwd_chunk_wgmma: a block is one warpgroup and owns one 64-row
//     tile of a chunk, for hpb heads of one group in turn, on one of three
//     sides, the heaviest first: the dx side of column tile J (rows j: dx_J,
//     Σ_i K_iJ, q_J, Σ_j K_ij dt_j) and its dB side (dB_J) stream C and dy of
//     the rows i ≥ J; row tile I (rows i: dC_I, (C_i S0)·dy_i) streams B and
//     x of the rows j ≤ I.  A chunk of 4 tiles is 12 blocks (dx and dB in
//     one block held both accumulators and spilled at the 168 registers
//     that three blocks an SM allow).  The column sides are computed turned
//     round, rows j: the score tiles B_J C_Iᵀ and x_J dy_Iᵀ (wgmma N = 32
//     streamed rows a step, both operands K-major from shared memory,
//     bfloat16 products exact, sums float32) hold Wᵀ and Mᵀ in the
//     accumulator layout, which feeds dx_J += Wᵀ dy_I and dB_J += Mᵀ C_I
//     from registers as two bfloat16 terms (two chains each, the streamed
//     operand MN-major), the way attention_bwd.cu's dK / dV pass feeds Pᵀ
//     and dSᵀ: this is that backward with L ⊙ (C Bᵀ) in place of P.  The
//     row side forms M from dy_I x_Jᵀ and feeds dC_I += M B_J the same way.
//     Each head's state terms come first: B_J dS (dx side), x_J dSᵀ (dB
//     side), dy_I S0ᵀ (row side), with the state's two terms staged in
//     shared memory; dB_J and dC_I sum over the block's heads in their
//     accumulators, so those state terms are added 32 columns at a time
//     with each head's row factor.  Σ_j K_ij dt_j is a column sum on the
//     dx side: each warp writes its partial per (column tile, warp), and
//     ssd_bwd_tail adds them in a fixed order.
//   * Staging: the streamed rows go through a ring of three 32-row stages
//     (12 KB: the N-wide and the P-wide operand) by 16-byte cp.async, two
//     steps ahead of the one being multiplied; the first stage loads while
//     the state terms are computed, beside the state (whose 32 KB the next
//     two stages then reuse).  One barrier a step: the warpgroup is the
//     block.
//   * Budget: 73,728 bytes of shared memory and at most 168 registers a
//     thread (__launch_bounds__(128, 3)) let three blocks share an SM: 12
//     warps from three independent tiles, so one block's exponentials,
//     loads and barriers overlap another's products.  The accumulators take
//     32 registers on the dx side, 64 on the others.
//   * What bounds it now: the bytes each block brings into shared memory
//     (a head's state, 32 KB, read by all 12 blocks of its chunk; every
//     streamed tile once per head and side), ~1.4 GB a call at the
//     training microbatch, ~2.3 TB/s from L2 and device memory; PERF.md has
//     the times, and what ordering the grid by chunk and two heads a step
//     did.
//
// ---- float32 (the CPU-parity dtype; nothing trains in float32 on the
// card): mma.sync.m16n8k8 TF32 in the split scheme of csrc/ssd.cu ----
// (split() and mma() copied from there, which copied them from
// csrc/attention.cu): float32 operands as hi + lo, 3 mma a product, at
// float32-level error.  ssd_bwd_local is the earlier walk's per-chunk
// product, 8 warps, one chunk a block.  ssd_bwd_chunk: a block per (batch,
// chunk, head), 256 threads, the chunk cut into 64-row tiles.  Column
// side: for each tile J, the state terms B_J dS and x_J dSᵀ, then for each
// row tile I ≥ J the score tiles C_I B_Jᵀ and dy_I x_Jᵀ, masked and
// weighted into W = L ⊙ (C Bᵀ) and M in shared memory, dx_J += Wᵀ dy_I
// and dB_J += Mᵀ C_I in registers, the row and column sums of K into
// per-chunk vectors.  Row side: for each tile I, dy_I S0ᵀ, then dC_I += M
// B_J over J ≤ I (M recomputed from dy_I x_Jᵀ).  A warp owns 16 × 32 of a
// 64 × 64 tile and 16 × 64 of a 64 × N one; operands widened to float32
// in shared memory (179,232 bytes, one block per SM).
//
// Every exponent is a difference of cums that is ≤ 0 (cums only
// decreases), and the upper triangle j > i is masked on the data before
// the exponential (see csrc/ssd.cu).  PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows of a chunk tile
constexpr int kMaxN = 128;     // d_state
constexpr int kMaxP = 64;      // head_dim
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kTile;
constexpr int kLdN = kMaxN + 4;  // pitch of B and C tiles: 132 ≡ 4 (mod 8)
constexpr int kLdP = kMaxP + 4;  // pitch of x, dy tiles and the state: 68
constexpr int kLdT = kTile + 4;  // pitch of W and M: 68
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kMaxChunk, "a thread per chunk row clears the row sums");

// Per (batch, chunk, head), rows of `chunk` float32 in the vecs scratch:
// the chunk's cums and dt (ssd_bwd_local), then what ssd_bwd_chunk leaves
// for ssd_bwd_tail: Σ_i K_ij, q_j, (C_i S0)·dy_i, ⟨S0, dS⟩ (first element)
// and the partial sums of Σ_j K_ij dt_j (float32: one; bfloat16: one per
// column tile and warp, kRowkParts)
constexpr int kVCums = 0, kVDt = 1, kVColk = 2, kVQ = 3, kVCs = 4, kVSdot = 5, kVRowk = 6;
constexpr int kRowkParts = kMaxTiles * 4;
constexpr int kVecRows = kVRowk + kRowkParts;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// From csrc/ssd.cu: x = hi + lo in TF32, hi rounded to nearest (ties
// away), lo the exact remainder cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// From csrc/ssd.cu: c += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool Exact, int N>
__device__ __forceinline__ void to_tf32(const float* v, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (Exact) {
      hi[e] = __float_as_uint(v[e]);
    } else {
      split(v[e], hi[e], lo[e]);
    }
  }
}

template <bool AExact, bool BExact>
__device__ __forceinline__ void mma_split(float* c, const uint32_t* ahi, const uint32_t* alo,
                                          const uint32_t* bhi, const uint32_t* blo) {
  if constexpr (!AExact) mma(c, alo, bhi);
  if constexpr (!BExact) mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

// acc[nt] += A B for the warp's 16 × 8·NT tile over K (a multiple of 8):
// A(m, k) = a[m·am + k·ak], B(k, n) = b[k·bk + n·bn], a and b at the
// tile's origin.  acc[nt][e] is row g + 8·(e / 2), column 8·nt + 2·t +
// e % 2, (g, t) = (lane / 4, lane % 4).
template <int NT, bool AExact, bool BExact>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const float* a, int am, int ak,
                                         const float* b, int bk, int bn, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* pa = a + g * am + t * ak;
  const float* pb = b + t * bk + g * bn;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {pa[0], pa[8 * am], pa[4 * ak], pa[8 * am + 4 * ak]};
    uint32_t ah[4], al[4];
    to_tf32<AExact, 4>(av, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float bv[2] = {pb[8 * nt * bn], pb[4 * bk + 8 * nt * bn]};
      uint32_t bh[2], bl[2];
      to_tf32<BExact, 2>(bv, bh, bl);
      mma_split<AExact, BExact>(acc[nt], ah, al, bh, bl);
    }
    pa += 8 * ak;
    pb += 8 * bk;
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
}

__device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// 8 elements as read from memory (16 bytes of bfloat16, 32 of float32)
template <typename T> struct Raw { uint4 u[sizeof(T) / 2]; };

template <typename T>
__device__ __forceinline__ void raw8(const T* src, Raw<T>& v) {
#pragma unroll
  for (int e = 0; e < (int)(sizeof(T) / 2); ++e) v.u[e] = reinterpret_cast<const uint4*>(src)[e];
}

// From csrc/ssd.cu: 8 elements widened to float32
__device__ __forceinline__ void widen8(const Raw<float>& r, float* v) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[4 * e] = __uint_as_float(r.u[e].x);
    v[4 * e + 1] = __uint_as_float(r.u[e].y);
    v[4 * e + 2] = __uint_as_float(r.u[e].z);
    v[4 * e + 3] = __uint_as_float(r.u[e].w);
  }
}

__device__ __forceinline__ void widen8(const Raw<__nv_bfloat16>& r, float* v) {
  const uint32_t w[4] = {r.u[0].x, r.u[0].y, r.u[0].z, r.u[0].w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// dst[r][k] for 64 rows and W columns: src[r·stride + k] (times w[r] when
// w is given) for r < rows and k < width, else 0.  `vec`: width, stride
// and src's address are multiples of 8 elements, so a thread moves 8 at a
// time and issues all its loads before its first store; otherwise one
// element at a time.
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, size_t stride,
                                          int rows, int width, bool vec, const float* w) {
  if (vec) {
    constexpr int kRow = W / 8;  // units of 8 elements a row
    constexpr int kUnits = kTile * kRow / kThreads;
    Raw<T> raw[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / kRow;
      const int k = (e - r * kRow) * 8;
      if (r < rows && k < width) raw8(src + r * stride + k, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / kRow;
      const int k = (e - r * kRow) * 8;
      float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < rows && k < width) {
        widen8(raw[u], v);
        if (w != nullptr) {
          const float s = w[r];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] *= s;
        }
      }
      float4* d = reinterpret_cast<float4*>(dst + r * pitch + k);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W;
    const int k = e - r * W;
    float v = 0.0f;
    if (r < rows && k < width) {
      v = to_f(src[r * stride + k]);
      if (w != nullptr) v *= w[r];
    }
    dst[r * pitch + k] = v;
  }
}

// an (N, P) float32 state into [kMaxN][kLdP], zero past N and P
__device__ __forceinline__ void load_state(float* dst, const float* src, int N, int P) {
  for (int e = threadIdx.x; e < kMaxN * kMaxP; e += kThreads) {
    const int n = e / kMaxP;
    const int p = e - n * kMaxP;
    dst[n * kLdP + p] = (n < N && p < P) ? src[n * P + p] : 0.0f;
  }
}

// dt over the chunk into dt_s and the inclusive prefix sum of dt·a into
// cums_s (the forward's scan; warp_s holds 8 floats); ends on a barrier
template <typename T>
__device__ __forceinline__ void chunk_scan(const T* dtb, int H, int chunk, float a, float* dt_s,
                                           float* cums_s, float* warp_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = 0.0f;
  if (tid < chunk) {
    const float d = to_f(dtb[(size_t)tid * H]);
    dt_s[tid] = d;
    v = d * a;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? warp_s[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kThreads / 32) warp_s[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_s[warp - 1];
  if (tid < chunk) cums_s[tid] = v;
  __syncthreads();
}

// row partials of two rows (g, g + 8 of a warp strip) summed over the 4
// threads of a group, then written by t == 0 to red[half][row]
__device__ __forceinline__ void rows_to_red(float* p, float* red, int half, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    p[e] += __shfl_xor_sync(kFull, p[e], 1);
    p[e] += __shfl_xor_sync(kFull, p[e], 2);
  }
  if ((lane & 3) == 0) {
    red[half * kTile + r0 + (lane >> 2)] = p[0];
    red[half * kTile + r0 + (lane >> 2) + 8] = p[1];
  }
}

using bf16 = __nv_bfloat16;

// What every kernel of a call gets
template <typename T>
struct Args {
  const T* x;       // (B, S, H, P)
  const T* dt;      // (B, S, H)
  const float* A;   // (H,)
  const T* Bm;      // (B, S, G, N)
  const T* Cm;
  const T* dy;      // (B, S, H, P)
  T* dx;
  T* ddt;
  float* dA;        // (H,)
  T* dB;            // (B, S, G, N)
  T* dC;
  float* local;     // (2, B, nc, H, N, P) float32: each chunk's own share of the states
  void* states;     // (2, B, nc, H, ...) S0, then dS: N·P float32, or its hi and lo bf16 terms
  float* dbh;       // (B, S, H / hpb, N) dB summed over each block's heads
  float* dch;       // (B, S, H / hpb, N) dC
  float* da_part;   // (B·nc, H)
  float* vecs;      // (B·nc·H, kVecRows, chunk)
  int B, S, H, G, N, P, chunk, nc;
  int hpb;          // heads a block of ssd_bwd_chunk takes, dB and dC summed over them
  bool vec_bc;      // 16-byte loads of B and C rows
  bool vec_x;       // ... of x and dy rows
  bool vec_s;       // ... of the states' bfloat16 rows
};

template <typename T>
__device__ __forceinline__ float* vec_row(const Args<T>& a, size_t u, int row) {
  return a.vecs + (u * kVecRows + row) * a.chunk;
}

// Columns c, c + 1 (c even) of a float32 row of `width` at p = row + c:
// one 8-byte store where both lie inside and the width is even (the row
// then starts on 8 bytes), else what lies inside one at a time
__device__ __forceinline__ void store_pair(float* p, int c, int width, float v0, float v1) {
  if ((width & 1) == 0 && c + 1 < width) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (c < width) p[0] = v0;
    if (c + 1 < width) p[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_local: block 2u + dir, u = (b·nc + chunk)·H + h
// ---------------------------------------------------------------------------

size_t local_smem_f32() {
  return (kTile * kLdN + kTile * kLdP + 3 * kMaxChunk + 8) * sizeof(float);
}

// the chunk's dt, cums and the weights w of direction dir (dir 0 also
// writes dt and cums to vecs); ends on a barrier
template <typename T>
__device__ __forceinline__ void local_weights(const Args<T>& a, size_t u, int dir, float* dt_s,
                                              float* cums_s, float* w_s, float* warp_s) {
  const int h = (int)(u % a.H);
  const size_t bc = u / a.H;
  const int b = (int)(bc / a.nc);
  const size_t c0 = (bc - (size_t)b * a.nc) * a.chunk;
  chunk_scan(a.dt + ((size_t)b * a.S + c0) * a.H + h, a.H, a.chunk, a.A[h], dt_s, cums_s, warp_s);
  const int tid = threadIdx.x;
  const float cum_last = cums_s[a.chunk - 1];
  if (tid < a.chunk) {
    w_s[tid] = dir ? expf(cums_s[tid]) : dt_s[tid] * expf(cum_last - cums_s[tid]);
    if (dir == 0) {
      vec_row(a, u, kVCums)[tid] = cums_s[tid];
      vec_row(a, u, kVDt)[tid] = dt_s[tid];
    }
  }
  __syncthreads();
}

// float32: the earlier state walk's product for one chunk, split TF32
// mma.sync, a warp per 16 rows of N
__global__ void __launch_bounds__(kThreads) ssd_bwd_local_f32(const Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                    // [kTile][kLdN]  w ⊙ V
  float* u_s = v_s + kTile * kLdN;      // [kTile][kLdP]  U
  float* dt_s = u_s + kTile * kLdP;     // [kMaxChunk]
  float* cums_s = dt_s + kMaxChunk;     // [kMaxChunk]
  float* w_s = cums_s + kMaxChunk;      // [kMaxChunk]
  float* warp_s = w_s + kMaxChunk;      // [8]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.x & 1;
  const size_t u = blockIdx.x >> 1;
  const int h = (int)(u % a.H);
  const size_t bc = u / a.H;
  const int b = (int)(bc / a.nc);
  const size_t c0 = (bc - (size_t)b * a.nc) * a.chunk;
  const int grp = h / (a.H / a.G);
  const size_t x_row = (size_t)a.H * a.P, bc_row = (size_t)a.G * a.N;
  const float* vb = (dir ? a.Cm : a.Bm) + ((size_t)b * a.S + c0) * bc_row + (size_t)grp * a.N;
  const float* ub = (dir ? a.dy : a.x) + ((size_t)b * a.S + c0) * x_row + (size_t)h * a.P;
  const int n0 = 16 * warp;  // this warp's rows of the state
  local_weights(a, u, dir, dt_s, cums_s, w_s, warp_s);

  float upd[8][4];
  zero<8>(upd);
  for (int r0 = 0; r0 < a.chunk; r0 += kTile) {
    const int rows = min(kTile, a.chunk - r0);
    __syncthreads();  // v_s, u_s free
    load_tile<kMaxN>(v_s, kLdN, vb + r0 * bc_row, bc_row, rows, a.N, a.vec_bc, w_s + r0);
    load_tile<kMaxP>(u_s, kLdP, ub + r0 * x_row, x_row, rows, a.P, a.vec_x, nullptr);
    __syncthreads();
    // upd(n, p) += Σ_j (w V)[j][n] U[j][p]
    if (n0 < a.N) warp_mma<8, false, false>(upd, v_s + n0, 1, kLdN, u_s, kLdP, 1, round8(rows));
  }
  float* o = a.local + ((size_t)dir * a.B * a.nc * a.H + u) * a.N * a.P;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e >> 1);
      const int p = 8 * pt + 2 * t + (e & 1);
      if (n < a.N && p < a.P) o[n * a.P + p] = upd[pt][e];
    }
  }
}

constexpr int kLocalVecBytes = 4096;  // dt, cums, w (kMaxChunk each) and 8 warp sums
constexpr int kLocalSmemBf16 = kAtom + kLocalVecBytes + 2 * kTile * (kMaxN + 2 * kMaxP) * 2;

// bfloat16: two warpgroups, each 64 rows of N, on wgmma; V tiles staged by
// cp.async and w ⊙ U as two bfloat16 terms, both double-buffered, U read
// into registers up front
__global__ void __launch_bounds__(kThreads) ssd_bwd_local_bf16(const Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cums_s = dt_s + kMaxChunk;
  float* w_s = cums_s + kMaxChunk;
  float* warp_s = w_s + kMaxChunk;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* tiles = smem_raw + kLocalVecBytes + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));
  constexpr int kV = kTile * kMaxN * 2;  // a V tile: 64 rows, two 64-column panels
  constexpr int kU = kTile * kMaxP * 2;  // one term of w ⊙ U
  unsigned char* v_s = tiles;            // [2][kV]
  unsigned char* uh_s = v_s + 2 * kV;    // [2][kU]
  unsigned char* ul_s = uh_s + 2 * kU;   // [2][kU]
  const uint32_t v_addr = (uint32_t)__cvta_generic_to_shared(v_s);
  const uint32_t uh_addr = v_addr + 2 * kV, ul_addr = uh_addr + 2 * kU;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.x & 1;
  const size_t u = blockIdx.x >> 1;
  const int h = (int)(u % a.H);
  const size_t bc = u / a.H;
  const int b = (int)(bc / a.nc);
  const size_t c0 = (bc - (size_t)b * a.nc) * a.chunk;
  const int grp = h / (a.H / a.G);
  const size_t x_row = (size_t)a.H * a.P, bc_row = (size_t)a.G * a.N;
  const bf16* vb = (dir ? a.Cm : a.Bm) + ((size_t)b * a.S + c0) * bc_row + (size_t)grp * a.N;
  const bf16* ub = (dir ? a.dy : a.x) + ((size_t)b * a.S + c0) * x_row + (size_t)h * a.P;
  const int ntiles = (a.chunk + kTile - 1) / kTile;

  auto issue_v = [&](int k) {
    const int rows = min(kTile, a.chunk - k * kTile);
    stage_sw128<kMaxN>(v_s + (k & 1) * kV, kTile, vb + (size_t)k * kTile * bc_row, bc_row, rows,
                       a.N, a.vec_bc);
    cp_async_commit();
  };
  // U of the whole chunk in registers, 8 elements (16 bytes) a unit, all
  // loads issued before the first product (vec_x), so one latency covers
  // them; unit e of tile k is row (tid + e·kThreads) / 8, column 8 · (tid %
  // 8)
  constexpr int kUnits = kTile * (kMaxP / 8) / kThreads;
  uint4 ureg[kMaxTiles][kUnits];
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
#pragma unroll
    for (int e = 0; e < kUnits; ++e) {
      const int i = tid + e * kThreads;
      const int r = k * kTile + i / (kMaxP / 8), c = (i % (kMaxP / 8)) * 8;
      ureg[k][e] = make_uint4(0u, 0u, 0u, 0u);
      if (a.vec_x && r < a.chunk && c < a.P)
        ureg[k][e] = *reinterpret_cast<const uint4*>(ub + (size_t)r * x_row + c);
    }
  }
  // w ⊙ U of tile k as its two bfloat16 terms, 8 elements a thread at a time
  auto store_u = [&](int k, const uint4 (&q)[kUnits]) {
    const int rows = min(kTile, a.chunk - k * kTile);
    unsigned char* uh = uh_s + (k & 1) * kU;
    unsigned char* ul = ul_s + (k & 1) * kU;
    const bf16* src = ub + (size_t)k * kTile * x_row;
#pragma unroll
    for (int e = 0; e < kUnits; ++e) {
      const int i = tid + e * kThreads;
      const int r = i / (kMaxP / 8);
      const int c = (i - r * (kMaxP / 8)) * 8;
      float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < rows) {
        const float w = w_s[k * kTile + r];
        if (a.vec_x) {
          const uint32_t wd[4] = {q[e].x, q[e].y, q[e].z, q[e].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = __uint_as_float(wd[j] << 16) * w;
            v[2 * j + 1] = __uint_as_float(wd[j] & 0xffff0000u) * w;
          }
        } else {
          const bf16* sr = src + r * x_row + c;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c + j < a.P) v[j] = __bfloat162float(sr[j]) * w;
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        const float2 hf = __bfloat1622float2(hb);
        hi[j] = bits(hb);
        lo[j] = bits(__floats2bfloat162_rn(v[2 * j] - hf.x, v[2 * j + 1] - hf.y));
      }
      *reinterpret_cast<uint4*>(uh + sw128(kTile, r, c)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(ul + sw128(kTile, r, c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  issue_v(0);
  local_weights(a, u, dir, dt_s, cums_s, w_s, warp_s);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {  // unrolled: ureg's index is known
    if (k >= ntiles) break;
    store_u(k, ureg[k]);
    if (k + 1 < ntiles) {
      issue_v(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    // acc (n, p) += Σ_j V[j][n] (w U)[j][p]: the warpgroup's panel of V as
    // A, MN-major; the lo term's chain, then the hi term's
    const uint32_t va = v_addr + (k & 1) * kV + wg * kTile * 128;
    fence_regs<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s)
      wgmma_ss_n64_t<1, 1>(acc, mnmajor(va, kTile, 16 * s), mnmajor(ul_addr + (k & 1) * kU, kTile, 16 * s), 1);
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s)
      wgmma_ss_n64_t<1, 1>(acc, mnmajor(va, kTile, 16 * s), mnmajor(uh_addr + (k & 1) * kU, kTile, 16 * s), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    __syncthreads();  // both warpgroups are done with buffer k & 1
  }
  float* o = a.local + ((size_t)dir * a.B * a.nc * a.H + u) * a.N * a.P;
  const int n0 = wg * kTile + 16 * warp + g;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int n = n0 + 8 * e2;
    if (n >= a.N) continue;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int p = 8 * nn + 2 * t;
      store_pair(o + n * a.P + p, p, a.P, acc[4 * nn + 2 * e2], acc[4 * nn + 2 * e2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_recur: thread blockIdx.x · kThreads + tid is a state element,
// blockIdx.y = 2 (b·H + h) + dir
// ---------------------------------------------------------------------------

__device__ __forceinline__ void put_state(const Args<float>& a, size_t at, int NP, int e, float s) {
  static_cast<float*>(a.states)[at + e] = s;
}

__device__ __forceinline__ void put_state(const Args<bf16>& a, size_t at, int NP, int e, float s) {
  bf16* base = static_cast<bf16*>(a.states) + 2 * at;
  const bf16 hi = __float2bfloat16_rn(s);
  base[e] = hi;
  base[NP + e] = __float2bfloat16_rn(s - __bfloat162float(hi));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_recur(const Args<T> a) {
  const int NP = a.N * a.P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int dir = blockIdx.y & 1;
  const int bh = blockIdx.y >> 1;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const size_t units = (size_t)a.B * a.nc * a.H;
  float s = 0.0f;
#pragma unroll 4
  for (int k = 0; k < a.nc; ++k) {
    const int cc = dir ? a.nc - 1 - k : k;
    const size_t u = ((size_t)b * a.nc + cc) * a.H + h;
    const size_t at = ((size_t)dir * units + u) * NP;
    const float decay = expf(vec_row(a, u, kVCums)[a.chunk - 1]);
    const float loc = a.local[at + e];
    put_state(a, at, NP, e, s);
    s = fmaf(s, decay, loc);
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk, float32: a block per (batch, chunk, head)
// ---------------------------------------------------------------------------

size_t chunk_smem_f32() {
  return (2 * kTile * kLdN + 4 * kTile * kLdP + kMaxN * kLdP + 6 * kMaxChunk + 4 * kTile + 8) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_f32(const Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  float* bj = smem;                     // [kTile][kLdN]  B_J
  float* ci = bj + kTile * kLdN;        // [kTile][kLdN]  C_I
  float* xj = ci + kTile * kLdN;        // [kTile][kLdP]  x_J
  float* dyi = xj + kTile * kLdP;       // [kTile][kLdP]  dy_I
  float* wt = dyi + kTile * kLdP;       // [kTile][kLdT]  W (i, j)
  float* mt = wt + kTile * kLdT;        // [kTile][kLdT]  M (i, j)
  float* st = mt + kTile * kLdT;        // [kMaxN][kLdP]  dS, then S0
  float* dt_s = st + kMaxN * kLdP;      // [kMaxChunk]
  float* cums_s = dt_s + kMaxChunk;
  float* rowk_s = cums_s + kMaxChunk;   // Σ_j K_ij dt_j
  float* colk_s = rowk_s + kMaxChunk;   // Σ_i K_ij
  float* q_s = colk_s + kMaxChunk;      // B_j·(dS x_j)
  float* cs_s = q_s + kMaxChunk;        // (C_i S0)·dy_i
  float* red = cs_s + kMaxChunk;        // [4][kTile] partial sums across warps
  float* warp_s = red + 4 * kTile;      // [8]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);   // this warp's rows of a 64-row tile
  const int q0 = 32 * (warp >> 2);  // its columns of a 64 × 64 product
  const int n0 = 64 * (warp >> 2);  // its columns of a 64 × N product
  const int N = a.N, P = a.P, H = a.H, chunk = a.chunk;
  const bool wide = n0 < N;         // warp-uniform: no mma inside is guarded
  const bool vec_bc = a.vec_bc, vec_x = a.vec_x;
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;    // b · nc + chunk
  const int b = bc / a.nc;
  const int grp = h / (H / a.G);
  const size_t c0 = (size_t)(bc - b * a.nc) * chunk;
  const float A = a.A[h];
  const size_t x_row = (size_t)H * P, bc_row = (size_t)a.G * N;
  const size_t row0 = (size_t)b * a.S + c0;  // the chunk's first token
  const float* xb = a.x + row0 * x_row + (size_t)h * P;
  const float* dyb = a.dy + row0 * x_row + (size_t)h * P;
  const float* bb = a.Bm + row0 * bc_row + (size_t)grp * N;
  const float* cb = a.Cm + row0 * bc_row + (size_t)grp * N;
  const size_t units = (size_t)a.B * a.nc * H;
  const float* s0b = static_cast<const float*>(a.states) + (size_t)blockIdx.x * N * P;
  const float* dsb = static_cast<const float*>(a.states) + (units + blockIdx.x) * N * P;
  const int n8 = round8(N), p8 = round8(P);
  const int n_tiles = (chunk + kTile - 1) / kTile;

  rowk_s[tid] = 0.0f;  // kThreads == kMaxChunk
  load_state(st, dsb, N, P);
  chunk_scan(a.dt + row0 * H + h, H, chunk, A, dt_s, cums_s, warp_s);
  const float cum_last = cums_s[chunk - 1];

  // ---- column side: dx_J, dB_J, q_J and Σ_i K_iJ, a row tile I ≥ J at a time
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    const int j_rows = min(kTile, chunk - j0);
    __syncthreads();  // bj, xj and red are free
    load_tile<kMaxN>(bj, kLdN, bb + j0 * bc_row, bc_row, j_rows, N, vec_bc, nullptr);
    load_tile<kMaxP>(xj, kLdP, xb + j0 * x_row, x_row, j_rows, P, vec_x, nullptr);
    __syncthreads();
    float dxa[4][4], dba[8][4];
    zero<4>(dxa);
    zero<8>(dba);
    // state terms: B_J dS (rows j, columns p) and x_J dSᵀ (rows j, columns n)
    warp_mma<4, false, false>(dxa, bj + r0 * kLdN, kLdN, 1, st + q0, kLdP, 1, n8);
    if (wide) warp_mma<8, false, false>(dba, xj + r0 * kLdP, kLdP, 1, st + n0 * kLdP, 1, kLdP, p8);
    {  // q_j = (B_j dS)·x_j
      float qp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qp[e >> 1] += dxa[nt][e] * xj[(r0 + g + 8 * (e >> 1)) * kLdP + q0 + 8 * nt + 2 * t + (e & 1)];
        }
      }
      rows_to_red(qp, red, warp >> 2, r0);
    }
    __syncthreads();
    if (tid < j_rows) q_s[j0 + tid] = red[tid] + red[kTile + tid];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {  // dx's state term times e_j, dB's times dt_j e_j
      const int jl = r0 + g + 8 * e2;
      const float ej = jl < j_rows ? expf(cum_last - cums_s[j0 + jl]) : 0.0f;
      const float dj = jl < j_rows ? dt_s[j0 + jl] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        dxa[nt][2 * e2] *= ej;
        dxa[nt][2 * e2 + 1] *= ej;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        dba[nt][2 * e2] *= ej * dj;
        dba[nt][2 * e2 + 1] *= ej * dj;
      }
    }

    float colp[4][2];  // Σ_i K_ij of this thread's columns q0 + 8 nt + 2t (+ 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) colp[nt][0] = colp[nt][1] = 0.0f;
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const int i_rows = min(kTile, chunk - i0);
      __syncthreads();  // ci, dyi, wt, mt and red are free
      load_tile<kMaxN>(ci, kLdN, cb + i0 * bc_row, bc_row, i_rows, N, vec_bc, nullptr);
      load_tile<kMaxP>(dyi, kLdP, dyb + i0 * x_row, x_row, i_rows, P, vec_x, nullptr);
      __syncthreads();
      float s[4][4], gg[4][4];
      zero<4>(s);
      zero<4>(gg);
      warp_mma<4, false, false>(s, ci + r0 * kLdN, kLdN, 1, bj + q0 * kLdN, 1, kLdN, n8);
      warp_mma<4, false, false>(gg, dyi + r0 * kLdP, kLdP, 1, xj + q0 * kLdP, 1, kLdP, p8);
      float rowp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = r0 + g + 8 * (e >> 1);
          const int jl = q0 + 8 * nt + 2 * t + (e & 1);
          const int i = i0 + il, j = j0 + jl;
          float w = 0.0f, m = 0.0f;
          if (j <= i && i < chunk) {  // exponent only where it is <= 0
            const float L = expf(cums_s[i] - cums_s[j]);
            w = L * s[nt][e];
            m = L * gg[nt][e] * dt_s[j];
          }
          wt[il * kLdT + jl] = w;
          mt[il * kLdT + jl] = m;
          rowp[e >> 1] += m * s[nt][e];   // K_ij dt_j
          colp[nt][e & 1] += w * gg[nt][e];  // K_ij
        }
      }
      rows_to_red(rowp, red, warp >> 2, r0);
      __syncthreads();
      if (tid < i_rows) rowk_s[i0 + tid] += red[tid] + red[kTile + tid];
      const int k8 = round8(i_rows);
      // dx_J += Wᵀ dy_I, dB_J += Mᵀ C_I
      warp_mma<4, false, false>(dxa, wt + r0, 1, kLdT, dyi + q0, kLdP, 1, k8);
      if (wide) warp_mma<8, false, false>(dba, mt + r0, 1, kLdT, ci + n0, kLdN, 1, k8);
    }

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // columns summed over the strip's 16 rows
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        colp[nt][c] += __shfl_xor_sync(kFull, colp[nt][c], 4);
        colp[nt][c] += __shfl_xor_sync(kFull, colp[nt][c], 8);
        colp[nt][c] += __shfl_xor_sync(kFull, colp[nt][c], 16);
      }
    }
    __syncthreads();  // the last row sums are read out of red
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        red[(warp & 3) * kTile + q0 + 8 * nt + 2 * t] = colp[nt][0];
        red[(warp & 3) * kTile + q0 + 8 * nt + 2 * t + 1] = colp[nt][1];
      }
    }
    __syncthreads();
    if (tid < j_rows) {
      colk_s[j0 + tid] = ((red[tid] + red[kTile + tid]) + red[2 * kTile + tid]) + red[3 * kTile + tid];
    }

    // dx_J = dt_J ⊙ (...), dB_J per head
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int jl = r0 + g + 8 * e2;
      if (jl >= j_rows) continue;
      const float d = dt_s[j0 + jl];
      float* xr = a.dx + (row0 + j0 + jl) * x_row + (size_t)h * P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = q0 + 8 * nt + 2 * t;
        if (p < P) xr[p] = dxa[nt][2 * e2] * d;
        if (p + 1 < P) xr[p + 1] = dxa[nt][2 * e2 + 1] * d;
      }
      if (wide) {
        float* br = a.dbh + ((row0 + j0 + jl) * H + h) * N;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = n0 + 8 * nt + 2 * t;
          if (n < N) br[n] = dba[nt][2 * e2];
          if (n + 1 < N) br[n + 1] = dba[nt][2 * e2 + 1];
        }
      }
    }
  }

  // ---- row side: dC_I and (C_i S0)·dy_i
  __syncthreads();  // every reader of dS is done
  load_state(st, s0b, N, P);
  float sdot = 0.0f;  // ⟨S0, dS⟩, read from device memory
  for (int e = tid; e < N * P; e += kThreads) sdot += s0b[e] * dsb[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sdot += __shfl_xor_sync(kFull, sdot, o);
  if (lane == 0) warp_s[warp] = sdot;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    const int i_rows = min(kTile, chunk - i0);
    __syncthreads();  // st and warp_s written; ci, dyi and red are free
    load_tile<kMaxN>(ci, kLdN, cb + i0 * bc_row, bc_row, i_rows, N, vec_bc, nullptr);
    load_tile<kMaxP>(dyi, kLdP, dyb + i0 * x_row, x_row, i_rows, P, vec_x, nullptr);
    __syncthreads();
    float dca[8][4];
    zero<8>(dca);
    // dy_I S0ᵀ (rows i, columns n)
    if (wide) warp_mma<8, false, false>(dca, dyi + r0 * kLdP, kLdP, 1, st + n0 * kLdP, 1, kLdP, p8);
    {
      float cp[2] = {0.0f, 0.0f};
      if (wide) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cp[e >> 1] += dca[nt][e] * ci[(r0 + g + 8 * (e >> 1)) * kLdN + n0 + 8 * nt + 2 * t + (e & 1)];
          }
        }
      }
      rows_to_red(cp, red, warp >> 2, r0);
    }
    __syncthreads();
    if (tid < i_rows) cs_s[i0 + tid] = red[tid] + red[kTile + tid];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {  // the state term times exp(cums_i)
      const int il = r0 + g + 8 * e2;
      const float ei = il < i_rows ? expf(cums_s[i0 + il]) : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        dca[nt][2 * e2] *= ei;
        dca[nt][2 * e2 + 1] *= ei;
      }
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      const int j_rows = min(kTile, chunk - j0);
      __syncthreads();  // bj, xj and mt are free
      load_tile<kMaxN>(bj, kLdN, bb + j0 * bc_row, bc_row, j_rows, N, vec_bc, nullptr);
      load_tile<kMaxP>(xj, kLdP, xb + j0 * x_row, x_row, j_rows, P, vec_x, nullptr);
      __syncthreads();
      float gg[4][4];
      zero<4>(gg);
      warp_mma<4, false, false>(gg, dyi + r0 * kLdP, kLdP, 1, xj + q0 * kLdP, 1, kLdP, p8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = r0 + g + 8 * (e >> 1);
          const int jl = q0 + 8 * nt + 2 * t + (e & 1);
          const int i = i0 + il, j = j0 + jl;
          float m = 0.0f;
          if (j <= i && i < chunk) m = expf(cums_s[i] - cums_s[j]) * gg[nt][e] * dt_s[j];
          mt[il * kLdT + jl] = m;
        }
      }
      __syncthreads();
      // dC_I += M B_J
      if (wide) warp_mma<8, false, false>(dca, mt + r0 * kLdT, kLdT, 1, bj + n0, kLdN, 1, round8(j_rows));
    }
    if (wide) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int il = r0 + g + 8 * e2;
        if (il >= i_rows) continue;
        float* cr = a.dch + ((row0 + i0 + il) * H + h) * N;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = n0 + 8 * nt + 2 * t;
          if (n < N) cr[n] = dca[nt][2 * e2];
          if (n + 1 < N) cr[n + 1] = dca[nt][2 * e2 + 1];
        }
      }
    }
  }

  // ---- the per-row sums for ssd_bwd_tail
  __syncthreads();
  const size_t u = blockIdx.x;
  if (tid < chunk) {
    vec_row(a, u, kVColk)[tid] = colk_s[tid];
    vec_row(a, u, kVQ)[tid] = q_s[tid];
    vec_row(a, u, kVCs)[tid] = cs_s[tid];
    vec_row(a, u, kVRowk)[tid] = rowk_s[tid];
  }
  if (tid == 0) {
    float dot = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) dot += warp_s[w];
    vec_row(a, u, kVSdot)[0] = dot;
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk_wgmma, bfloat16: a warpgroup per 64-row tile and side
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kStep = 32;                                   // streamed rows a step
constexpr int kNTileBytes = kTile * kMaxN * 2;              // 16 KB: 64 rows, 128 columns
constexpr int kPTileBytes = kTile * kMaxP * 2;              // 8 KB
constexpr int kStateBytes = kMaxN * kMaxP * 2;              // 16 KB: one term of a state
constexpr int kStageN = kStep * kMaxN * 2;                  // 8 KB
constexpr int kStageBytes = kStageN + kStep * kMaxP * 2;    // 12 KB
constexpr int kVecBytes = 3072;                             // cums, dt, 4 warp sums
constexpr int kRingBytes = 2 * kStateBytes + kStageBytes;   // 44 KB
constexpr int kChunkSmemBf16 = kAtom + kVecBytes + kNTileBytes + kPTileBytes + kRingBytes;
constexpr int kHeadsPerBlock = 4;  // at most; a power of two

// The ring slot of step k: the first past the state's two terms (so it
// loads while the state terms are computed), then the two that the state
// covered
__device__ __forceinline__ uint32_t slot_of(int k) {
  const int s = k % 3;
  return s == 0 ? 2 * kStateBytes : (s - 1) * kStageBytes;
}

template <int N>
__device__ __forceinline__ void zero_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// Wait for the cp.async group of step k: `ahead` groups were committed
// after it
__device__ __forceinline__ void wait_groups(int ahead) {
  if (ahead >= 2)
    cp_async_wait<2>();
  else if (ahead == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

template <int S>
struct SideTag {
  static constexpr int value = S;
};

__global__ void __launch_bounds__(kWgThreads, 3) ssd_bwd_chunk_wgmma(const Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));
  float* cums_s = reinterpret_cast<float*>(base);          // [kMaxChunk]
  float* dt_s = cums_s + kMaxChunk;                        // [kMaxChunk]
  float* red_s = dt_s + kMaxChunk;                         // [4]
  unsigned char* own_n = base + kVecBytes;                 // B_J (dx side)
  unsigned char* own_p = own_n + kNTileBytes;              // x_J, or dy_I (row side)
  unsigned char* ring = own_p + kPTileBytes;               // the state, then the stages
  const uint32_t own_n_addr = (uint32_t)__cvta_generic_to_shared(own_n);
  const uint32_t own_p_addr = own_n_addr + kNTileBytes;
  const uint32_t ring_addr = own_p_addr + kPTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N, P = a.P, H = a.H, chunk = a.chunk, hpb = a.hpb;
  const int Hq = H / hpb;            // blocks of hpb heads, each inside one group
  const int hq = blockIdx.x % Hq;
  const int bc = blockIdx.x / Hq;    // b · nc + chunk
  const int b = bc / a.nc;
  const int grp = hq * hpb / (H / a.G);
  const size_t c0 = (size_t)(bc - b * a.nc) * chunk;
  const size_t x_row = (size_t)H * P, bc_row = (size_t)a.G * N;
  const size_t row0 = (size_t)b * a.S + c0;  // the chunk's first token
  const bf16* bb = a.Bm + row0 * bc_row + (size_t)grp * N;
  const bf16* cb = a.Cm + row0 * bc_row + (size_t)grp * N;
  const int NP = N * P;
  const size_t units = (size_t)a.B * a.nc * H;
  const int ntiles = (chunk + kTile - 1) / kTile;
  // blockIdx.y = 3 q + side, the heaviest units of every chunk first: side
  // 0 the dx side of column tile J = q, side 1 its dB side, side 2 row tile
  // I = ntiles - 1 - q
  const int side = blockIdx.y % 3;
  const bool col = side < 2;
  const int tile = col ? blockIdx.y / 3 : ntiles - 1 - (int)(blockIdx.y / 3);
  const int r0 = tile * kTile;                   // the tile's first row in the chunk
  const int rows = min(kTile, chunk - r0);
  // streamed rows: column sides i from r0 to the chunk's end, row side j
  // from 0 to the tile's end, kStep a step
  const int s_first = col ? r0 : 0;
  const int s_end = col ? chunk : r0 + rows;
  const int nsteps = (s_end - s_first + kStep - 1) / kStep;
  const bf16* str_n = col ? cb : bb;   // the streamed N-wide operand: C, or B
  // this thread's rows of the tile: ra, ra + 8
  const int ra = 16 * warp + g;
  const bool edge = r0 + kTile > chunk;  // tile rows past the chunk
  const uint32_t st_hi = ring_addr, st_lo = ring_addr + kStateBytes;
  // the head being worked on, set by begin_head
  int h = 0;
  size_t u = 0;
  const bf16* str_p = nullptr;  // the streamed P-wide operand: dy, or x
  const bf16* s0g = nullptr;    // S0's two bfloat16 terms, hi then lo
  const bf16* dsg = nullptr;    // dS's
  float cum_last = 0.0f;        // cums at the chunk's end
  float cum_r[2], dt_r[2];      // cums and dt of this thread's rows (0 past the chunk)

  // the streamed operands of step k into its slot
  auto issue = [&](int k) {
    const int s0 = s_first + k * kStep;
    const int n = min(kStep, chunk - s0);
    unsigned char* slot = ring + slot_of(k);
    stage_sw128<kMaxN>(slot, kStep, str_n + s0 * bc_row, bc_row, n, N, a.vec_bc);
    stage_sw128<kMaxP>(slot + kStageN, kStep, str_p + s0 * x_row, x_row, n, P, a.vec_x);
    cp_async_commit();
  };
  // the steps: wait for step k's tiles, then step(k, first streamed row,
  // N-wide tile's address, P-wide tile's address); steps 1 and 2 load
  // where the state was
  auto run_steps = [&](auto&& step) {
    if (nsteps > 1) issue(1);
    if (nsteps > 2) issue(2);
    for (int k = 0; k < nsteps; ++k) {
      wait_groups(k == 0 ? min(nsteps, 3) - 1 : min(nsteps, k + 2) - k - 1);
      fence_proxy_async();
      __syncthreads();  // step k's tiles are in; step k - 1's slot is free
      if (k >= 1 && k + 2 < nsteps) issue(k + 2);
      const uint32_t n_addr = ring_addr + slot_of(k);
      step(k, s_first + k * kStep, n_addr, n_addr + kStageN);
    }
  };

  // Head hh of the block's: its pointers, then the chunk's cums and dt,
  // the own tile(s) and the state's two terms in shared memory, step 0
  // loading behind them, and this thread's rows' factors
  auto begin_head = [&](int hh) {
    h = hq * hpb + hh;
    u = (size_t)bc * H + h;
    const bf16* xb = a.x + row0 * x_row + (size_t)h * P;
    const bf16* dyb = a.dy + row0 * x_row + (size_t)h * P;
    str_p = col ? dyb : xb;
    s0g = static_cast<const bf16*>(a.states) + 2 * u * NP;
    dsg = static_cast<const bf16*>(a.states) + 2 * (units + u) * NP;
    __syncthreads();  // the previous head's readers of shared memory are done
    const float* vc = vec_row(a, u, kVCums);
    const float* vd = vec_row(a, u, kVDt);
    for (int i = tid; i < chunk; i += kWgThreads) {
      cp_async4(cums_s + i, vc + i, 4);
      cp_async4(dt_s + i, vd + i, 4);
    }
    if (side == 0) stage_sw128<kMaxN>(own_n, kTile, bb + r0 * bc_row, bc_row, rows, N, a.vec_bc);
    stage_sw128<kMaxP>(own_p, kTile, (col ? xb : dyb) + r0 * x_row, x_row, rows, P, a.vec_x);
    const bf16* sg = col ? dsg : s0g;
    stage_sw128<kMaxP>(ring, kMaxN, sg, P, N, P, a.vec_s);
    stage_sw128<kMaxP>(ring + kStateBytes, kMaxN, sg + NP, P, N, P, a.vec_s);
    cp_async_commit();
    issue(0);
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    cum_last = cums_s[chunk - 1];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {  // 0 past the chunk
      const int rl = ra + 8 * e2;
      cum_r[e2] = rl < rows ? cums_s[r0 + rl] : 0.0f;
      dt_r[e2] = rl < rows ? dt_s[r0 + rl] : 0.0f;
    }
  };

  // ======== column tile J, dx side: dx_J, Σ_i K_ij, q_j, Σ_j K_ij dt_j ========
  auto dx_head = [&]() {
    float dxa[32];
    // ---- state term: B_J dS (K = n; dS MN-major), the lo term's chain,
    // then the hi term's
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kMaxN / 16; ++s)
      wgmma_ss_n64_t<0, 1>(dxa, kmajor(own_n_addr, kTile, s), mnmajor(st_lo, kMaxN, 16 * s), s);
#pragma unroll
    for (int s = 0; s < kMaxN / 16; ++s)
      wgmma_ss_n64_t<0, 1>(dxa, kmajor(own_n_addr, kTile, s), mnmajor(st_hi, kMaxN, 16 * s), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dxa);
    {  // q_j = (B_j dS)·x_j
      float qp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = 8 * n + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(own_p + sw128(kTile, ra + 8 * e2, c)));
          qp[e2] += dxa[4 * n + 2 * e2] * xv.x + dxa[4 * n + 2 * e2 + 1] * xv.y;
        }
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        qp[e2] += __shfl_xor_sync(kFull, qp[e2], 1);
        qp[e2] += __shfl_xor_sync(kFull, qp[e2], 2);
        const int rl = ra + 8 * e2;
        if (t == 0 && rl < rows) vec_row(a, u, kVQ)[r0 + rl] = qp[e2];
      }
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {  // the state term times e_j
      const int rl = ra + 8 * e2;
      const float ej = rl < rows ? expf(cum_last - cum_r[e2]) : 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        dxa[4 * n + 2 * e2] *= ej;
        dxa[4 * n + 2 * e2 + 1] *= ej;
      }
    }
    __syncthreads();  // the state is read: its space takes steps 1 and 2

    float colp[2] = {0.0f, 0.0f};  // Σ_i K_ij of this thread's rows
    float* rowk = vec_row(a, u, kVRowk + 4 * tile + warp);  // this warp's Σ_j K_ij dt_j
    run_steps([&](int, int i0, uint32_t c_addr, uint32_t dy_addr) {
      // ---- Sᵀ = B_J C_Iᵀ and Gᵀ = x_J dy_Iᵀ (64 rows j x 32 columns i)
      float s[16], gg[16];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kMaxN / 16; ++sl)
        wgmma_ss_n32(s, kmajor(own_n_addr, kTile, sl), kmajor(c_addr, kStep, sl), sl);
#pragma unroll
      for (int sl = 0; sl < kMaxP / 16; ++sl)
        wgmma_ss_n32(gg, kmajor(own_p_addr, kTile, sl), kmajor(dy_addr, kStep, sl), sl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(s);
      fence_regs<16>(gg);

      // ---- Wᵀ = L ⊙ Sᵀ into s; K = Wᵀ ⊙ Gᵀ summed over i (rows) and,
      // times dt_j, over j (columns)
      const bool masked = edge || i0 < r0 + kTile || i0 + kStep > chunk;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float rc[2];  // K_ij dt_j of columns i, i + 1 over this thread's rows
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + 8 * n + 2 * t + c;
          const float cum_i = i < chunk ? cums_s[i] : 0.0f;
          rc[c] = 0.0f;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int idx = 4 * n + 2 * e2 + c;
            const int j = r0 + ra + 8 * e2;
            float w = 0.0f;
            if (!masked || (j <= i && i < chunk))  // exponent only where it is <= 0
              w = __expf(cum_i - cum_r[e2]) * s[idx];
            const float k = w * gg[idx];
            colp[e2] += k;
            rc[c] += k * dt_r[e2];
            s[idx] = w;
          }
          // the column sum over the warp's 16 rows
          rc[c] += __shfl_xor_sync(kFull, rc[c], 4);
          rc[c] += __shfl_xor_sync(kFull, rc[c], 8);
          rc[c] += __shfl_xor_sync(kFull, rc[c], 16);
        }
        const int i = i0 + 8 * n + 2 * t;
        if (g == 0 && i < chunk) rowk[i] = rc[0];
        if (g == 0 && i + 1 < chunk) rowk[i + 1] = rc[1];
      }

      // ---- dx_J += Wᵀ dy_I: two bfloat16 terms
      uint32_t wh[2][4], wl[2][4];
      split_frags<2>(s, wh, wl);
      fence_regs<32>(dxa);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) wgmma_rs<64>(dxa, wl[sl], mnmajor(dy_addr, kStep, 16 * sl));
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) wgmma_rs<64>(dxa, wh[sl], mnmajor(dy_addr, kStep, 16 * sl));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(dxa);
    });

#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      colp[e2] += __shfl_xor_sync(kFull, colp[e2], 1);
      colp[e2] += __shfl_xor_sync(kFull, colp[e2], 2);
    }
    // dx_J = dt_J ⊙ (...), Σ_i K_ij
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int rl = ra + 8 * e2;
      if (rl >= rows) continue;
      if (t == 0) vec_row(a, u, kVColk)[r0 + rl] = colp[e2];
      bf16* xr = a.dx + (row0 + r0 + rl) * x_row + (size_t)h * P;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = 8 * n + 2 * t;
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(xr + p) =
              __floats2bfloat162_rn(dxa[4 * n + 2 * e2] * dt_r[e2], dxa[4 * n + 2 * e2 + 1] * dt_r[e2]);
        } else {
          if (p < P) xr[p] = __float2bfloat16_rn(dxa[4 * n + 2 * e2] * dt_r[e2]);
          if (p + 1 < P) xr[p + 1] = __float2bfloat16_rn(dxa[4 * n + 2 * e2 + 1] * dt_r[e2]);
        }
      }
    }
  };

  // ======== side 1: this head's share of dB_J (column tile J, rows j);
  // side 2: of dC_I (row tile I, rows i), and (C_i S0)·dy_i ========
  auto acc_head = [&](float* acc, auto side_tag) {
    constexpr int kSide = decltype(side_tag)::value;  // compiled once a side
    // ---- the state term, 32 columns n at a time (K = p; the state
    // K-major): side 1 x_J dSᵀ times dt_j e_j, side 2 dy_I S0ᵀ times
    // exp(cums_i) and, unscaled, dotted with C_i (read from device memory)
    float f[2], cp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      f[e2] = ra + 8 * e2 >= rows ? 0.0f
              : kSide == 1        ? expf(cum_last - cum_r[e2]) * dt_r[e2]
                                  : expf(cum_r[e2]);
#pragma unroll
    for (int q = 0; q < kMaxN / 32; ++q) {
      float tmp[16];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kMaxP / 16; ++s)
        wgmma_ss_n32(tmp, kmajor(own_p_addr, kTile, s), kmajor(st_lo + 32 * q * 128, kMaxN, s), s);
#pragma unroll
      for (int s = 0; s < kMaxP / 16; ++s)
        wgmma_ss_n32(tmp, kmajor(own_p_addr, kTile, s), kmajor(st_hi + 32 * q * 128, kMaxN, s), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(tmp);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e2 = (i >> 1) & 1;
        const int rl = ra + 8 * e2;
        const int c = 32 * q + 8 * (i >> 2) + 2 * t + (i & 1);
        if (kSide == 2 && rl < rows && c < N)
          cp[e2] += tmp[i] * __bfloat162float(cb[(r0 + rl) * bc_row + c]);
        acc[16 * q + i] += f[e2] * tmp[i];
      }
    }
    if (kSide == 2) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        cp[e2] += __shfl_xor_sync(kFull, cp[e2], 1);
        cp[e2] += __shfl_xor_sync(kFull, cp[e2], 2);
        const int rl = ra + 8 * e2;
        if (t == 0 && rl < rows) vec_row(a, u, kVCs)[r0 + rl] = cp[e2];
      }
    }
    const bool sdot = kSide == 2 && tile == 0;
    if (sdot) {  // ⟨S0, dS⟩ from device memory, each state as hi + lo
      float dot = 0.0f;
      for (int e = tid; e < NP; e += kWgThreads) {
        const float sv = __bfloat162float(s0g[e]) + __bfloat162float(s0g[NP + e]);
        const float dv = __bfloat162float(dsg[e]) + __bfloat162float(dsg[NP + e]);
        dot += sv * dv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if (lane == 0) red_s[warp] = dot;
    }
    __syncthreads();  // the state is read: its space takes steps 1 and 2
    if (sdot && tid == 0) vec_row(a, u, kVSdot)[0] = ((red_s[0] + red_s[1]) + red_s[2]) + red_s[3];

    run_steps([&](int, int s0, uint32_t n_addr, uint32_t p_addr) {
      // ---- side 1 Gᵀ = x_J dy_Iᵀ (rows j, columns i), side 2 G = dy_I
      // x_Jᵀ (rows i, columns j): 64 x 32
      float gg[16];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kMaxP / 16; ++sl)
        wgmma_ss_n32(gg, kmajor(own_p_addr, kTile, sl), kmajor(p_addr, kStep, sl), sl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(gg);
      // ---- Mᵀ = L ⊙ dt_j Gᵀ, or M = L ⊙ G ⊙ dt_j
      const bool masked = edge || s0 + kStep > chunk ||
                          (kSide == 1 ? s0 < r0 + kTile : s0 + kStep > r0);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int sc = s0 + 8 * n + 2 * t + c;  // the streamed row of this column
          const bool in = sc < chunk;
          const float cum_c = in ? cums_s[sc] : 0.0f;
          const float dt_c = in ? dt_s[sc] : 0.0f;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int idx = 4 * n + 2 * e2 + c;
            const int rr = r0 + ra + 8 * e2;  // the tile's row
            const int i = kSide == 1 ? sc : rr, j = kSide == 1 ? rr : sc;
            float m = 0.0f;
            if (!masked || (j <= i && i < chunk))  // exponent only where it is <= 0
              m = kSide == 1 ? __expf(cum_c - cum_r[e2]) * gg[idx] * dt_r[e2]
                            : __expf(cum_r[e2] - cum_c) * gg[idx] * dt_c;
            gg[idx] = m;
          }
        }
      }
      // ---- acc += Mᵀ C_I or M B_J: two bfloat16 terms
      uint32_t mh[2][4], ml[2][4];
      split_frags<2>(gg, mh, ml);
      fence_regs<64>(acc);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) wgmma_rs<128>(acc, ml[sl], mnmajor(n_addr, kStep, 16 * sl));
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) wgmma_rs<128>(acc, mh[sl], mnmajor(n_addr, kStep, 16 * sl));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(acc);
    });
  };

  if (side == 0) {
    for (int hh = 0; hh < hpb; ++hh) {
      begin_head(hh);
      dx_head();
    }
    return;
  }
  // dB_J (side 1) or dC_I (side 2) summed over the block's heads in order
  float acc[64];
  zero_acc<64>(acc);
  for (int hh = 0; hh < hpb; ++hh) {
    begin_head(hh);
    if (side == 1)
      acc_head(acc, SideTag<1>{});
    else
      acc_head(acc, SideTag<2>{});
  }
  // dB_J or dC_I summed over the block's heads: one partial of the group's
  // sum (ssd_bwd_reduce adds the partials in order)
  float* out = side == 1 ? a.dbh : a.dch;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int rl = ra + 8 * e2;
    if (rl >= rows) continue;
    float* o = out + ((row0 + r0 + rl) * Hq + hq) * N;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = 8 * n + 2 * t;
      store_pair(o + c, c, N, acc[4 * n + 2 * e2], acc[4 * n + 2 * e2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_tail: a warp per (batch, chunk, head), lane l the rows
// [l·rpl, (l + 1)·rpl) of the chunk
// ---------------------------------------------------------------------------

constexpr int kTailWarps = 4;
constexpr int kMaxRowsPerLane = kMaxChunk / 32;

template <typename T>
__device__ __forceinline__ void store_elem(T* p, float v);
template <>
__device__ __forceinline__ void store_elem<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_elem<bf16>(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kTailWarps * 32) ssd_bwd_tail(const Args<T> a) {
  constexpr bool kParts = sizeof(T) == 2;  // bfloat16: Σ_j K_ij dt_j in parts
  const int lane = threadIdx.x & 31;
  const size_t u = (size_t)blockIdx.x * kTailWarps + (threadIdx.x >> 5);
  const size_t units = (size_t)a.B * a.nc * a.H;
  if (u >= units) return;
  const int chunk = a.chunk;
  const int h = (int)(u % a.H);
  const size_t bc = u / a.H;
  const int b = (int)(bc / a.nc);
  const size_t row0 = (size_t)b * a.S + (bc - (size_t)b * a.nc) * chunk;
  const float A = a.A[h];
  const float* cums = vec_row(a, u, kVCums);
  const float* dts = vec_row(a, u, kVDt);
  const float* colk = vec_row(a, u, kVColk);
  const float* q = vec_row(a, u, kVQ);
  const float* cs = vec_row(a, u, kVCs);
  const float cum_last = cums[chunk - 1];
  const int rpl = (chunk + 31) / 32;
  const int i_first = lane * rpl;

  // Σ_j e_j dt_j q_j: each lane's rows in order, then a fixed shuffle tree
  float tail = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxRowsPerLane; ++r) {
    const int i = i_first + r;
    if (r < rpl && i < chunk) tail += expf(cum_last - cums[i]) * dts[i] * q[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tail += __shfl_xor_sync(kFull, tail, o);
  const float sdot = vec_row(a, u, kVSdot)[0];

  float dc[kMaxRowsPerLane];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerLane; ++r) {
    const int i = i_first + r;
    dc[r] = 0.0f;
    if (r < rpl && i < chunk) {
      float rowk = 0.0f;
      if (kParts) {
        for (int jt = 0; jt <= i / kTile; ++jt)
          for (int w = 0; w < 4; ++w) rowk += vec_row(a, u, kVRowk + 4 * jt + w)[i];
      } else {
        rowk = vec_row(a, u, kVRowk)[i];
      }
      const float d = dts[i];
      const float e = expf(cum_last - cums[i]);
      dc[r] = rowk - d * colk[i] + expf(cums[i]) * cs[i] - e * d * q[i];
      if (i == chunk - 1) dc[r] += expf(cum_last) * sdot + tail;
    }
  }
  // r_i = Σ_{k ≥ i} dcums_k: the lane's own suffix sums, then the sum of
  // the later lanes' totals (an inclusive scan from the top, shifted)
  float suf[kMaxRowsPerLane];
  float run = 0.0f;
#pragma unroll
  for (int r = kMaxRowsPerLane - 1; r >= 0; --r) {
    run += dc[r];
    suf[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += v;
  }
  float carry = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) carry = 0.0f;

  float da = 0.0f;
  T* ddtb = a.ddt + row0 * a.H + h;
#pragma unroll
  for (int r = 0; r < kMaxRowsPerLane; ++r) {
    const int i = i_first + r;
    if (r < rpl && i < chunk) {
      const float rr = suf[r] + carry;
      const float e = expf(cum_last - cums[i]);
      store_elem<T>(ddtb + (size_t)i * a.H, colk[i] + e * q[i] + A * rr);
      da += dts[i] * rr;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(kFull, da, o);
  if (lane == 0) a.da_part[u] = da;
}

// ---------------------------------------------------------------------------
// ssd_bwd_reduce: dB, dC (B, S, G, N) the (B, S, H / hpb, N) partial sums
// over each group's blocks of heads in order; dA (H,) the (B·nc, H) shares
// summed over B·nc in order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(const Args<T> a) {
  const int Hq = a.H / a.hpb, G = a.G, N = a.N;  // Hq partial sums a row
  const int rep = Hq / G;
  const size_t BS = (size_t)a.B * a.S;
  const size_t total = BS * G * N;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t n = e % N;
    const size_t rest = e / N;
    const size_t gi = rest % G;
    const size_t src = ((rest / G) * Hq + gi * rep) * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += a.dbh[src + (size_t)r * N];
      sc += a.dch[src + (size_t)r * N];
    }
    store_elem<T>(a.dB + e, sb);
    store_elem<T>(a.dC + e, sc);
  }
  if (blockIdx.x == 0) {
    const int nbc = a.B * a.nc;
    for (int h = threadIdx.x; h < a.H; h += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < nbc; ++k) s += a.da_part[(size_t)k * a.H + h];
      a.dA[h] = s;
    }
  }
}

int reduce_blocks(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// ---------------------------------------------------------------------------
// The launches, by dtype
// ---------------------------------------------------------------------------

// One kernel of the five: its function, threads and dynamic shared bytes
struct Kernel {
  const void* fn;
  int threads;
  size_t smem;
};

template <typename T>
struct Kernels;
template <>
struct Kernels<float> {
  static Kernel local() { return {(const void*)ssd_bwd_local_f32, kThreads, local_smem_f32()}; }
  static Kernel chunk() { return {(const void*)ssd_bwd_chunk_f32, kThreads, chunk_smem_f32()}; }
};
template <>
struct Kernels<bf16> {
  static Kernel local() { return {(const void*)ssd_bwd_local_bf16, kThreads, (size_t)kLocalSmemBf16}; }
  static Kernel chunk() { return {(const void*)ssd_bwd_chunk_wgmma, kWgThreads, (size_t)kChunkSmemBf16}; }
};

template <typename T>
int allow_smem() {
  const Kernel ks[2] = {Kernels<T>::local(), Kernels<T>::chunk()};
  for (const Kernel& k : ks) {
    const int e = (int)cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
    if (e != 0) return e;
  }
  return 0;
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  int e = allow_smem<T>();
  if (e != 0) return e;
  const size_t units = (size_t)a.B * a.nc * a.H;
  const Kernel local = Kernels<T>::local(), chunk = Kernels<T>::chunk();
  void* args[] = {const_cast<Args<T>*>(&a)};
  e = (int)cudaLaunchKernel(local.fn, dim3((unsigned)(2 * units)), dim3(local.threads), args,
                            local.smem, stream);
  if (e != 0) return e;
  ssd_bwd_recur<T><<<dim3((unsigned)((a.N * a.P + kThreads - 1) / kThreads), 2 * a.B * a.H),
                     kThreads, 0, stream>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const dim3 grid = sizeof(T) == 2
                        ? dim3((unsigned)(units / a.hpb), 3 * ((a.chunk + kTile - 1) / kTile))
                        : dim3((unsigned)units);
  e = (int)cudaLaunchKernel(chunk.fn, grid, dim3(chunk.threads), args, chunk.smem, stream);
  if (e != 0) return e;
  ssd_bwd_tail<T><<<(unsigned)((units + kTailWarps - 1) / kTailWarps), kTailWarps * 32, 0, stream>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  ssd_bwd_reduce<T><<<reduce_blocks((size_t)a.B * a.S * a.G * a.N), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int info_of(const void* kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != 0) return err;
  info[0] = attr.numRegs;
  info[1] = (int)smem;
  info[2] = threads;
  info[3] = blocks;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}

// in kernel/ssd/kernel.py's BWD_KERNEL_NAMES order: local, recur, chunk,
// tail, reduce
template <typename T>
int infos(int* info) {
  int err = allow_smem<T>();
  if (err != 0) return err;
  const Kernel ks[5] = {
      Kernels<T>::local(),
      {(const void*)ssd_bwd_recur<T>, kThreads, 0},
      Kernels<T>::chunk(),
      {(const void*)ssd_bwd_tail<T>, kTailWarps * 32, 0},
      {(const void*)ssd_bwd_reduce<T>, kThreads, 0},
  };
  for (int k = 0; k < 5; ++k) {
    err = info_of(ks[k].fn, ks[k].threads, ks[k].smem, info + 5 * k);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int run(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
        const void* dy, void* dx, void* ddt, float* dA, void* dB, void* dC, float* local,
        void* states, float* per_head, float* da_part, float* vecs, int B, int S, int H, int G,
        int N, int P, int chunk, cudaStream_t stream) {
  Args<T> a;
  a.x = (const T*)x;
  a.dt = (const T*)dt;
  a.A = A;
  a.Bm = (const T*)Bm;
  a.Cm = (const T*)Cm;
  a.dy = (const T*)dy;
  a.dx = (T*)dx;
  a.ddt = (T*)ddt;
  a.dA = dA;
  a.dB = (T*)dB;
  a.dC = (T*)dC;
  a.local = local;
  a.states = states;
  // heads a chunk block takes: as many of a group's as divide it, up to
  // kHeadsPerBlock (bfloat16); float32 one
  a.hpb = 1;
  if (sizeof(T) == 2)
    while (a.hpb < kHeadsPerBlock && (H / G) % (2 * a.hpb) == 0) a.hpb *= 2;
  a.dbh = per_head;
  a.dch = per_head + (size_t)B * S * (H / a.hpb) * N;
  a.da_part = da_part;
  a.vecs = vecs;
  a.B = B;
  a.S = S;
  a.H = H;
  a.G = G;
  a.N = N;
  a.P = P;
  a.chunk = chunk;
  a.nc = S / chunk;
  // 16-byte loads where widths and addresses allow them
  a.vec_bc = N % 8 == 0 && ((uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  a.vec_x = P % 8 == 0 && ((uintptr_t)x | (uintptr_t)dy) % 16 == 0;
  a.vec_s = P % 8 == 0 && (uintptr_t)states % 16 == 0;
  return launch<T>(a, stream);
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, dy, dx (B,S,H,P), dt, ddt (B,S,H), Bm, Cm, dB, dC (B,S,G,N): contiguous
// device pointers of one dtype (0 float32, 1 bfloat16); A, dA (H,) float32.
// Scratch, float32: local and states (2,B,S/chunk,H,N,P) each, per_head
// (2,B,S,H/hpb,N) (hpb: bfloat16 the largest of 4, 2, 1 dividing H/G;
// float32 1), da_part (B·S/chunk, H), vecs (B·S/chunk·H, 22, chunk).
// 1 <= N <= 128, 1 <= P <= 64, 1 <= chunk <= 256, S a multiple of chunk,
// H a multiple of G.
extern "C" int tao_ssd_scan_bwd(const void* x, const void* dt, const float* A, const void* Bm,
                                const void* Cm, const void* dy, void* dx, void* ddt, float* dA,
                                void* dB, void* dC, float* local, void* states, float* per_head,
                                float* da_part, float* vecs, int B, int S, int H, int G, int N,
                                int P, int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || N < 1 || N > kMaxN || P < 1 ||
      P > kMaxP || chunk < 1 || chunk > kMaxChunk || S % chunk != 0 ||
      (long long)B * (S / chunk) * H > 0x7fffffffLL || 2LL * B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return run<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, local, states, per_head,
                        da_part, vecs, B, S, H, G, N, P, chunk, s);
    case 1:
      return run<bf16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, local, states, per_head,
                       da_part, vecs, B, S, H, G, N, P, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What each kernel of a call in `dtype` gets, without launching:
// info[5k + 0] registers per thread, [+1] dynamic shared bytes per block,
// [+2] threads per block, [+3] resident blocks per SM, [+4] local (spill)
// bytes per thread, for k = 0 ssd_bwd_local, 1 ssd_bwd_recur,
// 2 ssd_bwd_chunk (ssd_bwd_chunk_wgmma in bfloat16), 3 ssd_bwd_tail,
// 4 ssd_bwd_reduce.
extern "C" int tao_ssd_scan_bwd_info(int dtype, int* info, void* stream) {
  (void)stream;
  switch (dtype) {
    case 0: return infos<float>(info);
    case 1: return infos<bf16>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
