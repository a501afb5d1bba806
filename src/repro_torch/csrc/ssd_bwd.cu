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
// Three kernels, one C call, no atomics (two calls are bitwise equal):
//
//   ssd_bwd_states  a block per (batch, head, direction) walks the chunks
//                   with the (N, P) float32 state in registers (a warp per
//                   16 rows of N): forward it writes S0 of each chunk (the
//                   forward's recurrence, recomputed rather than saved by
//                   the forward: 67 MB a layer at the training shape would
//                   be held for every layer until the backward), backward
//                   it writes the dS leaving each chunk, dS ← exp(cums_last)
//                   dS + (exp(cums) ⊙ C)ᵀ dy.  (2, B, nc, H, N, P) float32.
//   ssd_bwd_chunk   a block per (batch, chunk, head), 256 threads, the
//                   chunk cut into 64-row tiles.  Column side: for each
//                   tile J, the state terms B_J dS and x_J dSᵀ, then for
//                   each row tile I ≥ J the score tiles C_I B_Jᵀ and
//                   dy_I x_Jᵀ, masked and weighted into W = L ⊙ (C Bᵀ) and
//                   M in shared memory, dx_J += Wᵀ dy_I and dB_J += Mᵀ C_I
//                   in registers, the row and column sums of K into
//                   per-chunk vectors.  Row side: for each tile I, dy_I S0ᵀ
//                   (the state term of dC and, dotted with C_I, of dcums),
//                   then dC_I += M B_J over J ≤ I (M recomputed from
//                   dy_I x_Jᵀ).  Then one thread takes the chunk's reverse
//                   prefix sum of dcums in a fixed order: ddt, and the
//                   block's share of dA.  dB and dC are written per head,
//                   (B, S, H, N) float32.
//   ssd_bwd_reduce  sums dB and dC over the heads of each group and the
//                   blocks' shares of dA over batch and chunks, each in a
//                   fixed order.
//
// Products: mma.sync.m16n8k8 TF32 in the split scheme of csrc/ssd.cu
// (split() and mma() copied from there, which copied them from
// csrc/attention.cu): float32 operands as hi + lo, 3 mma a product, at
// float32-level error; operands read from bfloat16 memory (x, dy, B, C)
// are exact in TF32 and take hi only, so the score tiles take 1 mma and the
// products of a computed operand (W, M, a state) 2.  A warp owns 16 × 32 of
// a 64 × 64 tile (rows 16·(warp % 4), columns 32·(warp / 4)) and 16 × 64 of
// a 64 × N one (columns 64·(warp / 4)).  Every exponent is a difference of
// cums that is ≤ 0 (cums only decreases), and the upper triangle j > i is
// masked on the data before the exponential (see csrc/ssd.cu).
//
// Shared memory (float32, operands widened on their way in, zero-padded to
// N 128, P 64 and 64 rows): chunk kernel 179,232 bytes (B_J and C_I
// [64][132], x_J, dy_I, W and M [64][68], the state [128][68], six
// per-chunk vectors), one block per SM; state kernel 54,304 bytes.
//
// What bounds it on the H100: per (batch, chunk) the function needs the
// causal score tiles C Bᵀ once per group and, per head, dy xᵀ, Wᵀ dy, M B
// and Mᵀ C over the triangle (c(c+1)/2 entries each) and five c·N·P
// products (the two state recurrences and the state terms of dx, dB, dC).
// At mamba2-1.3b's training shape (B 2, S 2048, H 64, P 64, G 1, N 128,
// c 256, bf16) that is ~47 GFLOP against ~105 MB of inputs and outputs:
// 0.048 ms at the 989 TFLOP/s bf16 tensor rate, 0.031 ms at 3.35 TB/s, so
// the operations bound it (chip_smoke.py counts both from the shapes).
// This kernel runs TF32 mma.sync, recomputes C Bᵀ per head (at G = 1 the 64
// heads of a group share it) and dy xᵀ on both sides, and loads its tiles
// in 8-element units with one block of 8 warps per SM; PERF.md has its
// times.  Left for later: wgmma on bf16 tiles, tiles staged by TMA or
// cp.async, C Bᵀ once per group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows of a chunk tile
constexpr int kMaxN = 128;     // d_state
constexpr int kMaxP = 64;      // head_dim
constexpr int kMaxChunk = 256;
constexpr int kLdN = kMaxN + 4;  // pitch of B and C tiles: 132 ≡ 4 (mod 8)
constexpr int kLdP = kMaxP + 4;  // pitch of x, dy tiles and the state: 68
constexpr int kLdT = kTile + 4;  // pitch of W and M: 68
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kMaxChunk, "a thread per chunk row clears the row sums");

// Which operands read from memory are exact in TF32: the bfloat16 ones.
template <typename T> struct Operands { static constexpr bool exact = false; };
template <> struct Operands<__nv_bfloat16> { static constexpr bool exact = true; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

size_t states_smem_bytes() {
  return (kTile * kLdN + kTile * kLdP + 3 * kMaxChunk + 8) * sizeof(float);
}

size_t chunk_smem_bytes() {
  return (2 * kTile * kLdN + 4 * kTile * kLdP + kMaxN * kLdP + 6 * kMaxChunk + 4 * kTile + 8) *
         sizeof(float);
}

// Block (b, h, dir): dir 0 writes the state entering each chunk to s0,
// walking forward; dir 1 the gradient of the state leaving each chunk to
// ds, walking back.  Both are state ← exp(cums_last) state + Σ_j w_j V_jᵀ
// U_j over the chunk: V = B, w = dt e, U = x forward; V = C, w =
// exp(cums), U = dy back.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
               float* __restrict__ s0, float* __restrict__ ds, int S, int H, int G, int N, int P,
               int chunk, bool vec_bc, bool vec_x) {
  constexpr bool kExact = Operands<T>::exact;
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                    // [kTile][kLdN]  w ⊙ V
  float* u_s = v_s + kTile * kLdN;      // [kTile][kLdP]  U
  float* dt_s = u_s + kTile * kLdP;     // [kMaxChunk]
  float* cums_s = dt_s + kMaxChunk;     // [kMaxChunk]
  float* w_s = cums_s + kMaxChunk;      // [kMaxChunk]
  float* warp_s = w_s + kMaxChunk;      // [8]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.x & 1;
  const int bh = blockIdx.x >> 1;
  const int b = bh / H;
  const int h = bh - b * H;
  const int grp = h / (H / G);
  const int nc = S / chunk;
  const float a = A[h];
  const size_t x_row = (size_t)H * P, bc_row = (size_t)G * N;
  const T* vb = (dir ? Cm : Bm) + (size_t)b * S * bc_row + (size_t)grp * N;
  const T* ub = (dir ? dy : x) + (size_t)b * S * x_row + (size_t)h * P;
  const T* dtb = dt + (size_t)b * S * H + h;
  float* out = dir ? ds : s0;
  const int n0 = 16 * warp;        // this warp's rows of the state
  const bool active = n0 < N;      // warp-uniform

  float st[8][4];
  zero<8>(st);
  for (int k = 0; k < nc; ++k) {
    const int cc = dir ? nc - 1 - k : k;
    const size_t c0 = (size_t)cc * chunk;
    float* o = out + (((size_t)b * nc + cc) * H + h) * N * P;
    if (active) {
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + g + 8 * (e >> 1);
          const int p = 8 * pt + 2 * t + (e & 1);
          if (n < N && p < P) o[n * P + p] = st[pt][e];
        }
      }
    }
    __syncthreads();  // the previous chunk's readers of the vectors and tiles are done
    chunk_scan(dtb + c0 * H, H, chunk, a, dt_s, cums_s, warp_s);
    const float cum_last = cums_s[chunk - 1];
    if (tid < chunk) w_s[tid] = dir ? expf(cums_s[tid]) : dt_s[tid] * expf(cum_last - cums_s[tid]);

    float upd[8][4];
    zero<8>(upd);
    for (int r0 = 0; r0 < chunk; r0 += kTile) {
      const int rows = min(kTile, chunk - r0);
      __syncthreads();  // w_s written; v_s, u_s free
      load_tile<kMaxN>(v_s, kLdN, vb + (c0 + r0) * bc_row, bc_row, rows, N, vec_bc, w_s + r0);
      load_tile<kMaxP>(u_s, kLdP, ub + (c0 + r0) * x_row, x_row, rows, P, vec_x, nullptr);
      __syncthreads();
      // upd(n, p) += Σ_j (w V)[j][n] U[j][p]
      if (active) warp_mma<8, false, kExact>(upd, v_s + n0, 1, kLdN, u_s, kLdP, 1, round8(rows));
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[pt][e] = fmaf(st[pt][e], decay, upd[pt][e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
              const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
              const float* __restrict__ s0, const float* __restrict__ ds, T* __restrict__ dx,
              T* __restrict__ ddt, float* __restrict__ dbh, float* __restrict__ dch,
              float* __restrict__ da_part, int S, int H, int G, int N, int P, int chunk,
              bool vec_bc, bool vec_x) {
  constexpr bool kExact = Operands<T>::exact;  // x, dy, B and C: hi only
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
  const bool wide = n0 < N;         // warp-uniform: no mma inside is guarded
  const int nc = S / chunk;
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;    // b · nc + chunk
  const int b = bc / nc;
  const int grp = h / (H / G);
  const size_t c0 = (size_t)(bc - b * nc) * chunk;
  const float a = A[h];
  const size_t x_row = (size_t)H * P, bc_row = (size_t)G * N;
  const size_t row0 = (size_t)b * S + c0;  // the chunk's first token
  const T* xb = x + row0 * x_row + (size_t)h * P;
  const T* dyb = dy + row0 * x_row + (size_t)h * P;
  const T* bb = Bm + row0 * bc_row + (size_t)grp * N;
  const T* cb = Cm + row0 * bc_row + (size_t)grp * N;
  const float* s0b = s0 + (size_t)blockIdx.x * N * P;  // (B, nc, H, N, P)
  const float* dsb = ds + (size_t)blockIdx.x * N * P;
  const int n8 = round8(N), p8 = round8(P);
  const int n_tiles = (chunk + kTile - 1) / kTile;

  rowk_s[tid] = 0.0f;  // kThreads == kMaxChunk
  load_state(st, dsb, N, P);
  chunk_scan(dt + row0 * H + h, H, chunk, a, dt_s, cums_s, warp_s);
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
    warp_mma<4, kExact, false>(dxa, bj + r0 * kLdN, kLdN, 1, st + q0, kLdP, 1, n8);
    if (wide) warp_mma<8, kExact, false>(dba, xj + r0 * kLdP, kLdP, 1, st + n0 * kLdP, 1, kLdP, p8);
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
      warp_mma<4, kExact, kExact>(s, ci + r0 * kLdN, kLdN, 1, bj + q0 * kLdN, 1, kLdN, n8);
      warp_mma<4, kExact, kExact>(gg, dyi + r0 * kLdP, kLdP, 1, xj + q0 * kLdP, 1, kLdP, p8);
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
      warp_mma<4, false, kExact>(dxa, wt + r0, 1, kLdT, dyi + q0, kLdP, 1, k8);
      if (wide) warp_mma<8, false, kExact>(dba, mt + r0, 1, kLdT, ci + n0, kLdN, 1, k8);
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
      T* xr = dx + (row0 + j0 + jl) * x_row + (size_t)h * P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = q0 + 8 * nt + 2 * t;
        if (p < P) store(xr + p, dxa[nt][2 * e2] * d);
        if (p + 1 < P) store(xr + p + 1, dxa[nt][2 * e2 + 1] * d);
      }
      if (wide) {
        float* br = dbh + ((row0 + j0 + jl) * H + h) * N;
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
    if (wide) warp_mma<8, kExact, false>(dca, dyi + r0 * kLdP, kLdP, 1, st + n0 * kLdP, 1, kLdP, p8);
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
      warp_mma<4, kExact, kExact>(gg, dyi + r0 * kLdP, kLdP, 1, xj + q0 * kLdP, 1, kLdP, p8);
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
      if (wide) warp_mma<8, false, kExact>(dca, mt + r0 * kLdT, kLdT, 1, bj + n0, kLdN, 1, round8(j_rows));
    }
    if (wide) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int il = r0 + g + 8 * e2;
        if (il >= i_rows) continue;
        float* cr = dch + ((row0 + i0 + il) * H + h) * N;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = n0 + 8 * nt + 2 * t;
          if (n < N) cr[n] = dca[nt][2 * e2];
          if (n + 1 < N) cr[n + 1] = dca[nt][2 * e2 + 1];
        }
      }
    }
  }

  // ---- dcums, its reverse prefix sum r, ddt and this block's share of dA,
  // by one thread in a fixed order
  __syncthreads();
  if (tid == 0) {
    float dot = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) dot += warp_s[w];
    float tail = 0.0f;  // Σ_j e_j dt_j q_j
    for (int j = 0; j < chunk; ++j) tail += expf(cum_last - cums_s[j]) * dt_s[j] * q_s[j];
    float r = 0.0f, da = 0.0f;
    T* ddtb = ddt + row0 * H + h;
    for (int i = chunk - 1; i >= 0; --i) {
      const float d = dt_s[i];
      const float e = expf(cum_last - cums_s[i]);
      float dc = rowk_s[i] - d * colk_s[i] + expf(cums_s[i]) * cs_s[i] - e * d * q_s[i];
      if (i == chunk - 1) dc += expf(cum_last) * dot + tail;
      r += dc;
      store(ddtb + (size_t)i * H, colk_s[i] + e * q_s[i] + a * r);
      da += d * r;
    }
    da_part[blockIdx.x] = da;
  }
}

// dB, dC (B, S, G, N): the per-head (B, S, H, N) sums over each group's
// heads in order; dA (H,): the (B·nc, H) shares summed over B·nc in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dbh, const float* __restrict__ dch,
               const float* __restrict__ da_part, T* __restrict__ dB, T* __restrict__ dC,
               float* __restrict__ dA, size_t BS, int H, int G, int N, int nbc) {
  const int rep = H / G;
  const size_t total = BS * G * N;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t n = e % N;
    const size_t rest = e / N;
    const size_t gi = rest % G;
    const size_t src = ((rest / G) * H + gi * rep) * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += dbh[src + (size_t)r * N];
      sc += dch[src + (size_t)r * N];
    }
    store(dB + e, sb);
    store(dC + e, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < nbc; ++k) s += da_part[(size_t)k * H + h];
      dA[h] = s;
    }
  }
}

int reduce_blocks(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int allow_smem() {
  int e = (int)cudaFuncSetAttribute(ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)states_smem_bytes());
  if (e != 0) return e;
  return (int)cudaFuncSetAttribute(ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)chunk_smem_bytes());
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
           const void* dy, void* dx, void* ddt, float* dA, void* dB, void* dC, float* states,
           float* per_head, float* da_part, int B, int S, int H, int G, int N, int P, int chunk,
           cudaStream_t stream) {
  int e = allow_smem<T>();
  if (e != 0) return e;
  const int nc = S / chunk;
  float* s0 = states;
  float* ds = states + (size_t)B * nc * H * N * P;
  float* dbh = per_head;
  float* dch = per_head + (size_t)B * S * H * N;
  // 8-element loads where widths and addresses allow them
  const bool vec_bc = N % 8 == 0 && ((uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  const bool vec_x = P % 8 == 0 && ((uintptr_t)x | (uintptr_t)dy) % 16 == 0;
  ssd_bwd_states<T><<<2 * B * H, kThreads, states_smem_bytes(), stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bm, (const T*)Cm, (const T*)dy, s0, ds, S, H, G, N,
      P, chunk, vec_bc, vec_x);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  ssd_bwd_chunk<T><<<B * nc * H, kThreads, chunk_smem_bytes(), stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bm, (const T*)Cm, (const T*)dy, s0, ds, (T*)dx,
      (T*)ddt, dbh, dch, da_part, S, H, G, N, P, chunk, vec_bc, vec_x);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const size_t BS = (size_t)B * S;
  ssd_bwd_reduce<T><<<reduce_blocks(BS * G * N), kThreads, 0, stream>>>(
      dbh, dch, da_part, (T*)dB, (T*)dC, dA, BS, H, G, N, B * nc);
  return (int)cudaGetLastError();
}

template <typename K>
int info_of(K kernel, size_t smem, int* info) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != 0) return err;
  info[0] = attr.numRegs;
  info[1] = (int)smem;
  info[2] = kThreads;
  info[3] = blocks;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}

template <typename T>
int infos(int* info) {
  int err = allow_smem<T>();
  if (err != 0) return err;
  err = info_of(ssd_bwd_states<T>, states_smem_bytes(), info);
  if (err != 0) return err;
  err = info_of(ssd_bwd_chunk<T>, chunk_smem_bytes(), info + 5);
  if (err != 0) return err;
  return info_of(ssd_bwd_reduce<T>, 0, info + 10);
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, dy, dx (B,S,H,P), dt, ddt (B,S,H), Bm, Cm, dB, dC (B,S,G,N): contiguous
// device pointers of one dtype (0 float32, 1 bfloat16); A, dA (H,) float32.
// Scratch, float32: states (2,B,S/chunk,H,N,P), per_head (2,B,S,H,N),
// da_part (B·S/chunk, H).  1 <= N <= 128, 1 <= P <= 64, 1 <= chunk <= 256,
// S a multiple of chunk, H a multiple of G.
extern "C" int tao_ssd_scan_bwd(const void* x, const void* dt, const float* A, const void* Bm,
                                const void* Cm, const void* dy, void* dx, void* ddt, float* dA,
                                void* dB, void* dC, float* states, float* per_head,
                                float* da_part, int B, int S, int H, int G, int N, int P,
                                int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || N < 1 || N > kMaxN || P < 1 ||
      P > kMaxP || chunk < 1 || chunk > kMaxChunk || S % chunk != 0 ||
      (long long)B * (S / chunk) * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, states, per_head, da_part,
                           B, S, H, G, N, P, chunk, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, states, per_head,
                                   da_part, B, S, H, G, N, P, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What each kernel of a call in `dtype` gets, without launching:
// info[5k + 0] registers per thread, [+1] dynamic shared bytes per block,
// [+2] threads per block, [+3] resident blocks per SM, [+4] local (spill)
// bytes per thread, for k = 0 ssd_bwd_states, 1 ssd_bwd_chunk,
// 2 ssd_bwd_reduce.
extern "C" int tao_ssd_scan_bwd_info(int dtype, int* info, void* stream) {
  (void)stream;
  switch (dtype) {
    case 0: return infos<float>(info);
    case 1: return infos<__nv_bfloat16>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
