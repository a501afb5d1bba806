// Mamba-2 chunked SSD scan for Hopper (sm_90a) on the tensor cores,
// float32 or bfloat16 I/O.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd_kernel, line 26; pallas_call at line 97).  For xh (B,S,H,P),
// dt (B,S,H), Bm and Cm (B,S,G,N), all of one dtype, A (H,) float32, head h
// reading group h / (H/G), it computes y (B,S,H,P) in that dtype and, on
// request, the final (B,H,N,P) float32 state.  Per chunk of c tokens, with
// cums the inclusive prefix sum of dt·A over the chunk:
//
//   y_diag = (L ⊙ C Bᵀ) diag(dt) X,   L[i,j] = exp(cums_i − cums_j), j ≤ i
//   y_off  = exp(cums) ⊙ (C · state)
//   state' = state·exp(cums_last) + Bᵀ diag(dt·exp(cums_last − cums)) X
//
// The TPU kernel runs a sequential chunk grid axis with the (N, P) state in
// VMEM and the whole c × c chunk matrix in one MXU step.  Here one block of
// 256 threads (8 warps) owns one (batch, head) and walks the chunks in a
// loop, the (N, P) float32 state in shared memory between them.  A chunk of
// 256 is too large for shared memory whole, so it is cut into 64-row tiles:
// for each row tile i, y = exp(cums_i) ⊙ (C_i · state) from the old state,
// then for each column tile j ≤ i the 64 × 64 score tile C_i B_jᵀ, masked
// and weighted into W, and y += W X_j.  While the last row tile walks the
// column tiles (every tile of B and X once) the warps also gather the state
// update (w_end ⊙ B)ᵀ X in registers; it is applied after a barrier, once
// every row tile has read the old state.
//
// Products: all four run as mma.sync.m16n8k8 TF32 tiles, a warp owning
// 16 × 32 of each 64 × 64 product (rows 16·(warp % 4), columns
// 32·(warp / 4)) and 16 × 64 of the (N, P) update (rows 16·warp).  Scores
// and W X_j take K in steps of 8; C_i · state takes K = N, the update
// K = the tile's 64 rows.
//
// Numerics: split TF32, as csrc/attention.cu does it (split() and mma()
// below are copied from there).  A float32 operand x is split into
// hi = tf32(x), rounded to nearest with ties away (add half a TF32 ulp to
// the bits and mask; cvt.rna.tf32.f32 is no single instruction on sm_90),
// and lo = (x − hi) cut to TF32; a product of two such operands is
// lo·hi + hi·lo + hi·hi accumulated in float32, ~2^-21 of |x y|:
// float32-level error, which the port's parity rule and the 1e-4
// tolerance ask for (plain TF32 keeps 10 mantissa bits, ~5e-4).  Every
// bfloat16 value is exact in TF32 (8 significant bits of 11), so in the
// bfloat16 instantiation an operand read from memory (C, B, X) has lo = 0
// and its products need fewer mma.sync:
//
//   product           A · B                  float32   bfloat16
//   C_i B_jᵀ          C · B                  3         1
//   W X_j             W (split) · X          3         2
//   C_i · state       C · state (split)      3         2
//   update            (w_end ⊙ B)ᵀ (split) · X   3     2
//
// The count is a template property of the element type (Operands<T>), so
// no run-time branch sits around an mma.sync: a guarded mma.sync is a
// convergence point, and guarded steps run one by one (csrc/attention.cu).
// Every exponent is a difference of two cums taken as one argument (≤ 0):
// cums only decreases (A < 0, dt ≥ 0) and reaches −10³ within a chunk at
// the full width, so exp(−cums_j) would overflow.  The upper triangle
// j > i is masked on the data, never exponentiated (exp there could be
// inf, and inf · 0 is NaN); every mma of a tile runs.
//
// Shared memory (float32; operands converted on their way in), with the
// pitches (in floats) that keep every fragment load of a warp on 32
// different banks: a fragment reads (g, t) = (lane / 4, lane % 4) at
// g·pitch + t when K runs along a row, which needs pitch ≡ 4 (mod 8), and
// at t·pitch + g when K runs down a column, which needs pitch ≡ 8 (mod 16).
//   C_i, B_j  [64][N16 + 4]   N16 = N rounded up to 16: K along the row
//             for C_i (A operand) and B_j (B operand of the scores); the
//             update reads B_j down its columns, 2-way conflicted (no
//             pitch serves both ways);
//   X_j       [64][72]        K (the tile's rows) down the column;
//   state     [N16][72]       K (n) down the column;
//   W         [64][68]        K along the row.
// Zeros pad K to multiples of 8 (16 for N), P to 64, and the rows past a
// partial last tile (chunk 96 or 200, chunk 8): products over the padding
// add zeros, and what lies past N, P or the chunk is never written.  At
// N 128, chunk 256: 143,392 bytes, one block per SM.
//
// Tiles come in from device memory 8 elements a thread (16-byte loads of
// bfloat16, 32-byte of float32) where widths and addresses allow, else one
// element at a time.  In the bfloat16 build each tile is fetched into
// registers one step ahead, in the order the loops read them (per chunk and
// row tile i: C_i, then B_j and X_j for j = 0..i), so its loads are in
// flight under the products of the step before; the float32 build, whose
// raw tiles take twice the registers, fetches a tile right before it
// stores it.  (Staging the next tiles in shared memory with cp.async
// instead was slower: the extra pass that widens them to float32 cost as
// much as the loads it hid.)
//
// What bounds it on the H100: at the mamba2-1.3b prefill shape (B 4, S 2048,
// H 64, P 64, N 128, c 256, bf16) the function moves 147.85 MB (each input
// read once, y and the state written once) and needs 26.07 GFLOP over the
// causal triangle, 0.026 ms at the 989 TFLOP/s bf16 tensor rate, so bytes
// bound it: 0.0441 ms at 3.35 TB/s.  (On the CUDA cores, at 67 TFLOP/s
// float32, the same FLOPs take 0.389 ms: no CUDA-core version gets under
// that.)  The kernel executes ~77 GFLOP of TF32
// mma (1 + 2 + 2 + 2 products over the causal tiles, the diagonal tiles
// whole).  It does not reach that: with one block of 8 warps per SM, each
// step (a tile's loads, the scores and their weights, W X_j, the update)
// runs between barriers with little else to overlap it, and the score
// tiles with their weights take the largest share.  PERF.md has the
// times.  Left for later, one change each: C Bᵀ once per group instead of
// once per head (at G = 1 the 64 heads of a group recompute it), operands
// read at their strides (kernels/ssd/ops.py copies them contiguous), two
// blocks per SM (the 256 blocks take two waves), and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows of a chunk tile
constexpr int kMaxN = 128;     // d_state
constexpr int kMaxP = 64;      // head_dim
constexpr int kMaxChunk = 256;
constexpr int kLdX = kMaxP + 8;   // pitch of X_j and the state: 72 ≡ 8 (mod 16)
constexpr int kLdW = kTile + 4;   // pitch of W: 68 ≡ 4 (mod 8)
constexpr unsigned kFull = 0xffffffffu;

// Which operands read from memory are exact in TF32: the bfloat16 ones.
template <typename T> struct Operands { static constexpr bool exact = false; };
template <> struct Operands<__nv_bfloat16> { static constexpr bool exact = true; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// From csrc/attention.cu: x = hi + lo in TF32, hi rounded to nearest (ties
// away), lo the exact remainder cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// From csrc/attention.cu: c += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// N fragment values as TF32: hi only where they are exact, else hi and lo
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

// c += a b with each side exact (hi only) or split: the small cross terms
// first, then hi · hi; 1, 2 or 3 mma.sync, fixed at compile time
template <bool AExact, bool BExact>
__device__ __forceinline__ void mma_split(float* c, const uint32_t* ahi, const uint32_t* alo,
                                          const uint32_t* bhi, const uint32_t* blo) {
  if constexpr (!AExact) mma(c, alo, bhi);
  if constexpr (!BExact) mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

// Rows of an A fragment (16 × 8, K along the row): p = &tile[g][k0 + t]
__device__ __forceinline__ void rows_a(const float* p, int pitch, float* v) {
  v[0] = p[0];
  v[1] = p[8 * pitch];
  v[2] = p[4];
  v[3] = p[8 * pitch + 4];
}

__host__ __device__ __forceinline__ int n16(int N) { return (N + 15) & ~15; }

size_t smem_bytes(int N, int chunk) {
  const size_t pc = n16(N) + 4;
  return (2 * kTile * pc         // C_i, B_j
          + n16(N) * kLdX        // state (n, p)
          + kTile * kLdX         // X_j
          + kTile * kLdW         // W
          + 3 * (size_t)chunk    // dt, cums, dt * exp(cums_last - cums)
          + 8) * sizeof(float);  // warp totals of the scan
}

// Units of 8 elements a thread holds between fetch and put: a 64-row tile
// of B or C at N 128 is 1,024 units (4 a thread), of X at P 64 512 (2).
constexpr int kUnitsBC = kTile * (kMaxN / 8) / kThreads;
constexpr int kUnitsX = kTile * (kMaxP / 8) / kThreads;
template <typename T> struct Raw { uint4 u[sizeof(T) / 2]; };  // 8 elements as read

template <typename T>
__device__ __forceinline__ void raw8(const T* src, Raw<T>& v) {
#pragma unroll
  for (int e = 0; e < (int)(sizeof(T) / 2); ++e) v.u[e] = reinterpret_cast<const uint4*>(src)[e];
}

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

// A 64-row tile of a (.., width) slab with row stride `stride` (elements),
// bound for dst[r * pitch + k] as float32; rows at or past `rows` and
// columns at or past `width`, up to the padded width `wpad` (a multiple of
// 8), are zero.  `vec`: width, stride and the slab's address are multiples
// of 8 elements, so a thread moves 8 at a time, its loads issued by fetch()
// into registers and stored by put(); otherwise put() reads one element at
// a time.
template <typename T, int kUnits>
struct Tile {
  float* dst;
  int pitch;
  const T* src;
  size_t stride;
  int rows, width, wpad;
  bool vec;
  Raw<T> raw[kUnits];

  __device__ __forceinline__ void fetch() {
    if (!vec) return;  // put() reads the slab itself
    const int cpr = wpad >> 3;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / cpr;
      const int k = (e - r * cpr) << 3;
      if (e < kTile * cpr && r < rows && k < width) raw8(src + r * stride + k, raw[u]);
    }
  }

  __device__ __forceinline__ void put() {
    if (vec) {
      const int cpr = wpad >> 3;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int r = e / cpr;
        const int k = (e - r * cpr) << 3;
        if (e >= kTile * cpr) continue;
        float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (r < rows && k < width) widen8(raw[u], v);
        float4* d = reinterpret_cast<float4*>(dst + r * pitch + k);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
      for (int e = threadIdx.x; e < kTile * wpad; e += kThreads) {
        const int r = e / wpad;
        const int k = e - r * wpad;
        dst[r * pitch + k] = (r < rows && k < width) ? to_f(src[r * stride + k]) : 0.0f;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int G, int N, int P,
           int chunk, bool vec_bc, bool vec_x) {
  constexpr bool kExact = Operands<T>::exact;  // C, B and X: hi only
  extern __shared__ __align__(16) float smem[];
  const int npad = n16(N);
  const int pc = npad + 4;
  float* c_s = smem;                    // [kTile][pc]    C_i
  float* b_s = c_s + kTile * pc;        // [kTile][pc]    B_j
  float* st_s = b_s + kTile * pc;       // [npad][kLdX]   state (n, p)
  float* x_s = st_s + npad * kLdX;      // [kTile][kLdX]  X_j
  float* w_s = x_s + kTile * kLdX;      // [kTile][kLdW]  W (i, j)
  float* dt_s = w_s + kTile * kLdW;     // [chunk]
  float* cums_s = dt_s + chunk;         // [chunk]
  float* wend_s = cums_s + chunk;       // [chunk]
  float* warp_s = wend_s + chunk;       // [8]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the mma's group: rows g and g + 8
  const int t = lane & 3;   // thread in group
  const int r0 = 16 * (warp & 3);   // this warp's rows of a 64 × 64 product
  const int q0 = 32 * (warp >> 2);  // and its columns
  const int n0 = 16 * warp;         // its rows of the (n, p) update
  const bool updates = n0 < npad;   // warp-uniform: no mma inside is guarded
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int grp = h / (H / G);
  const float a = A[h];
  const size_t x_row = (size_t)H * P;   // elements between tokens
  const size_t bc_row = (size_t)G * N;
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * P;
  const T* dtb = dt + (size_t)b * S * H + h;
  const T* bb = Bm + (size_t)b * S * bc_row + (size_t)grp * N;
  const T* cb = Cm + (size_t)b * S * bc_row + (size_t)grp * N;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P;
  const int n_tiles = (chunk + kTile - 1) / kTile;

  // The next C_i and the next B_j, X_j in the order the loops below read
  // them, fetched one step ahead in the bfloat16 build (see the header).
  constexpr bool kAhead = sizeof(T) == 2;
  using TileBC = Tile<T, kUnitsBC>;
  using TileX = Tile<T, kUnitsX>;
  auto tile_c = [&](int cc, int ii) {  // C of chunk cc, row tile ii (none past S)
    return TileBC{c_s, pc, cb + (size_t)(cc + ii * kTile) * bc_row, bc_row,
                  cc < S ? min(kTile, chunk - ii * kTile) : 0, N, npad, vec_bc};
  };
  auto tile_b = [&](int cc, int jj) {
    return TileBC{b_s, pc, bb + (size_t)(cc + jj * kTile) * bc_row, bc_row,
                  cc < S ? min(kTile, chunk - jj * kTile) : 0, N, npad, vec_bc};
  };
  auto tile_x = [&](int cc, int jj) {
    return TileX{x_s, kLdX, xb + (size_t)(cc + jj * kTile) * x_row, x_row,
                 cc < S ? min(kTile, chunk - jj * kTile) : 0, P, kMaxP, vec_x};
  };
  TileBC nc = tile_c(0, 0), nb = tile_b(0, 0);
  TileX nx = tile_x(0, 0);
  if constexpr (kAhead) {
    nc.fetch();
    nb.fetch();
    nx.fetch();
  }

  for (int e = tid; e < npad * kLdX; e += kThreads) st_s[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    // ---- dt and cums = inclusive scan of dt * a over the chunk
    __syncthreads();  // the previous chunk's readers of dt/cums and the state are done
    float v = 0.0f;
    if (tid < chunk) {
      const float d = to_f(dtb[(size_t)(c0 + tid) * H]);
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
    const float cum_last = cums_s[chunk - 1];
    if (tid < chunk) wend_s[tid] = dt_s[tid] * expf(cum_last - cums_s[tid]);

    // state update of this warp: rows n0 + g (+ 8), columns 8 pt + 2t (+ 1)
    float upd[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) upd[pt][0] = upd[pt][1] = upd[pt][2] = upd[pt][3] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const int i_rows = min(kTile, chunk - i0);
      __syncthreads();  // c_s is free
      if constexpr (!kAhead) nc.fetch();
      nc.put();
      __syncthreads();
      nc = it + 1 < n_tiles ? tile_c(c0, it + 1) : tile_c(c0 + chunk, 0);
      if constexpr (kAhead) nc.fetch();

      // ---- y = exp(cums_i) * (C_i · state): rows r0 + g (+ 8), columns q0 + 8nt + 2t (+ 1)
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      {
        const float* ca = c_s + (r0 + g) * pc + t;
        const float* sb = st_s + t * kLdX + q0 + g;
#pragma unroll 2
        for (int kk = 0; kk < npad; kk += 8) {
          float av[4];
          uint32_t ah[4], al[4];
          rows_a(ca + kk, pc, av);
          to_tf32<kExact, 4>(av, ah, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float bv[2] = {sb[kk * kLdX + 8 * nt], sb[(kk + 4) * kLdX + 8 * nt]};
            uint32_t bh[2], bl[2];
            to_tf32<false, 2>(bv, bh, bl);
            mma_split<kExact, false>(acc[nt], ah, al, bh, bl);
          }
        }
      }
      {
        const int i = r0 + g;
        const float e0 = i < i_rows ? expf(cums_s[i0 + i]) : 0.0f;
        const float e1 = i + 8 < i_rows ? expf(cums_s[i0 + i + 8]) : 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }

      const bool last = it == n_tiles - 1;
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // b_s, x_s, w_s are free
        if constexpr (!kAhead) {
          nb.fetch();
          nx.fetch();
        }
        nb.put();
        nx.put();
        __syncthreads();
        {  // the next B and X: this row tile's next, the next row tile's or chunk's first
          const int cc = jt < it || it + 1 < n_tiles ? c0 : c0 + chunk;
          const int jj = jt < it ? jt + 1 : 0;
          nb = tile_b(cc, jj);
          nx = tile_x(cc, jj);
          if constexpr (kAhead) {
            nb.fetch();
            nx.fetch();
          }
        }

        // ---- scores C_i B_jᵀ, then W[i][j] = s exp(cums_i - cums_j) dt_j for j <= i
        float s[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
        {
          const float* ca = c_s + (r0 + g) * pc + t;
          const float* bq = b_s + (q0 + g) * pc + t;
#pragma unroll 2
          for (int kk = 0; kk < npad; kk += 8) {
            float av[4];
            uint32_t ah[4], al[4];
            rows_a(ca + kk, pc, av);
            to_tf32<kExact, 4>(av, ah, al);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float bv[2] = {bq[8 * nt * pc + kk], bq[8 * nt * pc + kk + 4]};
              uint32_t bh[2], bl[2];
              to_tf32<kExact, 2>(bv, bh, bl);
              mma_split<kExact, kExact>(s[nt], ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = r0 + g + 8 * (e >> 1);
            const int jl = q0 + 8 * nt + 2 * t + (e & 1);
            const int i = i0 + il;
            const int j = j0 + jl;
            float w = 0.0f;
            if (j <= i && i < chunk)  // exponent only where it is <= 0
              w = s[nt][e] * expf(cums_s[i] - cums_s[j]) * dt_s[j];
            w_s[il * kLdW + jl] = w;
          }
        }
        __syncthreads();

        // ---- y += W · X_j (K = the tile's 64 rows)
        {
          const float* wa = w_s + (r0 + g) * kLdW + t;
          const float* xq = x_s + t * kLdX + q0 + g;
#pragma unroll
          for (int kk = 0; kk < kTile; kk += 8) {
            float av[4];
            uint32_t ah[4], al[4];
            rows_a(wa + kk, kLdW, av);
            to_tf32<false, 4>(av, ah, al);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float bv[2] = {xq[kk * kLdX + 8 * nt], xq[(kk + 4) * kLdX + 8 * nt]};
              uint32_t bh[2], bl[2];
              to_tf32<kExact, 2>(bv, bh, bl);
              mma_split<false, kExact>(acc[nt], ah, al, bh, bl);
            }
          }
        }

        // ---- the last row tile walks every column tile once: gather the
        // state update (w_end ⊙ B_j)ᵀ X_j, A[n][j] = B_j[j][n] w_end_j
        if (last && updates) {
          const float* ba = b_s + t * pc + n0 + g;
          const float* xq = x_s + t * kLdX + g;
#pragma unroll
          for (int kk = 0; kk < kTile; kk += 8) {
            const int ja = j0 + kk + t;
            const float wa = ja < chunk ? wend_s[ja] : 0.0f;
            const float wb = ja + 4 < chunk ? wend_s[ja + 4] : 0.0f;
            const float* p = ba + kk * pc;
            const float av[4] = {p[0] * wa, p[8] * wa, p[4 * pc] * wb, p[4 * pc + 8] * wb};
            uint32_t ah[4], al[4];
            to_tf32<false, 4>(av, ah, al);
#pragma unroll
            for (int pt = 0; pt < 8; ++pt) {
              const float bv[2] = {xq[kk * kLdX + 8 * pt], xq[(kk + 4) * kLdX + 8 * pt]};
              uint32_t bh[2], bl[2];
              to_tf32<kExact, 2>(bv, bh, bl);
              mma_split<false, kExact>(upd[pt], ah, al, bh, bl);
            }
          }
        }
      }

      // ---- y for this row tile
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = r0 + g + 8 * e2;
        if (i >= i_rows) continue;
        T* yr = yb + (size_t)(c0 + i0 + i) * x_row;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = q0 + 8 * nt + 2 * t;
          if (p < P) store(yr + p, acc[nt][2 * e2]);
          if (p + 1 < P) store(yr + p + 1, acc[nt][2 * e2 + 1]);
        }
      }
    }

    // every row tile has read the old state (barriers in the tile loops)
    __syncthreads();
    if (updates) {
      const float decay = expf(cum_last);
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        float* sp = st_s + (n0 + g) * kLdX + 8 * pt + 2 * t;
        sp[0] = fmaf(sp[0], decay, upd[pt][0]);
        sp[1] = fmaf(sp[1], decay, upd[pt][1]);
        sp[8 * kLdX] = fmaf(sp[8 * kLdX], decay, upd[pt][2]);
        sp[8 * kLdX + 1] = fmaf(sp[8 * kLdX + 1], decay, upd[pt][3]);
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + (size_t)blockIdx.x * N * P;  // (b, h) = blockIdx.x
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P;
      const int p = e - n * P;
      so[e] = st_s[n * kLdX + p];
    }
  }
}

template <typename T>
int allow_smem(size_t smem) {
  return (int)cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int B, int S, int H, int G,
           int N, int P, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, chunk);
  const int e = allow_smem<T>(smem);
  if (e != 0) return e;
  // 8-element loads where widths and addresses allow them
  const bool vec_bc = N % 8 == 0 && ((uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  const bool vec_x = P % 8 == 0 && (uintptr_t)x % 16 == 0;
  ssd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bm, (const T*)Cm, (T*)y, state,
      S, H, G, N, P, chunk, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

template <typename T>
int info_of(int N, int chunk, int* info) {
  const size_t smem = smem_bytes(N, chunk);
  int err = allow_smem<T>(smem);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, ssd_kernel<T>);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_kernel<T>, kThreads,
                                                           smem);
  if (err != 0) return err;
  info[0] = attr.numRegs;
  info[1] = (int)smem;
  info[2] = kThreads;
  info[3] = blocks;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// xh (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N), y (B,S,H,P): contiguous device
// pointers of one dtype (0 float32, 1 bfloat16); A (H,) float32; state
// (B,H,N,P) float32 or null.  1 <= N <= 128, 1 <= P <= 64,
// 1 <= chunk <= 256, S a multiple of chunk, H a multiple of G.
extern "C" int tao_ssd_scan(const void* x, const void* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            float* state, int B, int S, int H, int G, int N,
                            int P, int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || N < 1 || N > kMaxN ||
      P < 1 || P > kMaxP || chunk < 1 || chunk > kMaxChunk || S % chunk != 0 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, G, N, P, chunk, s);
    case 1: return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, G, N, P, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What a launch for (N, chunk, dtype) gets, without launching: info[0]
// registers per thread, [1] dynamic shared bytes per block, [2] threads
// per block, [3] resident blocks per SM, [4] local (spill) bytes per
// thread.
extern "C" int tao_ssd_scan_info(int N, int chunk, int dtype, int* info, void* stream) {
  (void)stream;
  if (N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return info_of<float>(N, chunk, info);
    case 1: return info_of<__nv_bfloat16>(N, chunk, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
