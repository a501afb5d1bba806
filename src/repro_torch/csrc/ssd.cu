// Mamba-2 chunked SSD scan for Hopper (sm_90a), float32 or bfloat16 I/O.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd_kernel, line 26).  For xh (B,S,H,P), dt (B,S,H), Bm and Cm
// (B,S,G,N), all of one dtype, A (H,) float32, head h reading group
// h / (H/G), it computes y (B,S,H,P) in that dtype and, on request, the
// final (B,H,N,P) float32 state.  All arithmetic is float32.  Per chunk of
// c tokens, with cums the inclusive prefix sum of dt·A over the chunk:
//
//   y_diag = (L ⊙ C Bᵀ) diag(dt) X,   L[i,j] = exp(cums_i − cums_j), j ≤ i
//   y_off  = exp(cums) ⊙ (C · state)
//   state' = state·exp(cums_last) + Bᵀ diag(dt·exp(cums_last − cums)) X
//
// The TPU kernel runs a sequential chunk grid axis with the (N, P) state in
// VMEM and the whole c × c chunk matrix in one MXU step.  Here one block of
// 256 threads owns one (batch, head) and walks the chunks in a loop, the
// state in shared memory between them (stored transposed, (P, N), so every
// product below reads float4 along its contraction axis).  A chunk of 256
// is too large for shared memory whole (its c × c float32 matrix alone is
// 256 KB), so it is cut into 64-row tiles: for each row tile i, y_off from
// the old state, then for each column tile j ≤ i the 64 × 64 score tile
// C_i B_jᵀ, masked and weighted into W, and y += W X_j.  While the last row
// tile walks the column tiles — every tile of B and X once — each thread
// also gathers its 32 entries of the state update in registers; they are
// written after a barrier, once every row tile has read the old state.
// Each thread holds 4 × 4 outputs of every 64 × 64 product (rows ty + 16k,
// columns tx + 16l), so a warp reads shared memory without bank conflicts.
//
// Numerics: cums only decreases (A < 0, dt ≥ 0) and reaches −10³ within a
// chunk at the full width, so exp(−cums_j) would overflow; every exponent
// is a difference of two cums taken as one argument (≤ 0), and the upper
// triangle j > i is never exponentiated (exp there could be inf, and
// inf · 0 is NaN).  Rows past the end of the last, partial row tile are
// zeros and are never written.
//
// What bounds it on the H100: at the mamba2-1.3b prefill shape (B 4, S 2048,
// H 64, P 64, N 128, c 256, bf16) it moves 148 MB (0.044 ms at 3.35 TB/s)
// and does 34.9 GFLOP (0.52 ms at 67 TFLOP/s float32), so operations bound
// it.  This first version runs on the CUDA cores at one block per SM
// (139 KB of shared memory), so the 256 blocks take two waves, and it
// recomputes C Bᵀ for every head of a group; tensor cores (wgmma), TMA and
// sharing the scores across a group's heads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows of a chunk tile
constexpr int kMaxN = 128;     // d_state
constexpr int kMaxP = 64;      // head_dim
constexpr int kMaxChunk = 256;
constexpr int kLdT = kTile + 4;  // row stride of the (64, 64) tiles
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Row stride of the (rows, N) tiles: N rounded up to 4, plus 4, so float4
// reads stay aligned and rows tx + 16l fall on different banks.
__host__ __device__ __forceinline__ int ld_n(int N) { return ((N + 3) & ~3) + 4; }

size_t smem_bytes(int N, int chunk) {
  const size_t ldn = ld_n(N);
  return (2 * kTile * ldn       // C row tile, B column tile
          + kMaxP * ldn         // state, transposed (P, N)
          + 2 * kMaxP * kLdT    // X column tile transposed (P, j); W (i, j)
          + 3 * (size_t)chunk   // dt, cums, dt * exp(cums_last - cums)
          + 8) * sizeof(float);  // warp totals of the scan
}

// rows [t0, t0 + kTile) of a (.., width) slab with row stride `stride`
// (elements) into dst[r * ld + k]; rows at or past `rows` and columns at
// or past `width` (up to the padded width `wpad`) are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, size_t stride,
                          int rows, int width, int wpad) {
  for (int e = threadIdx.x; e < kTile * wpad; e += kThreads) {
    const int r = e / wpad;
    const int k = e - r * wpad;
    dst[r * ld + k] = (r < rows && k < width) ? to_f(src[r * stride + k]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int G, int N, int P,
           int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = ld_n(N);
  const int n4 = ldn - 4;
  float* c_s = smem;                      // [kTile][ldn]  C_i
  float* b_s = c_s + kTile * ldn;         // [kTile][ldn]  B_j
  float* st_s = b_s + kTile * ldn;        // [kMaxP][ldn]  state (p, n)
  float* xt_s = st_s + kMaxP * ldn;       // [kMaxP][kLdT] X_j transposed (p, j)
  float* w_s = xt_s + kMaxP * kLdT;       // [kTile][kLdT] W (i, j)
  float* dt_s = w_s + kTile * kLdT;       // [chunk]
  float* cums_s = dt_s + chunk;           // [chunk]
  float* wend_s = cums_s + chunk;         // [chunk]
  float* warp_s = wend_s + chunk;         // [8]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const size_t x_row = (size_t)H * P;   // elements between tokens
  const size_t bc_row = (size_t)G * N;
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * P;
  const T* dtb = dt + (size_t)b * S * H + h;
  const T* bb = Bm + (size_t)b * S * bc_row + (size_t)g * N;
  const T* cb = Cm + (size_t)b * S * bc_row + (size_t)g * N;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P;
  const int n_tiles = (chunk + kTile - 1) / kTile;

  for (int e = tid; e < kMaxP * ldn; e += kThreads) st_s[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    // ---- dt and cums = inclusive scan of dt * a over the chunk
    __syncthreads();  // the previous chunk's readers of dt/cums are done
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

    float upd[4][2][4];  // state update, rows p = ty + 16k, n = 4tx + 64m + q
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) upd[k][m][q] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const int i_rows = min(kTile, chunk - i0);
      __syncthreads();  // c_s is free
      load_rows(c_s, ldn, cb + (size_t)(c0 + i0) * bc_row, bc_row, i_rows, N, n4);
      __syncthreads();

      // y_off = exp(cums_i) * (C_i · state), rows i = ty + 16k, p = tx + 16l
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] = 0.0f;
      for (int n = 0; n < n4; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = *(const float4*)&c_s[(ty + 16 * k) * ldn + n];
#pragma unroll
        for (int l = 0; l < 4; ++l) sv[l] = *(const float4*)&st_s[(tx + 16 * l) * ldn + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[k][l] = dot4(cv[k], sv[l], acc[k][l]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = ty + 16 * k;
        const float e = i < i_rows ? expf(cums_s[i0 + i]) : 0.0f;
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] *= e;
      }

      const bool last = it == n_tiles - 1;
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        const int j_rows = min(kTile, chunk - j0);
        __syncthreads();  // b_s, xt_s, w_s are free
        load_rows(b_s, ldn, bb + (size_t)(c0 + j0) * bc_row, bc_row, j_rows, N, n4);
        for (int e = tid; e < kTile * kMaxP; e += kThreads) {
          const int r = e / kMaxP;
          const int p = e - r * kMaxP;
          xt_s[p * kLdT + r] =
              (r < j_rows && p < P) ? to_f(xb[(size_t)(c0 + j0 + r) * x_row + p]) : 0.0f;
        }
        __syncthreads();

        // W[i][j] = (C_i · B_j) exp(cums_i - cums_j) dt_j for j <= i, else 0
        float s[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) s[k][l] = 0.0f;
        for (int n = 0; n < n4; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) cv[k] = *(const float4*)&c_s[(ty + 16 * k) * ldn + n];
#pragma unroll
          for (int l = 0; l < 4; ++l) bv[l] = *(const float4*)&b_s[(tx + 16 * l) * ldn + n];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int l = 0; l < 4; ++l) s[k][l] = dot4(cv[k], bv[l], s[k][l]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + ty + 16 * k;
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int j = j0 + tx + 16 * l;
            float w = 0.0f;
            if (j <= i && i < chunk)  // exponent only where it is <= 0
              w = s[k][l] * expf(cums_s[i] - cums_s[j]) * dt_s[j];
            w_s[(ty + 16 * k) * kLdT + tx + 16 * l] = w;
          }
        }
        __syncthreads();

        // y += W · X_j, rows i = ty + 16k, p = tx + 16l
        for (int j = 0; j < kTile; j += 4) {
          float4 wv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) wv[k] = *(const float4*)&w_s[(ty + 16 * k) * kLdT + j];
#pragma unroll
          for (int l = 0; l < 4; ++l) xv[l] = *(const float4*)&xt_s[(tx + 16 * l) * kLdT + j];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int l = 0; l < 4; ++l) acc[k][l] = dot4(wv[k], xv[l], acc[k][l]);
        }

        // the last row tile walks every column tile once: gather the state
        // update sum_j X_j[p] dt_j exp(cums_last - cums_j) B_j[n]
        if (last) {
          for (int j = 0; j < j_rows; ++j) {
            const float wj = wend_s[j0 + j];
            float xs[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) xs[k] = xt_s[(ty + 16 * k) * kLdT + j] * wj;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int n = 4 * tx + 64 * m;
              if (n < n4) {
                const float4 bv = *(const float4*)&b_s[j * ldn + n];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  upd[k][m][0] = fmaf(xs[k], bv.x, upd[k][m][0]);
                  upd[k][m][1] = fmaf(xs[k], bv.y, upd[k][m][1]);
                  upd[k][m][2] = fmaf(xs[k], bv.z, upd[k][m][2]);
                  upd[k][m][3] = fmaf(xs[k], bv.w, upd[k][m][3]);
                }
              }
            }
          }
        }
      }

#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = ty + 16 * k;
        if (i >= i_rows) continue;
        T* yr = yb + (size_t)(c0 + i0 + i) * x_row;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int p = tx + 16 * l;
          if (p < P) store(yr + p, acc[k][l]);
        }
      }
    }

    // every row tile has read the old state (barriers in the tile loops)
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ty + 16 * k;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int n = 4 * tx + 64 * m;
        if (n < n4) {
          float* sp = &st_s[p * ldn + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) sp[q] = fmaf(sp[q], decay, upd[k][m][q]);
        }
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + (size_t)blockIdx.x * N * P;  // (b, h) = blockIdx.x
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P;
      const int p = e - n * P;
      so[e] = st_s[p * ldn + n];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int B, int S, int H, int G,
           int N, int P, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, chunk);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bm, (const T*)Cm, (T*)y, state,
      S, H, G, N, P, chunk);
  return (int)cudaGetLastError();
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
