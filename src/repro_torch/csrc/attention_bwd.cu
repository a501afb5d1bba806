// The backward of the online-softmax attention (attention.cu), for Hopper
// (sm_90a), float32.
//
// The port's own kernel: the reference has no backward of its attention
// kernel (no custom_vjp under src/repro/kernels/); its trainer
// differentiates the jnp attention of src/repro/core/model.py:217.  This
// gives the same gradients from the forward's output and its per-row
// log-sum-exp, the FlashAttention-2 way, recomputing the probabilities
// instead of storing them:
//
//   s = q k^T * scale, P = 2^(s * log2(e) - lse)      (lse in base 2, as the
//                                                       forward stores it)
//   delta_i = sum_c dO_ic O_ic
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// What it takes: causal or not, no segment ids, q_offset 0, Sq == Sk = S,
// D == Dv <= 128; q, k, v, o, dO read and dq, dk, dv written at their
// (batch, head, sequence) strides with the last dimension contiguous.
//
// Three kernels on one stream, no atomics, so two calls give the same bits:
//   * bwd_delta: one warp per row, delta = rowsum(dO o) by a fixed
//     shuffle tree;
//   * bwd_dkdv: one block per (batch, head, 64-key tile), walking the
//     64-row query tiles that can see its keys (under causal masking, the
//     ones from the tile's diagonal on); per query tile it recomputes the
//     64 x 64 P and dS in registers, stores them in shared memory, then
//     each thread adds its keys' rows of dV and dK;
//   * bwd_dq: one block per (batch, head, 64-row query tile), walking the
//     key tiles its rows can see (up to its diagonal), recomputing dS the
//     same way and adding its rows of dQ.
// Both recompute P and dP (the cost of having no atomics: the scores are
// computed twice).  Every product is a plain float32 FMA on the CUDA
// cores.  Phase A (scores) gives each thread a 4 x 4 tile of (query, key)
// pairs, rows ty + 16i and keys tx + 16j, so a warp reads 16 consecutive
// key rows (pitch D + 1: 16 banks) and 2 query rows (broadcasts); phase B
// (the products with dS and P) gives each thread one output row and every
// fourth column, so a warp reads one shared row of dS or P per step and
// broadcasts the other operand.
//
// What bounds it on the H100: at the Tao training shape (16, 4, 129, 32),
// causal, it must move 7 tensors of B*H*S*D floats (q, k, v, o, dO in; dq,
// dk, dv out), 7.4 MB, 2.2 us at 3.35 TB/s, and do ~10 D FLOPs per visible
// (query, key) pair (the scores and dP twice each, dV, dK, dQ; 8,385 pairs
// per (batch, head)), 172 MFLOP, 2.6 us at 67 TFLOP/s float32: operations
// bind, barely.  This first version does not come near: it computes whole
// 64 x 64 tiles (129 keys take three tiles, the last holding one key), and
// phase B reads shared memory about once per FMA, so shared-memory
// bandwidth and the tiles' waste set its time.  mma.sync or wgmma tiles
// (as the forward's 3xTF32 split) are the redesign; PERF.md has the times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads in phase A
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;  // (B, H, S) contiguous, base 2
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* delta;      // (B, H, S) contiguous scratch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, S, D;
  int causal;
  float scale;       // 1 / sqrt(D)
  float qscale;      // scale * log2(e)
};

__device__ __forceinline__ const float* row_ptr(const float* base, const Strides& st, int b, int h,
                                                int s) {
  return base + b * st.b + h * st.h + s * st.s;
}

// rows [r0, r0 + kTile) of one (batch, head) into dst at pitch D + 1,
// zero past S
__device__ __forceinline__ void load_tile(float* dst, const float* base, const Strides& st, int b,
                                          int h, int r0, const Params& p) {
  const int pitch = p.D + 1;
  for (int i = threadIdx.x; i < kTile * p.D; i += blockDim.x) {
    const int r = i / p.D;
    const int c = i - r * p.D;
    const int s = r0 + r;
    dst[r * pitch + c] = s < p.S ? row_ptr(base, st, b, h, s)[c] : 0.0f;
  }
}

// per-row statistics of a query tile: lse and delta (+inf / 0 past S, so
// those rows' P is 0)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, int bh, int r0,
                                          const Params& p) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int s = r0 + i;
    const long long at = (long long)bh * p.S + s;
    lse_s[i] = s < p.S ? p.lse[at] : __int_as_float(0x7f800000);
    delta_s[i] = s < p.S ? p.delta[at] : 0.0f;
  }
}

// Phase A for one (query tile, key tile): this thread's 4 x 4 of P and
// dS, rows ty + 16i of the query tile and keys tx + 16j of the key tile.
// Masked pairs (past S, or a key after the row under causal masking) get
// P = dS = 0.
__device__ __forceinline__ void scores(float (&P)[4][4], float (&dS)[4][4], const float* q_s,
                                       const float* do_s, const float* k_s, const float* v_s,
                                       const float* lse_s, const float* delta_s, int q0, int k0,
                                       const Params& p) {
  const int pitch = p.D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int c = 0; c < p.D; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = q_s[(ty + 16 * i) * pitch + c];
      da[i] = do_s[(ty + 16 * i) * pitch + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = k_s[(tx + 16 * j) * pitch + c];
      vb[j] = v_s[(tx + 16 * j) * pitch + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < p.S && kpos < p.S && (!p.causal || kpos <= qpos);
      const float pr = ok ? exp2f(s[i][j] * p.qscale - lse_s[r]) : 0.0f;
      P[i][j] = pr;
      dS[i][j] = pr * (dp[i][j] - delta_s[r]);
    }
  }
}

// delta = rowsum(dO o): one warp per row
__global__ void __launch_bounds__(kThreads) bwd_delta(const Params p, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int bh = row / p.S;
  const int s = row - bh * p.S;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const float* o = row_ptr(p.o, p.so, b, h, s);
  const float* d = row_ptr(p.dout, p.sdo, b, h, s);
  float acc = 0.0f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(d[c], o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// One block per (batch, head, key tile): dK and dV of the tile's keys.
template <int DP>  // D rounded up to 32, 64 or 128
__global__ void __launch_bounds__(kThreads) bwd_dkdv(const Params p) {
  extern __shared__ float smem[];
  const int pitch = p.D + 1;
  float* k_s = smem;                    // [kTile][pitch]
  float* v_s = k_s + kTile * pitch;
  float* q_s = v_s + kTile * pitch;
  float* do_s = q_s + kTile * pitch;
  float* p_s = do_s + kTile * pitch;    // [kTile query rows][kTile + 1]
  float* ds_s = p_s + kTile * (kTile + 1);
  float* lse_s = ds_s + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int k0 = blockIdx.y * kTile;
  load_tile(k_s, p.k, p.sk, b, h, k0, p);
  load_tile(v_s, p.v, p.sv, b, h, k0, p);

  // phase B: this thread's key row and every fourth column
  const int kr = threadIdx.x & (kTile - 1);
  const int cg = threadIdx.x >> 6;  // 0..3
  float dk[DP / 4], dv[DP / 4];
#pragma unroll
  for (int u = 0; u < DP / 4; ++u) dk[u] = dv[u] = 0.0f;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qt0 = p.causal ? k0 / kTile : 0;  // query tiles from the diagonal on
  const int nqt = (p.S + kTile - 1) / kTile;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(q_s, p.q, p.sq, b, h, q0, p);
    load_tile(do_s, p.dout, p.sdo, b, h, q0, p);
    load_rows(lse_s, delta_s, bh, q0, p);
    __syncthreads();
    float P[4][4], dS[4][4];
    scores(P, dS, q_s, do_s, k_s, v_s, lse_s, delta_s, q0, k0, p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = P[i][j];
        ds_s[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = dS[i][j];
      }
    __syncthreads();
    const int rows = min(kTile, p.S - q0);
    for (int r = 0; r < rows; ++r) {
      const float pr = p_s[r * (kTile + 1) + kr];
      const float dsr = ds_s[r * (kTile + 1) + kr];
#pragma unroll
      for (int u = 0; u < DP / 4; ++u) {
        const int c = cg + 4 * u;
        if (c < p.D) {
          dv[u] = fmaf(pr, do_s[r * pitch + c], dv[u]);
          dk[u] = fmaf(dsr, q_s[r * pitch + c], dk[u]);
        }
      }
    }
  }
  const int kpos = k0 + kr;
  if (kpos >= p.S) return;
  float* dkr = p.dk + b * p.sdk.b + h * p.sdk.h + kpos * p.sdk.s;
  float* dvr = p.dv + b * p.sdv.b + h * p.sdv.h + kpos * p.sdv.s;
#pragma unroll
  for (int u = 0; u < DP / 4; ++u) {
    const int c = cg + 4 * u;
    if (c < p.D) {
      dkr[c] = dk[u] * p.scale;
      dvr[c] = dv[u];
    }
  }
}

// One block per (batch, head, query tile): dQ of the tile's rows.
template <int DP>
__global__ void __launch_bounds__(kThreads) bwd_dq(const Params p) {
  extern __shared__ float smem[];
  const int pitch = p.D + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * pitch;
  float* k_s = do_s + kTile * pitch;
  float* v_s = k_s + kTile * pitch;
  float* ds_s = v_s + kTile * pitch;    // [kTile rows][kTile + 1]
  float* lse_s = ds_s + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = blockIdx.y * kTile;
  load_tile(q_s, p.q, p.sq, b, h, q0, p);
  load_tile(do_s, p.dout, p.sdo, b, h, q0, p);
  load_rows(lse_s, delta_s, bh, q0, p);

  const int qr = threadIdx.x & (kTile - 1);
  const int cg = threadIdx.x >> 6;
  float dq[DP / 4];
#pragma unroll
  for (int u = 0; u < DP / 4; ++u) dq[u] = 0.0f;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kend = p.causal ? min(p.S, q0 + kTile) : p.S;  // keys its rows can see
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    load_tile(k_s, p.k, p.sk, b, h, k0, p);
    load_tile(v_s, p.v, p.sv, b, h, k0, p);
    __syncthreads();
    float P[4][4], dS[4][4];
    scores(P, dS, q_s, do_s, k_s, v_s, lse_s, delta_s, q0, k0, p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = dS[i][j];
    __syncthreads();
    const int keys = min(kTile, kend - k0);
    for (int j = 0; j < keys; ++j) {
      const float dsr = ds_s[qr * (kTile + 1) + j];
#pragma unroll
      for (int u = 0; u < DP / 4; ++u) {
        const int c = cg + 4 * u;
        if (c < p.D) dq[u] = fmaf(dsr, k_s[j * pitch + c], dq[u]);
      }
    }
  }
  const int qpos = q0 + qr;
  if (qpos >= p.S) return;
  float* dqr = p.dq + b * p.sdq.b + h * p.sdq.h + qpos * p.sdq.s;
#pragma unroll
  for (int u = 0; u < DP / 4; ++u) {
    const int c = cg + 4 * u;
    if (c < p.D) dqr[c] = dq[u] * p.scale;
  }
}

size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile);
}

template <int DP>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t s1 = dkdv_smem(p.D), s2 = dq_smem(p.D);
  if (s1 > kMaxSmem) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(bwd_dkdv<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)s1);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != 0) return err;
  const int rows = B * p.H * p.S;
  bwd_delta<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(p, rows);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid(B * p.H, (p.S + kTile - 1) / kTile);
  bwd_dkdv<DP><<<grid, kThreads, s1, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  bwd_dq<DP><<<grid, kThreads, s2, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, o, dout, dq, dk, dv: (B, H, S, D) float32 device pointers with
// element strides (batch, head, sequence) given as 8 triples in that
// order and a contiguous last dimension; lse (B, H, S) float32 contiguous,
// base 2, as tao_flash_attention writes it; delta (B, H, S) float32
// scratch.  1 <= D <= 128, no segment ids, q_offset 0.
extern "C" int tao_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o, const float* lse,
    const float* dout, float* dq, float* dk, float* dv, float* delta, const long long* strides,
    int B, int H, int S, int D, int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > 128 || (long long)B * H > 2147483647LL ||
      (S + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  Params p{q, k, v, o, lse, dout, dq, dk, dv, delta,
           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
           H, S, D, causal, scale, scale * kLog2e};
  const cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(p, B, s);
  if (D <= 64) return launch<64>(p, B, s);
  return launch<128>(p, B, s);
}
