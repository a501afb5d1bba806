// Online-softmax attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/kernel.py
// (flash_attention_kernel, line 38): out = softmax(q k^T / sqrt(D) + mask) v
// over (B, H, S, D) operands, with
//   * causal masking of key j for query row i at absolute position
//     q_offset + i (j <= q_offset + i), key tiles past the block's last
//     visible key skipped, and tiles above a row's diagonal skipped;
//   * optional segment ids (B, Sk): a row sees only keys of its own
//     segment; a row whose absolute position is past Sk has segment -2;
//   * fully masked rows finalizing to 0;
//   * Sq != Sk and a value width Dv != D (both up to 128).
//
// The TPU kernel runs a sequential key-block grid axis with (m, l, acc) in
// VMEM scratch and 128-wide MXU tiles.  Here one block of 4 warps takes 32
// query rows of one (batch, head) — 8 rows per warp — and keeps each row's
// running max, sum and Dv accumulators in registers (lane c holds output
// columns c, c + 32, ...).  Keys stream through shared memory 32 at a time,
// one key per lane: the lane computes its key's score against the row
// (K rows padded to D + 1 floats, so the 32 lanes hit 32 banks), the warp
// reduces max and sum with shuffles, and p_j is broadcast by __shfl_sync
// into the p·V update, where lanes read consecutive V columns.  Any Sk
// works; the Tao window (S = 129, D = 32) is 5 key tiles.
//
// What bounds it on the H100: at the Tao shape (64, 4, 129, 32) the two
// bounds are close — 16.9 MB of q/k/v/out over 3.35 TB/s is 5.0 us, and
// the 2.1 M visible (query, key) pairs at 4·D float32 FLOPs each over
// 67 TFLOP/s is 4.1 us.  This first version runs on the CUDA cores (no
// tensor cores) and is far from either: each staged K/V tile is reused by
// 32 rows, so device-memory traffic stays near one read of k and v per
// query tile, but the per-row work is a chain of shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKTile = 32;                     // keys per tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int DV_CHUNKS>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int32_t* __restrict__ seg,
                 float* __restrict__ out, int H, int Sq, int Sk, int D, int Dv,
                 int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kQTile][D]
  float* k_s = q_s + kQTile * D;            // [kKTile][D + 1]
  float* v_s = k_s + kKTile * (D + 1);      // [kKTile][Dv]
  int* segk_s = (int*)(v_s + kKTile * Dv);  // [kKTile]

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * kQTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * Dv;

  for (int i = threadIdx.x; i < kQTile * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = q0 + r < Sq ? qb[(size_t)q0 * D + i] : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DV_CHUNKS];
  int segq[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < DV_CHUNKS; ++c) acc[rr][c] = 0.0f;
    const int qpos = q_offset + q0 + warp * kRowsPerWarp + rr;
    segq[rr] = seg == nullptr ? 0 : (qpos < Sk ? seg[(size_t)b * Sk + qpos] : -2);
  }

  // keys past the block's last visible key are dead for all its rows
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kQTile, Sq)) : Sk;
  for (int kt = 0; kt < k_end; kt += kKTile) {
    const int kn = min(kKTile, Sk - kt);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kKTile * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      k_s[j * (D + 1) + c] = j < kn ? kb[(size_t)kt * D + i] : 0.0f;
    }
    for (int i = threadIdx.x; i < kKTile * Dv; i += kThreads) {
      const int j = i / Dv;
      v_s[i] = j < kn ? vb[(size_t)kt * Dv + i] : 0.0f;
    }
    if (threadIdx.x < kKTile)
      segk_s[threadIdx.x] =
          seg == nullptr ? 0
                         : (threadIdx.x < kn ? seg[(size_t)b * Sk + kt + threadIdx.x] : -1);
    __syncthreads();

    const int kj = kt + lane;
    const float* kr = k_s + lane * (D + 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int qrow = warp * kRowsPerWarp + rr;
      const int qpos = q_offset + q0 + qrow;
      if (causal && kt > qpos) continue;  // tile above this row's diagonal
      const float* qr = q_s + qrow * D;
      float s = 0.0f;
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      bool valid = lane < kn;
      if (causal) valid = valid && kj <= qpos;
      if (seg != nullptr) valid = valid && segk_s[lane] == segq[rr];
      s = valid ? s * scale : kNegInf;
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float m_new = fmaxf(m[rr], mt);
      const float p = valid ? expf(s - m_new) : 0.0f;
      const float corr = expf(m[rr] - m_new);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l[rr] = l[rr] * corr + ps;
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < DV_CHUNKS; ++c) acc[rr][c] *= corr;
      for (int j = 0; j < kn; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = v_s + j * Dv;
#pragma unroll
        for (int c = 0; c < DV_CHUNKS; ++c) {
          const int d = c * 32 + lane;
          if (d < Dv) acc[rr][c] = fmaf(pj, vr[d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[rr], 1e-30f);
    float* o = out + ((size_t)bh * Sq + row) * Dv;
#pragma unroll
    for (int c = 0; c < DV_CHUNKS; ++c) {
      const int d = c * 32 + lane;
      if (d < Dv) o[d] = acc[rr][c] * inv;
    }
  }
}

template <int DV_CHUNKS>
int launch(const float* q, const float* k, const float* v, const int32_t* seg,
           float* out, int B, int H, int Sq, int Sk, int D, int Dv,
           int causal, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kQTile * D + kKTile * (D + 1) + kKTile * Dv) *
                          sizeof(float) + kKTile * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<DV_CHUNKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kQTile - 1) / kQTile);
  attention_kernel<DV_CHUNKS><<<grid, kThreads, smem, stream>>>(
      q, k, v, seg, out, H, Sq, Sk, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B,H,Sq,D), k (B,H,Sk,D), v (B,H,Sk,Dv), out (B,H,Sq,Dv): contiguous
// float32 device pointers; seg (B,Sk) int32 or null.  1 <= D, Dv <= 128.
extern "C" int tao_flash_attention(const float* q, const float* k,
                                   const float* v, const int32_t* seg,
                                   float* out, int B, int H, int Sq, int Sk,
                                   int D, int Dv, int causal, int q_offset,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || Dv < 1 ||
      Dv > 128 || q_offset < 0 || (Sq + kQTile - 1) / kQTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((Dv + 31) / 32) {
    case 1: return launch<1>(q, k, v, seg, out, B, H, Sq, Sk, D, Dv, causal, q_offset, scale, s);
    case 2: return launch<2>(q, k, v, seg, out, B, H, Sq, Sk, D, Dv, causal, q_offset, scale, s);
    case 3: return launch<3>(q, k, v, seg, out, B, H, Sq, Sk, D, Dv, causal, q_offset, scale, s);
    default: return launch<4>(q, k, v, seg, out, B, H, Sq, Sk, D, Dv, causal, q_offset, scale, s);
  }
}
