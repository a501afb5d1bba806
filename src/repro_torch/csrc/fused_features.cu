// Fused trace-to-features kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused/kernel.py
// (fused_feature_kernel, line 49): one launch per engine batch of n trace
// positions turns ten raw columns into every model input —
//   regbits (n, 32)   dst/src1/src2 against the 32 registers,
//   flags   (n, 5)    is_branch, taken, is_mem, is_store, is_fp,
//   brhist  (n, N_q)  the branch's bucket row of the (N_b, N_q) outcome
//                     table, most recent first (0 off branches),
//   memdist (n, N_m)  signed-log of the deltas to the last N_m memory
//                     addresses (0 off memory ops / past the fill),
// and carries the scan state (table, address queue + fill count) from one
// batch into the next.  The state is functional: the incoming table and
// queue are read only and the outgoing ones go to separate buffers, so one
// state can be passed again (a retry, two runs from one start).
//
// The TPU kernel walks positions in one sequential loop with the table in
// VMEM.  Blocks on the card run in no order and carry nothing between
// them, so the state threads across LAUNCHES through device tensors and
// each scan is rewritten in a parallel form:
//   * branch history — one warp per bucket.  With N_q <= 32, lane j holds
//     slot j of the bucket's queue in a register.  The warp walks the
//     batch 32 positions at a time, finds its bucket's branches with
//     __ballot_sync, stores its row at each (one 128 B store) and pushes
//     the outcome with __shfl_up_sync.  The warp reads its row of the
//     incoming table at the start and writes it to the outgoing table at
//     the end.
//   * memory distance — the lag-gather form of core/features.py with the
//     carry prepended: an exclusive prefix count of is_mem gives each
//     access its rank r, and slot k is addr - compacted[r-1-k], or the
//     carried queue[k-r] while k-r < fill.  Every output is independent.
//     Addresses and the queue are int64 and the delta is taken in int64,
//     then rounded to float32 through float64 as the NumPy specification
//     does (int64 -> float64 -> float32), so any address is exact (the
//     TPU kernel's int32 deltas need |addr| < 2^30).
//     The block holding the last position writes the outgoing queue.
//   * regbits / flags — parallel over positions, one warp per row.
// The signed-log runs here, with __fadd_rn/__fmul_rn/__fdiv_rn in exactly
// the order of core/features.py::signed_log, so no multiply-add is
// contracted into an fma and the output is bitwise the NumPy
// specification's (one launch instead of ~20 eager ops).
//
// What bounds it on the H100: bytes.  Per position it reads 32 B of
// columns and writes (32 + 5 + N_q + N_m) * 4 B = 532 B of features at the
// default configuration; the branch warps re-read the batch's 5 B/position
// of keys from L2 through shared-memory tiles, once per block of 8 buckets.
// The design keeps every output store a coalesced 128 B warp row and
// stages the keys and the compacted addresses in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;      // positions per position-role block
constexpr int kBrTile = 2048;   // branch keys staged in shared memory per step
constexpr int kFlags = 5;
constexpr unsigned kFull = 0xffffffffu;

// Op.FALU / Op.FMUL / Op.FDIV (uarch/isa.py): the opcodes that set is_fp
constexpr int kOpFalu = 3;
constexpr int kOpFmul = 4;
constexpr int kOpFdiv = 5;

// float32 bit patterns of SIGNED_LOG_SQRT2 and SIGNED_LOG_COEFFS
// (core/features.py, k = 1, 3, ..., 13); tests/test_torch_features.py holds
// them to the Python constants.
#define SL_SQRT2 0x3fb504f3u
#define SL_C1 0x4038aa3bu
#define SL_C3 0x3f76384fu
#define SL_C5 0x3f13bb63u
#define SL_C7 0x3ed30bb1u
#define SL_C9 0x3ea4258au
#define SL_C11 0x3e864d42u
#define SL_C13 0x3e6347abu

__device__ __forceinline__ float horner_step(float p, float z, unsigned c) {
  return __fadd_rn(__fmul_rn(p, z), __uint_as_float(c));
}

// core/features.py::signed_log, one correctly rounded float32 op per step.
__device__ __forceinline__ float signed_log_rn(float d) {
  const float a = fabsf(d);
  const float x = __fadd_rn(a, 1.0f);
  const int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m > __uint_as_float(SL_SQRT2)) {
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  const float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float z = __fmul_rn(s, s);
  float p = __uint_as_float(SL_C13);
  p = horner_step(p, z, SL_C11);
  p = horner_step(p, z, SL_C9);
  p = horner_step(p, z, SL_C7);
  p = horner_step(p, z, SL_C5);
  p = horner_step(p, z, SL_C3);
  p = horner_step(p, z, SL_C1);
  float r = __fmul_rn(p, s);
  r = __fadd_rn(r, (float)e);  // e is a small integer: exact
  r = __fmul_rn(r, 0.03125f);
  return d < 0.0f ? -r : r;
}

struct Args {
  const int32_t* bucket;
  const int64_t* addr;
  const int32_t* opcode;
  const int32_t* dst;
  const int32_t* src1;
  const int32_t* src2;
  const uint8_t* is_branch;
  const uint8_t* taken;
  const uint8_t* is_mem;
  const uint8_t* is_store;
  const float* table_in;  // (n_buckets, n_queue)
  float* table_out;       // (n_buckets, n_queue)
  const int64_t* mq_in;   // (n_mem + 1): queue slots, then the fill count
  int64_t* mq_out;        // (n_mem + 1)
  float* regbits;
  float* flags;
  float* brhist;
  float* memdist;
  int n, n_buckets, n_queue, n_mem;
};

// One warp per bucket: the bucket's queue lives in the warp's registers.
__device__ void branch_role(const Args& g, int block, int* keys) {
  const int lane = threadIdx.x & 31;
  const int b = block * kWarps + (threadIdx.x >> 5);
  const bool active = b < g.n_buckets;  // warp-uniform
  const size_t row = (size_t)b * g.n_queue;
  float q = (active && lane < g.n_queue) ? g.table_in[row + lane] : 0.0f;
  for (int t0 = 0; t0 < g.n; t0 += kBrTile) {
    const int cnt = min(kBrTile, g.n - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const int p = t0 + i;
      // key = bucket * 2 + taken on branches, -1 elsewhere
      keys[i] = g.is_branch[p] ? g.bucket[p] * 2 + (g.taken[p] ? 1 : 0) : -1;
    }
    __syncthreads();
    if (!active) continue;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int key = i0 + lane < cnt ? keys[i0 + lane] : -1;
      unsigned hits = __ballot_sync(kFull, key >= 0 && (key >> 1) == b);
      while (hits) {
        const int j = __ffs(hits) - 1;
        hits &= hits - 1;
        const int kj = __shfl_sync(kFull, key, j);
        if (lane < g.n_queue)
          g.brhist[(size_t)(t0 + i0 + j) * g.n_queue + lane] = q;
        const float up = __shfl_up_sync(kFull, q, 1);
        q = lane == 0 ? ((kj & 1) ? 1.0f : -1.0f) : up;
      }
    }
  }
  if (active && lane < g.n_queue) g.table_out[row + lane] = q;
}

// core/features.py::_memory_distance: the int64 delta (wrapping, as NumPy
// does), to float64, to float32, each rounded to nearest even.
__device__ __forceinline__ float delta_f32(int64_t a, int64_t b) {
  const long long d = (long long)((unsigned long long)a - (unsigned long long)b);
  return __double2float_rn(__ll2double_rn(d));
}

// kTile positions: ranks of the memory ops, then one warp per row.
__device__ void position_role(const Args& g, int tile, char* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = tile * kTile;
  const int p1 = min(p0 + kTile, g.n);
  int64_t* queue = (int64_t*)smem;       // [n_mem] incoming address queue
  int64_t* comp = queue + g.n_mem;       // [n_mem + kTile] compacted addresses
  int* warp_cnt = (int*)(comp + g.n_mem + kTile);  // [kWarps]
  int* rank = warp_cnt + kWarps;         // [kTile] rank of each position here

  // r0: memory ops of this batch before p0
  int r0 = 0;
  for (int t = 0; t < p0; t += kThreads) {
    const int p = t + tid;
    r0 += __syncthreads_count(p < p0 && g.is_mem[p]);
  }
  // comp[r - lo] holds the address of the batch's memory op of rank r, for
  // the ranks this tile can reach back to: lo <= r < r0 + kTile
  const int lo = r0 - g.n_mem;
  for (int i = tid; i < g.n_mem; i += kThreads) queue[i] = g.mq_in[i];
  const int fill = (int)g.mq_in[g.n_mem];

  // block-wide exclusive prefix count of is_mem over [0, p1)
  int base = 0;
  for (int t = 0; t < p1; t += kThreads) {
    const int p = t + tid;
    const bool m = p < p1 && g.is_mem[p] != 0;
    const unsigned bal = __ballot_sync(kFull, m);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w];
      off += w < warp ? c : 0;
      total += c;
    }
    const int r = base + off + __popc(bal & ((1u << lane) - 1u));
    if (m && r >= lo) comp[r - lo] = g.addr[p];
    if (p >= p0 && p < p1) rank[p - p0] = r;
    base += total;
    __syncthreads();
  }

  for (int p = p0 + warp; p < p1; p += kWarps) {
    const int op = g.opcode[p];
    const bool br = g.is_branch[p] != 0;
    const bool mem = g.is_mem[p] != 0;
    g.regbits[(size_t)p * 32 + lane] =
        (lane == g.dst[p] || lane == g.src1[p] || lane == g.src2[p]) ? 1.0f : 0.0f;
    if (lane < kFlags) {
      bool f;
      switch (lane) {
        case 0: f = br; break;
        case 1: f = g.taken[p] != 0; break;
        case 2: f = mem; break;
        case 3: f = g.is_store[p] != 0; break;
        default: f = op == kOpFalu || op == kOpFmul || op == kOpFdiv;
      }
      g.flags[(size_t)p * kFlags + lane] = f ? 1.0f : 0.0f;
    }
    // rows no branch warp writes (a bucket outside the table gets zeros)
    const int b = g.bucket[p];
    if (!br || b < 0 || b >= g.n_buckets)
      for (int k = lane; k < g.n_queue; k += 32)
        g.brhist[(size_t)p * g.n_queue + k] = 0.0f;
    const int r = rank[p - p0];
    const int64_t a = g.addr[p];
    for (int k = lane; k < g.n_mem; k += 32) {
      float v = 0.0f;
      if (mem) {
        const int src = r - 1 - k;
        if (src >= 0) {
          v = signed_log_rn(delta_f32(a, comp[src - lo]));
        } else if (k - r < fill) {
          v = signed_log_rn(delta_f32(a, queue[k - r]));
        }
      }
      g.memdist[(size_t)p * g.n_mem + k] = v;
    }
  }

  // the outgoing queue: the last n_mem addresses, most recent first
  if (p1 == g.n) {
    const int total = base;
    for (int j = tid; j < g.n_mem; j += kThreads) {
      const int s = total - 1 - j;
      g.mq_out[j] = s >= 0 ? comp[s - lo] : queue[j - total];
    }
    if (tid == 0) g.mq_out[g.n_mem] = (int64_t)min(fill + total, g.n_mem);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_features_kernel(Args g, int branch_blocks) {
  extern __shared__ __align__(16) char smem[];
  if ((int)blockIdx.x < branch_blocks)
    branch_role(g, blockIdx.x, (int*)smem);
  else
    position_role(g, blockIdx.x - branch_blocks, smem);
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One batch.  Pointers are device pointers of contiguous tensors; the
// boolean columns are one byte each.  Requires 1 <= n_queue <= 32.
extern "C" int tao_fused_features(
    const int32_t* bucket, const int64_t* addr, const int32_t* opcode,
    const int32_t* dst, const int32_t* src1, const int32_t* src2,
    const uint8_t* is_branch, const uint8_t* taken, const uint8_t* is_mem,
    const uint8_t* is_store, const float* table_in, float* table_out,
    const int64_t* mq_in, int64_t* mq_out, float* regbits, float* flags,
    float* brhist, float* memdist, int n, int n_buckets, int n_queue,
    int n_mem, void* stream) {
  if (n < 1 || n_buckets < 1 || n_queue < 1 || n_queue > 32 || n_mem < 1)
    return (int)cudaErrorInvalidValue;
  Args g{bucket, addr, opcode, dst, src1, src2, is_branch, taken, is_mem,
         is_store, table_in, table_out, mq_in, mq_out, regbits, flags,
         brhist, memdist, n, n_buckets, n_queue, n_mem};
  const int branch_blocks = (n_buckets + kWarps - 1) / kWarps;
  const int tiles = (n + kTile - 1) / kTile;
  const size_t pos_bytes = (size_t)(2 * n_mem + kTile) * sizeof(int64_t) +
                           (size_t)(kWarps + kTile) * sizeof(int);
  const size_t br_bytes = (size_t)kBrTile * sizeof(int);
  const size_t smem = pos_bytes > br_bytes ? pos_bytes : br_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_features_kernel<<<branch_blocks + tiles, kThreads, smem,
                          (cudaStream_t)stream>>>(g, branch_blocks);
  return (int)cudaGetLastError();
}
