// Fused trace-to-features kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused/kernel.py
// (fused_feature_kernel, line 49): one call per engine batch of n trace
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
// VMEM.  Here both scans take the lag-gather form of the plain version
// (kernels/features/ref.py: branch_scan, memory_scan) with the carried
// state prepended, in five kernels on the caller's stream.  No pass reads
// the batch from position 0 again: each is O(n), plus O(tiles * N_b)
// per-bucket counters.  Only the scan of the bucket totals runs in one
// block: a single block moving the batch's ranks is held to one SM's share
// of L2 bandwidth, so every per-position and per-counter pass spreads over
// many blocks.
//   1. fx_rank, one block per tile of kRankTile positions.  Warp 0 walks
//      the tile in trace order; __match_any_sync groups a step's lanes by
//      bucket, so each branch gets its rank among the tile's branches of
//      its bucket (stable).  Warp 1 ranks the tile's memory ops with
//      ballots.  The tile's per-bucket counts go to its row of a
//      (tiles, N_b) table, counted in shared memory while N_b <=
//      kSmemBuckets and in that row itself past it.
//   2. fx_offsets, 32 buckets per block: per bucket, the exclusive scan of
//      its counts over the tiles (in place) and its total.
//   3. fx_scan, one block: the totals' exclusive scan (each bucket's start
//      in a bucket-sorted outcome list) and the tiles' memory bases.
//   4. fx_place, one block per tile: each branch's rank j in its bucket
//      sends its outcome to list[start + j], each memory op's rank r in the
//      batch sends its address to comp[r].
//   5. fx_write, one thread per output element over kRows positions a
//      block (the rows' columns staged in shared memory once), blocks over
//      the outgoing table and one block for the outgoing queue.  brhist
//      slot k of a branch is list[start + j - 1 - k] while k < j, else
//      table_in[b][k - j] (0 off branches and for a bucket outside
//      [0, N_b)); memdist slot k of an access is addr - comp[r - 1 - k]
//      while k < r, else addr - queue[k - r] while k - r < fill, else 0.
//      table_out row b is the newest N_q outcomes of the bucket's list,
//      then its carried row shifted (a bucket without branches keeps its
//      row); mq_out is the newest N_m compacted addresses, then the carried
//      queue, and the fill min(fill + m, N_m).
// Every store is coalesced for any N_q or N_m, and any n, N_b, N_q, N_m >= 1
// is taken.  Scratch comes from the caller (fused_scratch_bytes); nothing is
// allocated here.
// Deltas are taken in int64 and rounded to float32 through float64 as the
// NumPy specification does (int64 -> float64 -> float32), so any address is
// exact (the TPU kernel's int32 deltas need |addr| < 2^30).  The signed-log
// runs here, with __fadd_rn/__fmul_rn/__fdiv_rn in exactly the order of
// core/features.py::signed_log, so no multiply-add is contracted into an
// fma and the output is bitwise the NumPy specification's.
//
// What bounds it on the H100: bytes.  Per position it reads 32 B of columns
// and writes (32 + 5 + N_q + N_m) * 4 B = 532 B of features at the default
// configuration, and the table and queue are read and written once: 4.9 MB
// for a batch of 8,256 positions, 0.00147 ms at the data sheet's 3.35 TB/s.
// The five passes are short and dependent, so what is left above that
// bound is their latency and the launches between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRankTile = 256;        // positions per fx_rank block
constexpr int kSteps = kRankTile / 32;
constexpr int kRows = 16;             // positions per fx_write row block
constexpr int kTableElems = 2048;     // outgoing-table elements per block
constexpr int kScanThreads = 1024;    // fx_offsets (32 x 32) and fx_scan
constexpr int kSmemBuckets = 49152;   // per-bucket counters in shared memory
constexpr int kFlags = 5;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kScanThreads == 32 * 32, "32 buckets x 32 tile runs; one warp of warp sums");

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

#define TAO_LAUNCH_CHECK()                      \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

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

// core/features.py::_memory_distance: the int64 delta (wrapping, as NumPy
// does), to float64, to float32, each rounded to nearest even.
__device__ __forceinline__ float delta_f32(int64_t a, int64_t b) {
  const long long d = (long long)((unsigned long long)a - (unsigned long long)b);
  return __double2float_rn(__ll2double_rn(d));
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
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

// The passes' scratch, carved from the caller's buffer in this order.
struct Scratch {
  int64_t* comp;    // [n] the batch's memory addresses, compacted
  float* list;      // [n] branch outcomes sorted by bucket, stably
  int32_t* brank;   // [n] branch rank in its tile's bucket, then in the
                    //     batch's (-1 off branches)
  int32_t* mrank;   // [n] memory-op rank in its tile, then in the batch
  int32_t* counts;  // [tiles * N_b] branches per tile and bucket, then
                    //     their exclusive scan over the tiles
  int32_t* mbase;   // [tiles] memory ops per tile, then their scan
  int32_t* starts;  // [N_b] each bucket's first slot in list
  int32_t* totals;  // [N_b] each bucket's branches
  int32_t* m;       // [1] memory ops of the batch
};

// kernels/fused/kernel.py allocates the same size.
size_t fused_scratch_bytes(int n, int n_buckets) {
  const size_t tiles = ((size_t)n + kRankTile - 1) / kRankTile;
  return (size_t)n * 8 +
         (3 * (size_t)n + tiles * n_buckets + tiles + 2 * (size_t)n_buckets + 1) * 4;
}

// A branch whose bucket lies in the table keys its bucket; every other
// position keys -1 and gets a zero row (trace_columns never gives a bucket
// outside [0, N_b)).
__device__ __forceinline__ int branch_key(const Args& g, int p) {
  const int b = g.bucket[p];
  return (g.is_branch[p] && b >= 0 && b < g.n_buckets) ? b : -1;
}

// Pass 1: ranks inside one tile, and the tile's counts, in shared memory
// (kSmem, a template argument so that cnt is addressed as shared memory) or
// in the tile's row.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
fx_rank(const Args g, Scratch s) {
  extern __shared__ int smem_cnt[];  // [N_b] when kSmem
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int p0 = tile * kRankTile;
  const int p1 = min(p0 + kRankTile, g.n);
  int32_t* row = s.counts + (size_t)tile * g.n_buckets;
  int* cnt = kSmem ? smem_cnt : row;
  for (int b = tid; b < g.n_buckets; b += kThreads) cnt[b] = 0;
  __syncthreads();
  if (warp == 0) {
    int key[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int p = p0 + i * 32 + lane;
      key[i] = p < p1 ? branch_key(g, p) : -1;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int p = p0 + i * 32 + lane;
      const unsigned peers = __match_any_sync(kFull, key[i]);
      int r = -1;
      if (key[i] >= 0) r = cnt[key[i]] + __popc(peers & lanemask_lt());
      if (p < p1) s.brank[p] = r;
      __syncwarp();  // every lane has read cnt before the leaders move it
      if (key[i] >= 0 && lane == __ffs(peers) - 1) cnt[key[i]] += __popc(peers);
      __syncwarp();
    }
  } else if (warp == 1) {
    int run = 0;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int p = p0 + i * 32 + lane;
      const bool m = p < p1 && g.is_mem[p] != 0;
      const unsigned bal = __ballot_sync(kFull, m);
      if (p < p1) s.mrank[p] = m ? run + __popc(bal & lanemask_lt()) : -1;
      run += __popc(bal);
    }
    if (lane == 0) s.mbase[tile] = run;
  }
  if (kSmem) {
    __syncthreads();
    for (int b = tid; b < g.n_buckets; b += kThreads) row[b] = cnt[b];
  }
}

// In place over data[0, len): the exclusive prefix sum, kScanThreads
// elements a round; returns the total.  Every thread of the block calls it.
__device__ int block_scan_exclusive(int32_t* data, int len) {
  __shared__ int warp_sum[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < len; base += kScanThreads) {
    const int i = base + tid;
    const int v = i < len ? data[i] : 0;
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (i < len) data[i] = carry + incl - v + (warp > 0 ? warp_sum[warp - 1] : 0);
    carry += warp_sum[31];
    __syncthreads();  // warp_sum is rewritten next round
  }
  return carry;
}

// Pass 2: per bucket (threadIdx.x), its counts over the tiles, split in 32
// runs of tiles (threadIdx.y) -> their exclusive scan, and its total.
__global__ void __launch_bounds__(kScanThreads)
fx_offsets(const Args g, Scratch s, int tiles) {
  __shared__ int part[32][33];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x * 32 + tx;
  const int per = (tiles + 31) / 32;
  const int t0 = min(ty * per, tiles);
  const int t1 = min(t0 + per, tiles);
  int sum = 0;
  if (b < g.n_buckets)
    for (int t = t0; t < t1; ++t) sum += s.counts[(size_t)t * g.n_buckets + b];
  part[ty][tx] = sum;
  __syncthreads();
  if (ty == 0) {
    int run = 0;
    for (int y = 0; y < 32; ++y) {
      const int c = part[y][tx];
      part[y][tx] = run;
      run += c;
    }
    if (b < g.n_buckets) {
      s.totals[b] = run;
      s.starts[b] = run;  // scanned by fx_scan
    }
  }
  __syncthreads();
  int run = part[ty][tx];
  if (b < g.n_buckets)
    for (int t = t0; t < t1; ++t) {
      const size_t i = (size_t)t * g.n_buckets + b;
      const int c = s.counts[i];
      s.counts[i] = run;
      run += c;
    }
}

// Pass 3: the bucket starts, the tiles' memory bases and the batch's count.
__global__ void __launch_bounds__(kScanThreads)
fx_scan(Scratch s, int n_buckets, int tiles) {
  block_scan_exclusive(s.starts, n_buckets);
  const int m = block_scan_exclusive(s.mbase, tiles);
  if (threadIdx.x == 0) *s.m = m;
}

// Pass 4: each branch's outcome and each memory op's address to its slot.
__global__ void __launch_bounds__(kRankTile)
fx_place(const Args g, Scratch s) {
  const int t = blockIdx.x;
  const int p = t * kRankTile + threadIdx.x;
  if (p >= g.n) return;
  const int jt = s.brank[p];
  const int rt = s.mrank[p];
  if (jt >= 0) {
    const int b = g.bucket[p];
    const int j = s.counts[(size_t)t * g.n_buckets + b] + jt;
    s.list[s.starts[b] + j] = g.taken[p] ? 1.0f : -1.0f;
    s.brank[p] = j;
  }
  if (rt >= 0) {
    const int r = s.mbase[t] + rt;
    s.comp[r] = g.addr[p];
    s.mrank[p] = r;
  }
}

// Pass 5: every output element, one thread each.
__global__ void __launch_bounds__(kThreads)
fx_write(const Args g, const Scratch s, int row_blocks) {
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {  // the outgoing queue
    const int m = *s.m;
    for (int k = tid; k < g.n_mem; k += kThreads)
      g.mq_out[k] = k < m ? s.comp[m - 1 - k] : g.mq_in[k - m];
    if (tid == 0) {
      const int64_t fill = g.mq_in[g.n_mem] + m;
      g.mq_out[g.n_mem] = fill < g.n_mem ? fill : (int64_t)g.n_mem;
    }
    return;
  }
  if ((int)blockIdx.x >= row_blocks) {  // the outgoing table
    const size_t total = (size_t)g.n_buckets * g.n_queue;
    const size_t e0 = (size_t)(blockIdx.x - row_blocks) * kTableElems;
    const size_t e1 = e0 + kTableElems < total ? e0 + kTableElems : total;
    for (size_t e = e0 + tid; e < e1; e += kThreads) {
      const int b = (int)(e / g.n_queue);
      const int k = (int)(e - (size_t)b * g.n_queue);
      const int t = s.totals[b];
      g.table_out[e] = k < t ? s.list[s.starts[b] + t - 1 - k] : g.table_in[e - t];
    }
    return;
  }

  __shared__ int r_dst[kRows], r_src1[kRows], r_src2[kRows], r_flags[kRows];
  __shared__ int r_j[kRows], r_slot[kRows], r_bucket[kRows], r_rank[kRows];
  __shared__ int64_t r_addr[kRows];
  const int p0 = blockIdx.x * kRows;
  const int rows = min(kRows, g.n - p0);
  if (tid < rows) {
    const int p = p0 + tid;
    const int op = g.opcode[p];
    const bool fp = op == kOpFalu || op == kOpFmul || op == kOpFdiv;
    const int j = s.brank[p];
    r_dst[tid] = g.dst[p];
    r_src1[tid] = g.src1[p];
    r_src2[tid] = g.src2[p];
    r_flags[tid] = (g.is_branch[p] ? 1 : 0) | (g.taken[p] ? 2 : 0) |
                   (g.is_mem[p] ? 4 : 0) | (g.is_store[p] ? 8 : 0) | (fp ? 16 : 0);
    const int b = g.bucket[p];
    r_j[tid] = j;
    r_bucket[tid] = b;
    r_slot[tid] = j >= 0 ? s.starts[b] + j : 0;  // this branch's own slot
    r_rank[tid] = s.mrank[p];
    r_addr[tid] = g.addr[p];
  }
  __syncthreads();

  float* out = g.regbits + (size_t)p0 * 32;
  for (int e = tid; e < rows * 32; e += kThreads) {
    const int i = e >> 5;
    const int k = e & 31;
    out[e] = (k == r_dst[i] || k == r_src1[i] || k == r_src2[i]) ? 1.0f : 0.0f;
  }
  out = g.flags + (size_t)p0 * kFlags;
  for (int e = tid; e < rows * kFlags; e += kThreads) {
    const int i = e / kFlags;
    out[e] = (r_flags[i] >> (e - i * kFlags)) & 1 ? 1.0f : 0.0f;
  }
  out = g.brhist + (size_t)p0 * g.n_queue;
  for (int e = tid; e < rows * g.n_queue; e += kThreads) {
    const int i = e / g.n_queue;
    const int k = e - i * g.n_queue;
    const int j = r_j[i];
    float v = 0.0f;
    if (j >= 0)
      v = k < j ? s.list[r_slot[i] - 1 - k]
                : g.table_in[(size_t)r_bucket[i] * g.n_queue + (k - j)];
    out[e] = v;
  }
  const int64_t fill = g.mq_in[g.n_mem];
  out = g.memdist + (size_t)p0 * g.n_mem;
  for (int e = tid; e < rows * g.n_mem; e += kThreads) {
    const int i = e / g.n_mem;
    const int k = e - i * g.n_mem;
    const int r = r_rank[i];
    float v = 0.0f;
    if (r >= 0) {
      if (k < r)
        v = signed_log_rn(delta_f32(r_addr[i], s.comp[r - 1 - k]));
      else if (k - r < fill)
        v = signed_log_rn(delta_f32(r_addr[i], g.mq_in[k - r]));
    }
    out[e] = v;
  }
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One batch: five kernels on the stream.  Pointers are device pointers of
// contiguous tensors; the boolean columns are one byte each; scratch holds
// at least fused_scratch_bytes(n, n_buckets).  Requires n, n_buckets,
// n_queue, n_mem >= 1.
extern "C" int tao_fused_features(
    const int32_t* bucket, const int64_t* addr, const int32_t* opcode,
    const int32_t* dst, const int32_t* src1, const int32_t* src2,
    const uint8_t* is_branch, const uint8_t* taken, const uint8_t* is_mem,
    const uint8_t* is_store, const float* table_in, float* table_out,
    const int64_t* mq_in, int64_t* mq_out, float* regbits, float* flags,
    float* brhist, float* memdist, void* scratch, size_t scratch_bytes, int n,
    int n_buckets, int n_queue, int n_mem, void* stream) {
  if (n < 1 || n_buckets < 1 || n_queue < 1 || n_mem < 1 ||
      scratch_bytes < fused_scratch_bytes(n, n_buckets))
    return (int)cudaErrorInvalidValue;
  Args g{bucket, addr, opcode, dst, src1, src2, is_branch, taken, is_mem,
         is_store, table_in, table_out, mq_in, mq_out, regbits, flags,
         brhist, memdist, n, n_buckets, n_queue, n_mem};
  const int tiles = (n + kRankTile - 1) / kRankTile;
  Scratch s;
  s.comp = (int64_t*)scratch;
  s.list = (float*)(s.comp + n);
  s.brank = (int32_t*)(s.list + n);
  s.mrank = s.brank + n;
  s.counts = s.mrank + n;
  s.mbase = s.counts + (size_t)tiles * n_buckets;
  s.starts = s.mbase + tiles;
  s.totals = s.starts + n_buckets;
  s.m = s.totals + n_buckets;
  const cudaStream_t st = (cudaStream_t)stream;

  if (n_buckets <= kSmemBuckets) {
    const size_t smem = (size_t)n_buckets * sizeof(int);
    if (smem > 48 * 1024) {  // opt in past the default 48 KB
      const cudaError_t e = cudaFuncSetAttribute(
          fx_rank<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    fx_rank<true><<<tiles, kThreads, smem, st>>>(g, s);
  } else {
    fx_rank<false><<<tiles, kThreads, 0, st>>>(g, s);
  }
  TAO_LAUNCH_CHECK();
  fx_offsets<<<(n_buckets + 31) / 32, dim3(32, 32), 0, st>>>(g, s, tiles);
  TAO_LAUNCH_CHECK();
  fx_scan<<<1, kScanThreads, 0, st>>>(s, n_buckets, tiles);
  TAO_LAUNCH_CHECK();
  fx_place<<<tiles, kRankTile, 0, st>>>(g, s);
  TAO_LAUNCH_CHECK();
  const int row_blocks = (n + kRows - 1) / kRows;
  const size_t table_blocks =
      ((size_t)n_buckets * n_queue + kTableElems - 1) / kTableElems;
  fx_write<<<(unsigned)(row_blocks + table_blocks + 1), kThreads, 0, st>>>(
      g, s, row_blocks);
  TAO_LAUNCH_CHECK();
  return 0;
}
