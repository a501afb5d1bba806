// Whole-trace feature scans for Hopper (sm_90a): branch history and memory
// distance, the staged device feature path.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/features/kernel.py:
//   branch_history_kernel (line 39)  bucket (n,) int32, outcome (n,) f32 in
//     {-1, 0, +1} -> (n, N_q) f32: each branch's row of the (N_b, N_q)
//     outcome table before its own push, most recent first; 0 rows off
//     branches.  The table starts at zero and no state leaves the call.
//   memdist_delta_kernel (line 71)   addr (n,) int64, mem (n,) bool ->
//     (n, N_m) f32 `memdist` features: the signed-log of the deltas to
//     the last N_m memory addresses, 0 off memory ops and past the fill.
//     The TPU kernel writes the raw deltas and its caller applies the
//     signed-log; here the gather applies it (signed_log_rn,
//     core/features.py::signed_log in one correctly rounded float32 op per
//     step), bitwise the NumPy specification, so no raw (n, N_m) tensor
//     reaches device memory.
// Each runs once per trace over the whole trace, not once per batch.
//
// The TPU kernels walk the trace in one sequential loop with the table or
// queue in VMEM.  Blocks on the card run in no order, so both scans are
// rewritten in the lag-gather form of core/features.py: a position's row is
// a gather from a list of earlier events, once its rank in that list is
// known.  The ranks come from tile counts, an exclusive scan over the
// tiles, and a stable rank inside each tile — all computed here:
//   * branch history — a stable partition of the branches by bucket.
//     br_rank: one block per tile of kBrTile positions; each of its
//     warps loads the keys of its run of kBrRun positions into registers
//     once, coalesced, and names each bucket by a tile id (the bucket's
//     last position in the tile, by an atomicMax on a map of N_b entries:
//     in shared memory while N_b <= kSmemBuckets, past that the tile's row
//     of the counts scratch).  Each warp walks its run in trace order, 32
//     positions a step: __match_any_sync groups the lanes of one bucket,
//     __popc(peers & lanemask_lt) ranks them, and the group's first lane
//     moves the warp's counter of that tile id, in shared memory.  A scan
//     over the warps per tile id gives each branch its stable rank in the
//     tile (to slot_of) and the tile's row of counts.  br_tile_offsets: per
//     bucket, the exclusive scan of its counts over the tiles and its
//     total.  scan_exclusive: the bucket totals to bucket starts.
//     br_place: one thread per position; a branch of bucket b in tile t
//     takes slot s = starts[b] + offsets[t][b] + its in-tile rank in the
//     bucket-sorted list, writes its outcome there and keeps s in slot_of.
//     br_gather: row slot k is list[s-1-k] while k < r (r = the branch's
//     rank in its bucket), else 0.
//   * memory distance — a compaction of the memory addresses.  md_count:
//     per tile of kMemTile positions, the memory ops.  scan_exclusive: the
//     tile bases.  md_compact: a block-wide ballot scan gives each access
//     its rank r and writes its int64 address to comp[r].  md_gather: slot
//     k is comp[r] - comp[r-1-k] while k < r, else +0, the delta taken in
//     int64 and rounded int64 -> float64 -> float32 as the NumPy
//     specification does, so any address is exact (the TPU kernel's int32
//     deltas need |addr| < 2^30), and the slot holds the signed-log of
//     that float32 (a zero delta gives +0, a negative one keeps its sign).
// No pass re-reads the trace from position 0: every pass is O(n) (plus
// O(n / kBrTile * N_b) counters for the branch partition).  Any N_b >= 1
// is taken: counters that do not fit in shared memory live in global scratch.
//
// What bounds it on the H100: bytes.  Per position the branch history
// reads 8 B and writes 4 * N_q B (128 B at the default N_q = 32); the
// memory distance reads 9 B and writes 4 * N_m B (256 B at N_m = 64).
// Neither does arithmetic a tensor core serves.  The signed-log epilogue
// costs ~27 float32 ops per valid slot, one of them an IEEE divide, on top
// of the delta's 3: at a 150k-instruction trace's ~3.8M valid slots ~0.11
// GFLOP, ~1.7 us at 67 TFLOP/s against ~12 us for the bytes.  The
// gathers, which carry nearly all the bytes, run one thread per output
// element, so every store is coalesced for any N_q or N_m; the rank passes
// move 4-16 B per position.  The serial parts (each warp of a branch tile
// walking its keys from registers, kBrSteps steps of a shared-memory
// counter update each; one block for each exclusive scan) are short at
// trace sizes of 10^5..10^7.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBrTile = 1024;      // positions per branch rank tile (one block)
constexpr int kBrRun = kBrTile / kWarps;  // positions each warp of a rank tile walks
constexpr int kBrSteps = kBrRun / 32;      // its steps, one key per lane each
constexpr int kBrRankStatic = kWarps * kBrTile * 4;  // br_rank's static shared memory
constexpr int kMemTile = 2048;     // positions per compaction tile
constexpr int kRows = 64;          // positions per gather block
constexpr int kSmemBuckets = 49152;  // per-bucket counters in shared memory
constexpr int kScanThreads = 1024;
constexpr int kMaxPositions = 1 << 30;  // int32 positions, a tile of headroom
constexpr unsigned kFull = 0xffffffffu;

// float32 bit patterns of SIGNED_LOG_SQRT2 and SIGNED_LOG_COEFFS
// (core/features.py, k = 1, 3, ..., 13), and horner_step / signed_log_rn
// below: verbatim copies of fused_features.cu's (each library is keyed on
// its own source's hash; tests/test_torch_feature_kernels.py holds the
// copies identical).
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

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// A branch (outcome != 0) whose bucket lies in the table keys its bucket;
// every other position keys -1 and gets a zero row (trace_columns never
// gives a bucket outside [0, N_b)).
__device__ __forceinline__ int branch_key(const int32_t* bucket,
                                          const float* outcome, int p,
                                          int n_buckets) {
  const int b = bucket[p];
  return (outcome[p] != 0.0f && b >= 0 && b < n_buckets) ? b : -1;
}

// In place: data[i] = data[0] + ... + data[i-1].  One block of
// kScanThreads; thread t scans a contiguous run of ceil(len / threads).
__global__ void __launch_bounds__(kScanThreads)
scan_exclusive(int32_t* data, int len) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (len + kScanThreads - 1) / kScanThreads;
  const int i0 = min(tid * per, len);
  const int i1 = min(i0 + per, len);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += data[i];
  int incl = own;
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
  int run = incl - own + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int c = data[i];
    data[i] = run;
    run += c;
  }
}

// ---- branch history ------------------------------------------------------

// Per tile (one block): each branch's stable rank among its bucket's
// branches in the tile to slot_of (-1 off branches), and the tile's counts
// to counts[t * N_b + b].  Each warp loads its run of kBrRun positions'
// keys into registers, coalesced, and names each bucket by a tile id (its
// last position in the tile, by an atomicMax on a map of N_b entries: in
// shared memory (kSmem, a template argument so that the map is addressed
// as shared memory) or the tile's row).  Each warp then walks its run in
// trace order with its own counters by tile id, in shared memory, so no
// global load sits inside the walk; a scan over the warps per tile id
// turns their counts into each warp's offsets and the tile's totals.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
br_rank(const int32_t* bucket, const float* outcome, int n, int n_buckets,
        int32_t* counts, int32_t* slot_of) {
  extern __shared__ int smem_map[];   // [n_buckets] when kSmem
  __shared__ int cnt[kWarps][kBrTile];  // per warp by tile id; then offsets, row 0 the totals
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kBrTile;
  const int p1 = min(p0 + kBrTile, n);
  const int r0 = warp * kBrRun;  // this warp's run of the tile
  int32_t* row = counts + (size_t)blockIdx.x * n_buckets;
  int* map = kSmem ? smem_map : row;
  int key[kBrSteps];
#pragma unroll
  for (int j = 0; j < kBrSteps; ++j) {
    const int p = p0 + r0 + j * 32 + lane;
    key[j] = p < p1 ? branch_key(bucket, outcome, p, n_buckets) : -1;
  }
  for (int b = tid; b < n_buckets; b += kThreads) map[b] = 0;
  for (int i = tid; i < kWarps * kBrTile; i += kThreads) (&cnt[0][0])[i] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kBrSteps; ++j)
    if (key[j] >= 0) atomicMax(&map[key[j]], r0 + j * 32 + lane + 1);
  __syncthreads();
  int id[kBrSteps];  // the bucket's tile id, -1 off branches
#pragma unroll
  for (int j = 0; j < kBrSteps; ++j)
    id[j] = key[j] < 0 ? -1 : (kSmem ? map[key[j]] : __ldcg(&map[key[j]])) - 1;
  // __match_any_sync groups one bucket's lanes, __popc(peers & lanemask_lt)
  // ranks them, and the group's first lane moves the warp's counter
  int rank[kBrSteps];
  int* wc = cnt[warp];
#pragma unroll
  for (int j = 0; j < kBrSteps; ++j) {
    const unsigned peers = __match_any_sync(kFull, id[j]);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (id[j] >= 0 && lane == leader) {
      base = wc[id[j]];
      wc[id[j]] = base + __popc(peers);
    }
    rank[j] = __shfl_sync(kFull, base, leader) + __popc(peers & lanemask_lt());
    __syncwarp();  // the leaders' counters are written before the next step reads them
  }
  __syncthreads();
  for (int i = tid; i < kBrTile; i += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][i];
      cnt[w][i] = run;
      run += c;
    }
    cnt[0][i] = run;  // warp 0's offsets are 0: its row takes the totals
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kBrSteps; ++j) {
    const int p = p0 + r0 + j * 32 + lane;
    if (p < p1) slot_of[p] = id[j] < 0 ? -1 : rank[j] + (warp > 0 ? cnt[warp][id[j]] : 0);
  }
  if (kSmem) {
    for (int b = tid; b < n_buckets; b += kThreads) {
      const int m = map[b];
      row[b] = m > 0 ? cnt[0][m - 1] : 0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBrSteps; ++j)  // each bucket's last position writes its count
      if (id[j] == r0 + j * 32 + lane) row[key[j]] = cnt[0][id[j]];
  }
}

// Per bucket, counts over the tiles -> their exclusive scan (in place);
// totals[b] = the bucket's branches.  Block (32, 32): x is the bucket
// (coalesced along a counts row), y one of 32 runs of tiles.
__global__ void __launch_bounds__(1024)
br_tile_offsets(int32_t* counts, int tiles, int n_buckets, int32_t* totals) {
  __shared__ int part[32][33];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x * 32 + tx;
  const int per = (tiles + 31) / 32;
  const int t0 = min(ty * per, tiles);
  const int t1 = min(t0 + per, tiles);
  int s = 0;
  if (b < n_buckets)
    for (int t = t0; t < t1; ++t) s += counts[(size_t)t * n_buckets + b];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    int run = 0;
    for (int y = 0; y < 32; ++y) {
      const int c = part[y][tx];
      part[y][tx] = run;
      run += c;
    }
    if (b < n_buckets) totals[b] = run;
  }
  __syncthreads();
  int run = part[ty][tx];
  if (b < n_buckets)
    for (int t = t0; t < t1; ++t) {
      const size_t i = (size_t)t * n_buckets + b;
      const int c = counts[i];
      counts[i] = run;
      run += c;
    }
}

// One thread per position: a branch of bucket b in tile t goes to slot
// s = starts[b] + offsets[t][b] + its in-tile rank in the bucket-sorted
// list (stable: tiles in order, ranks in trace order); list[s] = its
// outcome, and slot_of[p] = s.
__global__ void __launch_bounds__(kThreads)
br_place(const int32_t* bucket, const float* outcome, int n, int n_buckets,
         const int32_t* offsets, const int32_t* starts, float* list,
         int32_t* slot_of) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int r = slot_of[p];
  if (r < 0) return;
  const int b = bucket[p];
  const int s = starts[b] + offsets[(size_t)(p / kBrTile) * n_buckets + b] + r;
  list[s] = outcome[p];
  slot_of[p] = s;
}

// One thread per output element of kRows positions.
__global__ void __launch_bounds__(kThreads)
br_gather(const int32_t* bucket, const int32_t* starts, const float* list,
          const int32_t* slot_of, int n, int n_queue, float* out) {
  const int p0 = blockIdx.x * kRows;
  const int len = min(kRows, n - p0) * n_queue;
  float* o = out + (size_t)p0 * n_queue;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const int row = j / n_queue;
    const int k = j - row * n_queue;
    const int p = p0 + row;
    const int s = slot_of[p];
    float v = 0.0f;
    if (s >= 0 && k < s - starts[bucket[p]]) v = list[s - 1 - k];
    o[j] = v;
  }
}

// ---- memory distance -----------------------------------------------------

// base[t] = memory ops in tile t.
__global__ void __launch_bounds__(kThreads)
md_count(const uint8_t* mem, int n, int32_t* base) {
  const int p0 = blockIdx.x * kMemTile;
  const int p1 = min(p0 + kMemTile, n);
  int c = 0;
  for (int t = p0; t < p1; t += kThreads) {
    const int p = t + threadIdx.x;
    c += __syncthreads_count(p < p1 && mem[p] != 0);
  }
  if (threadIdx.x == 0) base[blockIdx.x] = c;
}

// rank_of[p] = the access's rank among all memory ops (-1 off them), and
// comp[rank] = its address.
__global__ void __launch_bounds__(kThreads)
md_compact(const int64_t* addr, const uint8_t* mem, int n,
           const int32_t* base, int64_t* comp, int32_t* rank_of) {
  __shared__ int warp_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kMemTile;
  const int p1 = min(p0 + kMemTile, n);
  int run = base[blockIdx.x];
  for (int t = p0; t < p1; t += kThreads) {
    const int p = t + tid;
    const bool m = p < p1 && mem[p] != 0;
    const unsigned bal = __ballot_sync(kFull, m);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int r = run + before + __popc(bal & lanemask_lt());
    if (m) comp[r] = addr[p];
    if (p < p1) rank_of[p] = m ? r : -1;
    run += total;
    __syncthreads();  // warp_cnt is rewritten next round
  }
}

// core/features.py::_memory_distance: the int64 delta (wrapping, as NumPy
// does), to float64, to float32, each rounded to nearest even.
__device__ __forceinline__ float delta_f32(int64_t a, int64_t b) {
  const long long d = (long long)((unsigned long long)a - (unsigned long long)b);
  return __double2float_rn(__ll2double_rn(d));
}

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

// One thread per output element of kRows positions: the delta's signed-log.
__global__ void __launch_bounds__(kThreads)
md_gather(const int64_t* comp, const int32_t* rank_of, int n, int n_mem,
          float* out) {
  const int p0 = blockIdx.x * kRows;
  const int len = min(kRows, n - p0) * n_mem;
  float* o = out + (size_t)p0 * n_mem;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const int row = j / n_mem;
    const int k = j - row * n_mem;
    const int r = rank_of[p0 + row];
    o[j] = k < r ? signed_log_rn(delta_f32(comp[r], comp[r - 1 - k])) : 0.0f;
  }
}

// Scratch of the branch history: counts (tiles * N_b), bucket starts (N_b),
// slot_of (n) as int32, then the bucket-sorted outcome list (n) as float32.
// kernels/features/kernel.py allocates the same size.
size_t branch_history_scratch_bytes(int n, int n_buckets) {
  const size_t tiles = ((size_t)n + kBrTile - 1) / kBrTile;
  return (tiles * n_buckets + n_buckets + 2 * (size_t)n) * 4;
}

// Scratch of the memory distance: the compacted addresses (n) as int64,
// then rank_of (n) and the tile bases (tiles) as int32.
size_t memdist_delta_scratch_bytes(int n) {
  const size_t tiles = ((size_t)n + kMemTile - 1) / kMemTile;
  return (size_t)n * 8 + ((size_t)n + tiles) * 4;
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous tensors.  Requires
// 1 <= n <= kMaxPositions, n_buckets >= 1, n_queue >= 1.
extern "C" int tao_branch_history(const int32_t* bucket, const float* outcome,
                                  float* out, void* scratch,
                                  size_t scratch_bytes, int n, int n_buckets,
                                  int n_queue, void* stream) {
  if (n < 1 || n > kMaxPositions || n_buckets < 1 || n_queue < 1 ||
      scratch_bytes < branch_history_scratch_bytes(n, n_buckets))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + kBrTile - 1) / kBrTile;
  int32_t* counts = (int32_t*)scratch;
  int32_t* starts = counts + (size_t)tiles * n_buckets;
  int32_t* slot_of = starts + n_buckets;
  float* list = (float*)(slot_of + n);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool smem_counts = n_buckets <= kSmemBuckets;
  const size_t smem = smem_counts ? (size_t)n_buckets * sizeof(int) : 0;
  if (smem + kBrRankStatic > 48 * 1024) {  // opt in past the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        br_rank<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem_counts)
    br_rank<true><<<tiles, kThreads, smem, s>>>(bucket, outcome, n, n_buckets,
                                                counts, slot_of);
  else
    br_rank<false><<<tiles, kThreads, 0, s>>>(bucket, outcome, n, n_buckets,
                                              counts, slot_of);
  TAO_LAUNCH_CHECK();
  br_tile_offsets<<<(n_buckets + 31) / 32, dim3(32, 32), 0, s>>>(
      counts, tiles, n_buckets, starts);
  TAO_LAUNCH_CHECK();
  scan_exclusive<<<1, kScanThreads, 0, s>>>(starts, n_buckets);
  TAO_LAUNCH_CHECK();
  br_place<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      bucket, outcome, n, n_buckets, counts, starts, list, slot_of);
  TAO_LAUNCH_CHECK();
  br_gather<<<(n + kRows - 1) / kRows, kThreads, 0, s>>>(
      bucket, starts, list, slot_of, n, n_queue, out);
  TAO_LAUNCH_CHECK();
  return 0;
}

// Pointers are device pointers of contiguous tensors; mem is one byte per
// position.  Requires 1 <= n <= kMaxPositions, n_mem >= 1.
extern "C" int tao_memdist_delta(const int64_t* addr, const uint8_t* mem,
                                 float* out, void* scratch,
                                 size_t scratch_bytes, int n, int n_mem,
                                 void* stream) {
  if (n < 1 || n > kMaxPositions || n_mem < 1 ||
      scratch_bytes < memdist_delta_scratch_bytes(n))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + kMemTile - 1) / kMemTile;
  int64_t* comp = (int64_t*)scratch;
  int32_t* rank_of = (int32_t*)(comp + n);
  int32_t* base = rank_of + n;
  const cudaStream_t s = (cudaStream_t)stream;
  md_count<<<tiles, kThreads, 0, s>>>(mem, n, base);
  TAO_LAUNCH_CHECK();
  scan_exclusive<<<1, kScanThreads, 0, s>>>(base, tiles);
  TAO_LAUNCH_CHECK();
  md_compact<<<tiles, kThreads, 0, s>>>(addr, mem, n, base, comp, rank_of);
  TAO_LAUNCH_CHECK();
  md_gather<<<(n + kRows - 1) / kRows, kThreads, 0, s>>>(comp, rank_of, n,
                                                         n_mem, out);
  TAO_LAUNCH_CHECK();
  return 0;
}
