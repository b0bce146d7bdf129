// Ring programs on the H100: the forward kernel body shared by replay.cu
// (forward), replay_adjoint.cu (taped forward, with the value log),
// spill.cu (spill programs: no resident tier, the scratch rows in the
// eviction log's place, the staged input in the basic stream's) and
// fused.cu (a whole tree's live-row program: no eviction, its rows in
// device memory).
//
// The host encoder (ops/stream_kernel.py, encode_replay) flattens every
// segment of a canopy_tpu_torch/compiler/replay.py ReplayProgram into one
// op table in program order and resolves each read the TPU kernel made
// from a DMA ring, slab buffer or refill target to a pool or resident
// slot, a row of the basic replay stream, a row of the eviction log (slab
// reads, refills and gate-stream reads alike) or a house constant.  EVICT
// (slot -> log row: the TPU's slab ring and flush DMA) and REFILL (log
// row -> slot: its rstart/rwait) move values; the rings, semaphores and
// the whole-pool dump and load at segment boundaries disappear.
// ops/stream_kernel.replay_ring_stream then packs that table as this
// kernel's op stream (the word format below).
//
// What bounds it on an H100 is latency: the pool and resident tier take
// (P + R) x W values of shared memory, so an SM holds a few hundred
// trials, and the first design (one trial per thread, every value read
// straight from device memory when its op came up) kept about one 128 B
// load in flight per warp: 288 GB/s on the 65k tree.  But the program
// reads the basic stream strictly in order, each row once, and every
// eviction-log read sits at a known place, so the whole read sequence is
// known before launch.  This kernel therefore hides latency with a
// prefetch ring, as the TPU kernel did with its VMEM rings:
//   * each thread owns one trial; a block of W threads keeps its pool and
//     resident tier, (P + R) x W values, and a ring of D x W values in
//     dynamic shared memory;
//   * every basic-stream argument, eviction-log argument and REFILL
//     consumes the next ring entry; consuming entry k waits for it
//     (cp.async.wait_group D - 2) and issues entry k + D - 1, a 4- or
//     8-byte cp.async of the trial's element of that row, into the slot
//     entry k - 1 left, so D - 1 reads stay in flight per thread.  The
//     fetch to issue is the payload of the consuming word, so issuing
//     costs no lookup.  A thread's ring is its own column: no barrier;
//   * an eviction-log entry is issued only after the EVICT that stores
//     its row (same thread, program order); where the program reads a
//     row back sooner than D - 1 entries, the EVICT consumes pad entries
//     after its store (the host places them);
//   * the op stream itself (headers and argument words) arrives in chunks
//     through two shared-memory buffers, each loaded by one cp.async.bulk
//     (TMA) a chunk ahead and completed on an mbarrier, so every decode is
//     a broadcast shared-memory read, not a dependent device-memory load.
// The block width W and ring depth D come from the program
// (ops/stream_kernel.replay_plan): D rows of W trials keep about 24 KB in
// flight per block, and W is the widest power of two that fits beside
// (P + R + D) x W values.  Each op is still a chain of dependent
// shared-memory reads and issues (header, argument words, values, the
// next fetches, the store), and an SM runs as many chains at once as it
// holds trials: that, not bytes, is what the kernel's time follows
// (PERF.md; the ring's waits do not stall).  fused.cu runs the same body
// with the rows in device memory (ring_forward's DEVICE: one column per
// thread of a (rows, gridDim.x * W) array): a whole tree's live set is a
// few hundred rows, which in shared memory would hold an SM to 64-256
// trials, while in device memory its recent rows stay in L1 and the SM
// keeps 64 warps' chains in flight.
//
// Op stream words: a chunk holds whole ops, then -1.  An op is an 8-word
// header {kind, slot, b, e, aux0, aux1, log_row, extra} and its argument
// words [b, e) (chunk offsets).  An argument word holds its kind in bits
// 30-31 (SHARED slot, RING read, HOUSE constant), its complement flag in
// bit 29 and a payload: the slot, the house index, or for a ring read the
// fetch code to issue (0: none; 1 + r: basic-stream row r; kEvlogFetch +
// r: eviction-log row r).  extra: a gate's number of ring reads, a
// REFILL's fetch code; an EVICT's argument words are its pads.
//
// Each op's arithmetic is stream_ops.cuh's eval_op_with, in the same order
// (only where values come from changes), built with --fmad=false, so the
// kernel is bit-equal to replay_forward_plain and to the stream kernel on
// the same tree.
#pragma once

#include "stream_ops.cuh"

namespace canopy {

enum WordKind { W_SHARED = 0, W_RING = 1, W_HOUSE = 2 };
constexpr int kPayload = (1 << 29) - 1;
constexpr int kEvlogFetch = 1 << 28;
constexpr int kHeaderWords = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy src_bytes (BYTES or 0) of src into dst, the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from device memory
// into shared memory with one bulk copy (TMA), completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The thread's column of the pool and resident tier: row r at
// base[r * stride].  In shared memory the stride is the block width; in
// device memory (DEVICE) the rows are a (rows, gridDim.x * W) array, one
// column per launched thread.
template <typename V, bool DEVICE>
struct Column {
  V* base;
  int stride;
  __device__ __forceinline__ V& operator[](int r) const {
    return base[r * stride];
  }
};
template <typename V>
struct Column<V, true> {
  V* base;
  long long stride;
  __device__ __forceinline__ V& operator[](int r) const {
    return base[(long long)r * stride];
  }
};

// A thread's prefetch ring: D shared-memory values (stride W), entry e in
// slot e % D; k counts the entries consumed.
template <typename V, int D>
struct Ring {
  V* slots;  // ring base + lane
  int W, k;
  const V* staged;  // (brs_len_pad, T) basic replay stream
  const V* evlog;   // (n_evicted, T) eviction log
  long long T, t;
  bool valid;  // t < T: the block's idle threads copy nothing

  // Without a branch: a pad, or an idle thread, copies zero bytes (the
  // source size operand), which fills the slot with zeros.
  __device__ __forceinline__ void issue_into(int slot, int code) {
    const bool from_log = code >= kEvlogFetch;
    const V* base = from_log ? evlog : staged;
    const int row = code - (from_log ? kEvlogFetch : 1);
    const int bytes = code != 0 && valid ? (int)sizeof(V) : 0;
    cp_async_ca<sizeof(V)>(slots + slot * W, base + at(row, T, t), bytes);
    cp_async_commit_group();  // one group per entry, empty or not
  }
  // Consume entry k (its group done once at most D - 2 newer ones are
  // pending) and issue entry k + D - 1, fetch `code`, into the slot entry
  // k - 1 left.
  __device__ __forceinline__ V take(int code) {
    cp_async_wait_group<D - 2>();
    const V v = slots[(k & (D - 1)) * W];
    issue_into((k + D - 1) & (D - 1), code);
    ++k;
    return v;
  }
  // A pad: consume entry k without reading it.
  __device__ __forceinline__ void skip(int code) {
    issue_into((k + D - 1) & (D - 1), code);
    ++k;
  }
};

// Forward reads of a gate: argument word j of the chunk; a ring read
// takes the next entry and issues the fetch code of its payload.
template <typename V, int D, typename Col>
struct RingArgs {
  const int* words;
  Col column;
  const V* house;
  Ring<V, D>* ring;
  __device__ __forceinline__ V operator()(int j) const {
    const int word = words[j];
    const unsigned kind = static_cast<unsigned>(word) >> 30;
    const int payload = word & kPayload;
    V v;
    if (kind == W_SHARED) {
      v = column[payload];
    } else if (kind == W_RING) {
      v = ring->take(payload);
    } else {
      v = house[payload];
    }
    return (word >> 29) & 1 ? V(1) - v : v;
  }
};

// Shared memory: two mbarriers, two chunks of chunk_words ints, the
// (P + R, W) pool and resident tier (DEVICE: in device memory, gpool
// (P + R, gridDim.x * W)), the (D, W) ring.  With WITH_LOG every gate's
// output also goes to its value-log row op[6].
template <typename V, bool WITH_LOG, int D, bool DEVICE>
__device__ __forceinline__ void ring_forward(
    const int* __restrict__ words, int n_chunks, int chunk_words,
    const int* __restrict__ head, const V* __restrict__ staged,
    const V* __restrict__ house, V* evlog, V* __restrict__ vlog,
    V* __restrict__ top, long long T, int pool_slots, int res_rows,
    int top_slot, V* gpool, V* dp_base) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bar = reinterpret_cast<unsigned long long*>(smem);
  int* chunks = reinterpret_cast<int*>(smem + 16);
  V* shared = reinterpret_cast<V*>(chunks + 2 * chunk_words);
  const int W = blockDim.x, lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * W + lane;
  const bool valid = t < T;
  const int chunk_bytes = chunk_words * (int)sizeof(int);
  using Col = Column<V, DEVICE>;
  Col column;
  V* ring_base = shared + lane;
  if constexpr (DEVICE) {
    column = Col{gpool + t, (long long)gridDim.x * W};
  } else {
    column = Col{shared + lane, W};
    ring_base += (pool_slots + res_rows) * W;
  }
  const DpScratch<V> dp = dp_scratch(dp_base);
  if (lane == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (lane == 0) bulk_load(chunks, words, chunk_bytes, &bar[0]);
  for (int i = 0; i < res_rows; ++i)
    column[pool_slots + i] = valid ? staged[at(i, T, t)] : V(0);
  Ring<V, D> ring{ring_base, W, 0, staged, evlog, T, t, valid};
  for (int e = 0; e < D - 1; ++e) ring.issue_into(e, head[e]);
  for (int c = 0; c < n_chunks; ++c) {
    if (lane == 0 && c + 1 < n_chunks)
      bulk_load(chunks + ((c + 1) & 1) * chunk_words,
                words + (long long)(c + 1) * chunk_words, chunk_bytes,
                &bar[(c + 1) & 1]);
    mbar_wait(&bar[c & 1], (c >> 1) & 1);
    const int* cw = chunks + (c & 1) * chunk_words;
    for (int w = 0; w < chunk_words;) {
      const int* op = cw + w;
      const int kind = op[0];
      if (kind < 0) break;  // the chunk's end mark
      if (kind == EVICT) {
        if (valid) evlog[at(op[4], T, t)] = column[op[1]];
        for (int j = op[2]; j < op[3]; ++j) ring.skip(cw[j] & kPayload);
      } else if (kind == REFILL) {
        column[op[1]] = ring.take(op[7]);
      } else {
        const int k0 = ring.k;
        const RingArgs<V, D, Col> x{cw, column, house, &ring};
        const V v = eval_op_with(op, V(0), x, dp);
        // A count window that is always true (cap 0) reads no argument:
        // its ring reads still pass, as pads.
        for (int j = op[2], left = ring.k - k0; ring.k - k0 < op[7]; ++j) {
          if ((static_cast<unsigned>(cw[j]) >> 30) != W_RING) continue;
          if (left > 0) {
            --left;
          } else {
            ring.skip(cw[j] & kPayload);
          }
        }
        column[op[1]] = v;
        if (WITH_LOG && valid) vlog[at(op[6], T, t)] = v;
      }
      w = op[3];
    }
    __syncthreads();  // every thread is done with chunk c's buffer
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (valid) top[t] = column[top_slot];
}

// The replay and spill forward: pool and resident tier in shared memory.
template <typename V, bool WITH_LOG, int D>
__global__ void replay_forward_kernel(
    const int* __restrict__ words, int n_chunks, int chunk_words,
    const int* __restrict__ head, const V* __restrict__ staged,
    const V* __restrict__ house, V* evlog, V* __restrict__ vlog,
    V* __restrict__ top, long long T, int pool_slots, int res_rows,
    int top_slot, V* dp_base) {
  ring_forward<V, WITH_LOG, D, false>(
      words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, T,
      pool_slots, res_rows, top_slot, nullptr, dp_base);
}

// Dynamic shared memory of a ring kernel block: the barriers, two chunks,
// `shared_rows` rows of W values and the (D, W) ring.
template <typename V>
size_t ring_shared_bytes(int chunk_words, int shared_rows, int depth,
                         int W) {
  return 16 + (size_t)2 * chunk_words * sizeof(int) +
         (size_t)(shared_rows + depth) * W * sizeof(V);
}

// Set `kernel`'s dynamic shared memory and launch it over ceil(T / W)
// blocks of W threads; the CUDA error code (0 on success).
template <typename Kernel, typename... Args>
int launch_ring(Kernel kernel, size_t smem, long long T, int W,
                cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (T + W - 1) / W;
  kernel<<<(unsigned)blocks, W, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename V, bool WITH_LOG, int D>
int launch_replay_depth(const int* words, int n_chunks, int chunk_words,
                        const int* head, const V* staged, const V* house,
                        V* evlog, V* vlog, V* top, long long T,
                        int pool_slots, int res_rows, int top_slot, int W,
                        V* dp, cudaStream_t stream) {
  return launch_ring(
      replay_forward_kernel<V, WITH_LOG, D>,
      ring_shared_bytes<V>(chunk_words, pool_slots + res_rows, D, W), T, W,
      stream, words, n_chunks, chunk_words, head, staged, house, evlog, vlog,
      top, T, pool_slots, res_rows, top_slot, dp);
}

// words (n_chunks * chunk_words,) and head (depth - 1,) from
// replay_ring_stream; staged (brs_len_pad, T), house (n_house + 1,),
// evlog (max(n_evicted, 1), T) scratch, vlog (n_log, T) with WITH_LOG,
// top (T,); W trials per block, ring depth 8, 16, 32 or 64 (else
// cudaErrorInvalidValue); dp the count-DP scratch (states, blocks * W)
// or null.
template <typename V, bool WITH_LOG>
int launch_replay_forward(const int* words, int n_chunks, int chunk_words,
                          const int* head, const V* staged, const V* house,
                          V* evlog, V* vlog, V* top, long long T,
                          int pool_slots, int res_rows, int top_slot, int W,
                          int depth, V* dp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CANOPY_REPLAY_DEPTH(D)                                              \
  case D:                                                                   \
    return launch_replay_depth<V, WITH_LOG, D>(                             \
        words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, \
        T, pool_slots, res_rows, top_slot, W, dp, s);
  switch (depth) {
    CANOPY_REPLAY_DEPTH(8)
    CANOPY_REPLAY_DEPTH(16)
    CANOPY_REPLAY_DEPTH(32)
    CANOPY_REPLAY_DEPTH(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CANOPY_REPLAY_DEPTH
}

}  // namespace canopy
