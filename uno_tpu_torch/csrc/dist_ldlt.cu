// dist_panel: the rank-local panel factor of the distributed dense LDL^T
// (uno_tpu_torch/parallel/dist_ldlt.py), for Hopper (sm_90a).
//
// It replaces no Pallas kernel.  uno_tpu's `_panel_factor`
// (uno_tpu/parallel/dist_ldlt.py:89-116) is XLA code: a loop over the
// panel's columns of whole-slab operations.  As torch operations it would
// be some 8 launches a column, 500 a panel of 64 and ten thousand a
// factorization at dim 1280, where host dispatch already sets the port's
// time; so it is one kernel a panel.
//
// What it computes, on a column slab C of n rows and BLOCK columns (row i,
// column k at C[i * ld + k]) whose pivots lie on rows row0 .. row0+BLOCK-1,
// in _panel_factor's expressions and order:
//   for jj = 0 .. BLOCK-1:   pr = row0 + jj
//     dj  = C[pr, jj];   inv = 1 / safe(dj)
//     l_i = i > pr ? C[i, jj] * inv : 0                  every row i
//     C[i, k] = fma(-dj, l_i * l_{row0+k}, C[i, k])      every row i, column k
//     C[i, jj] = l_i;   d[jj] = dj
// with correctly rounded operations, the product by dj fused into the
// subtraction as XLA:CPU compiles _panel_factor's update (ldlt.cu's note),
// so that it equals panel_factor_plain bit for bit.  The multipliers of the
// panel's own rows, l_{row0+k}, are 0 for k <= jj, so for those columns
// the update subtracts the one value dj * (l_i * 0) (a zero, or NaN where
// dj or l_i is not finite: exact, so fused or not alike), as the plain
// version does.
//
// Design: the pivots, their reciprocals and the panel's multipliers of
// every column depend on the diagonal block's rows alone, and every other
// row is independent of the rest.  So the rows are dealt over a grid of
// CTAs (cuda_ldlt.dist_panel_grid: about one wave of the card at every
// height), and each CTA factors the diagonal block itself.  A row is held
// in the registers of a group of 4 threads, each with a quarter of its
// columns in 16-byte chunks dealt round the group (thread q has chunks q,
// q+4, ...; 16 values at BLOCK 64), so that a column's updates are even
// over the group; the holder of a row's column-jj entry passes it round
// the group by a shuffle.  In a CTA:
//  * producers, 4 * BLOCK threads, the diagonal block's rows.  At column jj
//    each reads the pivot and the panel row jj+1's entry from the column
//    published at jj-1, takes the reciprocal and its row's multiplier, and
//    the holder of the row's column jj+1 updates and publishes that entry
//    (the look-ahead) before a named barrier over the producers alone ends
//    the column; the rest of the row's update follows the barrier, off the
//    chain.  One of them then completes column jj's mbarrier;
//  * row threads, up to 256, the CTA's run of the rows below the block, 64
//    rows at a time.  Each waits on column jj's mbarrier alone, so the rows
//    follow the diagonal block column by column.  A row is read and written
//    once.
// The column loop is unrolled over a chunk's columns and rolled over the
// chunks, the registers rotated a chunk a step (column_loop): unrolled over
// the whole panel, its code is fetched once per SM and the fetch sets the
// time.
// The rows above row0 are zeros when every pivot and multiplier is finite
// (their l is 0 at every column) and are written so, a run a CTA;
// otherwise they run the column loop too, so that NaN and Inf spread as in
// the plain version.  The diagonal block's rows are read by every CTA, so
// only the last CTA to have read them writes them back (and the pivots):
// each CTA takes a ticket from a counter in device memory once its
// producers have loaded the block, and the one holding the last ticket
// writes.  No CTA waits for another: the grid needs no co-residency.  The
// counter wraps to 0 on the last ticket; a launch names one of
// DIST_TICKETS counters, round-robin in the wrapper, so that launches on
// different streams do not share one.
//
// Bound on this card: it moves the slab once (n * BLOCK elements in and
// out) and does about 2 n BLOCK^2 operations; the diagonal block's 64
// dependent columns (a barrier, a reciprocal and four dependent operations
// each) set the time at every height up to 8,192 rows.
//
// UNO_DIST_STUDY_DIAG_ONLY (tools/ldlt_kernel_study.py) builds a library
// that launches the kernel with no rows for its row threads: its time is
// the diagonal block's alone; its results are wrong by construction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldlt_common.cuh"

namespace {

constexpr int LANES = 4;              // threads a row
constexpr int MAX_ROW_THREADS = 256;  // a CTA's row threads: 64 rows at a time
constexpr int DIST_TICKETS = 256;     // the ticket counters (DIST_PANEL_TICKETS)
constexpr int BAR_PRODUCERS = 1;      // named barriers; 0 is __syncthreads
constexpr int BAR_TICKET = 2;

__device__ unsigned int dist_tickets[DIST_TICKETS];

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// wait for the barrier's first phase (each column's barrier completes once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// the ticket: the counter's value before, the counter back at 0 after `last`
__device__ __forceinline__ unsigned take_ticket(unsigned* counter, unsigned last) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(last)
               : "memory");
  return old;
}

// A row's share in a thread of its group: PER chunks of V = 16 / sizeof(T)
// columns, chunk u of thread q holding columns (q + LANES u) V .. + V - 1,
// so that chunk u of the group spans columns SPAN u .. SPAN (u + 1) - 1
template <typename T, int BLOCK>
struct Share {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PER = BLOCK / V / LANES;
  static constexpr int R = PER * V;                  // values a thread
  static constexpr int SPAN = V * LANES;
  static_assert(BLOCK % SPAN == 0, "BLOCK splits into the group's chunks");
  __device__ static constexpr int col(int q, int u, int v) { return (q + LANES * u) * V + v; }
};

template <typename T, int BLOCK>
__device__ __forceinline__ void load_share(const T* p, int q, T (&r)[Share<T, BLOCK>::R],
                                           bool vec) {
  using S = Share<T, BLOCK>;
#pragma unroll
  for (int u = 0; u < S::PER; ++u) {
    if (vec) {
      T buf[S::V];
      load16(p + S::col(q, u, 0), buf);
#pragma unroll
      for (int v = 0; v < S::V; ++v) r[u * S::V + v] = buf[v];
    } else {
#pragma unroll
      for (int v = 0; v < S::V; ++v) r[u * S::V + v] = p[S::col(q, u, v)];
    }
  }
}

template <typename T, int BLOCK>
__device__ __forceinline__ void store_share(T* p, int q, const T (&r)[Share<T, BLOCK>::R],
                                            bool vec) {
  using S = Share<T, BLOCK>;
#pragma unroll
  for (int u = 0; u < S::PER; ++u) {
    if (vec) {
      T buf[S::V];
#pragma unroll
      for (int v = 0; v < S::V; ++v) buf[v] = r[u * S::V + v];
      store16(p + S::col(q, u, 0), buf);
    } else {
#pragma unroll
      for (int v = 0; v < S::V; ++v) p[S::col(q, u, v)] = r[u * S::V + v];
    }
  }
}

// The column loop over a row share, the panel's BLOCK columns in PER steps
// of SPAN: at step U, position p of the share holds chunk (U + p) % PER, so
// that the chunk spanning the step's columns is at position 0 and the
// loop's body is the same at every step (unrolled over the SPAN columns, not
// over the panel: straight-line code over the whole panel is fetched once
// per SM and its fetch, not the arithmetic, sets the time).  Column jj's
// update of the row, whose multiplier is li: right of the pivot
// a - dj * (li * lk), left of it a - dj * (li * 0), the multiplier itself at
// column jj; the panel's multipliers lk from lp.  Chunks wholly right or
// wholly left of the step take a branch that is the same for every thread.
//
// A producer (row `row` of the diagonal block) makes column jj itself: the
// pivot and the panel row jj+1's entry from the column published at jj-1
// (colv), its reciprocal, the row's multiplier (published in lp by the
// entry's holder), then the look-ahead: the holder of the row's column
// jj+1 publishes that entry updated, before the barrier over the producers
// that ends the column; the rest of the row's update follows the barrier.
// A row thread (row `row` of the slab) waits for column jj's barrier and
// reads the pivot and its reciprocal from dp and rp.
template <typename T, int BLOCK, bool PRODUCER>
__device__ __forceinline__ void column_loop(T (&r)[Share<T, BLOCK>::R], int q, int row,
                                            int row0, T* lp, T (*colv)[BLOCK], T* dp, T* rp,
                                            uint64_t* full, int* nonfinite) {
  using S = Share<T, BLOCK>;
  constexpr int V = S::V, PER = S::PER, SPAN = S::SPAN;
  bool finite = true;
#pragma unroll 1
  for (int U = 0; U < PER; ++U) {
#pragma unroll
    for (int jc = 0; jc < SPAN; ++jc) {
      const int jj = U * SPAN + jc;
      // the row's column jj, from its holder: position 0, lane jc / V
      const T a = __shfl_sync(FULL, r[jc % V], jc / V, LANES);
      T dj, li;
      if (PRODUCER) {
        const T* col = colv[jc & 1];
        dj = col[jj];
        const T inv = rcp_rn(safe_pivot(dj));
        li = row > jj ? mul_rn(a, inv) : T(0);
        if (q == jc / V) lp[jj * BLOCK + row] = li;
        // the look-ahead: column jj+1 is at position 0 or, past the
        // chunk's end, at position 1, lane 0
        const int nlane = jc + 1 < SPAN ? (jc + 1) / V : 0;
        const int nidx = jc + 1 < SPAN ? (jc + 1) % V : V;
        if (jj + 1 < BLOCK && q == nlane)
          colv[(jc + 1) & 1][row] =
              fma_rn(-dj, mul_rn(li, mul_rn(col[jj + 1], inv)), r[nidx]);
        finite = finite && isfinite(li) && isfinite(dj);
        if (row == 0 && q == 0) {
          dp[jj] = dj;
          rp[jj] = inv;
        }
        if (jj == BLOCK - 1 && !finite) *nonfinite = 1;
        bar_sync(BAR_PRODUCERS, LANES * BLOCK);
        if (row == 0 && q == 0) mbar_arrive(&full[jj]);
      } else {
        mbar_wait(&full[jj]);
        dj = dp[jj];
        li = row - row0 > jj ? mul_rn(a, rp[jj]) : T(0);
      }
      const T z = mul_rn(dj, mul_rn(li, T(0)));
      const T* lcol = lp + jj * BLOCK;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        T* x = r + p * V;
        if (p > 0 && p >= PER - U) {         // wholly left: a finished chunk
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = sub_rn(x[v], z);
          continue;
        }
        T l[V];
        load16(lcol + S::col(q, (U + p) % PER, 0), l);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T right = fma_rn(-dj, mul_rn(li, l[v]), x[v]);
          if (p > 0) {
            x[v] = right;
          } else {
            const int k = (q * V + v) - jc;  // column minus jj, in the chunk
            x[v] = k > 0 ? right : (k < 0 ? sub_rn(x[v], z) : li);
          }
        }
      }
    }
    // the finished chunk goes to the end
    T first[V];
#pragma unroll
    for (int v = 0; v < V; ++v) first[v] = r[v];
#pragma unroll
    for (int k = 0; k < S::R - V; ++k) r[k] = r[k + V];
#pragma unroll
    for (int v = 0; v < V; ++v) r[S::R - V + v] = first[v];
  }
}

// rows first .. first+count-1 of the slab, each in a group, `groups` rows
// at a time; the trip count is the same for every row thread, rows past
// the range compute zeros and are not written
template <typename T, int BLOCK>
__device__ __forceinline__ void run_rows(T* C, int ld, int row0, int first, int count,
                                         int rt, int groups, T* dp, T* rp, T* lp,
                                         uint64_t* full, bool vec) {
  using S = Share<T, BLOCK>;
  const int g = rt / LANES, q = rt % LANES;
  for (int base = 0; base < count; base += groups) {
    const int i = first + base + g;
    const bool live = base + g < count;
    T* p = C + static_cast<long long>(i) * ld;
    T r[S::R];
    if (live) {
      load_share<T, BLOCK>(p, q, r, vec);
    } else {
#pragma unroll
      for (int k = 0; k < S::R; ++k) r[k] = T(0);
    }
    column_loop<T, BLOCK, false>(r, q, i, row0, lp, nullptr, dp, rp, full, nullptr);
    if (live) store_share<T, BLOCK>(p, q, r, vec);
  }
}

// CTA c takes the rows below the diagonal block row0+BLOCK+c*rows .. +rows-1
// and the rows above it c*above .. +above-1 (each cut at its end), the
// diagonal block's if it holds the last ticket.  Its first LANES * BLOCK
// threads are the producers, a row of the block to a group of LANES
template <typename T, int BLOCK>
__global__ void __launch_bounds__(LANES * BLOCK + MAX_ROW_THREADS, 1)
dist_panel_kernel(T* __restrict__ C, T* __restrict__ d, int n, int ld, int row0, int rows,
                  int above, int slot, int vec) {
  using S = Share<T, BLOCK>;
  constexpr int PRODUCERS = LANES * BLOCK;
  __shared__ __align__(16) T lp[BLOCK * BLOCK];   // column jj's multipliers
  __shared__ __align__(16) T colv[2][BLOCK];      // the block's column jj, by parity
  __shared__ T dp[BLOCK], rp[BLOCK];              // pivots and their reciprocals
  __shared__ __align__(8) uint64_t full[BLOCK];   // column jj published
  __shared__ int nonfinite, last;
  const int t = threadIdx.x;
  if (t == 0) nonfinite = 0;
  if (t < BLOCK) mbar_init(&full[t], 1);
  __syncthreads();

  if (t < PRODUCERS) {
    const int k = t / LANES, q = t % LANES;
    T* p = C + static_cast<long long>(row0 + k) * ld;
    T r[S::R];
    load_share<T, BLOCK>(p, q, r, vec);
    if (q == 0) colv[0][k] = r[0];
    bar_sync(BAR_PRODUCERS, PRODUCERS);
    column_loop<T, BLOCK, true>(r, q, k, row0, lp, colv, dp, rp, full, &nonfinite);
    bar_sync(BAR_TICKET, PRODUCERS + 32);
    if (last) {
      store_share<T, BLOCK>(p, q, r, vec);
      if (q == 0) d[k] = dp[k];
    }
    return;
  }

  // row threads
  const int rt = t - PRODUCERS, groups = (blockDim.x - PRODUCERS) / LANES;
  unsigned ticket = 0;
  if (rt == 0) {
    mbar_wait(&full[0]);   // the producers have read the diagonal block
    ticket = take_ticket(&dist_tickets[slot], gridDim.x - 1);
  }
  const int below = n - row0 - BLOCK, first = blockIdx.x * rows;
  run_rows<T, BLOCK>(C, ld, row0, row0 + BLOCK + first, max(0, min(rows, below - first)),
                     rt, groups, dp, rp, lp, full, vec);
  const int up = blockIdx.x * above, ucount = max(0, min(above, row0 - up));
  if (ucount > 0) {
    mbar_wait(&full[BLOCK - 1]);
    if (nonfinite) {
      run_rows<T, BLOCK>(C, ld, row0, up, ucount, rt, groups, dp, rp, lp, full, vec);
    } else if (vec) {
      constexpr int V = 16 / sizeof(T);
      const T zero[V] = {};
      for (int e = rt; e < ucount * (BLOCK / V); e += blockDim.x - PRODUCERS)
        store16(C + static_cast<long long>(up + e / (BLOCK / V)) * ld + e % (BLOCK / V) * V,
                zero);
    } else {
      for (int e = rt; e < ucount * BLOCK; e += blockDim.x - PRODUCERS)
        C[static_cast<long long>(up + e / BLOCK) * ld + e % BLOCK] = T(0);
    }
  }
  if (rt < 32) {
    // hand the ticket to the producers
    if (rt == 0) {
      last = ticket == gridDim.x - 1;
      __threadfence_block();
    }
    bar_arrive(BAR_TICKET, PRODUCERS + 32);
  }
}

template <typename T, int BLOCK>
int launch_block(T* C, T* d, int n, int ld, int row0, int grid, int rows, int above,
                 int threads, int slot, int vec, cudaStream_t stream) {
  dist_panel_kernel<T, BLOCK><<<grid, threads, 0, stream>>>(C, d, n, ld, row0, rows, above,
                                                            slot, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dist_panel(void* C_, void* d_, int n, int ld, int row0, int block, int grid,
                      int rows, int above, int threads, int slot, void* stream_,
                      int* launched) {
  *launched = 0;
  const long long below = static_cast<long long>(n) - row0 - block;
  bool covered = static_cast<long long>(grid) * rows >= below &&
                 static_cast<long long>(grid) * above >= row0;
#ifdef UNO_DIST_STUDY_DIAG_ONLY
  rows = above = 0;   // the rows are left alone, the kernel's code as it is
  covered = true;
#endif
  if ((block != 32 && block != 64) || n < block || ld < block || row0 < 0 || below < 0 ||
      grid < 1 || rows < 0 || above < 0 || !covered || threads < LANES * block + 32 ||
      threads > LANES * block + MAX_ROW_THREADS || (threads - LANES * block) % 32 != 0 ||
      slot < 0 || slot >= DIST_TICKETS)
    return static_cast<int>(cudaErrorInvalidValue);
  T* C = static_cast<T*>(C_);
  T* d = static_cast<T*>(d_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int vec = aligned16(C) && (static_cast<long long>(ld) * sizeof(T)) % 16 == 0;
  const int err = block == 32
      ? launch_block<T, 32>(C, d, n, ld, row0, grid, rows, above, threads, slot, vec, stream)
      : launch_block<T, 64>(C, d, n, ld, row0, grid, rows, above, threads, slot, vec, stream);
  if (err == 0) ++*launched;
  return err;
}

}  // namespace

// C: the slab's first element, n rows of `block` columns (32 or 64) at a
// row stride of ld elements, factored in place; d: `block` pivots out;
// the pivots lie on rows row0 .. row0+block-1.  grid CTAs of `threads`
// threads (4 * block producers, then row threads, a multiple of 32 up to
// 256),
// CTA c taking `rows` rows below the block and `above` rows above it;
// `slot` names the ticket counter (0 .. 255).  The geometry is
// cuda_ldlt.dist_panel_grid's.  Launches one kernel on `stream`, sets
// *launched to the kernels it launched and returns cudaGetLastError() (0
// on success), cudaErrorInvalidValue for sizes it does not take.
extern "C" int uno_dist_panel_f32(void* C, void* d, int n, int ld, int row0, int block,
                                  int grid, int rows, int above, int threads, int slot,
                                  void* stream, int* launched) {
  return launch_dist_panel<float>(C, d, n, ld, row0, block, grid, rows, above, threads,
                                  slot, stream, launched);
}

extern "C" int uno_dist_panel_f64(void* C, void* d, int n, int ld, int row0, int block,
                                  int grid, int rows, int above, int threads, int slot,
                                  void* stream, int* launched) {
  return launch_dist_panel<double>(C, d, n, ld, row0, block, grid, rows, above, threads,
                                   slot, stream, launched);
}
