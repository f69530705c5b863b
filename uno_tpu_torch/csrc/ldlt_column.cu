// ldlt_column: batched unpivoted LDL^T with inertia of dense symmetric
// matrices at 32 < dim <= 64, for Hopper (sm_90a).  The dims 33-64 of the
// Pallas kernels of uno_tpu/linalg/pallas_ldlt.py (ldlt_factor_pallas ->
// _ldlt_kernel, ldlt_factor_pallas_batched -> _ldlt_kernel_batched), where
// uno_tpu factors with the column form: linalg/cuda_ldlt.py's plan() routes
// them here, ldlt.cu takes the other dims.
//
// Arithmetic: the column form's (uno_tpu_torch/linalg/ldlt.py's
// ldlt_factor), bit for bit.  Each entry (i, k) of the lower triangle is
// owned by one thread, which updates it once for every column j < k, in
// increasing j, with fma(-d_j, l_i * l_k, a_ik): the product of the
// multipliers correctly rounded, the one by d_j fused into the subtraction,
// as XLA:CPU compiles the column form (ldlt.cu's note); l_i = a_ij /
// safe(d_j) is correctly rounded (Markstein's correction of a correctly
// rounded reciprocal, ldlt_common.cuh's div_by_fast, and the division
// itself where that path does not hold).  No tensor cores.  The
// inertia is counted in the kernel as _inertia counts it.
//
// Design.  A group of P x Q threads factors one instance: 64 (8 x 8, two
// warps, one block) unless the batch fills the card, and then 16 (4 x 4,
// two instances a warp) up to dim 40 or 32 (8 x 4) in float64 above dim 56,
// where they take less time (plan() picks; linalg/cuda_ldlt.py).  Thread
// (p, q) holds in registers the entries (i, k), i >= k, with i = p (mod P)
// and k = q (mod Q): the trailing triangle of every column is spread evenly
// over the threads, and the register indices are known at compile time
// because the kernel is compiled for the dim's bucket N of 8 dims; rows and
// columns past the dim hold zeros, take part in the updates (their
// multipliers are zeros) and are not written.  Column j, one step each:
//   1. the threads holding column j store it in shared memory;
//   2. after a barrier every thread reads the pivot d_j, and the divisions
//      of rows j+1.. are spread over the group's threads, straight-line
//      (the exact division only where a warp has a quotient off the fast
//      path), which store the multipliers l_i in shared memory, each
//      thread's rows and columns in runs of 16-byte vectors (row i at
//      (i % P) R + i / P);
//   3. after a barrier each thread reads its rows' and columns'
//      multipliers, 16 bytes at a time, and updates the entries it holds
//      right of column j; the holders of column j keep its multipliers as
//      their entries.  Entries above the diagonal take the updates too (no
//      one reads them), so only the block's own columns test per column
//      whether they are live.
// The barriers are __syncwarp up to 32 threads and __syncthreads for 64.
// The column loop runs over blocks of P columns, unrolled, so that the
// rows and columns left of a block are out of its code.  Shared memory
// holds only the column, its multipliers and the pivots (under 2 KB an
// instance), so registers, not shared memory, bound the instances an SM
// runs.  The matrix is read from and L written to device memory directly
// by each thread (its columns of a row are Q apart).
//
// Bound on this card: the bytes (the lower triangle in, the dense L and d
// out) are below the time at every shape the solver's paths give it; the
// time is the group's instruction stream.  At (8192, 36, 36) float32 an
// instance executes about 5,400 warp instructions, two thirds of them the
// fixed cost of its 36 columns (the pivot's reciprocal, a division or two,
// the column and multiplier traffic through shared memory, two barriers),
// a third the three operations of each update, including the updates of
// padding and of entries a column block leaves dead; taking its loads and
// stores of device memory out leaves its time as it is (PERF.md).  At
// small batches the chain of the columns sets the time: a two-warp group
// beats wider ones, whose barriers cost more than their shorter updates
// save.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldlt_common.cuh"

namespace {

// How an instance of dim <= N lies over P x Q threads, and its shared memory.
template <typename T, int N, int P, int Q>
struct ColumnLayout {
  static_assert(P % Q == 0 && N % P == 0, "Q divides P, P divides N");
  static constexpr int THREADS = P * Q;
  static constexpr int NA = N / P;        // rows of a thread
  static constexpr int NB = N / Q;        // columns of a thread
  static constexpr int RQ = P / Q;        // runs of multipliers a thread's columns take
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  // a run of NA multipliers: whole 16-byte vectors, an odd number of them,
  // so that the runs of 8 threads' vector loads lie in distinct banks
  static constexpr int RV = (NA + V - 1) / V;
  static constexpr int R = (RV % 2 == 1 ? RV : RV + 1) * V;
  static constexpr int CB = (N + V - 1) / V * V;
  // the multipliers (P runs), the column, the pivots
  static constexpr int ELEMS = P * R + 2 * CB;
  // a block: one instance, or two of 16 threads (a warp's barriers)
  static constexpr int INSTANCES = THREADS < 32 ? 32 / THREADS : 1;
  static constexpr int BLOCK = INSTANCES * THREADS;
  // (a, b) holds a lower entry for some thread: i = p + P a >= k = q + Q b
  __host__ __device__ static constexpr bool slot(int a, int b) { return P * a + P - 1 >= Q * b; }
};

template <int THREADS>
__device__ __forceinline__ void group_sync() {
  if constexpr (THREADS <= 32) __syncwarp(); else __syncthreads();
}

// grid = blocks of INSTANCES instances, block = INSTANCES x P x Q threads
template <typename T, int N, int P, int Q>
__global__ void __launch_bounds__(ColumnLayout<T, N, P, Q>::BLOCK, 1)  // 1: no spills
ldlt_column_kernel(const T* __restrict__ A, T* __restrict__ L, T* __restrict__ d,
                   long long* __restrict__ pos, long long* __restrict__ neg,
                   long long* __restrict__ zero, int batch, int dim, T rtol) {
  using Lay = ColumnLayout<T, N, P, Q>;
  constexpr int TH = Lay::THREADS, NA = Lay::NA, NB = Lay::NB, RQ = Lay::RQ;
  constexpr int V = Lay::V, R = Lay::R;
  constexpr int DIVS = (N - 1 + TH - 1) / TH;   // divisions of a thread a column, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = threadIdx.x / TH, t = threadIdx.x % TH, p = t % P, q = t / P;
  T* lbuf = reinterpret_cast<T*>(smem_raw) + g * Lay::ELEMS;  // column j's multipliers,
                                             // row i at (i % P) R + i / P
  T* cbuf = lbuf + P * R;                    // column j as updated so far, row i at i
  T* dbuf = cbuf + Lay::CB;                  // the pivots
  const int n = dim;
  // a block's last instances may lie past the batch: they factor zeros
  // beside the others (the warp's barriers need them) and store nothing
  const long long inst = static_cast<long long>(blockIdx.x) * Lay::INSTANCES + g;
  const bool real = inst < batch;
  const long long nn = static_cast<long long>(n) * n;
  const T* a_in = A + (real ? inst : 0) * nn;
  // the padding rows' multipliers, never written below, are zeros
  for (int e = t; e < P * R; e += TH) lbuf[e] = T(0);

  // the thread's entries of the lower triangle, every load in flight at once
  T r[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (Lay::slot(a, b)) {
        const int i = p + P * a, k = q + Q * b;
        r[a][b] = (real && i < n && k <= i) ? a_in[i * n + k] : T(0);
      }

#pragma unroll
  for (int J = 0; J < NA; ++J) {
    // columns j0 .. j0 + P - 1: rows a < J and columns b < RQ J are done
    const int j0 = P * J;
    const int jn = min(P, n - j0);
#pragma unroll 1
    for (int jj = 0; jj < jn; ++jj) {
      const int j = j0 + jj;
      // 1. column j from the threads holding it (q = j % Q); every row of
      // the block's rows on goes, the ones above j unread
#pragma unroll
      for (int c = 0; c < RQ; ++c)
        if (q + Q * (RQ * J + c) == j) {
#pragma unroll
          for (int a = J; a < NA; ++a) cbuf[p + P * a] = r[a][RQ * J + c];
        }
      group_sync<TH>();
      // 2. the pivot, and the multipliers of rows j + 1.. over the threads:
      // row j + 1 + t + TH u for thread t, straight-line, with the exact
      // division only where a warp has a quotient off the fast path
      const T dj = cbuf[j];
      const T s = safe_pivot(dj);
      const T y = rcp_rn(s);
      T lv[DIVS], av[DIVS];
      bool slow[DIVS], any = false;
#pragma unroll
      for (int u = 0; u < DIVS; ++u) {
        const unsigned i = j + 1 + t + TH * u;
        av[u] = i < unsigned(n) ? cbuf[i] : T(0);
        lv[u] = div_by_fast(av[u], s, y, slow[u]);
        any |= slow[u];
      }
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int u = 0; u < DIVS; ++u)
          if (slow[u]) lv[u] = div_rn(av[u], s);
      }
#pragma unroll
      for (int u = 0; u < DIVS; ++u) {
        const unsigned i = j + 1 + t + TH * u;
        if (i < unsigned(n)) lbuf[(i % P) * R + i / P] = lv[u];
      }
      if (t == 0) dbuf[j] = dj;
      group_sync<TH>();
      // 3. the multipliers of the thread's rows and columns (row q + Q c of
      // the runs holds columns b = RQ m + c), then its updates
      T lr[NA], lc[NB];
#pragma unroll
      for (int a0 = J / V * V; a0 < NA; a0 += V) {
        T buf[V];
        load16(lbuf + p * R + a0, buf);
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (a0 + u < NA) lr[a0 + u] = buf[u];
      }
#pragma unroll
      for (int c = 0; c < RQ; ++c)
#pragma unroll
        for (int m0 = J / V * V; m0 < NA; m0 += V) {
          T buf[V];
          load16(lbuf + (q + Q * c) * R + m0, buf);
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (m0 + u < NA) lc[RQ * (m0 + u) + c] = buf[u];
        }
      // column b of the block is live right of column j and takes column
      // j's multipliers at it; columns right of the block are live.  An
      // entry above the diagonal takes the updates too: no one reads it
#pragma unroll
      for (int b = RQ * J; b < NB; ++b) {
        const int k = q + Q * b;
        const bool in_block = b < RQ * (J + 1);
        const bool live = !in_block || k > j;
        const bool own = in_block && k == j;
#pragma unroll
        for (int a = J; a < NA; ++a)
          if (Lay::slot(a, b)) {
            if (live)
              r[a][b] = fma_rn(-dj, mul_rn(lr[a], lc[b]), r[a][b]);
            else if (own)
              r[a][b] = lr[a];
          }
      }
    }
  }

  if (!real) return;                        // no barrier follows
  // L: the thread's entries of the dense factor, unit diagonal, zeros above
  T* l_out = L + inst * nn;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = p + P * a, k = q + Q * b;
      if (i < n && k < n) {
        T v = T(i == k);
        if (Lay::slot(a, b) && k < i) v = r[a][b];
        l_out[i * n + k] = v;
      }
    }
  T* dv = d + inst * n;
  for (int j = t; j < n; j += TH) dv[j] = dbuf[j];

  // inertia, by the instance's first W lanes: max |d| (NaN propagates),
  // then the counts, each lane over pivots t, t + W, ...
  constexpr int W = TH < 32 ? TH : 32;
  if (t < W) {
    constexpr int U = (N + W - 1) / W;
    T dt[U];
    T m = T(0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dt[u] = t + W * u < n ? dbuf[t + W * u] : T(0);
      m = nan_max(m, fabs(dt[u]));
    }
    // the lanes of one instance: the whole warp or its half (W = 16)
    const unsigned mask = W == 32 ? FULL : 0xffffu << (threadIdx.x & 16);
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(mask, m, o, W));
    const T thresh = mul_rn(rtol, nan_max(m, T(1)));
    unsigned np = 0, nneg = 0, nz = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bool pu, nu, zu;
      classify(dt[u], t + W * u < n, thresh, pu, nu, zu);
      np += pu; nneg += nu; nz += zu;
    }
    np = __reduce_add_sync(mask, np);
    nneg = __reduce_add_sync(mask, nneg);
    nz = __reduce_add_sync(mask, nz);
    if (t == 0) {
      pos[inst] = np;
      neg[inst] = nneg;
      zero[inst] = nz;
    }
  }
}

template <typename T, int N, int P, int Q>
int launch_shape(const void* A, void* L, void* d, void* pos, void* neg,
                 void* zero, int batch, int dim, T rtol, int block, int smem,
                 int grid, cudaStream_t stream, int* launched) {
  using Lay = ColumnLayout<T, N, P, Q>;
  if (smem != Lay::INSTANCES * Lay::ELEMS * static_cast<int>(sizeof(T)) ||
      block != Lay::BLOCK || grid != (batch + Lay::INSTANCES - 1) / Lay::INSTANCES)
    return static_cast<int>(cudaErrorInvalidValue);
  ldlt_column_kernel<T, N, P, Q><<<grid, block, smem, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d),
      static_cast<long long*>(pos), static_cast<long long*>(neg),
      static_cast<long long*>(zero), batch, dim, rtol);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

// N: the dim's bucket of 8; a group of 16 only takes the first bucket
template <typename T, int P, int Q>
int launch_group(const void* A, void* L, void* d, void* pos, void* neg,
                 void* zero, int batch, int dim, T rtol, int block, int smem,
                 int grid, cudaStream_t stream, int* launched) {
  switch ((dim + 7) / 8 * 8) {
    case 40:
      return launch_shape<T, 40, P, Q>(A, L, d, pos, neg, zero, batch, dim, rtol, block, smem, grid, stream, launched);
    case 48:
      if constexpr (P * Q >= 32)
        return launch_shape<T, 48, P, Q>(A, L, d, pos, neg, zero, batch, dim, rtol, block, smem, grid, stream, launched);
      break;
    case 56:
      if constexpr (P * Q >= 32)
        return launch_shape<T, 56, P, Q>(A, L, d, pos, neg, zero, batch, dim, rtol, block, smem, grid, stream, launched);
      break;
    case 64:
      if constexpr (P * Q >= 32)
        return launch_shape<T, 64, P, Q>(A, L, d, pos, neg, zero, batch, dim, rtol, block, smem, grid, stream, launched);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan of linalg/cuda_ldlt.py: `group` threads per instance (16 up to
// dim 40, 32 or 64; any of them is taken, so that each can be timed), a
// block of one instance or two of 16 threads, a grid that covers the batch,
// and the instances' shared memory.
template <typename T>
int launch_column(const void* A, void* L, void* d, void* pos, void* neg,
                  void* zero, int batch, int dim, double rtol, int group,
                  int block, int smem, int grid, void* stream, int* launched) {
  *launched = 0;
  if (batch <= 0 || dim <= 32 || dim > 64) return static_cast<int>(cudaErrorInvalidValue);
  const T r = static_cast<T>(rtol);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 16:
      return launch_group<T, 4, 4>(A, L, d, pos, neg, zero, batch, dim, r, block, smem, grid, s, launched);
    case 32:
      return launch_group<T, 8, 4>(A, L, d, pos, neg, zero, batch, dim, r, block, smem, grid, s, launched);
    case 64:
      return launch_group<T, 8, 8>(A, L, d, pos, neg, zero, batch, dim, r, block, smem, grid, s, launched);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// A: (batch, dim, dim) contiguous; L: (batch, dim, dim); d: (batch, dim);
// pos, neg, zero: (batch,) int64.  `rtol` is the zero-pivot tolerance.  A
// plan this side would not launch is refused with cudaErrorInvalidValue.
// Launches on `stream`, sets *launched to the kernels it launched (1) and
// returns cudaGetLastError() (0 on success).
extern "C" int uno_ldlt_column_f32(const void* A, void* L, void* d, void* pos,
                                   void* neg, void* zero, int batch, int dim,
                                   double rtol, int group, int block, int smem,
                                   int grid, void* stream, int* launched) {
  return launch_column<float>(A, L, d, pos, neg, zero, batch, dim, rtol, group,
                              block, smem, grid, stream, launched);
}

extern "C" int uno_ldlt_column_f64(const void* A, void* L, void* d, void* pos,
                                   void* neg, void* zero, int batch, int dim,
                                   double rtol, int group, int block, int smem,
                                   int grid, void* stream, int* launched) {
  return launch_column<double>(A, L, d, pos, neg, zero, batch, dim, rtol, group,
                               block, smem, grid, stream, launched);
}
