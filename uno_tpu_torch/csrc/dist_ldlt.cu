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
//     C[i, k] = C[i, k] - dj * (l_i * l_{row0+k})       every row i, column k
//     C[i, jj] = l_i;   d[jj] = dj
// with correctly rounded operations and no contraction into fused
// multiply-adds, so that it equals panel_factor_plain bit for bit.  The
// multipliers of the panel's own rows, l_{row0+k}, are 0 for k <= jj, so
// for those columns the update subtracts the one value dj * (l_i * 0)
// (a zero, or NaN where dj or l_i is not finite), as the plain version does.
//
// Design: the pivots and the panel's multipliers of every column depend on
// the diagonal block's rows alone.  A row is held in the registers of a
// group of 4 threads, each with a quarter of its columns in 16-byte chunks
// dealt round the group (thread q has chunks q, q+4, ...), so that a
// column's updates right of the pivot are even over the group and a
// thread holds 16 values of a row at BLOCK 64 (8 at 32).  One block of 512
// threads per panel:
//  (1) the diagonal block's BLOCK rows, a group each; at column jj the
//      holder of each row's column-jj entry writes it to a shared vector
//      (two of them, by the column's parity), one barrier, then every
//      thread reads the pivot, its row's multiplier and the panel's
//      multipliers from it and updates its entries.  The pivots, their
//      reciprocals and every column's multipliers stay in shared memory;
//  (2) every other row then runs the same column loop in its group, 128
//      rows at a time, the holder of column jj passing the entry by a
//      shuffle within the group: no barrier, each row read and written
//      once.  Rows above row0 come out zero (their l is 0 at every column)
//      when every pivot and multiplier is finite, and are written so
//      directly; otherwise they run the loop too, so that NaN and Inf
//      spread as in the plain version.
//
// Bound on this card: it moves the slab once (n * BLOCK elements in and
// out) and does about 2 n BLOCK^2 operations; on the one SM its block runs
// on, the operations take longer than the bytes, so it is bound by that
// SM's arithmetic.  Simple and right first: rows over several blocks (each
// repeating the diagonal block) would spread it over the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldlt_common.cuh"

namespace {

constexpr int DIST_THREADS = 512;
constexpr int LANES = 4;             // threads a row

// A row's share in a thread of its group: PER chunks of V = 16 / sizeof(T)
// columns, chunk u of thread q holding columns (q + LANES u) V .. + V - 1
template <typename T, int BLOCK>
struct Share {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PER = BLOCK / V / LANES;
  static constexpr int R = PER * V;                  // values a thread
  static_assert(BLOCK % (V * LANES) == 0, "BLOCK splits into the group's chunks");
  __device__ static constexpr int col(int q, int u, int v) { return (q + LANES * u) * V + v; }
  // the holder of column jj and the index of its entry there
  __host__ __device__ static constexpr int owner(int jj) { return (jj / V) % LANES; }
  __host__ __device__ static constexpr int slot(int jj) { return (jj / V / LANES) * V + jj % V; }
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

// column jj's update of a thread's entries of a row whose multiplier is li:
// right of the pivot a - dj * (li * lk), left of it a - dj * (li * 0), and
// the multiplier itself at column jj; lk(k) gives the panel's multiplier
template <typename T, int BLOCK, typename LK>
__device__ __forceinline__ void update_share(T (&r)[Share<T, BLOCK>::R], int q, int jj,
                                             T dj, T li, LK lk) {
  using S = Share<T, BLOCK>;
  const T z = mul_rn(dj, mul_rn(li, T(0)));
#pragma unroll
  for (int u = 0; u < S::PER; ++u) {
    T l[S::V];
    lk(u, l);
#pragma unroll
    for (int v = 0; v < S::V; ++v) {
      const int k = S::col(q, u, v);
      T& a = r[u * S::V + v];
      a = k > jj ? sub_rn(a, mul_rn(dj, mul_rn(li, l[v]))) : (k < jj ? sub_rn(a, z) : li);
    }
  }
}

// rows first .. first+count-1, each in a group, `groups` rows at a time,
// given every column's pivot dp, reciprocal rp and panel multipliers lp
// (lp[jj * BLOCK + k]) in shared memory; the trip count is the same for
// every thread, rows past the range compute zeros and are not written
template <typename T, int BLOCK>
__device__ __forceinline__ void run_rows(T* C, int ld, int row0, int first, int count,
                                         const T* dp, const T* rp, const T* lp, bool vec) {
  using S = Share<T, BLOCK>;
  const int groups = blockDim.x / LANES;
  const int g = threadIdx.x / LANES, q = threadIdx.x % LANES;
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
#pragma unroll
    for (int jj = 0; jj < BLOCK; ++jj) {
      const T a = __shfl_sync(FULL, r[S::slot(jj)], S::owner(jj), LANES);
      const T li = i - row0 > jj ? mul_rn(a, rp[jj]) : T(0);
      update_share<T, BLOCK>(r, q, jj, dp[jj], li, [&](int u, T (&l)[S::V]) {
        load16(lp + jj * BLOCK + S::col(q, u, 0), l);
      });
    }
    if (live) store_share<T, BLOCK>(p, q, r, vec);
  }
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(DIST_THREADS, 1)
dist_panel_kernel(T* __restrict__ C, T* __restrict__ d, int n, int ld, int row0,
                  int vec) {
  using S = Share<T, BLOCK>;
  __shared__ __align__(16) T lp[BLOCK * BLOCK];   // column jj's multipliers
  __shared__ __align__(16) T col[2][BLOCK];       // the diagonal rows' column jj
  __shared__ T dp[BLOCK], rp[BLOCK];              // pivots and their reciprocals
  const int t = threadIdx.x;
  const int row = t / LANES, q = t % LANES;
  const bool diag = t < LANES * BLOCK;

  // (1) the diagonal block, a row a group
  T r[S::R];
  bool finite = true;
  if (diag) load_share<T, BLOCK>(C + static_cast<long long>(row0 + row) * ld, q, r, vec);
#pragma unroll
  for (int jj = 0; jj < BLOCK; ++jj) {
    const T* c = col[jj & 1];
    if (diag && q == S::owner(jj)) col[jj & 1][row] = r[S::slot(jj)];
    __syncthreads();
    if (diag) {
      const T dj = c[jj];
      const T inv = div_rn(T(1), safe_pivot(dj));
      const T li = row > jj ? mul_rn(c[row], inv) : T(0);
      update_share<T, BLOCK>(r, q, jj, dj, li, [&](int u, T (&l)[S::V]) {
#pragma unroll
        for (int v = 0; v < S::V; ++v) l[v] = mul_rn(c[S::col(q, u, v)], inv);
      });
      if (q == S::owner(jj)) {
        lp[jj * BLOCK + row] = li;
        finite = finite && isfinite(li);
      }
      if (t == 0) {
        dp[jj] = dj;
        rp[jj] = inv;
        finite = finite && isfinite(dj);
      }
    }
  }
  if (diag) store_share<T, BLOCK>(C + static_cast<long long>(row0 + row) * ld, q, r, vec);
  const bool all_finite = __syncthreads_and(finite);
  if (t < BLOCK) d[t] = dp[t];

  // (2) the rows above the diagonal block, then those below it
  if (all_finite) {
    for (long long e = t; e < static_cast<long long>(row0) * BLOCK; e += blockDim.x)
      C[(e / BLOCK) * ld + e % BLOCK] = T(0);
  } else {
    run_rows<T, BLOCK>(C, ld, row0, 0, row0, dp, rp, lp, vec);
  }
  run_rows<T, BLOCK>(C, ld, row0, row0 + BLOCK, n - row0 - BLOCK, dp, rp, lp, vec);
}

template <typename T>
int launch_dist_panel(void* C_, void* d_, int n, int ld, int row0, int block,
                      void* stream_, int* launched) {
  *launched = 0;
  if ((block != 32 && block != 64) || n < block || ld < block || row0 < 0 ||
      row0 > n - block)
    return static_cast<int>(cudaErrorInvalidValue);
  T* C = static_cast<T*>(C_);
  T* d = static_cast<T*>(d_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int vec = aligned16(C) && (static_cast<long long>(ld) * sizeof(T)) % 16 == 0;
  if (block == 32)
    dist_panel_kernel<T, 32><<<1, DIST_THREADS, 0, stream>>>(C, d, n, ld, row0, vec);
  else
    dist_panel_kernel<T, 64><<<1, DIST_THREADS, 0, stream>>>(C, d, n, ld, row0, vec);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

}  // namespace

// C: the slab's first element, n rows of `block` columns (32 or 64) at a
// row stride of ld elements, factored in place; d: `block` pivots out;
// the pivots lie on rows row0 .. row0+block-1.  Launches one block of
// threads on `stream`, sets *launched to the kernels it launched and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for sizes it
// does not take.
extern "C" int uno_dist_panel_f32(void* C, void* d, int n, int ld, int row0,
                                  int block, void* stream, int* launched) {
  return launch_dist_panel<float>(C, d, n, ld, row0, block, stream, launched);
}

extern "C" int uno_dist_panel_f64(void* C, void* d, int n, int ld, int row0,
                                  int block, void* stream, int* launched) {
  return launch_dist_panel<double>(C, d, n, ld, row0, block, stream, launched);
}
