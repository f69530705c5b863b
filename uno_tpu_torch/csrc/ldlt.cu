// Batched unpivoted LDL^T with inertia of dense symmetric KKT matrices, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of uno_tpu/linalg/pallas_ldlt.py:
//   ldlt_factor_pallas          -> _ldlt_kernel          (one instance)
//   ldlt_factor_pallas_batched  -> _ldlt_kernel_batched  (one instance per grid step)
// by three kernels routed by dim (the Python side, linalg/cuda_ldlt.py's
// plan(), picks the route and the launch sizes; the C side checks them):
//
//   ldlt_warp   dim <= 32.  A group of G lanes (G = 8, 16 or 32, the dim's
//               bucket) factors one instance, so a warp takes 32/G of them
//               and a block 8 warps' worth.  Lane i holds row i in
//               registers; column j broadcasts d_j with __shfl_sync and
//               every l_kj through a shared-memory column buffer read 16
//               bytes at a time, and each lane updates its own row: no
//               block barrier inside the factorization.  The block stages its
//               instances' contiguous matrices through shared memory with
//               16-byte loads and stores; a lane reads its row 16 bytes at
//               a time where the row length allows.  One kernel per
//               bucket serves every dim in it: lanes past the dim update
//               zeros rather than branch.
//   ldlt_column 32 < dim <= 64, in csrc/ldlt_column.cu: the column form's
//               operations in its order, the lower triangle in registers
//               spread over a group of threads per instance.
//   ldlt_panel  dim > 64, any batch (B = 1 too).  Right-looking blocked
//               LDL^T, panel width 32, two launches per panel step from one
//               C loop: (a) a panel kernel over instances x chunks of rows
//               below the panel, each block factoring the 32x32 diagonal
//               block with ldlt_warp's device function and solving its rows
//               by forward substitution; (b) a trailing-update kernel over
//               instances x 64x64 tiles (32x32 up to dim 64) of the trailing
//               block's lower triangle, C -= (L_i D) L_k^T on CUDA cores.
//               The ragged last panel is masked, not padded, and has no
//               trailing update, so a call makes 2*ceil(dim/32) - 1 launches.
//
// Each entry point reports the kernels it launched through `launched`, so
// the wrapper counts launches where they are made.
//
// Arithmetic: the reference's, column by column (the plain versions are
// uno_tpu_torch/linalg/ldlt.py's ldlt_factor / _unrolled / _blocked):
//   dj = a_jj;  l = a_{>j,j} / safe(dj);  a_ik = fma(-dj, l_i * l_k, a_ik)
// with safe() the +-1e-35 clamp of _safe, in increasing column order, with
// correctly rounded multiplies and divisions, and the update's product by
// dj fused into its subtraction, as XLA:CPU compiles uno_tpu's updates and
// torch.addcmul computes the plain versions' (tools/xla_fma_census.py):
// ldlt_warp, ldlt_column and the panel elimination of ldlt_panel repeat
// the plain versions' operations exactly.
// (ldlt_column and the row solves of ldlt_panel divide by Markstein's
// correction of a correctly rounded reciprocal, which gives the correctly
// rounded quotient.)  The trailing
// update sums its 32 products in increasing column order with fused
// multiply-adds, as a matrix product does.  IEEE float32 / float64
// throughout; no TF32, no tensor cores.
//
// Inertia, in the kernel (the last panel step for ldlt_panel): |pivot| <=
// rtol * max(max|d|, 1) counts as zero, otherwise by sign, with the
// threshold computed in the dtype of d and a NaN anywhere in d propagating
// into it, exactly as _inertia / _pivot_threshold do.
//
// Bound on this card: ldlt_warp moves ~1.5 dim^2 elements per instance for
// dim^3/3 flops, so it is bound by bytes; its design spends them once,
// with coalesced 16-byte accesses, but at dim 12 its instructions (the
// divisions, the idle lanes of a 16-lane group, the updates of the upper
// triangle each lane holds) take longer than its bytes (PERF.md;
// tools/ldlt_kernel_study.py builds this file with the UNO_LDLT_STUDY_*
// switches below to time those parts, and instantiates fixed-dim kernels).
// ldlt_panel reads and writes the trailing block once per panel step (not
// once per column) and spreads each step over every SM whatever the batch;
// its per-step cost is the 32-column factorization of the diagonal block
// on one warp, a serial chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldlt_common.cuh"

namespace {

constexpr int WARP_THREADS = 256;   // ldlt_warp's largest block
constexpr int PB = 32;              // ldlt_panel's panel width
// trailing-update tiles: 64 x 64, or 32 x 32 when the trailing block is no
// larger (dims 33 to 64); a thread computes 4 x 4 of a tile
__host__ __device__ constexpr int trail_threads(int tile) { return (tile / 4) * (tile / 4); }
constexpr int DEFAULT_SMEM = 48 * 1024;

// Factor the matrix of an instance of `dim` <= G rows held by a group of G
// lanes, lane i holding row i (only its lower part, r[k] for k <= i, is
// read; lanes i >= dim carry zeros).  DIM is dim when it is known at
// compile time, else 0.  On return lane i holds l_ik in r[k] for k < i;
// returns its pivot d_i.  Every lane of the warp must call it with the
// same dim.  `cb` is the group's G elements of 16-byte aligned shared
// memory: column j's l_kj pass through it, read 16 bytes at a time, which
// takes a quarter (float) or an eighth (double) of the shuffles it
// replaces.
template <typename T, int G, int DIM>
__device__ __forceinline__ T factor_rows(T (&r)[G], int i, int dim, T* cb) {
  constexpr int V = 16 / sizeof(T);
  const int n = DIM ? DIM : dim;
  T di = T(0);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < n) {
      const T dj = __shfl_sync(FULL, r[j], j, G);
      if (i == j) di = dj;
      // l_ij = a_ij / safe(d_j).  A zero a_ij, and the lanes that need no
      // l (i <= j), divide s by itself: the division's slow path, which a
      // zero dividend takes, would hold up the whole warp.  0 / s is the
      // zero of the quotient's sign.
      const T s = safe_pivot(dj);
      const bool zero_a = r[j] == T(0);
#ifdef UNO_LDLT_STUDY_NO_DIVISION   // products in place of the divisions
      T lj = mul_rn(r[j], s);
#else
      T lj = div_rn(i > j && !zero_a ? r[j] : s, s);
#endif
      if (zero_a) lj = r[j] * (s < T(0) ? T(-1) : T(1));
      if (i > j) r[j] = lj;
      // with a run-time dim every lane updates all G - 1 - j columns: the
      // ones past dim are padding, and a branch per column costs more
      cb[i] = r[j];
      __syncwarp();
#pragma unroll
      for (int q = (j + 1) / V * V; q < G; q += V) {
        if (DIM == 0 || q < DIM) {
          T lk[V];
          load16(cb + q, lk);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const int k = q + u;
            if (k > j && (DIM == 0 || k < DIM))
              r[k] = fma_rn(-dj, mul_rn(lj, lk[u]), r[k]);
          }
        }
      }
      __syncwarp();                        // before column j + 1 is written
    }
  }
  return di;
}

// Copy `elems` contiguous elements between global and shared memory, 16
// bytes at a time where the global side is aligned (`sm` always is).
template <typename T>
__device__ void copy_in(const T* __restrict__ src, T* sm, int elems) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (aligned16(src)) {
    const int nv = elems / V;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      T buf[V];
      load16(src + v * V, buf);
      store16(sm + v * V, buf);
    }
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < elems; e += blockDim.x) sm[e] = src[e];
}

template <typename T>
__device__ void copy_out(const T* sm, T* __restrict__ dst, int elems) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (aligned16(dst)) {
    const int nv = elems / V;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      T buf[V];
      load16(sm + v * V, buf);
      store16(dst + v * V, buf);
    }
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < elems; e += blockDim.x) dst[e] = sm[e];
}

// ---------------------------------------------------------------------------
// ldlt_warp: dim <= G, blockDim.x / G instances per block
// ---------------------------------------------------------------------------

// DIM is the dim when the kernel is compiled for one, else 0 (the library
// compiles DIM = 0 only).
// Shared memory holds the block's instances as they lie in global memory;
// a row is read 16 bytes at a time when its length allows.
template <typename T, int G, int DIM>
__global__ void __launch_bounds__(WARP_THREADS)
ldlt_warp_kernel(const T* __restrict__ A, T* __restrict__ L, T* __restrict__ d,
                 long long* __restrict__ pos, long long* __restrict__ neg,
                 long long* __restrict__ zero, int batch, int dim_, T rtol) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int dim = DIM ? DIM : dim_;
  const int per_block = blockDim.x / G;
  const long long nn = static_cast<long long>(dim) * dim;
  const long long inst0 = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block), batch - inst0));
  const int elems = count * static_cast<int>(nn);
  // after the instances: one column buffer of G elements per group
  T* cb = sm + (per_block * static_cast<int>(nn) + V - 1) / V * V;

#ifndef UNO_LDLT_STUDY_NO_GLOBAL_MEMORY
  copy_in(A + inst0 * nn, sm, elems);
#endif
  __syncthreads();

  const int g = threadIdx.x / G;         // instance within the block
  const int i = threadIdx.x % G;         // row within the instance
  const bool live = g < count && i < dim;
  const bool rowvec = dim % V == 0;      // rows start 16-byte aligned
  T* row = sm + (g * dim + i) * dim;
  T r[G];
#pragma unroll
  for (int k = 0; k < G; ++k) r[k] = T(0);
  if (live) {
    if (rowvec) {
#pragma unroll
      for (int q = 0; q < G; q += V) {
        if (q < dim) {
          T buf[V];
          load16(row + q, buf);
#pragma unroll
          for (int u = 0; u < V; ++u) r[q + u] = buf[u];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        if (k < dim) r[k] = row[k];
    }
  }

#ifdef UNO_LDLT_STUDY_NO_FACTORIZATION
  const T di = r[0];
#else
  const T di = factor_rows<T, G, DIM>(r, i, dim, cb + (threadIdx.x - i));
#endif

  if (live) {
#pragma unroll
    for (int k = 0; k < G; ++k) r[k] = k < i ? r[k] : (k == i ? T(1) : T(0));
    if (rowvec) {
#pragma unroll
      for (int q = 0; q < G; q += V) {
        if (q < dim) {
          T buf[V];
#pragma unroll
          for (int u = 0; u < V; ++u) buf[u] = r[q + u];
          store16(row + q, buf);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        if (k < dim) row[k] = r[k];
    }
    d[(inst0 + g) * dim + i] = di;
  }

  // inertia: the group's max |d| (NaN propagates), then counts by ballot
  T m = live ? fabs(di) : T(0);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(FULL, m, o, G));
  const T thresh = mul_rn(rtol, nan_max(m, T(1)));
  bool p, n, z;
  classify(di, live, thresh, p, n, z);
  const unsigned lane = threadIdx.x & 31;
  const unsigned gmask = (G == 32 ? FULL : ((1u << (G & 31)) - 1u)) << (lane & ~(G - 1u));
  const int np = __popc(__ballot_sync(FULL, p) & gmask);
  const int nneg = __popc(__ballot_sync(FULL, n) & gmask);
  const int nz = __popc(__ballot_sync(FULL, z) & gmask);
  if (i == 0 && g < count) {
    pos[inst0 + g] = np;
    neg[inst0 + g] = nneg;
    zero[inst0 + g] = nz;
  }

  __syncthreads();
#ifndef UNO_LDLT_STUDY_NO_GLOBAL_MEMORY
  copy_out(sm, L + inst0 * nn, elems);
#endif
}

// ---------------------------------------------------------------------------
// ldlt_panel (a): factor the panel [k0, k0 + bw) of every instance
// ---------------------------------------------------------------------------

// Warp 0's factorization of the bw x bw diagonal block in D (rows of stride
// PB + V, zeros above the diagonal and past bw), with the first G >= bw
// lanes holding its rows: D becomes its L (unit diagonal, zeros above),
// piv its pivots and rc their reciprocals.  Lanes G.. factor zeros.  `cb`
// is 32 elements of 16-byte aligned shared memory.
template <typename T, int G>
__device__ __forceinline__ void factor_diag(T* D, T* piv, T* rc, T* cb, int t, int bw) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SP = PB + V;
  T r[G];
#pragma unroll
  for (int q = 0; q < G; q += V) {
    T buf[V];
    load16(D + t * SP + q, buf);
#pragma unroll
    for (int u = 0; u < V; ++u) r[q + u] = t < G ? buf[u] : T(0);
  }
  const T dt = factor_rows<T, G, 0>(r, t % G, bw, cb + (t - t % G));
  if (t >= G) return;
#pragma unroll
  for (int q = 0; q < G; q += V) {
    T buf[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int k = q + u;
      buf[u] = k < t ? r[k] : (k == t ? T(1) : T(0));
    }
    store16(D + t * SP + q, buf);
  }
  piv[t] = dt;
  rc[t] = rcp_rn(safe_pivot(dt));
}

// ROWS rows per chunk, one thread each; grid = instances x chunks.  `src` is
// A at the first step (the factorization then continues in L) and L after
// it.  Loads are issued in batches before their stores to shared memory, so
// that their latencies overlap.
template <typename T, int ROWS>
__global__ void __launch_bounds__(ROWS) ldlt_panel_kernel(const T* src, T* L, T* d,
                                  long long* __restrict__ pos,
                                  long long* __restrict__ neg,
                                  long long* __restrict__ zero, int dim, int k0,
                                  int chunks, T rtol, int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SP = PB + V;              // row stride: 16-byte rows, no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* D = reinterpret_cast<T*>(smem_raw);  // PB x SP: the diagonal block, then its L
  T* piv = D + PB * SP;                   // PB pivots
  T* rc = piv + PB;                       // their reciprocals, rcp_rn(safe_pivot(.))
  __shared__ T red[32];
  __shared__ __align__(16) T cb[32];
  __shared__ int counts[3];

  constexpr int rows = ROWS;
  constexpr int BATCH = 8;                // loads in flight per thread
  const int t = threadIdx.x;
  const long long inst = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - inst * chunks);
  const long long nn = static_cast<long long>(dim) * dim;
  const T* a = src + inst * nn;
  T* l = L + inst * nn;
  T* dv = d + inst * dim;
  const int bw = min(PB, dim - k0);        // < PB only on the last panel
  const int r0 = k0 + bw + chunk * rows;   // first row, and column, of the chunk
  const int nr = max(0, min(rows, dim - r0));

  // element e = t + q * rows of the diagonal block: its column, e % PB, is
  // the same for every q
  const int j0 = t % PB;
#pragma unroll
  for (int q0 = 0; q0 < PB * PB / rows; q0 += BATCH) {
    T v[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int i = (t + (q0 + q) * rows) / PB;
      v[q] = (i < bw && j0 <= i) ? a[static_cast<long long>(k0 + i) * dim + k0 + j0] : T(0);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) D[((t + (q0 + q) * rows) / PB) * SP + j0] = v[q];
  }
  __syncthreads();

  if (t < 32) {                             // warp 0 factors the diagonal block,
    if (bw > 16)                            // in lane groups of its width's bucket
      factor_diag<T, 32>(D, piv, rc, cb, t, bw);
    else if (bw > 8)
      factor_diag<T, 16>(D, piv, rc, cb, t, bw);
    else
      factor_diag<T, 8>(D, piv, rc, cb, t, bw);
  }
  __syncthreads();

  if (t < nr) {                             // forward substitution of row r0 + t
    T x[PB];
    T* row = l + static_cast<long long>(r0 + t) * dim + k0;
    const T* arow = a + static_cast<long long>(r0 + t) * dim + k0;
    if (vec) {                              // 16-byte aligned rows
#pragma unroll
      for (int q = 0; q < PB; q += V) {
        T buf[V];
        load16(arow + q, buf);
#pragma unroll
        for (int u = 0; u < V; ++u) x[q + u] = buf[u];
      }
    } else {
#pragma unroll
      for (int c = 0; c < PB; ++c) x[c] = arow[c];
    }
#pragma unroll
    for (int c = 0; c < PB; ++c) {
      T v = x[c];
#pragma unroll
      for (int j0 = 0; j0 < c; j0 += V) {
        T dc[V], pj[V];
        load16(D + c * SP + j0, dc);
        load16(piv + j0, pj);
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (j0 + u < c) v = fma_rn(-pj[u], mul_rn(x[j0 + u], dc[u]), v);
      }
      x[c] = div_by(v, safe_pivot(piv[c]), rc[c]);
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < PB; q += V) {
        T buf[V];
#pragma unroll
        for (int u = 0; u < V; ++u) buf[u] = x[q + u];
        store16(row + q, buf);
      }
    } else {
#pragma unroll
      for (int c = 0; c < PB; ++c) row[c] = x[c];
    }
  }

  if (t < nr) {                             // zeros above the diagonal
    for (int i = 0; i < bw; ++i) l[static_cast<long long>(k0 + i) * dim + r0 + t] = T(0);
  }
  if (chunk != 0) return;

  // The diagonal block.  Other chunks of this launch may still be reading
  // its lower part, so before the last step it goes, transposed, into the
  // upper part, which nobody reads; the trailing kernel moves it.
  const bool last = k0 + bw == dim;
  for (int e = t; e < PB * PB; e += rows) {
    const int i = e / PB, j = e % PB;
    if (i >= bw || j >= bw) continue;
    if (last) l[static_cast<long long>(k0 + i) * dim + k0 + j] = D[i * SP + j];
    else if (i > j) l[static_cast<long long>(k0 + j) * dim + k0 + i] = D[i * SP + j];
  }
  if (t < bw) dv[k0 + t] = piv[t];
  if (!last) return;

  // the last step: the inertia of the whole d
  __syncthreads();
  T m = T(0);
#pragma unroll 8
  for (int e = t; e < dim; e += rows) m = nan_max(m, fabs(dv[e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(FULL, m, o));
  if ((t & 31) == 0) red[t >> 5] = m;
  if (t < 3) counts[t] = 0;
  __syncthreads();
  if (t == 0) {
    T mm = red[0];
    for (int w = 1; w < rows / 32; ++w) mm = nan_max(mm, red[w]);
    red[0] = mul_rn(rtol, nan_max(mm, T(1)));
  }
  __syncthreads();
  const T thresh = red[0];
  int np = 0, nneg = 0, nz = 0;
#pragma unroll 8
  for (int e = t; e < dim; e += rows) {
    bool p, n, z;
    classify(dv[e], true, thresh, p, n, z);
    np += p; nneg += n; nz += z;
  }
  atomicAdd(&counts[0], np);
  atomicAdd(&counts[1], nneg);
  atomicAdd(&counts[2], nz);
  __syncthreads();
  if (t == 0) {
    pos[inst] = counts[0];
    neg[inst] = counts[1];
    zero[inst] = counts[2];
  }
}

// ---------------------------------------------------------------------------
// ldlt_panel (b): C -= (L_i D) L_k^T on the trailing block's lower triangle
// ---------------------------------------------------------------------------

// grid = instances x tiles, the tiles of the lower triangle row by row;
// reads C from `src`, writes L.  Runs only after a full panel (bw = PB).
// Tile 0's block also writes the panel's diagonal block of L.
template <typename T, int TILE>
__global__ void __launch_bounds__(trail_threads(TILE))
ldlt_trail_kernel(const T* src, T* L, const T* __restrict__ d, int dim, int k0,
                  int tiles, int vec) {
  constexpr int SW = TILE + 16 / sizeof(T);  // row stride, 16-byte aligned
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);  // PB x SW: (l_ij * d_j), transposed
  T* V = W + PB * SW;                     // PB x SW: l_kj, transposed

  const long long inst = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - inst * tiles);
  int ti = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  while (ti * (ti + 1) / 2 > tile) --ti;
  const int tk = tile - ti * (ti + 1) / 2;
  const int row0 = k0 + PB + ti * TILE;
  const int col0 = k0 + PB + tk * TILE;
  const long long nn = static_cast<long long>(dim) * dim;
  const T* a = src + inst * nn;
  T* l = L + inst * nn;
  const T* dp = d + inst * dim + k0;
  constexpr int TRAIL_THREADS = trail_threads(TILE);
  const int t = threadIdx.x, tx = t % (TILE / 4), ty = t / (TILE / 4);

  if (tile == 0) {
    // the panel's diagonal block of L, from the upper part where the panel
    // kernel left it transposed: unit diagonal, zeros above
    T blk[PB * PB / TRAIL_THREADS];
#pragma unroll
    for (int q = 0; q < PB * PB / TRAIL_THREADS; ++q) {
      const int e = t + q * TRAIL_THREADS, i = e / PB, j = e % PB;
      blk[q] = i > j ? l[static_cast<long long>(k0 + j) * dim + k0 + i] : T(i == j);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PB * PB / TRAIL_THREADS; ++q) {
      const int e = t + q * TRAIL_THREADS, i = e / PB, j = e % PB;
      l[static_cast<long long>(k0 + i) * dim + k0 + j] = blk[q];
    }
  }

  // C first: its loads are in flight while the panel is staged
  T c[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = row0 + ty * 4 + u;
    const int cb = col0 + tx * 4;
    const T* ar = a + static_cast<long long>(r) * dim;
    // 16-byte loads only where all four columns lie inside the row: with
    // float64 and dim = 2 (mod 4) the last tile column holds two
    if (r < dim && vec && cb + 3 < dim && cb <= r) {
      if constexpr (sizeof(T) == 4) {
        load16(ar + cb, c[u]);
      } else {
        T lo[2], hi[2];
        load16(ar + cb, lo);
        load16(ar + cb + 2, hi);
        c[u][0] = lo[0]; c[u][1] = lo[1]; c[u][2] = hi[0]; c[u][3] = hi[1];
      }
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        c[u][v] = (r < dim && cb + v < dim && cb + v <= r) ? ar[cb + v] : T(0);
    }
  }

  {
    // element e = t + q * TRAIL_THREADS of the tile's rows of the panel;
    // its column, e % PB, is the same for every q.  All loads first.
    constexpr int Q = TILE * PB / TRAIL_THREADS;
    const int j = t % PB;
    const T dj = dp[j];
    T wv[Q], vv[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = (t + q * TRAIL_THREADS) / PB;
      const int r = row0 + i, k = col0 + i;
      wv[q] = r < dim ? l[static_cast<long long>(r) * dim + k0 + j] : T(0);
      vv[q] = k < dim ? l[static_cast<long long>(k) * dim + k0 + j] : T(0);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = (t + q * TRAIL_THREADS) / PB;
      W[j * SW + i] = mul_rn(wv[q], dj);
      V[j * SW + i] = vv[q];
    }
  }
  __syncthreads();

  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    T w[4], x[4];
    if constexpr (sizeof(T) == 4) {
      load16(W + j * SW + ty * 4, w);
      load16(V + j * SW + tx * 4, x);
    } else {
      T p0[2], p1[2];
      load16(W + j * SW + ty * 4, p0);
      load16(W + j * SW + ty * 4 + 2, p1);
      w[0] = p0[0]; w[1] = p0[1]; w[2] = p1[0]; w[3] = p1[1];
      load16(V + j * SW + tx * 4, p0);
      load16(V + j * SW + tx * 4 + 2, p1);
      x[0] = p0[0]; x[1] = p0[1]; x[2] = p1[0]; x[3] = p1[1];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fma_rn(w[u], x[v], acc[u][v]);
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = row0 + ty * 4 + u;
    const int cb = col0 + tx * 4;
    if (r >= dim) continue;
    T* lr = l + static_cast<long long>(r) * dim;
    T out[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) out[v] = sub_rn(c[u][v], acc[u][v]);
    if (vec && cb < dim && cb + 3 <= r) {
      if constexpr (sizeof(T) == 4) {
        store16(lr + cb, out);
      } else {
        const T lo[2] = {out[0], out[1]}, hi[2] = {out[2], out[3]};
        store16(lr + cb, lo);
        store16(lr + cb + 2, hi);
      }
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (cb + v < dim && cb + v <= r) lr[cb + v] = out[v];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

inline int bucket(int dim) { return dim <= 8 ? 8 : (dim <= 16 ? 16 : 32); }

template <typename T, int G, int DIM>
int launch_warp_g(const T* A, T* L, T* d, long long* pos, long long* neg,
                  long long* zero, int batch, int dim, T rtol, int block,
                  int smem, int grid, cudaStream_t stream, int* launched) {
  cudaError_t err = allow_smem(ldlt_warp_kernel<T, G, DIM>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ldlt_warp_kernel<T, G, DIM><<<grid, block, smem, stream>>>(A, L, d, pos, neg,
                                                             zero, batch, dim, rtol);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

template <typename T>
int launch_warp(const void* A, void* L, void* d, void* pos, void* neg,
                void* zero, int batch, int dim, double rtol, int group,
                int block, int smem, int grid, void* stream, int* launched) {
  *launched = 0;
  // the plan must be the one this side would make
  if (batch <= 0 || dim <= 0 || dim > 32 || group != bucket(dim) ||
      block <= 0 || block > WARP_THREADS || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the instances, then a column buffer per group (16-byte aligned)
  const int per_block = block / group;
  constexpr long long V = 16 / sizeof(T);
  const long long need = ((static_cast<long long>(per_block) * dim * dim + V - 1) / V * V + block) * sizeof(T);
  if (smem < need || grid != (batch + per_block - 1) / per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(A);
  T* l = static_cast<T*>(L);
  T* dv = static_cast<T*>(d);
  long long* p = static_cast<long long*>(pos);
  long long* n = static_cast<long long*>(neg);
  long long* z = static_cast<long long*>(zero);
  const T r = static_cast<T>(rtol);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 8)
    return launch_warp_g<T, 8, 0>(a, l, dv, p, n, z, batch, dim, r, block, smem, grid, s, launched);
  if (group == 16)
    return launch_warp_g<T, 16, 0>(a, l, dv, p, n, z, batch, dim, r, block, smem, grid, s, launched);
  return launch_warp_g<T, 32, 0>(a, l, dv, p, n, z, batch, dim, r, block, smem, grid, s, launched);
}

template <typename T, int ROWS, int TILE>
int run_panel(const T* A, T* L, T* d, long long* pos, long long* neg,
              long long* zero, int batch, int dim, T rtol, int panel_smem,
              int trail_smem, cudaStream_t stream, int* launched) {
  cudaError_t err = allow_smem(ldlt_panel_kernel<T, ROWS>, panel_smem);
  if (err == cudaSuccess) err = allow_smem(ldlt_trail_kernel<T, TILE>, trail_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (dim * sizeof(T)) % 16 == 0 && aligned16(A) && aligned16(L);
  for (int k0 = 0; k0 < dim; k0 += PB) {
    const int bw = dim - k0 < PB ? dim - k0 : PB;
    const int below = dim - k0 - bw;
    const int chunks = below > 0 ? (below + ROWS - 1) / ROWS : 1;
    const T* src = k0 == 0 ? A : L;
    const long long pgrid = static_cast<long long>(batch) * chunks;
    if (pgrid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    ldlt_panel_kernel<T, ROWS><<<static_cast<unsigned>(pgrid), ROWS, panel_smem, stream>>>(
        src, L, d, pos, neg, zero, dim, k0, chunks, rtol, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    if (below == 0) break;
    const int nt = (below + TILE - 1) / TILE;
    const int tiles = nt * (nt + 1) / 2;
    const long long tgrid = static_cast<long long>(batch) * tiles;
    if (tgrid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    ldlt_trail_kernel<T, TILE><<<static_cast<unsigned>(tgrid), trail_threads(TILE), trail_smem, stream>>>(
        src, L, d, dim, k0, tiles, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

template <typename T>
int launch_panel(const void* A_, void* L_, void* d_, void* pos_, void* neg_,
                 void* zero_, int batch, int dim, double rtol, int rows,
                 int panel_smem, int trail_smem, void* stream_, int* launched) {
  *launched = 0;
  if (batch <= 0 || dim <= 32 || dim > 46340 ||
      (rows != 32 && rows != 64 && rows != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long SP = PB + 16 / sizeof(T);
  const int tile = dim - PB <= 32 ? 32 : 64;
  const long long panel_need = (PB * SP + 2 * PB) * sizeof(T);
  const long long trail_need = 2LL * PB * (tile + 16 / sizeof(T)) * sizeof(T);
  if (tile == 32 && rows != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (panel_smem < panel_need || trail_smem < trail_need)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* A = static_cast<const T*>(A_);
  T* L = static_cast<T*>(L_);
  T* d = static_cast<T*>(d_);
  long long* pos = static_cast<long long*>(pos_);
  long long* neg = static_cast<long long*>(neg_);
  long long* zero = static_cast<long long*>(zero_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const T r = static_cast<T>(rtol);
  if (tile == 32)
    return run_panel<T, 32, 32>(A, L, d, pos, neg, zero, batch, dim, r, panel_smem, trail_smem, stream, launched);
  if (rows == 32)
    return run_panel<T, 32, 64>(A, L, d, pos, neg, zero, batch, dim, r, panel_smem, trail_smem, stream, launched);
  if (rows == 64)
    return run_panel<T, 64, 64>(A, L, d, pos, neg, zero, batch, dim, r, panel_smem, trail_smem, stream, launched);
  return run_panel<T, 128, 64>(A, L, d, pos, neg, zero, batch, dim, r, panel_smem, trail_smem, stream, launched);
}

}  // namespace

// A: (batch, dim, dim) contiguous; L: (batch, dim, dim); d: (batch, dim);
// pos, neg, zero: (batch,) int64.  `rtol` is the zero-pivot tolerance.  The
// launch sizes come from linalg/cuda_ldlt.py's plan(); a plan this side
// would not make is refused with cudaErrorInvalidValue.  Launches on
// `stream`, sets *launched to the number of kernels it launched and
// returns cudaGetLastError() (0 on success).
extern "C" int uno_ldlt_warp_f32(const void* A, void* L, void* d, void* pos,
                                 void* neg, void* zero, int batch, int dim,
                                 double rtol, int group, int block, int smem,
                                 int grid, void* stream, int* launched) {
  return launch_warp<float>(A, L, d, pos, neg, zero, batch, dim, rtol, group,
                            block, smem, grid, stream, launched);
}

extern "C" int uno_ldlt_warp_f64(const void* A, void* L, void* d, void* pos,
                                 void* neg, void* zero, int batch, int dim,
                                 double rtol, int group, int block, int smem,
                                 int grid, void* stream, int* launched) {
  return launch_warp<double>(A, L, d, pos, neg, zero, batch, dim, rtol, group,
                             block, smem, grid, stream, launched);
}

extern "C" int uno_ldlt_panel_f32(const void* A, void* L, void* d, void* pos,
                                  void* neg, void* zero, int batch, int dim,
                                  double rtol, int rows, int panel_smem,
                                  int trail_smem, void* stream, int* launched) {
  return launch_panel<float>(A, L, d, pos, neg, zero, batch, dim, rtol, rows,
                             panel_smem, trail_smem, stream, launched);
}

extern "C" int uno_ldlt_panel_f64(const void* A, void* L, void* d, void* pos,
                                  void* neg, void* zero, int batch, int dim,
                                  double rtol, int rows, int panel_smem,
                                  int trail_smem, void* stream, int* launched) {
  return launch_panel<double>(A, L, d, pos, neg, zero, batch, dim, rtol, rows,
                              panel_smem, trail_smem, stream, launched);
}
