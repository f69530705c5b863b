// Batched unpivoted LDL^T of dense symmetric KKT matrices, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of uno_tpu/linalg/pallas_ldlt.py:
//   ldlt_factor_pallas          -> _ldlt_kernel          (one instance)
//   ldlt_factor_pallas_batched  -> _ldlt_kernel_batched  (one instance per grid step)
// The single instance is the batch of one.
//
// Arithmetic: what _ldlt_kernel computes, column by column (the plain
// versions are uno_tpu_torch/linalg/ldlt.py's ldlt_factor / _unrolled):
//   dj = a_jj;  l = a_{>j,j} / safe(dj);  a_{>j,>j} -= dj * (l l^T)
// with safe() = the +-1e-35 clamp of _safe.  Writes L (unit lower) and d;
// the inertia is counted from d in torch.  No padding to 128 and no
// transposed panels: those were the TPU's (8, 128) tiling.
//
// Design, the first and simple version: one block per instance; the
// block's threads share out the trailing update of the lower triangle, so
// each column costs two __syncthreads.  When dim^2 * sizeof(T) fits in the
// block's opt-in shared memory (227 KB on H100: dim <= ~240 in float,
// ~170 in double) the matrix lives in shared memory; otherwise it is
// factored in place in the output buffer in global memory, as the Pallas
// kernel did in its output ref.
//
// Bound: the work is B*dim^3/3 flops against B*dim^2 elements read
// and written, so a large dim is bound by operations and a small one by
// bytes.  This version is bound by neither: the column chain is serial
// (2*dim barriers per instance) and, above the shared-memory limit, every
// column re-reads the trailing block from global memory.  Panelled
// (blocked) updates are the next step.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T safe_pivot(T dj) {
  const T tiny = T(1e-35);
  return (dj < tiny && dj > -tiny) ? (dj < T(0) ? -tiny : tiny) : dj;
}

template <typename T>
__global__ void ldlt_kernel(const T* __restrict__ A, T* __restrict__ L,
                            T* __restrict__ d, int dim, int use_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long nn = static_cast<long long>(dim) * dim;
  const T* a = A + blockIdx.x * nn;
  T* out = L + blockIdx.x * nn;
  T* dout = d + static_cast<long long>(blockIdx.x) * dim;
  T* M = use_shared ? reinterpret_cast<T*>(smem_raw) : out;

  if (use_shared) {
    for (long long e = threadIdx.x; e < nn; e += blockDim.x) M[e] = a[e];
  } else {
    for (long long e = threadIdx.x; e < nn; e += blockDim.x) out[e] = a[e];
  }
  __syncthreads();

  for (int j = 0; j < dim; ++j) {
    const T dj = M[j * dim + j];
    const T s = safe_pivot(dj);
    // column j below the pivot becomes column j of L
    for (int i = j + 1 + threadIdx.x; i < dim; i += blockDim.x) {
      M[i * dim + j] = M[i * dim + j] / s;
    }
    if (threadIdx.x == 0) dout[j] = dj;
    __syncthreads();
    // trailing update of the lower triangle (rows i > j, columns j < k <= i);
    // consecutive threads take consecutive columns of a row
    const unsigned r = static_cast<unsigned>(dim - j - 1);
    const unsigned cnt = r * r;
    for (unsigned e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int i = j + 1 + static_cast<int>(e / r);
      const int k = j + 1 + static_cast<int>(e % r);
      if (k <= i) {
        const T li = M[i * dim + j];
        const T lk = M[k * dim + j];
        M[i * dim + k] = M[i * dim + k] - dj * (li * lk);
      }
    }
    __syncthreads();
  }

  // unit lower-triangular L; each thread reads and writes only its own
  // elements, so the in-place case needs no further barrier
  for (long long e = threadIdx.x; e < nn; e += blockDim.x) {
    const long long i = e / dim;
    const long long k = e - i * dim;
    out[e] = i > k ? M[e] : (i == k ? T(1) : T(0));
  }
}

template <typename T>
int launch(const void* A, void* L, void* d, int batch, int dim, void* stream) {
  if (batch <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(dim) * dim * sizeof(T);
  const int use_shared = bytes <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = use_shared ? bytes : 0;
  // raised once to the largest size asked for (the attribute is per kernel;
  // callers launch from one host thread)
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(ldlt_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const int threads = dim <= 32 ? 128 : 256;
  ldlt_kernel<T><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), static_cast<T*>(d), dim,
      use_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: (batch, dim, dim) contiguous; L: (batch, dim, dim); d: (batch, dim).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int uno_ldlt_factor_f32(const void* A, void* L, void* d, int batch,
                                   int dim, void* stream) {
  return launch<float>(A, L, d, batch, dim, stream);
}

extern "C" int uno_ldlt_factor_f64(const void* A, void* L, void* d, int batch,
                                   int dim, void* stream) {
  return launch<double>(A, L, d, batch, dim, stream);
}
