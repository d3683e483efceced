// Batched SPD factor + solve on Hopper (sm_90a), hand-written CUDA.
//
// For each of B independent systems: A = L L^T (right-looking rank-1
// Cholesky that keeps 1/L[p][p]), then L z = b, then L^T x = z. The input A
// is not modified; only its lower triangle is read.
//
// Replaces the TPU kernel qmf_tpu/ops/pallas_solve.py cholesky_solve_nat
// (:154-188, body _chol_solve_kernel_nat :99-115 over _factor_solve_core
// :53-90) and its batch-last twin cholesky_solve_t (:118-151). It computes
// what _factor_solve_core computes; the TPU kernel's lane-major batch,
// 16-aligned Schur slices and in-VMEM transposes existed for Mosaic and are
// not carried over. Both TPU layouts arrive here as strides.
//
// What bounds it on the card: at the WALS main path's shapes (k = 64,
// B ~ 138k systems in an ml20m user half-epoch) it reads B k^2 4 bytes
// ~ 2.3 GB and does B k^3 / 3 ~ 12 GFLOP, which alone would take under a
// millisecond of HBM time. In this design one block factors one system, and
// the k serial pivot steps, each closed by a block barrier, set the pace.
// Making it fast (several systems per block, tensor-core panel updates, TMA
// loads) is later work.
//
// A non-positive pivot gives NaN through sqrt, with no clamping; the NaN
// spreads over that system's x, so the caller's finiteness guard fires.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Opt-in shared memory per block on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Odd row stride: a column walk (rows r, r+1, ...) hits distinct banks.
__host__ __device__ inline int lead_dim(int k) { return k | 1; }

template <typename T>
size_t smem_bytes(int k) {
  return (size_t(k) * lead_dim(k) + 2 * size_t(k)) * sizeof(T);
}

// One block per system; blockDim = (32, nwarps).
template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b, T* __restrict__ x,
                                  int k, int64_t sa_b, int64_t sa_r,
                                  int64_t sa_c, int64_t sb_b, int64_t sb_r,
                                  int64_t sx_b, int64_t sx_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = lead_dim(k);
  T* s = reinterpret_cast<T*>(smem_raw);  // L by rows, lower triangle
  T* inv_diag = s + size_t(k) * ld;       // 1 / L[p][p]
  T* z = inv_diag + k;                    // b, then z, then x

  const int64_t sys = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int tid = warp * 32 + lane;
  const int nthreads = nwarps * 32;

  const T* a_sys = a + sys * sa_b;
  for (int r = warp; r < k; r += nwarps) {
    for (int c = lane; c <= r; c += 32) {
      s[r * ld + c] = a_sys[r * sa_r + c * sa_c];
    }
  }
  for (int r = tid; r < k; r += nthreads) {
    z[r] = b[sys * sb_b + r * sb_r];
  }
  __syncthreads();

  // Factor. Step p reads the pivot s[p][p], scales column p below it, then
  // subtracts the rank-1 product from the trailing lower triangle. Neither
  // phase writes the pivot, and the update never writes column p.
  for (int p = 0; p < k; ++p) {
    const T inv = T(1) / sqrt(s[p * ld + p]);
    for (int r = p + 1 + tid; r < k; r += nthreads) {
      s[r * ld + p] *= inv;
    }
    if (tid == 0) inv_diag[p] = inv;
    __syncthreads();
    for (int r = p + 1 + warp; r < k; r += nwarps) {
      const T l_rp = s[r * ld + p];
      for (int c = p + 1 + lane; c <= r; c += 32) {
        s[r * ld + c] -= l_rp * s[c * ld + p];
      }
    }
    __syncthreads();
  }

  // The two substitutions run in warp 0, lanes over rows.
  if (warp != 0) return;
  // Forward: L z = b.
  for (int p = 0; p < k; ++p) {
    const T zp = z[p] * inv_diag[p];
    __syncwarp();
    for (int r = p + 1 + lane; r < k; r += 32) {
      z[r] -= s[r * ld + p] * zp;
    }
    if (lane == 0) z[p] = zp;
    __syncwarp();
  }
  // Backward: L^T x = z, in place; rows > p already hold x.
  for (int p = k - 1; p >= 0; --p) {
    T acc = T(0);
    for (int r = p + 1 + lane; r < k; r += 32) {
      acc += s[r * ld + p] * z[r];
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) z[p] = (z[p] - acc) * inv_diag[p];
    __syncwarp();
  }
  for (int r = lane; r < k; r += 32) {
    x[sys * sx_b + r * sx_r] = z[r];
  }
}

template <typename T>
int launch(const void* a, const void* b, void* x, long long batch, int k,
           long long sa_b, long long sa_r, long long sa_c, long long sb_b,
           long long sb_r, long long sx_b, long long sx_r, int device,
           void* stream) {
  if (batch <= 0) return int(cudaSuccess);
  if (k <= 0 || batch > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(k);
  if (smem > kMaxSmemBytes) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chol_solve_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  int nwarps = (k + 15) / 16;
  nwarps = nwarps < 1 ? 1 : (nwarps > 8 ? 8 : nwarps);
  const dim3 block(32, nwarps);
  const dim3 grid(static_cast<unsigned>(batch));
  chol_solve_kernel<T><<<grid, block, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
      k, sa_b, sa_r, sa_c, sb_b, sb_r, sx_b, sx_r);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Strides are in elements. Returns the cudaError_t of the launch.
int qmf_chol_solve_f32(const void* a, const void* b, void* x, long long batch,
                       int k, long long sa_b, long long sa_r, long long sa_c,
                       long long sb_b, long long sb_r, long long sx_b,
                       long long sx_r, int device, void* stream) {
  return launch<float>(a, b, x, batch, k, sa_b, sa_r, sa_c, sb_b, sb_r, sx_b,
                       sx_r, device, stream);
}

int qmf_chol_solve_f64(const void* a, const void* b, void* x, long long batch,
                       int k, long long sa_b, long long sa_r, long long sa_c,
                       long long sb_b, long long sb_r, long long sx_b,
                       long long sx_r, int device, void* stream) {
  return launch<double>(a, b, x, batch, k, sa_b, sa_r, sa_c, sb_b, sb_r, sx_b,
                        sx_r, device, stream);
}

const char* qmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
