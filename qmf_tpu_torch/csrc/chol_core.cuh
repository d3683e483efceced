// In-block SPD factor + solve, shared by chol_solve.cu and build_solve.cu.
//
// One thread block holds one k x k system in shared memory: the lower
// triangle of A by rows with row stride ld = lead_dim(k), b in z, and room
// for 1/L[p][p] in inv_diag. factor_solve overwrites the lower triangle with
// L (A = L L^T, right-looking rank-1 Cholesky) and z with x (L z = b, then
// L^T x = z). blockDim is (32, nwarps); every thread of the block must call
// it, after a __syncthreads that publishes A and b. On return x is complete
// in warp 0 only; other warps must not read z without another barrier.
//
// A non-positive pivot gives NaN through sqrt, with no clamping; the NaN
// spreads over that system's x, so the caller's finiteness guard fires.

#pragma once

#include <cuda_runtime.h>

namespace qmf {

// Opt-in shared memory per block on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Odd row stride: a column walk (rows r, r+1, ...) hits distinct banks.
__host__ __device__ inline int lead_dim(int k) { return k | 1; }

template <typename T>
__device__ void factor_solve(T* s, int ld, T* inv_diag, T* z, int k) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int tid = warp * 32 + lane;
  const int nthreads = nwarps * 32;

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
}

}  // namespace qmf
