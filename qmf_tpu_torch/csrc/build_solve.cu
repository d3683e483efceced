// Fused Hu-Koren normal-equation build + SPD factor + solve on Hopper
// (sm_90a), hand-written CUDA.
//
// For each row t of a width-class chunk, with the gathered fixed-side stream
// yg[t] (D x k, type T = bf16 or f32), its weights w[t] and conf[t] (D, f32)
// and, optionally, the hot head W_a[t], W_b[t] (H, type T) over the hot
// fixed-side rows y_hot (H x k, type T):
//
//   A = ytyl + sum_h W_a[t,h] rnd(y_h y_h^T) + sum_d rnd(rnd(w) y_d) y_d^T
//   b = sum_h W_b[t,h] y_h + sum_d rnd(conf) y_d
//
// then x = A^-1 b by qmf::factor_solve (chol_core.cuh, shared with
// chol_solve.cu). rnd() rounds an f32 value to T (the identity for f32);
// every other product and every sum is f32. Writes x and b, both (N, k) f32.
//
// Replaces the TPU kernel qmf_tpu/ops/pallas_solve.py build_solve (:438),
// both of its variants: without the hot head (pallas_call :502, body
// _build_solve_kernel :307-322 over _accum_cold_tile :264-294 and
// _solve_tile :297-304) and with it (pallas_call :534, body
// _make_build_solve_hot_kernel :325-370). It computes what those compute,
// with their roundings: w and conf rounded to the stream type, the product
// w y rounded to it (:279-284, :290-294), and the hot table
// Z[h] = vec(y_h y_h^T) rounded to it as als_ops.hot_tables rounds it. The
// TPU kernel's (TB, BD, HB) Mosaic tiling, lane-major batch and in-VMEM
// transposes are not carried over.
//
// Design. One block per row; A's lower triangle, b and 1/diag live in
// shared memory (row stride k | 1, as in chol_solve.cu). The reduction axis
// runs in steps of kStage rows: a step stages kStage rows of the stream (or
// of y_hot) in shared memory, upcast to f32, and each thread accumulates a
// kTile x kTile register tile of A's lower triangle over the step, then adds
// it into shared A. The hot head comes first, then the cold stream. Z is
// never read from memory: each thread rebuilds its entries y_h[r] y_h[c]
// from the staged y_hot rows and rounds them, so a row reads H k values of
// y_hot (from L2) instead of H k^2 of Z. No padding of N, D, H or k.
//
// What bounds it on the card: at the ml20m user side (k = 64) a row does
// k (k + 1) / 2 = 2080 f32 FMAs per stream row and, with H = 1024 hot
// columns, 2.1M multiply-round-FMA triples for the head. That is compute on
// the CUDA cores, not HBM: the stream is read once (D k values per row) and
// A never leaves shared memory. Later work: tensor cores (wgmma) for the
// rank-D and rank-H updates, several rows per block, TMA staging, and
// gathering y through col_idx inside the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "chol_core.cuh"

namespace {

using qmf::kMaxSmemBytes;
using qmf::lead_dim;

constexpr int kTile = 4;    // each thread owns kTile x kTile entries of A
constexpr int kStage = 32;  // reduction rows staged per step

__host__ __device__ inline int padded_k(int k) {
  return (k + kTile - 1) / kTile * kTile;
}

__host__ __device__ inline int n_tile_pairs(int k) {
  const int nt = padded_k(k) / kTile;
  return nt * (nt + 1) / 2;
}

// Shared memory, in floats: A (k * ld), 1/diag (k), b then x (k), padded to
// 16 bytes; then the stage: rows (kStage * kp), rounded w * rows
// (kStage * kp), and two per-row weights (kStage each).
__host__ __device__ inline size_t head_floats(int k) {
  return (size_t(k) * lead_dim(k) + 2 * size_t(k) + 3) / 4 * 4;
}

size_t smem_bytes(int k) {
  return (head_floats(k) + 2 * size_t(kStage) * padded_k(k) + 2 * kStage) *
         sizeof(float);
}

template <typename T>
__device__ inline float to_f32(T v);
template <>
__device__ inline float to_f32<float>(float v) {
  return v;
}
template <>
__device__ inline float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to T, as f32 (the identity for f32).
template <typename T>
__device__ inline float rnd(float v);
template <>
__device__ inline float rnd<float>(float v) {
  return v;
}
template <>
__device__ inline float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Tile pair p -> (bi, bj), bi >= bj, numbered by rows of the lower triangle.
__device__ inline void tile_pair(int p, int& bi, int& bj) {
  int i = int((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  while (i * (i + 1) / 2 > p) --i;
  bi = i;
  bj = p - i * (i + 1) / 2;
}

__device__ inline void load4(const float* p, float (&v)[kTile]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Add a thread's register tile into the lower triangle of shared A.
__device__ inline void add_tile(float* s, int ld, int k, int bi, int bj,
                                const float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int r = bi * kTile + i;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int c = bj * kTile + j;
      if (r < k && c <= r) s[r * ld + c] += acc[i][j];
    }
  }
}

// One block per row; blockDim = (32, nwarps).
template <typename T, bool kHot>
__global__ void build_solve_kernel(
    const T* __restrict__ yg, const float* __restrict__ w,
    const float* __restrict__ conf, const float* __restrict__ ytyl,
    const T* __restrict__ w_a, const T* __restrict__ w_b,
    const T* __restrict__ y_hot, float* __restrict__ x,
    float* __restrict__ b_out, int d, int k, int h) {
  extern __shared__ __align__(16) float smem[];
  const int ld = lead_dim(k);
  const int kp = padded_k(k);
  float* s = smem;                      // A by rows, lower triangle, then L
  float* inv_diag = s + size_t(k) * ld;  // 1 / L[p][p]
  float* z = inv_diag + k;              // b, then x
  float* sy = smem + head_floats(k);    // staged rows, f32
  float* swy = sy + kStage * kp;        // cold: rnd(rnd(w) y)
  float* sb = swy + kStage * kp;        // cold: rnd(conf); hot: W_b
  float* sa = sb + kStage;              // hot: W_a

  const int64_t t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int tid = warp * 32 + lane;
  const int nthreads = nwarps * 32;
  const int npairs = n_tile_pairs(k);

  // A = ytyl (YtY + lam I), b = 0: the TPU kernel's _init. The barrier
  // after the first stage publishes both.
  for (int r = warp; r < k; r += nwarps) {
    for (int c = lane; c <= r; c += 32) s[r * ld + c] = ytyl[r * k + c];
  }
  for (int r = tid; r < k; r += nthreads) z[r] = 0.0f;

  if (kHot) {
    // A += sum_h W_a[t,h] rnd(y_h y_h^T), b += sum_h W_b[t,h] y_h
    const T* wa_t = w_a + t * h;
    const T* wb_t = w_b + t * h;
    for (int h0 = 0; h0 < h; h0 += kStage) {
      const int nh = min(kStage, h - h0);
      for (int i = warp; i < nh; i += nwarps) {
        const T* src = y_hot + int64_t(h0 + i) * k;
        for (int r = lane; r < kp; r += 32) {
          sy[i * kp + r] = r < k ? to_f32(src[r]) : 0.0f;
        }
      }
      for (int i = tid; i < nh; i += nthreads) {
        sa[i] = to_f32(wa_t[h0 + i]);
        sb[i] = to_f32(wb_t[h0 + i]);
      }
      __syncthreads();
      for (int p = tid; p < npairs; p += nthreads) {
        int bi, bj;
        tile_pair(p, bi, bj);
        float acc[kTile][kTile] = {};
        for (int i = 0; i < nh; ++i) {
          float yr[kTile], yc[kTile];
          load4(sy + i * kp + bi * kTile, yr);
          load4(sy + i * kp + bj * kTile, yc);
          const float wa = sa[i];
#pragma unroll
          for (int u = 0; u < kTile; ++u) {
#pragma unroll
            for (int v = 0; v < kTile; ++v) {
              acc[u][v] = fmaf(wa, rnd<T>(yr[u] * yc[v]), acc[u][v]);
            }
          }
        }
        add_tile(s, ld, k, bi, bj, acc);
      }
      for (int r = tid; r < k; r += nthreads) {
        float acc = 0.0f;
        for (int i = 0; i < nh; ++i) acc = fmaf(sb[i], sy[i * kp + r], acc);
        z[r] += acc;
      }
      __syncthreads();
    }
  }

  // A += sum_d rnd(rnd(w) y_d) y_d^T, b += sum_d rnd(conf) y_d
  const T* yg_t = yg + t * int64_t(d) * k;
  const float* w_t = w + t * d;
  const float* conf_t = conf + t * d;
  for (int d0 = 0; d0 < d; d0 += kStage) {
    const int nd = min(kStage, d - d0);
    for (int i = warp; i < nd; i += nwarps) {
      const T* src = yg_t + int64_t(d0 + i) * k;
      const float wi = rnd<T>(w_t[d0 + i]);
      for (int r = lane; r < kp; r += 32) {
        const float y = r < k ? to_f32(src[r]) : 0.0f;
        sy[i * kp + r] = y;
        swy[i * kp + r] = rnd<T>(wi * y);
      }
    }
    for (int i = tid; i < nd; i += nthreads) sb[i] = rnd<T>(conf_t[d0 + i]);
    __syncthreads();
    for (int p = tid; p < npairs; p += nthreads) {
      int bi, bj;
      tile_pair(p, bi, bj);
      float acc[kTile][kTile] = {};
      for (int i = 0; i < nd; ++i) {
        float wyr[kTile], yc[kTile];
        load4(swy + i * kp + bi * kTile, wyr);
        load4(sy + i * kp + bj * kTile, yc);
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
#pragma unroll
          for (int v = 0; v < kTile; ++v) {
            acc[u][v] = fmaf(wyr[u], yc[v], acc[u][v]);
          }
        }
      }
      add_tile(s, ld, k, bi, bj, acc);
    }
    for (int r = tid; r < k; r += nthreads) {
      float acc = 0.0f;
      for (int i = 0; i < nd; ++i) acc = fmaf(sb[i], sy[i * kp + r], acc);
      z[r] += acc;
    }
    __syncthreads();
  }
  __syncthreads();  // d == 0 and no hot head: publish the init

  // b goes out before the solve overwrites z. These reads finish before
  // the first barrier inside factor_solve; warp 0 writes z only after it.
  for (int r = tid; r < k; r += nthreads) b_out[t * k + r] = z[r];
  qmf::factor_solve(s, ld, inv_diag, z, k);
  if (warp != 0) return;
  for (int r = lane; r < k; r += 32) x[t * k + r] = z[r];
}

template <typename T>
int launch(const void* yg, const void* w, const void* conf, const void* ytyl,
           const void* w_a, const void* w_b, const void* y_hot, void* x,
           void* b, long long n, int d, int k, int h, int device,
           void* stream) {
  if (n <= 0) return int(cudaSuccess);
  if (k <= 0 || d < 0 || h < 0 || n > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(k);
  if (smem > kMaxSmemBytes) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  auto* kernel = h > 0 ? &build_solve_kernel<T, true>
                       : &build_solve_kernel<T, false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  int nwarps = (n_tile_pairs(k) + 31) / 32;
  nwarps = nwarps < 1 ? 1 : (nwarps > 8 ? 8 : nwarps);
  const dim3 block(32, nwarps);
  const dim3 grid(static_cast<unsigned>(n));
  kernel<<<grid, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(yg), static_cast<const float*>(w),
      static_cast<const float*>(conf), static_cast<const float*>(ytyl),
      static_cast<const T*>(w_a), static_cast<const T*>(w_b),
      static_cast<const T*>(y_hot), static_cast<float*>(x),
      static_cast<float*>(b), d, k, h);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// All arrays contiguous. yg (n, d, k), w_a and w_b (n, h) and y_hot (h, k)
// of the stream type; w and conf (n, d), ytyl (k, k), x and b (n, k) f32.
// h = 0 runs the variant without the hot head (w_a, w_b, y_hot unread).
// Returns the cudaError_t of the launch.
int qmf_build_solve_f32(const void* yg, const void* w, const void* conf,
                        const void* ytyl, const void* w_a, const void* w_b,
                        const void* y_hot, void* x, void* b, long long n,
                        int d, int k, int h, int device, void* stream) {
  return launch<float>(yg, w, conf, ytyl, w_a, w_b, y_hot, x, b, n, d, k, h,
                       device, stream);
}

int qmf_build_solve_bf16(const void* yg, const void* w, const void* conf,
                         const void* ytyl, const void* w_a, const void* w_b,
                         const void* y_hot, void* x, void* b, long long n,
                         int d, int k, int h, int device, void* stream) {
  return launch<__nv_bfloat16>(yg, w, conf, ytyl, w_a, w_b, y_hot, x, b, n,
                               d, k, h, device, stream);
}

}  // extern "C"
