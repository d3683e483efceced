// Batched SPD factor + solve on Hopper (sm_90a), hand-written CUDA.
//
// For each of B independent systems: A = L L^T (right-looking Cholesky that
// keeps 1/L[p][p]), then L z = b, then L^T x = z. The input A is not
// modified; only its lower triangle is read. A non-positive pivot gives NaN
// through sqrt, with no clamping; the NaN spreads over that system's x, so
// the caller's finiteness guard fires.
//
// Replaces the TPU kernel qmf_tpu/ops/pallas_solve.py cholesky_solve_nat
// (:154-188, body _chol_solve_kernel_nat :99-115 over _factor_solve_core
// :53-90) and its batch-last twin cholesky_solve_t (:118-151). It computes
// what _factor_solve_core computes; the TPU kernel's lane-major batch,
// 16-aligned Schur slices and in-VMEM transposes existed for Mosaic and are
// not carried over. Both TPU layouts arrive here as strides.
//
// What bounds it. At the WALS main path's shape (k = 64, f32, B = 138,493
// systems in an ml20m user half-epoch) the kernel must read the lower
// triangle and b and write x: B (k(k+1)/2 + 2k) 4 bytes = 1.22 GB, 0.37 ms
// at 3.35 TB/s; it does B (k^3/3 + 2k^2) = 13 GFLOP, 0.2 ms at 67 TFLOP/s.
// Neither is what sets the pace. The factor's k^3/6 = 44k multiply-adds
// per system each read and write an entry of the trailing triangle, which
// lives in shared memory (at one load and one store per multiply-add,
// ~90k shared accesses per system), and the k pivot steps are serial, so
// each system's instruction stream and its latency count.
//
// The design, against the four costs of the block-per-system kernel
// (qmf::factor_solve in chol_core.cuh, which build_solve.cu keeps):
// 1. A block barrier around every pivot step: one warp factors and solves
//    one system, and a block holds several systems (systems_per_block
//    below: 13 at k = 64). Nothing crosses warps, so there is no block
//    barrier at all: __syncwarp and shuffles only.
// 2. Idle warps during the substitutions: both run in the same warp right
//    after its factor, on b kept in registers (lane i%32 holds entry i);
//    no warp waits on another.
// 3. Padded storage (stride k|1, 17.1 KB at k = 64): the lower triangle is
//    stored by rows, each padded to a multiple of NB = 4 entries, 8.5 KB at
//    k = 64 in f32 (8.1 KB packed), so 26 systems are resident per SM
//    instead of 13. The padding makes each row's entries p0..p0+3 (p0 a
//    multiple of 4) one aligned 16-byte vector.
// 4. Three shared accesses per multiply-add: the factor goes PW = 8 pivots
//    at a time. A warp first factors the panel of columns p0..p0+7 in
//    registers (lane i%32 holds row i's eight entries; pivots and column
//    entries pass by shuffle), then applies the eight rank-1 updates to each
//    trailing entry in one load and one store: lanes walk a row's columns
//    c, each holding L[c][p0..p0+7] in registers, and the row's own panel
//    entries come as two broadcast vector loads. Rows go two at a time,
//    both rows' loads ahead of their stores. Each entry still takes its
//    updates one pivot at a time, in pivot order, so the arithmetic is that
//    of the rank-1 right-looking factor.
// The triangle's loads go out with cp.async, all of a warp's in flight at
// once. Register arrays are indexed only by constants (pivots are walked in
// 32-row slots, unrolled): a run-time index would move them to local memory.
// The library reports max k and systems per block (qmf_chol_solve_limits,
// from shared memory and the kernel's registers), so no caller repeats this
// layout.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "chol_core.cuh"

namespace {

using qmf::kMaxSmemBytes;

// Every row is padded to a multiple of NB entries (one 16-byte vector in
// f32); a panel is PW = two such groups of pivots.
constexpr int NB = 4;
constexpr int PW = 2 * NB;
// Trailing rows updated per step (a pair never straddles a row group).
constexpr int RS = 2;
// Shared memory of one SM on sm_90 (228 KB) and what each block reserves.
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerBlockReserved = 1024;
constexpr int kMaxWarpsPerSm = 64;
constexpr int kMaxBlocksPerSm = 32;
// The register file: 64K per SM in four quarters, a block's warps spread
// over the quarters, registers allocated per warp in units of 256.
constexpr int kRegsPerQuarter = 16384;
constexpr int kRegAllocUnit = 256;
constexpr int kMaxSystemsPerBlock = 32;
// Row slots per lane: max k = 32 * kMaxSlots (f32 stops at 338).
constexpr int kMaxSlots = 11;

// Offset of row r in a system's triangle: rows NB m .. NB m + NB-1 each take
// NB (m + 1) entries. row_off(k) is the whole system.
__host__ __device__ inline int row_off(int r) {
  const int m = r / NB, j = r % NB;
  return NB * NB * (m * (m + 1) / 2) + j * NB * (m + 1);
}

template <typename T>
size_t system_bytes(int k) {
  return size_t(row_off(k)) * sizeof(T);
}

template <typename T>
int max_k() {
  int k = 1;
  while (k < 32 * kMaxSlots && system_bytes<T>(k + 1) <= kMaxSmemBytes) ++k;
  return k;
}

// Systems per block: the count that keeps the most systems resident on an
// SM, given its shared memory, registers (``regs`` a thread), block and
// warp limits (the smallest such).
template <typename T>
int systems_per_block(int k, int regs) {
  const size_t sys = system_bytes<T>(k);
  const int warp_regs =
      (regs * 32 + kRegAllocUnit - 1) / kRegAllocUnit * kRegAllocUnit;
  const int per_quarter = kRegsPerQuarter / warp_regs;
  int warps = 4 * per_quarter;
  warps = warps < kMaxWarpsPerSm ? warps : kMaxWarpsPerSm;
  int best = 0, best_resident = 0;
  for (int s = 1; s <= kMaxSystemsPerBlock && (s + 3) / 4 <= per_quarter;
       ++s) {
    const size_t block = s * sys;
    if (block > kMaxSmemBytes) break;
    int blocks = int(kSmemPerSm / (block + kSmemPerBlockReserved));
    blocks = blocks < kMaxBlocksPerSm ? blocks : kMaxBlocksPerSm;
    blocks = blocks < warps / s ? blocks : warps / s;
    if (blocks * s > best_resident) {
      best_resident = blocks * s;
      best = s;
    }
  }
  return best;
}

// NB consecutive entries, NB-aligned, as 16-byte vectors.
template <typename T>
__device__ inline void load_nb(const T* p, T* v) {
  static_assert(NB * sizeof(T) % 16 == 0, "NB entries must fill 16 B");
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < NB; q += kPer) {
    if constexpr (sizeof(T) == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + q);
      v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
    } else {
      const double2 w = *reinterpret_cast<const double2*>(p + q);
      v[q] = w.x; v[q + 1] = w.y;
    }
  }
}

template <typename T>
__device__ inline void store_nb(T* p, const T* v) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < NB; q += kPer) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
      *reinterpret_cast<double2*>(p + q) = make_double2(v[q], v[q + 1]);
    }
  }
}

// Copy one element from device to shared memory without a register round
// trip; a warp's copies are all in flight until cp_async_wait_all.
template <typename T>
__device__ inline void cp_async(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(int(sizeof(T))));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp per system, blockDim = (32, systems per block). Lane l holds the
// entries of rows i = l + 32 t, t < KT (KT = ceil(k / 32)). Pivots are
// walked in blocks of 32, tb, unrolled, so that every register array index
// is known at compile time (a run-time index would put the array in local
// memory).
template <typename T, int KT>
__global__ void chol_solve_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b, T* __restrict__ x,
                                  int64_t batch, int k, int64_t sa_b,
                                  int64_t sa_r, int64_t sa_c, int64_t sb_b,
                                  int64_t sb_r, int64_t sx_b, int64_t sx_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int64_t sys = int64_t(blockIdx.x) * blockDim.y + threadIdx.y;
  if (sys >= batch) return;
  T* s = reinterpret_cast<T*>(smem_raw) + threadIdx.y * row_off(k);

  // Load: the lower triangle row by row, lanes over columns, every copy in
  // flight at once (cp.async); b into z meanwhile.
  const T* a_row = a + sys * sa_b;
  T* s_row = s;
  for (int r = 0; r < k; ++r) {
    for (int c = lane; c <= r; c += 32) cp_async(s_row + c, a_row + c * sa_c);
    a_row += sa_r;
    s_row += NB * (r / NB + 1);
  }
  T z[KT], inv[KT];
  int off[KT];  // row_off of this lane's rows
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int i = lane + 32 * t;
    z[t] = i < k ? b[sys * sb_b + i * sb_r] : T(0);
    inv[t] = T(0);
    off[t] = row_off(i);
  }
  cp_async_wait_all();
  __syncwarp();

  // Factor, PW pivots per panel; pivots p0 .. p0 + PW - 1 lie in slot tb.
#pragma unroll
  for (int tb = 0; tb < KT; ++tb) {
    const int p_end = k < 32 * tb + 32 ? k : 32 * tb + 32;
    for (int p0 = 32 * tb; p0 < p_end; p0 += PW) {
      // pan[t][j]: row i's entry in column p0 + j, for rows i >= p0 (so
      // t >= tb). Each half is one row group's vector; a row of the first
      // group ends before the second half.
      T pan[KT][PW];
#pragma unroll
      for (int t = tb; t < KT; ++t) {
        const int i = lane + 32 * t;
#pragma unroll
        for (int h = 0; h < PW; h += NB) {
          if (i >= p0 + h && i < k) {
            load_nb(s + off[t] + p0 + h, pan[t] + h);
          } else {
#pragma unroll
            for (int j = h; j < h + NB; ++j) pan[t][j] = T(0);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        const int p = p0 + j;
        if (p < k) {
          const T iv = T(1) / sqrt(__shfl_sync(0xffffffffu, pan[tb][j],
                                               p & 31));
          if (lane == (p & 31)) inv[tb] = iv;
#pragma unroll
          for (int t = tb; t < KT; ++t) {
            const int i = lane + 32 * t;
            if (i > p && i < k) pan[t][j] *= iv;
          }
          // The panel's later columns take this pivot's update now.
#pragma unroll
          for (int j2 = j + 1; j2 < PW; ++j2) {
            const int c = p0 + j2;
            const T l_cp = __shfl_sync(0xffffffffu, pan[tb][j], c & 31);
#pragma unroll
            for (int t = tb; t < KT; ++t) {
              const int i = lane + 32 * t;
              if (i >= c && i < k) pan[t][j2] -= pan[t][j] * l_cp;
            }
          }
        }
      }
#pragma unroll
      for (int t = tb; t < KT; ++t) {
        const int i = lane + 32 * t;
#pragma unroll
        for (int h = 0; h < PW; h += NB) {
          if (i >= p0 + h && i < k) store_nb(s + off[t] + p0 + h, pan[t] + h);
        }
      }
      __syncwarp();
      // Trailing update, RS rows r .. r + RS - 1 at a time (of one row
      // group, so of one length): columns c in [p0 + PW, row], lanes over
      // c. The step's loads go out before its stores.
      const int c0 = p0 + PW;
      T* rows = s + row_off(c0);
      for (int r = c0; r < k; r += RS) {
        const int len = NB * (r / NB + 1);
        T l[RS][PW];  // l[q][j]: row r + q's entry in column p0 + j
#pragma unroll
        for (int q = 0; q < RS; ++q) {
#pragma unroll
          for (int h = 0; h < PW; h += NB) {
            if (r + q < k) {
              load_nb(rows + q * len + p0 + h, l[q] + h);
            } else {
#pragma unroll
              for (int j = h; j < h + NB; ++j) l[q][j] = T(0);
            }
          }
        }
#pragma unroll
        for (int t = tb; t < KT; ++t) {
          if (32 * t > r + RS - 1) break;
          const int c = lane + 32 * t;
          bool in[RS];
          T v[RS];
#pragma unroll
          for (int q = 0; q < RS; ++q) {
            in[q] = c >= c0 && c <= r + q && r + q < k;
            v[q] = in[q] ? rows[q * len + c] : T(0);
          }
#pragma unroll
          for (int j = 0; j < PW; ++j) {
#pragma unroll
            for (int q = 0; q < RS; ++q) v[q] -= l[q][j] * pan[t][j];
          }
#pragma unroll
          for (int q = 0; q < RS; ++q) {
            if (in[q]) rows[q * len + c] = v[q];
          }
        }
        rows += RS * len;
      }
      __syncwarp();
    }
  }

  // Forward: L z = b, down column p.
#pragma unroll
  for (int tb = 0; tb < KT; ++tb) {
    const int p_end = k < 32 * tb + 32 ? k : 32 * tb + 32;
    for (int p = 32 * tb; p < p_end; ++p) {
      const T zp = __shfl_sync(0xffffffffu, z[tb] * inv[tb], p & 31);
      if (lane == (p & 31)) z[tb] = zp;
#pragma unroll
      for (int t = tb; t < KT; ++t) {
        const int i = lane + 32 * t;
        if (i > p && i < k) z[t] -= s[off[t] + p] * zp;
      }
    }
  }
  // Backward: L^T x = z, along row p; entries > p already hold x.
#pragma unroll
  for (int tb = KT - 1; tb >= 0; --tb) {
    const int p_end = k < 32 * tb + 32 ? k : 32 * tb + 32;
    for (int p = p_end - 1; p >= 32 * tb; --p) {
      const T xp = __shfl_sync(0xffffffffu, z[tb] * inv[tb], p & 31);
      if (lane == (p & 31)) z[tb] = xp;
      const T* row = s + row_off(p);
#pragma unroll
      for (int t = 0; t <= tb; ++t) {
        const int c = lane + 32 * t;
        if (c < p) z[t] -= row[c] * xp;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int i = lane + 32 * t;
    if (i < k) x[sys * sx_b + i * sx_r] = z[t];
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, int64_t, int, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t);

template <typename T, int... KTs>
KernelFn<T> pick_kernel(int kt, std::integer_sequence<int, KTs...>) {
  KernelFn<T> fn = nullptr;
  ((fn = (kt == KTs + 1) ? chol_solve_kernel<T, KTs + 1> : fn), ...);
  return fn;
}

// The kernel for k (1 <= k <= max_k) and its systems per block, from the
// registers the compiler gave it.
template <typename T>
cudaError_t plan(int k, KernelFn<T>* fn, int* per_block) {
  *fn = pick_kernel<T>((k + 31) / 32,
                       std::make_integer_sequence<int, kMaxSlots>{});
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, *fn);
  if (err != cudaSuccess) return err;
  *per_block = systems_per_block<T>(k, attr.numRegs);
  return *per_block > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(const void* a, const void* b, void* x, long long batch, int k,
           long long sa_b, long long sa_r, long long sa_c, long long sb_b,
           long long sb_r, long long sx_b, long long sx_r, int device,
           void* stream) {
  if (batch <= 0) return int(cudaSuccess);
  if (k <= 0 || k > max_k<T>()) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  KernelFn<T> fn;
  int per_block;
  err = plan<T>(k, &fn, &per_block);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = (batch + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = per_block * system_bytes<T>(k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 block(32, per_block);
  fn<<<dim3(unsigned(blocks)), block, smem,
       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
      batch, k, sa_b, sa_r, sa_c, sb_b, sb_r, sx_b, sx_r);
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

// out[0] = the largest k for the dtype (0 f32, 1 f64); out[1] = systems per
// block at k as a launch on the current device uses it (0 where k is out of
// range); out[2] = shared bytes per system. Returns a cudaError_t.
int qmf_chol_solve_limits(int dtype, int k, int* out) {
  const bool f64 = dtype != 0;
  const int kmax = f64 ? max_k<double>() : max_k<float>();
  out[0] = kmax;
  out[1] = out[2] = 0;
  if (k < 1 || k > kmax) return int(cudaSuccess);
  cudaError_t err;
  if (f64) {
    KernelFn<double> fn;
    err = plan<double>(k, &fn, &out[1]);
    out[2] = int(system_bytes<double>(k));
  } else {
    KernelFn<float> fn;
    err = plan<float>(k, &fn, &out[1]);
    out[2] = int(system_bytes<float>(k));
  }
  return int(err);
}

const char* qmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
