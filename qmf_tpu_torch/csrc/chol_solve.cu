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
// :53-90) and its batch-last twin cholesky_solve_t (:118-151, call :136). It
// computes what _factor_solve_core computes; the TPU kernel's lane-major
// batch, 16-aligned Schur slices and in-VMEM transposes existed for Mosaic
// and are not carried over. The batch-first operand (B, k, k) arrives as
// strides; the batch-last operand (k, k, B) has its own load and store,
// below, and is never copied.
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
// The library reports max k and systems per block (qmf_chol_solve_limits_*,
// from shared memory and the kernel's registers), so no caller repeats this
// layout.
//
// The batch-last entry (a (k, k, B), b and x (k, B)). There one system's
// entries lie B elements apart, and a warp that loaded its own system would
// touch one 32-byte sector per 4-byte element. But a block's S systems are
// neighbours along B, so for every triangle entry their S values are
// contiguous. The block therefore loads cooperatively: all 32 S threads walk
// the triangle's entries with the system index fastest, so a warp
// instruction reads 32 / S runs of S contiguous values (whole sectors, give
// or take one where a run straddles: B need not be a multiple of anything),
// and each thread drops its value into its system's triangle in shared
// memory, which keeps the padded row layout, so the factor is the same code.
// b comes in the same pass, into k entries behind each triangle; x goes back
// through those entries and is stored the same way, lanes along B. One block
// barrier after the load and one before the store are the only ones. A
// system's region is padded so that consecutive systems start 4 banks apart:
// the S values of one entry then land in distinct banks (without it, at
// k = 64 in f32, in one). S is a multiple of 8 (32-byte runs in f32) where
// 8 systems fit. The entry is a template parameter of the kernel: as a
// run-time branch of one kernel it cost the batch-first entry 8% (the
// compiler then shares one register allocation between the two, 60 against
// 73 at k = 64), so each entry has its own instantiations, and the library
// is built one dtype a translation unit to keep nvcc's time where it was.

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
// The batch-last entry's systems per block are a multiple of this where one
// fits: 8 f32 values are one 32-byte sector. At B = 138,493, k = 64 (H100,
// 700 W) 8 systems a block, three blocks an SM, took 3.41 ms, 16 (one block)
// 4.15 and 24 (one block) 3.64.
constexpr int kBatchLastStep = 8;

// Offset of row r in a system's triangle: rows NB m .. NB m + NB-1 each take
// NB (m + 1) entries. row_off(k) is the whole system.
__host__ __device__ inline int row_off(int r) {
  const int m = r / NB, j = r % NB;
  return NB * NB * (m * (m + 1) / 2) + j * NB * (m + 1);
}

// Elements of one system's region in shared memory. Batch-first: its
// triangle. Batch-last: the triangle, k entries for b and then x, and padding
// to a 16-byte multiple whose 32-bit words are 4 mod 32, so that consecutive
// systems start 4 banks apart.
template <typename T>
int system_elems(int k, bool batch_last) {
  int n = row_off(k);
  if (!batch_last) return n;
  constexpr int kVec = 16 / int(sizeof(T)), kWords = int(sizeof(T)) / 4;
  n = (n + k + kVec - 1) / kVec * kVec;
  while (n * kWords % 32 != 4) n += kVec;
  return n;
}

template <typename T>
size_t system_bytes(int k, bool batch_last) {
  return size_t(system_elems<T>(k, batch_last)) * sizeof(T);
}

template <typename T>
int max_k(bool batch_last) {
  int k = 1;
  while (k < 32 * kMaxSlots &&
         system_bytes<T>(k + 1, batch_last) <= kMaxSmemBytes)
    ++k;
  return k;
}

// Warps of ``regs`` registers a thread that one quarter of an SM holds.
inline int warps_per_quarter(int regs) {
  const int warp_regs =
      (regs * 32 + kRegAllocUnit - 1) / kRegAllocUnit * kRegAllocUnit;
  return kRegsPerQuarter / warp_regs;
}

// Blocks of s systems of ``sys`` bytes that one SM holds (0: none fits).
inline int blocks_per_sm(int s, size_t sys, int regs) {
  const int per_quarter = warps_per_quarter(regs);
  if (s < 1 || s > kMaxSystemsPerBlock || (s + 3) / 4 > per_quarter ||
      s * sys > kMaxSmemBytes)
    return 0;
  int warps = 4 * per_quarter;
  warps = warps < kMaxWarpsPerSm ? warps : kMaxWarpsPerSm;
  int blocks = int(kSmemPerSm / (s * sys + kSmemPerBlockReserved));
  blocks = blocks < kMaxBlocksPerSm ? blocks : kMaxBlocksPerSm;
  return blocks < warps / s ? blocks : warps / s;
}

// Systems per block: of the multiples of ``step``, the count that keeps the
// most systems of ``sys`` bytes resident on an SM, given its shared memory,
// registers (``regs`` a thread), block and warp limits (the smallest such);
// 0 where no multiple fits.
inline int systems_per_block(size_t sys, int regs, int step) {
  int best = 0, best_resident = 0;
  for (int s = step; s <= kMaxSystemsPerBlock; s += step) {
    const int resident = s * blocks_per_sm(s, sys, regs);
    if (resident > best_resident) {
      best_resident = resident;
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

// One warp's system: factors the triangle at s in place and turns z (b on
// entry) into x. Lane l holds the entries of rows i = l + 32 t, t < KT
// (KT = ceil(k / 32)). Pivots are walked in blocks of 32, tb, unrolled, so
// that every register array index is known at compile time (a run-time index
// would put the array in local memory).
template <typename T, int KT>
__device__ __forceinline__ void warp_factor_solve(T* s, T (&z)[KT], int k,
                                                  int lane) {
  T inv[KT];
  int off[KT];  // row_off of this lane's rows
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    inv[t] = T(0);
    off[t] = row_off(lane + 32 * t);
  }

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
}  // warp_factor_solve

// The batch-last entry's walk over what a block loads and stores: thread
// tid of the block's 32 S owns system tid % S of the block and starts at
// item tid / S, then takes every 32nd item. The triangle's items are its
// entries with rows r and k - 1 - r paired, k + 1 entries a pair, so that
// the walk needs no square root.
struct BlockWalk {
  int sys;   // this thread's system within the block
  int item;  // its first item, < 32
  __device__ BlockWalk(int per_block, int lane, int warp)
      : sys((warp * 32 + lane) % per_block),
        item((warp * 32 + lane) / per_block) {}
};

// Loads the block's triangles and right-hand sides (system index fastest
// over the threads), each value into its system's region: the triangle by
// padded rows, b behind it. The copies are in flight until the caller's
// cp_async_wait_all.
template <typename T>
__device__ inline void block_load(const BlockWalk w, T* region, const T* a,
                                  const T* b, int k, int64_t sa_r,
                                  int64_t sa_c, int64_t sb_r) {
  const int pairs = (k + 1) / 2;
  int pair = 0, j = w.item;
  while (j > k) {
    j -= k + 1;
    ++pair;
  }
  while (pair < pairs) {
    const bool first = j <= pair;
    const int r = first ? pair : k - 1 - pair;
    const int c = first ? j : j - pair - 1;
    // the middle row of an odd k is its own partner: taken once
    if (first || r != pair) cp_async(region + row_off(r) + c,
                                     a + r * sa_r + c * sa_c);
    j += 32;
    while (j > k) {
      j -= k + 1;
      ++pair;
    }
  }
  T* z = region + row_off(k);
  for (int i = w.item; i < k; i += 32) cp_async(z + i, b + i * sb_r);
}

// blockDim = (32, systems per block); warp y of block x owns system
// x blockDim.y + y. ``stride`` is a system's region in shared memory, in
// elements, of the batch-last entry (the batch-first entry's is its
// triangle, row_off(k), and is worked out here: told the same number as an
// argument the compiler schedules the factor another way, 2.3% slower at
// k = 64). Batch-last: the block loads and stores together (block_load),
// and the tail block's warps without a system stay for both barriers.
// Batch-first: each warp loads its own system through the strides and stores
// its own x; no block barrier.
template <typename T, int KT, bool kBatchLast>
__global__ void chol_solve_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b, T* __restrict__ x,
                                  int64_t batch, int k, int stride,
                                  int64_t sa_b, int64_t sa_r, int64_t sa_c,
                                  int64_t sb_b, int64_t sb_r, int64_t sx_b,
                                  int64_t sx_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int64_t sys0 = int64_t(blockIdx.x) * blockDim.y;
  const int64_t sys = sys0 + threadIdx.y;
  const bool live = sys < batch;
  T* s = reinterpret_cast<T*>(smem_raw) +
         threadIdx.y * (kBatchLast ? stride : row_off(k));
  T z[KT];

  if constexpr (kBatchLast) {
    const BlockWalk w(blockDim.y, lane, threadIdx.y);
    const int64_t mine = sys0 + w.sys;
    T* region = reinterpret_cast<T*>(smem_raw) + w.sys * stride;
    if (mine < batch)
      block_load(w, region, a + mine * sa_b, b + mine * sb_b, k, sa_r, sa_c,
                 sb_r);
    cp_async_wait_all();
    __syncthreads();
    if (live) {
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int i = lane + 32 * t;
        z[t] = i < k ? s[row_off(k) + i] : T(0);
      }
      warp_factor_solve<T, KT>(s, z, k, lane);
      // x through the entries b came in by, then out with lanes along B
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int i = lane + 32 * t;
        if (i < k) s[row_off(k) + i] = z[t];
      }
    }
    __syncthreads();
    if (mine < batch) {
      const T* from = region + row_off(k);
      for (int i = w.item; i < k; i += 32)
        x[mine * sx_b + i * sx_r] = from[i];
    }
  } else {
    if (!live) return;
    // Load: the lower triangle row by row, lanes over columns, every copy
    // in flight at once (cp.async); b into z meanwhile.
    const T* a_row = a + sys * sa_b;
    T* s_row = s;
    for (int r = 0; r < k; ++r) {
      for (int c = lane; c <= r; c += 32)
        cp_async(s_row + c, a_row + c * sa_c);
      a_row += sa_r;
      s_row += NB * (r / NB + 1);
    }
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int i = lane + 32 * t;
      z[t] = i < k ? b[sys * sb_b + i * sb_r] : T(0);
    }
    cp_async_wait_all();
    __syncwarp();
    warp_factor_solve<T, KT>(s, z, k, lane);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int i = lane + 32 * t;
      if (i < k) x[sys * sx_b + i * sx_r] = z[t];
    }
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, int64_t, int, int, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t);

template <typename T, int... KTs>
KernelFn<T> pick_kernel(int kt, bool batch_last,
                        std::integer_sequence<int, KTs...>) {
  KernelFn<T> fn = nullptr;
  ((fn = (kt == KTs + 1) ? (batch_last ? chol_solve_kernel<T, KTs + 1, true>
                                       : chol_solve_kernel<T, KTs + 1, false>)
                         : fn),
   ...);
  return fn;
}

// The kernel for k (1 <= k <= max_k) and its systems per block, from the
// registers the compiler gave it. The batch-last entry takes a multiple of
// kBatchLastStep where one fits.
template <typename T>
cudaError_t plan(int k, bool batch_last, KernelFn<T>* fn, int* per_block) {
  *fn = pick_kernel<T>((k + 31) / 32, batch_last,
                       std::make_integer_sequence<int, kMaxSlots>{});
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, *fn);
  if (err != cudaSuccess) return err;
  const size_t sys = system_bytes<T>(k, batch_last);
  *per_block =
      batch_last ? systems_per_block(sys, attr.numRegs, kBatchLastStep) : 0;
  if (*per_block == 0) *per_block = systems_per_block(sys, attr.numRegs, 1);
  return *per_block > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(const void* a, const void* b, void* x, long long batch, int k,
           bool batch_last, long long sa_b, long long sa_r, long long sa_c,
           long long sb_b, long long sb_r, long long sx_b, long long sx_r,
           int device, void* stream) {
  if (batch <= 0) return int(cudaSuccess);
  if (k <= 0 || k > max_k<T>(batch_last)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  KernelFn<T> fn;
  int per_block;
  err = plan<T>(k, batch_last, &fn, &per_block);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = (batch + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = per_block * system_bytes<T>(k, batch_last);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 block(32, per_block);
  fn<<<dim3(unsigned(blocks)), block, smem,
       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
      batch, k, system_elems<T>(k, batch_last), sa_b, sa_r, sa_c, sb_b, sb_r,
      sx_b, sx_r);
  return int(cudaGetLastError());
}

// Fills out[0..2] (max k, systems per block, bytes per system) for one
// entry of one dtype; see qmf_chol_solve_limits_<dtype>.
template <typename T>
cudaError_t limits(int k, bool batch_last, int* out) {
  out[0] = max_k<T>(batch_last);
  out[1] = out[2] = 0;
  if (k < 1 || k > out[0]) return cudaSuccess;
  KernelFn<T> fn;
  out[2] = int(system_bytes<T>(k, batch_last));
  return plan<T>(k, batch_last, &fn, &out[1]);
}

}  // namespace

// One translation unit per dtype where QMF_CHOL_DTYPE says so (32 or 64:
// the library's build compiles both, side by side); without it, both.
#ifndef QMF_CHOL_DTYPE
#define QMF_CHOL_DTYPE 0
#endif

extern "C" {

// qmf_chol_solve_<dtype>: batch-first or any strides, a (B, k, k), b and x
// (B, k), each warp loading its own system. qmf_chol_solve_t_<dtype>:
// batch-last, the same systems and the same strides' meaning, loaded and
// stored by the block together, which is what a batch stride of 1 (a
// (k, k, B), b and x (k, B)) wants. Strides are in elements. Both return
// the cudaError_t of the launch.
// qmf_chol_solve_limits_<dtype>: out[0..2] of the batch-first entry and
// out[3..5] of the batch-last one: the largest k; the systems per block at k
// as a launch on the current device chooses it (0 where k is out of range);
// the shared bytes per system at k. Returns a cudaError_t.
#define QMF_CHOL_ENTRIES(NAME, T)                                             \
  int qmf_chol_solve_##NAME(const void* a, const void* b, void* x,            \
                            long long batch, int k, long long sa_b,           \
                            long long sa_r, long long sa_c, long long sb_b,   \
                            long long sb_r, long long sx_b, long long sx_r,   \
                            int device, void* stream) {                       \
    return launch<T>(a, b, x, batch, k, false, sa_b, sa_r, sa_c, sb_b, sb_r,  \
                     sx_b, sx_r, device, stream);                             \
  }                                                                           \
  int qmf_chol_solve_t_##NAME(const void* a, const void* b, void* x,          \
                              long long batch, int k, long long sa_b,         \
                              long long sa_r, long long sa_c, long long sb_b, \
                              long long sb_r, long long sx_b, long long sx_r, \
                              int device, void* stream) {                     \
    return launch<T>(a, b, x, batch, k, true, sa_b, sa_r, sa_c, sb_b, sb_r,   \
                     sx_b, sx_r, device, stream);                             \
  }                                                                           \
  int qmf_chol_solve_limits_##NAME(int k, int* out) {                         \
    for (int entry = 0; entry < 2; ++entry) {                                 \
      const cudaError_t err = limits<T>(k, entry != 0, out + 3 * entry);      \
      if (err != cudaSuccess) return int(err);                                \
    }                                                                         \
    return int(cudaSuccess);                                                  \
  }

#if QMF_CHOL_DTYPE != 64
QMF_CHOL_ENTRIES(f32, float)

const char* qmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
#if QMF_CHOL_DTYPE != 32
QMF_CHOL_ENTRIES(f64, double)
#endif

}  // extern "C"
