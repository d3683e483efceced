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
// Z[h] = vec(y_h y_h^T) rounded to it as als_ops.hot_tables rounds it.
// bf16 x bf16 products are exact in f32, so tensor cores with f32
// accumulation compute exactly this up to summation order, as the TPU's MXU
// does. The TPU kernel's (TB, BD, HB) Mosaic tiling, lane-major batch and
// in-VMEM transposes are not carried over.
//
// Design: up to four kernels per call, on the caller's stream.
//
// 1. Hot head (H > 0): hot_gemm_kernel computes, for a tile of 128 rows at
//    a time, a0 = ytyl + W_a Z over the k (k + 1) / 2 lower-triangle
//    entries of A and b0 = W_b y_hot: one GEMM (N x H) x (H x (k (k+1)/2 +
//    k)). Each Z tile is built in shared memory from y_hot, once per run
//    of row tiles, each entry rounded as hot_tables rounds it; Z is never
//    read from memory. bf16 runs mma.sync m16n8k16 (f32 accumulate); f32 runs a
//    register-tiled GEMM on the CUDA cores (true fp32, no TF32). W tiles
//    arrive by cp.async three steps ahead. build_solve.hot_split_count
//    splits H into slices, each written to its own a0 slice and summed in
//    slice order: an H wider than one Z tile holds (hot_max_slice), and a
//    chunk of few rows, to fill the card. The
//    head is the same for every row, so a GEMM across rows replaces the
//    per-row rank-H update. Cost: a0, (N, k (k+1)/2) f32, goes to device
//    memory and back: 8,192 rows x 8.3 KB at k = 64, ~68 MB per chunk. The
//    TPU kernel avoided that buffer only because its per-row MXU dot was
//    free; here a per-row rank-H update on the CUDA cores cost ~0.79 us per
//    row at H = 1024, far more than the buffer's HBM time.
// 2. Cold stream, one block per row (rows x 1 block fill the card): A's
//    lower triangle, b and 1/diag live in shared memory (row stride k | 1,
//    as in chol_solve.cu) from the init (the a0/b0 slices, or ytyl and 0)
//    to the solve. The stream runs in steps of 32 rows, loaded into
//    registers a step ahead and staged transposed in shared memory as bf16
//    (k padded to 16 with zeros in shared memory only) beside rnd(w) and
//    rnd(conf). One warp per 16-row m-tile runs mma.sync m16n8k16 on the
//    16 x 8 tiles of A's lower triangle, forming each A fragment
//    rnd(rnd(w) y) as it loads it (rows of A on the w y side, columns on
//    the y side: A is not symmetric after rounding), and adds the tile into
//    shared A. b accumulates beside it on the CUDA cores. The f32 stream
//    keeps 4 x 4 register tiles on the CUDA cores (true fp32).
// 3. Cold stream, D split (few rows: the wrapper picks the slice count S,
//    build_solve.split_count): block (t, s) accumulates slice s of row t's
//    stream from zero and writes its partial lower triangle and b to an f32
//    workspace the wrapper allocates; sum_partials_kernel adds each row's S
//    partials in slice order, one thread per entry; reduce_solve_kernel
//    adds the init and runs the solve. No atomics: two calls give the same
//    bits.
//
// What bounds it on the card (H100): at the ml20m user side (k = 64, ~18M
// stream entries) the cold build reads 18M x (128 + 8) B ~ 2.4 GB and does
// 18M x 64 x 64 x 2 ~ 0.15 TFLOP, so on tensor cores it is bound by memory
// and the staging loop's latency, not by arithmetic. The k serial pivot
// steps of the solve, each closed by a block barrier, then set the pace: a
// block solves one k = 64 system in ~60-80 us, and ~9 blocks fit an SM (56
// registers, 22 KB), so a 138k-row side takes ~20 ms of solve. A wide
// class's chunk holds 8 rows (packing.py's chunk cap), so without the split
// 8 of 132 SMs worked; with it rows x S reaches ~4 blocks per SM, and the
// chunk's cost is the one-system solve latency (~65 us at k = 64). The hot
// GEMM of that side is 138k x 1024 x 2,144 x 2 ~ 0.61 TFLOP; it reads W_a
// once per 64-column tile (34 at k = 64, ~3 GB, since W_a does not fit L2),
// ~1 ms at HBM rate. A block keeps a whole Z tile of a 1,024-wide slice
// (~130 KB), so one block of 8 warps fits an SM and mma.sync's latency is
// poorly hidden: ~37 TFLOP/s on an H100 (16.5 ms for that side). Later
// work: wgmma, TMA staging, accumulators in registers across steps, a
// faster single-system factor, and gathering y through col_idx inside the
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "chol_core.cuh"

namespace {

using qmf::kMaxSmemBytes;
using qmf::lead_dim;

constexpr int kStage = 32;        // stream rows staged per step
constexpr int kLds = kStage + 8;  // bf16 stage row stride (halfs): the
                                  // fragment loads hit distinct banks
constexpr int kTile = 4;          // f32 stream: kTile x kTile A per thread

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline int n_pairs(int k) { return k * (k + 1) / 2; }

__host__ __device__ inline int pair_index(int r, int c) {
  return r * (r + 1) / 2 + c;
}

template <typename T>
__device__ inline float to_f32(T v);
template <>
__device__ inline float to_f32<float>(float v) {
  return v;
}
template <>
__device__ inline float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ inline T zero();
template <>
__device__ inline float zero<float>() {
  return 0.0f;
}
template <>
__device__ inline bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.0f);
}

// Round an f32 value to T, as f32 (the identity for f32).
template <typename T>
__device__ inline float rnd(float v);
template <>
__device__ inline float rnd<float>(float v) {
  return v;
}
template <>
__device__ inline float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Pair p of the packed lower triangle -> (r, c), c <= r.
__device__ inline void unpack_pair(int p, int& r, int& c) {
  int i = int((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  while (i * (i + 1) / 2 > p) --i;
  r = i;
  c = p - i * (i + 1) / 2;
}

// 16 x 8 MMA tile p of A's lower triangle -> (mi, ni): m-tile mi (rows
// 16 mi ..) holds n-tiles 0 .. 2 mi + 1; M m-tiles hold M (M + 1) tiles.
__device__ inline void mma_tile(int p, int& mi, int& ni) {
  int m = int((sqrtf(4.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((m + 1) * (m + 2) <= p) ++m;
  while (m * (m + 1) > p) --m;
  mi = m;
  ni = p - m * (m + 1);
}

__device__ inline uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b: m16n8k16, bf16 operands, f32 accumulate.
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Shared memory of the row kernels, in floats: A (k * ld), 1/diag (k), b
// then x (k), padded to 16 bytes; then the stage.
__host__ __device__ inline size_t head_floats(int k) {
  return (size_t(k) * lead_dim(k) + 2 * size_t(k) + 3) / 4 * 4;
}

// bf16 stage: y transposed (kp16 x kLds halfs), rnd(w) and rnd(conf)
// (kStage floats each). f32 stage: y and w y by rows (kStage x kp4 floats
// each) and conf.
template <typename T>
size_t stage_bytes(int k);
template <>
size_t stage_bytes<bf16>(int k) {
  return size_t(round_up(k, 16)) * kLds * sizeof(bf16) +
         2 * kStage * sizeof(float);
}
template <>
size_t stage_bytes<float>(int k) {
  return (2 * size_t(kStage) * round_up(k, kTile) + kStage) * sizeof(float);
}

template <typename T>
size_t row_smem_bytes(int k) {
  return head_floats(k) * sizeof(float) + stage_bytes<T>(k);
}

// bf16: one warp per 16-row m-tile of A, so 2 kp threads stage a step's
// (kStage / 2) x kp pairs in kBfPerThread rounds with a fixed column each.
// f32: enough warps for the 4 x 4 tiles, at most 8.
constexpr int kBfPerThread = kStage / 4;

template <typename T>
int row_warps(int k) {
  if (sizeof(T) == 2) return round_up(k, 16) / 16;
  const int nt = round_up(k, kTile) / kTile;
  const int nwarps = (nt * (nt + 1) / 2 + 31) / 32;
  return nwarps < 1 ? 1 : (nwarps > 8 ? 8 : nwarps);
}

// A's lower triangle as the sum, in order, of n_src packed sources
// (a0[t, 0..n_src) of the hot head) or as ytyl when there are none, or
// zero when ytyl is null too; b likewise from b_src (n_src rows of k).
__device__ inline void init_system(float* s, int ld, float* z, int k,
                                   const float* a_src, const float* b_src,
                                   int n_src, const float* ytyl) {
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  const int np = n_pairs(k);
  for (int r = warp; r < k; r += nwarps) {
    for (int c = lane; c <= r; c += 32) {
      const int p = pair_index(r, c);
      float v = a_src || !ytyl ? 0.0f : ytyl[r * k + c];
      for (int i = 0; a_src && i < n_src; ++i) v += a_src[int64_t(i) * np + p];
      s[r * ld + c] = v;
    }
  }
  for (int r = tid; r < k; r += nthreads) {
    float v = 0.0f;
    for (int i = 0; b_src && i < n_src; ++i) v += b_src[int64_t(i) * k + r];
    z[r] = v;
  }
}

// A += sum_d rnd(rnd(w_d) y_d) y_d^T, b += sum_d rnd(conf_d) y_d over the
// stream rows [d_begin, d_end) of one row. Every thread calls it. The init
// before it is published by its first barrier (when d_end > d_begin); its
// last writes to A and b are published by the caller's next barrier.
template <typename T>
__device__ void accumulate(float* s, int ld, float* z, int k, const T* yg_t,
                           const float* w_t, const float* conf_t,
                           int d_begin, int d_end, float* stage);

// The next step's stream values wait in registers while the tensor cores
// work on the current one: two barriers a step, the loads in flight across
// the MMA. Shared memory holds y (transposed) and rnd(w), rnd(conf); the A
// fragments rnd(rnd(w) y) are formed from them as they are loaded.
template <>
__device__ void accumulate<bf16>(float* s, int ld, float* z, int k,
                                 const bf16* yg_t, const float* w_t,
                                 const float* conf_t, int d_begin, int d_end,
                                 float* stage) {
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  const int kp = round_up(k, 16);  // = 16 nwarps
  bf16* sy = reinterpret_cast<bf16*>(stage);  // sy[c * kLds + i] = y_i[c]
  float* sw = reinterpret_cast<float*>(sy + kp * kLds);  // rnd(w_i)
  float* sconf = sw + kStage;                             // rnd(conf_i)
  const int mt = kp / 16;
  const int ntiles = mt * (mt + 1);
  const int g = lane >> 2, tq = lane & 3;
  // this thread stages column c of stream rows i0 + 4 u and i0 + 4 u + 1
  const int c = tid % kp;
  const int i0 = 2 * (tid / kp);

  __nv_bfloat162 y[kBfPerThread];
  float wd = 0.0f, cf = 0.0f;
  auto fetch = [&](int d0) {
#pragma unroll
    for (int u = 0; u < kBfPerThread; ++u) {
      const int d = d0 + i0 + 4 * u;
      const bf16 zero_v = zero<bf16>();
      y[u].x = c < k && d < d_end ? yg_t[int64_t(d) * k + c] : zero_v;
      y[u].y = c < k && d + 1 < d_end ? yg_t[int64_t(d + 1) * k + c] : zero_v;
    }
    if (tid < kStage) {
      const bool ok = d0 + tid < d_end;
      wd = ok ? w_t[d0 + tid] : 0.0f;
      cf = ok ? conf_t[d0 + tid] : 0.0f;
    }
  };
  // an A fragment register: rnd(rnd(w) y) of the pair at p, weights wv
  auto wy = [](const bf16* p, float2 wv) {
    const float2 yy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    const __nv_bfloat162 v = __floats2bfloat162_rn(wv.x * yy.x, wv.y * yy.y);
    return *reinterpret_cast<const uint32_t*>(&v);
  };

  if (d_begin < d_end) fetch(d_begin);
  for (int d0 = d_begin; d0 < d_end; d0 += kStage) {
#pragma unroll
    for (int u = 0; u < kBfPerThread; ++u) {
      *reinterpret_cast<__nv_bfloat162*>(sy + c * kLds + i0 + 4 * u) = y[u];
    }
    if (tid < kStage) {
      sw[tid] = rnd<bf16>(wd);
      sconf[tid] = rnd<bf16>(cf);
    }
    __syncthreads();
    if (d0 + kStage < d_end) fetch(d0 + kStage);
    // this thread's weights in the A fragments: columns ks + 2 tq (+ 1)
    // and ks + 2 tq + 8 (+ 1) of each k16 step
    float2 wk[kStage / 16][2];
#pragma unroll
    for (int ks = 0; ks < kStage / 16; ++ks) {
      wk[ks][0] = *reinterpret_cast<const float2*>(sw + 16 * ks + 2 * tq);
      wk[ks][1] = *reinterpret_cast<const float2*>(sw + 16 * ks + 2 * tq + 8);
    }
    for (int p = warp; p < ntiles; p += nwarps) {
      int mi, ni;
      mma_tile(p, mi, ni);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kStage / 16; ++ks) {
        const bf16* pa = sy + (mi * 16 + g) * kLds + 16 * ks + 2 * tq;
        const uint32_t a[4] = {wy(pa, wk[ks][0]), wy(pa + 8 * kLds, wk[ks][0]),
                               wy(pa + 8, wk[ks][1]),
                               wy(pa + 8 * kLds + 8, wk[ks][1])};
        const bf16* pb = sy + (ni * 8 + g) * kLds + 16 * ks + 2 * tq;
        const uint32_t b[2] = {ld32(pb), ld32(pb + 8)};
        mma_bf16(acc, a, b);
      }
      const int r = mi * 16 + g, cc = ni * 8 + 2 * tq;
      if (r < k) {
        if (cc <= r) s[r * ld + cc] += acc[0];
        if (cc + 1 <= r) s[r * ld + cc + 1] += acc[1];
      }
      if (r + 8 < k) {
        if (cc <= r + 8) s[(r + 8) * ld + cc] += acc[2];
        if (cc + 1 <= r + 8) s[(r + 8) * ld + cc + 1] += acc[3];
      }
    }
    for (int r = tid; r < k; r += nthreads) {
      float acc = 0.0f;
      for (int i = 0; i < kStage; i += 2) {
        const float2 yy = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sy + r * kLds + i));
        acc = fmaf(sconf[i], yy.x, acc);
        acc = fmaf(sconf[i + 1], yy.y, acc);
      }
      z[r] += acc;
    }
    __syncthreads();
  }
}

template <>
__device__ void accumulate<float>(float* s, int ld, float* z, int k,
                                  const float* yg_t, const float* w_t,
                                  const float* conf_t, int d_begin,
                                  int d_end, float* stage) {
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  const int kp = round_up(k, kTile);
  const int nt = kp / kTile;
  const int npairs = nt * (nt + 1) / 2;
  float* sy = stage;             // sy[i * kp + c] = y_i[c]
  float* swy = sy + kStage * kp;  // w_i y_i[c]
  float* sconf = swy + kStage * kp;

  for (int d0 = d_begin; d0 < d_end; d0 += kStage) {
    const int nd = min(kStage, d_end - d0);
    for (int i = warp; i < nd; i += nwarps) {
      const float* src = yg_t + int64_t(d0 + i) * k;
      const float wi = w_t[d0 + i];
      for (int c = lane; c < kp; c += 32) {
        const float y = c < k ? src[c] : 0.0f;
        sy[i * kp + c] = y;
        swy[i * kp + c] = wi * y;
      }
    }
    for (int i = tid; i < nd; i += nthreads) sconf[i] = conf_t[d0 + i];
    __syncthreads();
    for (int p = tid; p < npairs; p += nthreads) {
      int bi, bj;
      unpack_pair(p, bi, bj);  // tile pair p -> (bi, bj), bi >= bj
      float acc[kTile][kTile] = {};
      for (int i = 0; i < nd; ++i) {
        const float4 wr =
            *reinterpret_cast<const float4*>(swy + i * kp + bi * kTile);
        const float4 yc =
            *reinterpret_cast<const float4*>(sy + i * kp + bj * kTile);
        const float wv[kTile] = {wr.x, wr.y, wr.z, wr.w};
        const float yv[kTile] = {yc.x, yc.y, yc.z, yc.w};
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
#pragma unroll
          for (int v = 0; v < kTile; ++v) {
            acc[u][v] = fmaf(wv[u], yv[v], acc[u][v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        const int r = bi * kTile + u;
#pragma unroll
        for (int v = 0; v < kTile; ++v) {
          const int c = bj * kTile + v;
          if (r < k && c <= r) s[r * ld + c] += acc[u][v];
        }
      }
    }
    for (int r = tid; r < k; r += nthreads) {
      float acc = 0.0f;
      for (int i = 0; i < nd; ++i) acc = fmaf(sconf[i], sy[i * kp + r], acc);
      z[r] += acc;
    }
    __syncthreads();
  }
}

// Publish A and b, write b, factor and solve, write x.
__device__ inline void finish(float* s, int ld, float* inv_diag, float* z,
                              int k, float* x_t, float* b_t) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane, nthreads = blockDim.y * 32;
  __syncthreads();
  // these reads finish before the first barrier inside factor_solve; warp
  // 0 writes z only after it
  for (int r = tid; r < k; r += nthreads) b_t[r] = z[r];
  qmf::factor_solve(s, ld, inv_diag, z, k);
  if (warp != 0) return;
  for (int r = lane; r < k; r += 32) x_t[r] = z[r];
}

// One block per row: init from the hot head's a0/b0 (n_hot partials) or
// ytyl and 0, the whole stream, the solve. blockDim = (32, row_warps<T>(k)).
template <typename T>
__global__ void build_solve_kernel(const T* __restrict__ yg,
                                   const float* __restrict__ w,
                                   const float* __restrict__ conf,
                                   const float* __restrict__ ytyl,
                                   const float* __restrict__ a0,
                                   const float* __restrict__ b0, int n_hot,
                                   float* __restrict__ x,
                                   float* __restrict__ b_out, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int ld = lead_dim(k);
  float* s = smem;                       // A by rows, lower triangle, then L
  float* inv_diag = s + size_t(k) * ld;  // 1 / L[p][p]
  float* z = inv_diag + k;               // b, then x
  const int64_t t = blockIdx.x;
  init_system(s, ld, z, k, a0 ? a0 + t * n_hot * n_pairs(k) : nullptr,
              b0 ? b0 + t * n_hot * k : nullptr, n_hot, ytyl);
  accumulate<T>(s, ld, z, k, yg + t * int64_t(d) * k, w + t * d, conf + t * d,
                0, d, smem + head_floats(k));
  finish(s, ld, inv_diag, z, k, x + t * k, b_out + t * k);
}

// Block (t, sl) of n_slices per row: slice sl of row t's stream, from zero,
// into the workspace (packed lower triangle, then b).
template <typename T>
__global__ void build_partial_kernel(const T* __restrict__ yg,
                                     const float* __restrict__ w,
                                     const float* __restrict__ conf,
                                     float* __restrict__ ws_a,
                                     float* __restrict__ ws_b, int d, int k,
                                     int n_slices, int slice) {
  extern __shared__ __align__(16) float smem[];
  const int ld = lead_dim(k);
  float* s = smem;
  float* z = s + size_t(k) * ld + k;
  const int64_t blk = blockIdx.x;
  const int64_t t = blk / n_slices;
  const int sl = int(blk % n_slices);
  const int d_begin = min(d, sl * slice);
  const int d_end = min(d, d_begin + slice);
  init_system(s, ld, z, k, nullptr, nullptr, 0, nullptr);
  accumulate<T>(s, ld, z, k, yg + t * int64_t(d) * k, w + t * d, conf + t * d,
                d_begin, d_end, smem + head_floats(k));
  __syncthreads();
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  float* out = ws_a + blk * n_pairs(k);
  for (int r = warp; r < k; r += nwarps) {
    for (int c = lane; c <= r; c += 32) out[pair_index(r, c)] = s[r * ld + c];
  }
  for (int r = warp * 32 + lane; r < k; r += nwarps * 32) {
    ws_b[blk * k + r] = z[r];
  }
}

// One block per row: the init (as build_solve_kernel's) plus the partials'
// sum (slice 0 of the row's n_slices after sum_partials_kernel), then the
// solve. blockDim = (32, (k + 7) / 8 clamped to [1, 16]).
__global__ void reduce_solve_kernel(const float* __restrict__ ytyl,
                                    const float* __restrict__ a0,
                                    const float* __restrict__ b0, int n_hot,
                                    const float* __restrict__ ws_a,
                                    const float* __restrict__ ws_b,
                                    float* __restrict__ x,
                                    float* __restrict__ b_out, int k,
                                    int n_slices) {
  extern __shared__ __align__(16) float smem[];
  const int ld = lead_dim(k);
  float* s = smem;
  float* inv_diag = s + size_t(k) * ld;
  float* z = inv_diag + k;
  const int64_t t = blockIdx.x;
  const int np = n_pairs(k);
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  init_system(s, ld, z, k, a0 ? a0 + t * n_hot * np : nullptr,
              b0 ? b0 + t * n_hot * k : nullptr, n_hot, ytyl);
  // the same (thread, entry) map as init_system: no barrier between them
  const float* part = ws_a + t * n_slices * int64_t(np);
  for (int r = warp; r < k; r += nwarps) {
    for (int c = lane; c <= r; c += 32) s[r * ld + c] += part[pair_index(r, c)];
  }
  const float* part_b = ws_b + t * n_slices * int64_t(k);
  for (int r = warp * 32 + lane; r < k; r += nwarps * 32) z[r] += part_b[r];
  finish(s, ld, inv_diag, z, k, x + t * k, b_out + t * k);
}

// ---------------------------------------------------------------------------
// Hot head over H slice hs of h_slices: a0[t, hs, pair(r, c)] = [hs == 0]
// ytyl[r, c] + sum_h W_a[t, h] rnd(y_h[r] y_h[c]) and b0[t, hs, c] =
// sum_h W_b[t, h] y_h[c], h in the slice. Output column j of the GEMM is a
// pair (r, c) (a column tile below tiles_a, operand W_a) or a b entry c
// (operand W_b). A unit is (H slice, column tile of kHotN, row tile of
// kHotM), in the order of HotUnits; each of a grid of one block per resident
// slot takes a contiguous range of units. Over a run of units with one H
// slice and column tile the block keeps that Z tile (kHotN columns x the
// whole slice) in shared memory, built once from y_hot, and streams the W
// tiles, kHotK hot columns a step,
// through a ring of kHotStages buffers by cp.async, kHotStages - 1 steps
// ahead and across unit boundaries. One barrier a step.

constexpr int kHotM = 128, kHotN = 64, kHotK = 32, kHotThreads = 256;
constexpr int kHotStages = 4;

// The widest H slice whose Z tile fits beside the ring (the wrapper's
// hot_split_count splits H at least that finely; qmf_build_solve_limits
// reports it).
template <typename T>
__host__ __device__ constexpr int hot_max_slice() {
  return sizeof(T) == 2 ? 1024 : 512;
}
// Row stride of a W tile (by rows, H contiguous), its bytes; the Z tile's
// row stride: bf16 by columns (the MMA's B operand, H contiguous), f32 by
// hot rows.
template <typename T>
__host__ __device__ constexpr int hot_ldw() {
  return sizeof(T) == 2 ? kHotK + 8 : kHotK + 4;
}
template <typename T>
__host__ __device__ constexpr size_t hot_w_bytes() {
  return size_t(kHotM) * hot_ldw<T>() * sizeof(T);
}
template <typename T>
__host__ __device__ inline int hot_ldz(int h_slice) {
  return sizeof(T) == 2 ? h_slice + 8 : kHotN;
}
template <typename T>
__host__ __device__ inline size_t hot_z_bytes(int h_slice) {
  return sizeof(T) == 2 ? size_t(kHotN) * hot_ldz<T>(h_slice) * sizeof(T)
                        : size_t(h_slice) * kHotN * sizeof(T);
}

// The ring of W tiles, the Z tile, each column's (r, c).
template <typename T>
size_t hot_smem_bytes(int h_slice) {
  return kHotStages * hot_w_bytes<T>() + hot_z_bytes<T>(h_slice) +
         2 * kHotN * sizeof(int);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The four 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15, 16-23, 24-31
// address, one register each.
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Copy 16 bytes src -> dst (n_valid elements valid, the rest zero):
// asynchronously when whole and aligned, else by plain loads.
template <typename T>
__device__ inline void copy16(T* dst, const T* src, int n_valid,
                              bool aligned) {
  constexpr int V = 16 / sizeof(T);
  if (n_valid == V && aligned) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) dst[e] = e < n_valid ? src[e] : zero<T>();
}

// Unit u = (hs tiles_c + c) row_tiles + r is row tile r of column tile c
// and H slice hs: a block's contiguous range of units runs down the row
// tiles of one Z tile before it moves to the next.
struct HotUnits {
  int tiles_c, row_tiles;
  __device__ void at(int64_t u, int& hs, int& c, int& r) const {
    const int64_t per_slice = int64_t(tiles_c) * row_tiles;
    hs = int(u / per_slice);
    const int64_t rem = u - hs * per_slice;
    c = int(rem / row_tiles);
    r = int(rem % row_tiles);
  }
};

// A step of a block's range: unit u (decomposed) and its step st.
struct HotCursor {
  int64_t u;
  int st, hs, c, r;
};

template <typename T>
__global__ void __launch_bounds__(kHotThreads)
    hot_gemm_kernel(const T* __restrict__ w_a, const T* __restrict__ w_b,
                    const T* __restrict__ y_hot,
                    const float* __restrict__ ytyl, float* __restrict__ a0,
                    float* __restrict__ b0, int n, int k, int h, int h_slices,
                    int h_slice, HotUnits units) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
  constexpr int kLdw = hot_ldw<T>();
  constexpr int kRing = int(hot_w_bytes<T>() / sizeof(T));
  T* ring = reinterpret_cast<T*>(raw);
  T* zt = reinterpret_cast<T*>(raw + kHotStages * hot_w_bytes<T>());
  int* col_r = reinterpret_cast<int*>(raw + kHotStages * hot_w_bytes<T>() +
                                      hot_z_bytes<T>(h_slice));
  int* col_c = col_r + kHotN;
  const int ldz = hot_ldz<T>(h_slice);

  const int tid = threadIdx.x;
  const int np = n_pairs(k);
  const int tiles_a = (np + kHotN - 1) / kHotN;
  const int nsteps = h_slice / kHotK;
  const int64_t total =
      int64_t(h_slices) * units.tiles_c * units.row_tiles;
  const int64_t u_end = total * (blockIdx.x + 1) / gridDim.x;

  // unit cu.u, step 0
  auto seek = [&](HotCursor& cu) {
    cu.st = 0;
    if (cu.u < u_end) units.at(cu.u, cu.hs, cu.c, cu.r);
  };
  auto advance = [&](HotCursor& cu) {
    if (++cu.st < nsteps) return;
    ++cu.u;
    seek(cu);
  };

  // Issue the W tile of step ic into ring slot `slot`, then commit a group
  // (empty past the range, so the wait counts stay uniform).
  auto issue = [&](const HotCursor& ic, int slot) {
    if (ic.u < u_end) {
      constexpr int V = 16 / sizeof(T);
      const T* src = ic.c >= tiles_a ? w_b : w_a;
      const bool aligned =
          h % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
      const int h_end = min(h, (ic.hs + 1) * h_slice);
      const int h0 = ic.hs * h_slice + ic.st * kHotK;
      T* sw = ring + slot * kRing;
      for (int idx = tid; idx < kHotM * (kHotK / V); idx += kHotThreads) {
        const int m = idx / (kHotK / V), i = (idx % (kHotK / V)) * V;
        const int64_t t = int64_t(ic.r) * kHotM + m;
        const int valid = t < n ? max(0, min(V, h_end - (h0 + i))) : 0;
        copy16(sw + m * kLdw + i, valid ? src + t * h + h0 + i : src, valid,
               aligned);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Z tile of H slice hs, column tile c, and the columns' (r, c): r = -1
  // for a b entry, -2 past the end. Thread j = tid % kHotN owns column j.
  auto build_z = [&](int hs, int c_tile) {
    const bool is_b = c_tile >= tiles_a;
    const int col0 = (is_b ? c_tile - tiles_a : c_tile) * kHotN;
    const int j = tid % kHotN;
    int r = -2, c = 0;
    if (!is_b && col0 + j < np) unpack_pair(col0 + j, r, c);
    if (is_b && col0 + j < k) r = -1, c = col0 + j;
    if (tid < kHotN) {
      col_r[j] = r;
      col_c[j] = c;
    }
    const int h_begin = min(h, hs * h_slice);
    const int len = min(h, h_begin + h_slice) - h_begin;
    const T* yb = y_hot + int64_t(h_begin) * k;
    for (int i = tid / kHotN; i < h_slice; i += kHotThreads / kHotN) {
      float zv = 0.0f;
      if (i < len && r != -2) {
        const float yc = to_f32(yb[int64_t(i) * k + c]);
        zv = r >= 0 ? rnd<T>(to_f32(yb[int64_t(i) * k + r]) * yc) : yc;
      }
      if constexpr (sizeof(T) == 2) {
        zt[j * ldz + i] = __float2bfloat16_rn(zv);  // exact: a bf16 value
      } else {
        zt[i * kHotN + j] = zv;
      }
    }
  };

  // bf16: 8 warps as 4 (rows) x 2 (columns), each 32 x 32 = 2 x 4 MMA
  // tiles. f32: thread (ty, tx) owns rows 8 ty .. and columns 4 tx ..
  constexpr bool kMma = sizeof(T) == 2;
  float acc[kMma ? 2 : 8][4][kMma ? 4 : 1] = {};
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int ty = tid / 16, tx = tid % 16;

  // a0 = [hs == 0] ytyl + acc on pair columns, b0 = acc on b columns
  auto store = [&](const HotCursor& cu, int m, int j, float v) {
    const int64_t t = int64_t(cu.r) * kHotM + m;
    const int r = col_r[j], c = col_c[j];
    if (t >= n || r == -2) return;
    const int64_t slot = t * h_slices + cu.hs;
    if (r == -1) {
      b0[slot * k + c] = v;
    } else {
      const int p = (cu.c * kHotN) + j;
      a0[slot * np + p] = cu.hs == 0 ? v + ytyl[r * k + c] : v;
    }
  };
  auto epilogue = [&](const HotCursor& cu) {
    if constexpr (kMma) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int m = wm * 32 + mi * 16 + g, j = wn * 32 + ni * 8 + 2 * tq;
          store(cu, m, j, acc[mi][ni][0]);
          store(cu, m, j + 1, acc[mi][ni][1]);
          store(cu, m + 8, j, acc[mi][ni][2]);
          store(cu, m + 8, j + 1, acc[mi][ni][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          store(cu, ty * 8 + u, tx * 4 + v, acc[u][v][0]);
          acc[u][v][0] = 0.0f;
        }
      }
    }
  };

  HotCursor cc{total * blockIdx.x / gridDim.x, 0, 0, 0, 0};
  seek(cc);
  HotCursor ic = cc;
  for (int s = 0; s < kHotStages - 1; ++s) {
    issue(ic, s);
    advance(ic);
  }
  int z_hs = -1, z_c = -1;  // the Z tile in shared memory
  for (int q = 0; cc.u < u_end; ++q) {
    if (cc.st == 0 && (cc.hs != z_hs || cc.c != z_c)) {
      // every thread is done with the old Z tile and its column map
      __syncthreads();
      build_z(cc.hs, cc.c);
      z_hs = cc.hs;
      z_c = cc.c;
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kHotStages - 2));
    // step q's W tile has landed for every thread, the Z tile is
    // published, and every thread is done with step q - 1, whose ring slot
    // the next issue refills
    __syncthreads();
    issue(ic, (q + kHotStages - 1) % kHotStages);
    advance(ic);
    const T* sw = ring + (q % kHotStages) * kRing;
    const int i0 = cc.st * kHotK;
    if constexpr (kMma) {
#pragma unroll
      for (int ks = 0; ks < kHotK; ks += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ldsm_x4(a[mi], sw + (wm * 32 + mi * 16 + (lane & 15)) * kLdw + ks +
                             (lane >> 4) * 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ni += 2) {
          uint32_t r4[4];
          ldsm_x4(r4, zt + (wn * 32 + ni * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                ldz +
                            i0 + ks + ((lane >> 3) & 1) * 8);
          b[ni][0] = r4[0];
          b[ni][1] = r4[1];
          b[ni + 1][0] = r4[2];
          b[ni + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
      }
    } else {
      for (int i = 0; i < kHotK; ++i) {
        const float4 zq = *reinterpret_cast<const float4*>(
            zt + (i0 + i) * kHotN + tx * 4);
        const float zr4[4] = {zq.x, zq.y, zq.z, zq.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float wr = to_f32(sw[(ty * 8 + u) * kLdw + i]);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[u][v][0] = fmaf(wr, zr4[v], acc[u][v][0]);
          }
        }
      }
    }
    if (cc.st == nsteps - 1) epilogue(cc);
    advance(cc);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Sum each row's n_slices partials of the D split into its slice 0, entry
// by entry in slice order (the loads are independent, the adds in order).
// One thread per entry of the packed lower triangle and of b; a 1-D grid of
// blocks_per_row blocks per row.
__global__ void sum_partials_kernel(float* __restrict__ ws_a,
                                    float* __restrict__ ws_b, int k,
                                    int n_slices, int blocks_per_row) {
  const int np = n_pairs(k);
  const int64_t t = blockIdx.x / blocks_per_row;
  const int e = (blockIdx.x % blocks_per_row) * blockDim.x + threadIdx.x;
  if (e >= np + k) return;
  float* p = e < np ? ws_a + t * n_slices * int64_t(np) + e
                    : ws_b + t * n_slices * int64_t(k) + (e - np);
  const int64_t stride = e < np ? np : k;
  float v = p[0];
#pragma unroll 8
  for (int sl = 1; sl < n_slices; ++sl) v += p[sl * stride];
  p[0] = v;
}

// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T>
int launch(const void* yg, const void* w, const void* conf, const void* ytyl,
           const void* w_a, const void* w_b, const void* y_hot, void* a0,
           void* b0, void* ws_a, void* ws_b, void* x, void* b, long long n,
           int d, int k, int h, int h_slices, int n_slices, int device,
           void* stream) {
  if (n <= 0) return int(cudaSuccess);
  if (k <= 0 || d < 0 || h < 0 || n_slices < 1 || h_slices < 1 ||
      h_slices > 65535 || n * n_slices > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  const size_t row_smem = row_smem_bytes<T>(k);
  const int nwarps = row_warps<T>(k);
  if (row_smem > kMaxSmemBytes || nwarps > 32) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  auto* strm = reinterpret_cast<cudaStream_t>(stream);
  const T* yg_t = static_cast<const T*>(yg);
  const auto* w_f = static_cast<const float*>(w);
  const auto* conf_f = static_cast<const float*>(conf);
  const auto* ytyl_f = static_cast<const float*>(ytyl);
  auto* a0_f = static_cast<float*>(h > 0 ? a0 : nullptr);
  auto* b0_f = static_cast<float*>(h > 0 ? b0 : nullptr);
  auto* x_f = static_cast<float*>(x);
  auto* b_f = static_cast<float*>(b);

  if (h > 0) {
    const int h_slice = round_up((h + h_slices - 1) / h_slices, kHotK);
    if (h_slice > hot_max_slice<T>()) return int(cudaErrorInvalidValue);
    const size_t hot_smem = hot_smem_bytes<T>(h_slice);
    err = allow_smem(&hot_gemm_kernel<T>, hot_smem);
    if (err != cudaSuccess) return int(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hot_gemm_kernel<T>, kHotThreads, hot_smem);
    if (err != cudaSuccess) return int(err);
    HotUnits units;
    units.tiles_c = (n_pairs(k) + kHotN - 1) / kHotN + (k + kHotN - 1) / kHotN;
    units.row_tiles = int((n + kHotM - 1) / kHotM);
    const long long total =
        (long long)h_slices * units.tiles_c * units.row_tiles;
    // a block per resident slot: each works through its range of units
    const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
    hot_gemm_kernel<T><<<static_cast<unsigned>(total < slots ? total : slots),
                         kHotThreads, hot_smem, strm>>>(
        static_cast<const T*>(w_a), static_cast<const T*>(w_b),
        static_cast<const T*>(y_hot), ytyl_f, a0_f, b0_f, int(n), k, h,
        h_slices, h_slice, units);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  const dim3 block(32, nwarps);
  if (n_slices == 1) {
    err = allow_smem(&build_solve_kernel<T>, row_smem);
    if (err != cudaSuccess) return int(err);
    build_solve_kernel<T><<<static_cast<unsigned>(n), block, row_smem,
                            strm>>>(yg_t, w_f, conf_f, ytyl_f, a0_f, b0_f,
                                    h_slices, x_f, b_f, d, k);
    return int(cudaGetLastError());
  }
  const int slice = round_up((d + n_slices - 1) / n_slices, kStage);
  err = allow_smem(&build_partial_kernel<T>, row_smem);
  if (err != cudaSuccess) return int(err);
  build_partial_kernel<T><<<static_cast<unsigned>(n * n_slices), block,
                            row_smem, strm>>>(
      yg_t, w_f, conf_f, static_cast<float*>(ws_a), static_cast<float*>(ws_b),
      d, k, n_slices, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int blocks_per_row = (n_pairs(k) + k + 255) / 256;
  sum_partials_kernel<<<static_cast<unsigned>(n * blocks_per_row), 256, 0,
                        strm>>>(static_cast<float*>(ws_a),
                                static_cast<float*>(ws_b), k, n_slices,
                                blocks_per_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t solve_smem = head_floats(k) * sizeof(float);
  err = allow_smem(&reduce_solve_kernel, solve_smem);
  if (err != cudaSuccess) return int(err);
  // few rows: the solve's latency, not its throughput, counts, and twice
  // chol_solve.cu's warps cut it by a fifth at k = 64 (82 -> 64 us)
  int solve_warps = (k + 7) / 8;
  solve_warps = solve_warps < 1 ? 1 : (solve_warps > 16 ? 16 : solve_warps);
  reduce_solve_kernel<<<static_cast<unsigned>(n), dim3(32, solve_warps),
                        solve_smem, strm>>>(
      ytyl_f, a0_f, b0_f, h_slices, static_cast<const float*>(ws_a),
      static_cast<const float*>(ws_b), x_f, b_f, k, n_slices);
  return int(cudaGetLastError());
}

// The largest k whose row kernel launch() accepts, the widest H slice, and
// the hot GEMM's rows and columns per unit.
template <typename T>
void limits(int* out) {
  int k = 1;
  while (row_smem_bytes<T>(k + 1) <= kMaxSmemBytes && row_warps<T>(k + 1) <= 32)
    ++k;
  out[0] = k;
  out[1] = hot_max_slice<T>();
  out[2] = kHotM;
  out[3] = kHotN;
}

}  // namespace

extern "C" {

// All arrays contiguous. yg (n, d, k), w_a and w_b (n, h) and y_hot (h, k)
// of the stream type; w and conf (n, d), ytyl (k, k), x and b (n, k) f32.
// h = 0 runs the variant without the hot head (w_a, w_b, y_hot, a0, b0
// unread); with h > 0 the head's GEMM splits H over h_slices blocks and
// writes a0 (n, h_slices, k (k+1)/2) and b0 (n, h_slices, k) f32 scratch.
// n_slices = 1 runs one block per row (ws_a, ws_b unread); n_slices > 1
// splits each row's stream over that many blocks, with scratch ws_a
// (n, n_slices, k (k+1)/2) and ws_b (n, n_slices, k) f32. Returns the
// cudaError_t of the launches.
int qmf_build_solve_f32(const void* yg, const void* w, const void* conf,
                        const void* ytyl, const void* w_a, const void* w_b,
                        const void* y_hot, void* a0, void* b0, void* ws_a,
                        void* ws_b, void* x, void* b, long long n, int d,
                        int k, int h, int h_slices, int n_slices, int device,
                        void* stream) {
  return launch<float>(yg, w, conf, ytyl, w_a, w_b, y_hot, a0, b0, ws_a, ws_b,
                       x, b, n, d, k, h, h_slices, n_slices, device, stream);
}

int qmf_build_solve_bf16(const void* yg, const void* w, const void* conf,
                         const void* ytyl, const void* w_a, const void* w_b,
                         const void* y_hot, void* a0, void* b0, void* ws_a,
                         void* ws_b, void* x, void* b, long long n, int d,
                         int k, int h, int h_slices, int n_slices, int device,
                         void* stream) {
  return launch<bf16>(yg, w, conf, ytyl, w_a, w_b, y_hot, a0, b0, ws_a, ws_b,
                      x, b, n, d, k, h, h_slices, n_slices, device, stream);
}

// For a bf16 (bf16_stream != 0) or f32 stream, into out[0..4): the largest
// k the kernels take; the widest H slice of the hot head's GEMM (h_slices
// must make ceil(h / h_slices), rounded up to 32, no wider); the GEMM's
// rows and output columns per unit of work. Needs no device.
void qmf_build_solve_limits(int bf16_stream, int* out) {
  if (bf16_stream) {
    limits<bf16>(out);
  } else {
    limits<float>(out);
  }
}

}  // extern "C"
