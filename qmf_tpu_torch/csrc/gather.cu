// Row gather, out[r] = table[idx[r]], for Hopper (sm_90a).
//
// Replaces the three TPU gather probes: pallas_gather and pallas_take
// (benchmarks/gather_micro.py) and the on-chip-table gather of
// benchmarks/vmem_gather_micro.py (_take_kernel with its zero fill,
// _loop_kernel without). Those keep the table in the TPU's on-chip memory
// and walk 256 to 2048 indices per grid step; here a block loads its own
// indices and the table is read through L2, which holds a factor table whole
// (3.4 MB and 8.4 MB against 50 MB) where one SM's shared memory does not.
//
// Bound by bytes: every output byte is read once and written once and no
// arithmetic is done, so the design is about the shape of the accesses.
// A row is row_bytes contiguous bytes and the kernels copy bytes, whatever
// the element type. Three access shapes, all grid-stride:
//
//   vec   a group of 1..32 lanes copies one row in vectors of the widest
//         width (16, 8, 4 or 2 bytes) that divides the row and both base
//         pointers: 8 lanes a row at 128-byte rows, so a warp moves 4 rows a
//         step, each lane one 16-byte load and one 16-byte store.
//   warp  one warp per row, each lane a 1/32 piece of it (4 bytes at
//         128-byte rows): one fully coalesced transaction per row. It keeps
//         too few bytes in flight: 4 a lane, and the next row's index is not
//         asked for before this row's stores are out.
//   tile  a warp owns a tile of up to 32 consecutive output rows (32 at
//         128-byte rows: 4 KB), which is one contiguous piece of the output.
//         It reads the tile's indices in one coalesced load, lane t holding
//         index t, and brings the rows into a tile in shared memory laid out
//         as the output tile, by asynchronous copies; then one thread writes
//         the whole tile with one bulk store (cp.async.bulk, shared to
//         global). Each warp has two such tiles, so one tile's reads fly
//         while the other's store drains. The reads are 16-byte cp.async by
//         groups of lanes, as vec groups them (one bulk copy a row,
//         completing on an mbarrier, was tried beside it and was level with
//         it, so the read that needs no barrier stayed). Bulk stores need
//         16-byte sizes and addresses; rows or base pointers that are not
//         multiples of 16 take the same tile with lane copies in and lane
//         stores out (width 8, 4 or 2), one tile a warp.
//
// `fill` (vec only) is jnp.take's fill_value=0 rule: a negative index wraps
// once, then an index outside [0, table_rows) gives a zero row. Without it an
// out-of-range index is the caller's error and is not checked.
//
// Indices and output are touched once, so they are loaded and stored with
// the streaming hint (__ldcs, __stcs) and leave L2 to the table. With
// `l2_window` the launch also pins the table: it raises the device's
// persisting-L2 carve-out to the table's size if it is smaller, puts an
// access-policy window over the table on the stream, launches, and takes the
// window off the stream again. qmf_l2_reset gives the carve-out back.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

template <typename I>
__device__ __forceinline__ int64_t load_index(const I* idx, int64_t r) {
  return int64_t(__ldcs(idx + r));
}

// Resolves idx[r] to a table row; false where `fill` makes the row zero.
template <bool kFill>
__device__ __forceinline__ bool resolve(int64_t* src, int64_t table_rows) {
  if (!kFill) return true;
  if (*src < 0) *src += table_rows;
  return *src >= 0 && *src < table_rows;
}

// Groups of 2^group_shift lanes, one output row per group and step.
template <typename V, typename I, bool kFill>
__global__ void __launch_bounds__(kThreads)
gather_vec_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                  V* __restrict__ out, int64_t n_out, int64_t table_rows,
                  int vecs_per_row, int group_shift) {
  const int group_lanes = 1 << group_shift;
  const int lane = threadIdx.x & (group_lanes - 1);
  const int64_t groups_per_block = kThreads >> group_shift;
  const int64_t step = int64_t(gridDim.x) * groups_per_block;
  for (int64_t r = int64_t(blockIdx.x) * groups_per_block +
                   (threadIdx.x >> group_shift);
       r < n_out; r += step) {
    int64_t src = load_index(idx, r);
    const bool live = resolve<kFill>(&src, table_rows);
    const V* from = table + src * vecs_per_row;
    V* to = out + r * vecs_per_row;
    for (int c = lane; c < vecs_per_row; c += group_lanes) {
      V v{};
      if (live) v = from[c];
      __stcs(to + c, v);
    }
  }
}

// One warp per output row and step; lane 0 reads the index for the warp.
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_warp_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                   V* __restrict__ out, int64_t n_out, int vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = kThreads / 32;
  const int64_t step = int64_t(gridDim.x) * warps_per_block;
  for (int64_t r = int64_t(blockIdx.x) * warps_per_block + (threadIdx.x >> 5);
       r < n_out; r += step) {
    long long src = 0;
    if (lane == 0) src = load_index(idx, r);
    src = __shfl_sync(0xffffffffu, src, 0);
    const V* from = table + src * vecs_per_row;
    V* to = out + r * vecs_per_row;
#pragma unroll 2
    for (int c = lane; c < vecs_per_row; c += 32) __stcs(to + c, from[c]);
  }
}

// ---- tile ----

constexpr int kTileWarps = 8;   // warps a block, fewer where tiles are large
constexpr int kTileStages = 2;  // tiles a warp with asynchronous reads
constexpr size_t kTileBlockBytes = 64 * 1024;  // shared bytes a block aims at
constexpr size_t kMaxSmemBytes = 232448;       // opt-in limit a block, sm_90
constexpr size_t kSmemPerSm = 233472, kSmemPerBlockReserved = 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` from shared to device memory, as a bulk group of this thread.
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(gmem),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
}

// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders writes to shared memory by threads before reads of it by the copy
// unit.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most kPending of this thread's cp.async groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

enum TileRead { kCp16 = 0, kLanes = 1 };

struct TileArgs {
  const unsigned char* table;
  unsigned char* out;
  int64_t n_out;
  int row_bytes, tile_rows, stage_bytes;  // stage_bytes: a tile, 16-aligned
  int group_shift;                        // kCp16: 2^shift lanes a row
};

// Rows of tile `tile` that exist (the last tile may be short).
__device__ __forceinline__ int live_rows(const TileArgs& a, int64_t tile) {
  const int64_t left = a.n_out - tile * a.tile_rows;
  return left < a.tile_rows ? int(left) : a.tile_rows;
}

// Starts the reads of one tile into `stage`: groups of lanes copy rows in
// 16-byte pieces, the row's index passed from the lane that holds it; one
// cp.async group a tile.
template <typename I>
__device__ __forceinline__ void tile_start(const TileArgs& a, const I* idx,
                                           int64_t tile, unsigned char* stage,
                                           int lane) {
  const int live = live_rows(a, tile);
  long long mine = 0;
  if (lane < live) mine = load_index(idx, tile * a.tile_rows + lane);
  const int group = 1 << a.group_shift, rows_a_step = 32 >> a.group_shift;
  const int sub = lane & (group - 1), vecs = a.row_bytes / 16;
  for (int row0 = 0; row0 < live; row0 += rows_a_step) {
    const int row = row0 + (lane >> a.group_shift);
    const long long src = __shfl_sync(0xffffffffu, mine, row & 31);
    if (row < live) {
      const unsigned char* from = a.table + src * a.row_bytes;
      unsigned char* to = stage + row * a.row_bytes;
      for (int c = sub; c < vecs; c += group)
        cp_async16(to + 16 * c, from + 16 * c);
    }
  }
  cp_async_commit();
}

// One warp per tile and step, kTileStages tiles a warp in shared memory.
// V is the copy width of kLanes (uint4 otherwise).
template <typename V, typename I, int kRead>
__global__ void __launch_bounds__(32 * kTileWarps)
gather_tile_kernel(const TileArgs a, const I* __restrict__ idx) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warps = blockDim.x >> 5;
  const int64_t n_tiles = (a.n_out + a.tile_rows - 1) / a.tile_rows;
  const int64_t step = int64_t(gridDim.x) * warps;
  int64_t tile = int64_t(blockIdx.x) * warps + warp;

  if constexpr (kRead == kLanes) {
    // one tile a warp: lanes copy the rows' pieces in, then the tile out
    V* stage = reinterpret_cast<V*>(tile_smem + size_t(warp) * a.stage_bytes);
    const int vecs = a.row_bytes / int(sizeof(V));
    for (; tile < n_tiles; tile += step) {
      const int live = live_rows(a, tile);
      long long mine = 0;
      if (lane < live) mine = load_index(idx, tile * a.tile_rows + lane);
      const int total = live * vecs;
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int e = e0 + lane, row = e / vecs;
        const long long src = __shfl_sync(0xffffffffu, mine, row & 31);
        if (e < total)
          stage[e] = reinterpret_cast<const V*>(a.table + src * a.row_bytes)
              [e - row * vecs];
      }
      __syncwarp();
      V* to = reinterpret_cast<V*>(a.out +
                                   tile * a.tile_rows * int64_t(a.row_bytes));
      for (int e = lane; e < total; e += 32) __stcs(to + e, stage[e]);
      __syncwarp();
    }
    return;
  }

  unsigned char* stages =
      tile_smem + size_t(warp) * kTileStages * a.stage_bytes;
  // Step `it` of this warp uses stage it & 1. The next tile's reads start
  // before this tile's are waited for; the stage they go to was last read by
  // the store of the step before, which must have left shared memory by then.
  if (tile < n_tiles) tile_start(a, idx, tile, stages, lane);
  for (int it = 0; tile < n_tiles; tile += step, ++it) {
    const int st = it & 1;
    const bool more = tile + step < n_tiles;
    if (more) {
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      tile_start(a, idx, tile + step, stages + (st ^ 1) * a.stage_bytes,
                 lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    proxy_fence();
    __syncwarp();
    if (lane == 0)
      bulk_store(a.out + tile * a.tile_rows * int64_t(a.row_bytes),
                 stages + st * a.stage_bytes,
                 unsigned(live_rows(a, tile)) * unsigned(a.row_bytes));
  }
  if (lane == 0) bulk_wait();
}

struct Args {
  const void* table;
  const void* idx;
  void* out;
  int64_t n_out, table_rows, row_bytes;
  int variant, fill;  // variant 0 vec, 1 warp, 2 tile
  int tile_rows, tile_stages;
  cudaStream_t stream;
};

template <typename V, typename I>
cudaError_t launch(const Args& a, int sms) {
  const int64_t vecs = a.row_bytes / int64_t(sizeof(V));
  if (vecs > 0x7fffffffLL) return cudaErrorInvalidValue;
  int shift = 0;
  if (a.variant == 0)
    while (shift < 5 && (1 << shift) < vecs) ++shift;
  else
    shift = 5;
  const int64_t rows_per_block = kThreads >> shift;
  int64_t blocks = (a.n_out + rows_per_block - 1) / rows_per_block;
  const int64_t resident = int64_t(sms) * kBlocksPerSm;
  if (blocks > resident) blocks = resident;
  const V* table = static_cast<const V*>(a.table);
  const I* idx = static_cast<const I*>(a.idx);
  V* out = static_cast<V*>(a.out);
  const dim3 grid{unsigned(blocks)};
  if (a.variant == 1)
    gather_warp_kernel<V, I><<<grid, kThreads, 0, a.stream>>>(
        table, idx, out, a.n_out, int(vecs));
  else if (a.fill)
    gather_vec_kernel<V, I, true><<<grid, kThreads, 0, a.stream>>>(
        table, idx, out, a.n_out, a.table_rows, int(vecs), shift);
  else
    gather_vec_kernel<V, I, false><<<grid, kThreads, 0, a.stream>>>(
        table, idx, out, a.n_out, a.table_rows, int(vecs), shift);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_idx(const Args& a, int idx64, int sms) {
  return idx64 ? launch<V, long long>(a, sms) : launch<V, int>(a, sms);
}

// The tile kernel for one copy width and index type. Blocks of up to
// kTileWarps warps, fewer where that many tiles pass kTileBlockBytes, and as
// many blocks an SM as its shared memory and 2048 threads hold.
template <typename V, typename I, int kRead>
cudaError_t launch_tile(const Args& a, int sms) {
  const int stages = kRead == kLanes ? 1 : kTileStages;
  if (a.tile_rows < 1 || a.tile_rows > 32 || a.tile_stages != stages ||
      a.row_bytes > 0x7fffffffLL / 32)
    return cudaErrorInvalidValue;
  const size_t stage_bytes =
      (size_t(a.tile_rows) * size_t(a.row_bytes) + 15) / 16 * 16;
  const size_t warp_bytes = stages * stage_bytes;
  if (warp_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  int warps = kTileWarps;
  while (warps > 1 && warps * warp_bytes > kTileBlockBytes) warps /= 2;
  const size_t smem = warps * warp_bytes;
  const auto fn = gather_tile_kernel<V, I, kRead>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  int64_t per_sm = int64_t(kSmemPerSm / (smem + kSmemPerBlockReserved));
  if (per_sm > 2048 / (32 * warps)) per_sm = 2048 / (32 * warps);
  if (per_sm < 1) per_sm = 1;
  const int64_t n_tiles = (a.n_out + a.tile_rows - 1) / a.tile_rows;
  int64_t blocks = (n_tiles + warps - 1) / warps;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  int shift = 0;
  while (shift < 5 && (16LL << shift) < a.row_bytes) ++shift;
  const TileArgs t{static_cast<const unsigned char*>(a.table),
                   static_cast<unsigned char*>(a.out),
                   a.n_out,
                   int(a.row_bytes),
                   a.tile_rows,
                   int(stage_bytes),
                   shift};
  fn<<<dim3{unsigned(blocks)}, 32 * warps, smem, a.stream>>>(
      t, static_cast<const I*>(a.idx));
  return cudaGetLastError();
}

// 16-byte rows and pointers take the asynchronous reads and the bulk store;
// narrower widths the lane copies.
template <typename I>
cudaError_t launch_tile_width(const Args& a, int width, int sms) {
  switch (width) {
    case 16: return launch_tile<uint4, I, kCp16>(a, sms);
    case 8: return launch_tile<uint2, I, kLanes>(a, sms);
    case 4: return launch_tile<unsigned int, I, kLanes>(a, sms);
    default: return launch_tile<unsigned short, I, kLanes>(a, sms);
  }
}

cudaError_t set_window(cudaStream_t stream, void* base, size_t bytes,
                       float hit_ratio) {
  cudaStreamAttrValue attr = {};
  attr.accessPolicyWindow.base_ptr = base;
  attr.accessPolicyWindow.num_bytes = bytes;
  attr.accessPolicyWindow.hitRatio = hit_ratio;
  attr.accessPolicyWindow.hitProp =
      bytes ? cudaAccessPropertyPersisting : cudaAccessPropertyNormal;
  attr.accessPolicyWindow.missProp =
      bytes ? cudaAccessPropertyStreaming : cudaAccessPropertyNormal;
  return cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow,
                                &attr);
}

// Carve-out of at least `bytes` of persisting L2 (raised only, so a run of
// launches sets it once) and a window over the table on the stream. Writes
// the carve-out the device granted; cudaErrorNotSupported where it cannot
// hold the window.
cudaError_t pin_table(const Args& a, int device, size_t bytes,
                      long long* granted) {
  int max_persist = 0, max_window = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_persist, cudaDevAttrMaxPersistingL2CacheSize, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_window,
                               cudaDevAttrMaxAccessPolicyWindowSize, device);
  if (err != cudaSuccess) return err;
  size_t have = 0;
  err = cudaDeviceGetLimit(&have, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return err;
  *granted = (long long)have;
  if (bytes > size_t(max_persist) || bytes > size_t(max_window))
    return cudaErrorNotSupported;
  if (have < bytes) {
    err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetLimit(&have, cudaLimitPersistingL2CacheSize);
    if (err != cudaSuccess) return err;
    *granted = (long long)have;
    if (have < bytes) return cudaErrorNotSupported;
  }
  return set_window(a.stream, const_cast<void*>(a.table), bytes, 1.0f);
}

}  // namespace

extern "C" {

// out[r] = table[idx[r]] for r < n_out, rows of row_bytes bytes copied in
// vectors of `width` bytes (16, 8, 4 or 2: it must divide row_bytes and both
// base pointers). idx is int32 (idx64 = 0) or int64. variant 0 vec, 1 warp,
// 2 tile (tile_rows <= 32 rows a tile, tile_stages tiles a warp: 2, or 1
// where width is below 16 and lanes copy); fill (vec only) zero-fills
// out-of-range rows.
// With l2_window the table is pinned in L2 for this launch and *l2_granted
// gets the persisting carve-out in bytes. Returns the cudaError_t of the
// first call that failed.
int qmf_gather(const void* table, const void* idx, void* out, long long n_out,
               long long table_rows, long long row_bytes, int width,
               int idx64, int variant, int fill, int tile_rows,
               int tile_stages, int l2_window, int device, void* stream,
               long long* l2_granted) {
  if (n_out <= 0) return int(cudaSuccess);
  if (row_bytes <= 0 || table_rows <= 0 || n_out > 0x7fffffffLL ||
      variant < 0 || variant > 2 || (variant != 0 && fill))
    return int(cudaErrorInvalidValue);
  if (width != 16 && width != 8 && width != 4 && width != 2)
    return int(cudaErrorInvalidValue);
  if (row_bytes % width || reinterpret_cast<uintptr_t>(table) % width ||
      reinterpret_cast<uintptr_t>(out) % width)
    return int(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const Args a{table,     idx,         out,
               n_out,     table_rows,  row_bytes,
               variant,   fill,        tile_rows,
               tile_stages, reinterpret_cast<cudaStream_t>(stream)};
  if (l2_window) {
    err = pin_table(a, device, size_t(table_rows) * size_t(row_bytes),
                    l2_granted);
    if (err != cudaSuccess) return int(err);
  }
  if (variant == 2) {
    err = idx64 ? launch_tile_width<long long>(a, width, sms)
                : launch_tile_width<int>(a, width, sms);
  } else {
    switch (width) {
      case 16: err = launch_idx<uint4>(a, idx64, sms); break;
      case 8: err = launch_idx<uint2>(a, idx64, sms); break;
      case 4: err = launch_idx<unsigned int>(a, idx64, sms); break;
      default: err = launch_idx<unsigned short>(a, idx64, sms); break;
    }
  }
  if (l2_window) {
    // the launch took the window with it; later launches on the stream
    // must not
    const cudaError_t off = set_window(a.stream, nullptr, 0, 0.0f);
    if (err == cudaSuccess) err = off;
  }
  return int(err);
}

// Waits for the stream, turns every persisting L2 line back to normal and
// returns the persisting carve-out to 0. *limit gets the carve-out
// afterwards.
int qmf_l2_reset(int device, void* stream, long long* limit) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  err = cudaStreamSynchronize(reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  err = cudaCtxResetPersistingL2Cache();
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  if (err != cudaSuccess) return int(err);
  size_t have = 0;
  err = cudaDeviceGetLimit(&have, cudaLimitPersistingL2CacheSize);
  *limit = (long long)have;
  return int(err);
}

}  // extern "C"
