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
// the element type. Two access shapes, both grid-stride over output rows:
//
//   vec   a group of 1..32 lanes copies one row in vectors of the widest
//         width (16, 8, 4 or 2 bytes) that divides the row and both base
//         pointers: 8 lanes a row at 128-byte rows, so a warp moves 4 rows a
//         step, each lane one 16-byte load and one 16-byte store.
//   warp  one warp per row, each lane a 1/32 piece of it (4 bytes at
//         128-byte rows): one fully coalesced transaction per row.
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

struct Args {
  const void* table;
  const void* idx;
  void* out;
  int64_t n_out, table_rows, row_bytes;
  int variant, fill;  // variant 0 vec, 1 warp
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
// base pointers). idx is int32 (idx64 = 0) or int64. variant 0 vec, 1 warp;
// fill (vec only) zero-fills out-of-range rows. With l2_window the table is
// pinned in L2 for this launch and *l2_granted gets the persisting carve-out
// in bytes. Returns the cudaError_t of the first call that failed.
int qmf_gather(const void* table, const void* idx, void* out, long long n_out,
               long long table_rows, long long row_bytes, int width,
               int idx64, int variant, int fill, int l2_window, int device,
               void* stream, long long* l2_granted) {
  if (n_out <= 0) return int(cudaSuccess);
  if (row_bytes <= 0 || table_rows <= 0 || n_out > 0x7fffffffLL ||
      variant < 0 || variant > 1 || (variant == 1 && fill))
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
  const Args a{table, idx, out, n_out, table_rows, row_bytes, variant, fill,
               reinterpret_cast<cudaStream_t>(stream)};
  if (l2_window) {
    err = pin_table(a, device, size_t(table_rows) * size_t(row_bytes),
                    l2_granted);
    if (err != cudaSuccess) return int(err);
  }
  switch (width) {
    case 16: err = launch_idx<uint4>(a, idx64, sms); break;
    case 8: err = launch_idx<uint2>(a, idx64, sms); break;
    case 4: err = launch_idx<unsigned int>(a, idx64, sms); break;
    default: err = launch_idx<unsigned short>(a, idx64, sms); break;
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
