// Serving's seen-item exclusion: scores[b, j] = -inf for every item j of the
// CSR segment items[indptr[users[b]] : indptr[users[b] + 1]].
//
// Replaces no TPU kernel: qmf_tpu/models/recommend.py excludes seen items
// with plain jnp, a per-element binary search of each user's segment
// (_is_member) at every (user, item) of the batch's grid. On the card that
// search was ~10 elementwise passes of the whole (B, I) grid a step, tens of
// GB moved for an answer of B x the mean degree entries. This kernel writes
// exactly those entries, so the masked scores are the search's bit for bit.
//
// Bound by the latency of scattered stores, not by bytes: a request of 4,096
// users at MovieLens-20M's mean degree reads ~0.59M item ids (2.4 MB, read
// once and in order) and writes as many 2- to 8-byte elements at scattered
// columns of their rows. One block a batch row: its threads stride over the
// user's segment, so neighbouring threads read neighbouring ids and a
// segment of any length is covered (the lognormal head of the degrees runs
// into the thousands), while the many short segments of the body take a
// block each, which the card schedules side by side. Ids outside
// [0, cols) are skipped: the search never matched them. A user outside
// [0, n_users) is the caller's error; its row is left as it is rather than
// read out of bounds.
//
// -inf is written as its bit pattern in an unsigned type of the element's
// width, so the kernel needs no floating-point header.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    exclude_seen_kernel(T* __restrict__ scores, long long cols,
                        const int* __restrict__ indptr,
                        const int* __restrict__ items,
                        const int* __restrict__ users, long long n_users,
                        T neg_inf) {
  const long long b = blockIdx.x;
  const long long u = static_cast<long long>(__ldg(users + b));
  if (u < 0 || u >= n_users) return;
  const long long end = __ldg(indptr + u + 1);
  T* row = scores + b * cols;
#pragma unroll 4
  for (long long p = __ldg(indptr + u) + threadIdx.x; p < end; p += kThreads) {
    const int j = __ldcs(items + p);
    if (j >= 0 && j < cols) row[j] = neg_inf;
  }
}

template <typename T>
cudaError_t launch(void* scores, long long rows, long long cols,
                   const void* indptr, const void* items, const void* users,
                   long long n_users, T neg_inf, cudaStream_t stream) {
  exclude_seen_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                           stream>>>(
      static_cast<T*>(scores), cols, static_cast<const int*>(indptr),
      static_cast<const int*>(items), static_cast<const int*>(users), n_users,
      neg_inf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (rows, cols) contiguous, of dtype 0 float32, 1 float64 or
// 2 bfloat16; indptr (n_users + 1,), items and users (rows,) int32; all in
// device memory of `device`. Writes -inf at scores[b, items[p]] for
// indptr[users[b]] <= p < indptr[users[b] + 1] and items[p] in [0, cols), on
// `stream`. Launches nothing for rows = 0. The caller's current device is
// left as it was. Does not synchronise. Returns the cudaError_t of the first
// call that failed.
int qmf_exclude_seen(void* scores, long long rows, long long cols, int dtype,
                     const void* indptr, const void* items, const void* users,
                     long long n_users, int device, void* stream) {
  if (rows == 0) return int(cudaSuccess);
  if (rows < 0 || rows > 0x7fffffffLL || cols < 0 || n_users < 0 ||
      dtype < 0 || dtype > 2)
    return int(cudaErrorInvalidValue);
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<uint32_t>(scores, rows, cols, indptr, items, users,
                             n_users, 0xff800000u, s);
      break;
    case 1:
      err = launch<uint64_t>(scores, rows, cols, indptr, items, users,
                             n_users, 0xfff0000000000000ull, s);
      break;
    default:
      err = launch<uint16_t>(scores, rows, cols, indptr, items, users,
                             n_users, uint16_t(0xff80), s);
      break;
  }
  if (caller != device) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return int(err);
}

}  // extern "C"
