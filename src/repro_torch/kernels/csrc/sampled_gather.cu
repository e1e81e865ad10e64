// Mini-batch assembly kernels for Hopper (sm_90a): the paper's two access
// patterns at the device-memory tier.
//
// These replace the two Pallas TPU kernels of
// src/repro/kernels/sampled_gather.py:
//
//   repro_block_gather   <- block_gather  (sampled_gather.py:34)
//   repro_random_gather  <- random_gather (sampled_gather.py:58)
//
// Both copy rows of a row-major (l, n) array of any element size (the
// wrapper passes the row's bytes, n * itemsize) into a fresh (b, n) array,
// byte for byte: a copy moves the bits of NaNs and of integer data alike.
//
// Design.  The TPU kernels encode the access structure in their grids: the
// block kernel is ONE grid step whose BlockSpec brings the whole batch in as
// one block DMA; the rows kernel is b grid steps, one row DMA each.  The
// same asymmetry here:
//
//   * block: the batch is one contiguous region of b * row_bytes bytes
//     starting at row clip(block_idx * b, 0, l - b) (the clamp of
//     lax.dynamic_slice).  One grid of CTAs strides over it with the widest
//     load both ends are aligned to: 16-byte words when the region's start
//     and the output are 16-byte aligned, else 8, 4, 2 or 1 bytes, and the
//     last bytes that do not fill a word one at a time.  block_idx is read
//     from device memory: the host never learns the start.
//   * rows: one warp per batch row.  The 32 lanes copy the row with the
//     widest words the row's source and destination allow.  An id outside
//     [0, l) is clamped to the nearest row (below 0 -> row 0, l or above ->
//     row l - 1), so the kernel never reads outside the array.
//
// What bounds them.  Each reads b * row_bytes and writes as many: at the
// SUSY shape (b = 500, n = 18, f32) that is 36 KB each way, moved in about
// 0.02 us at 3.35 TB/s, so a call is bound by launch latency; at
// 500 x 4096 f32 it is 8 MB each way and the bytes bound it.  The rows kernel
// issues b independent row copies of row_bytes each: at n = 18 a row is
// 72 bytes, so its words are 8 bytes and each warp moves one short row.
// TMA bulk copies (cp.async.bulk) would take the block kernel's address
// arithmetic off the threads; that is later work.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS_PER_BLOCK = THREADS / 32;
constexpr long long MAX_BLOCKS = 132 * 8;   // grid-stride beyond this

template <int W> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<1> { using T = unsigned char; };

// Copy nbytes from src to dst (both W-aligned) in W-byte words: thread t of
// nt takes words t, t + nt, ...; the nbytes % W bytes after the last word go
// one at a time.
template <int W>
__device__ __forceinline__ void copy_words(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           long long nbytes, long long t,
                                           long long nt) {
  using T = typename Word<W>::T;
  const long long words = nbytes / W;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (long long k = t; k < words; k += nt) d[k] = s[k];
  for (long long k = words * W + t; k < nbytes; k += nt) dst[k] = src[k];
}

// The widest word (16, 8, 4, 2 or 1 bytes) both addresses are aligned to.
__device__ __forceinline__ int common_alignment(const void* a, const void* b) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b);
  if ((x & 15) == 0) return 16;
  if ((x & 7) == 0) return 8;
  if ((x & 3) == 0) return 4;
  if ((x & 1) == 0) return 2;
  return 1;
}

__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           long long nbytes, long long t,
                                           long long nt) {
  switch (common_alignment(dst, src)) {   // uniform across the threads
    case 16: copy_words<16>(dst, src, nbytes, t, nt); break;
    case 8: copy_words<8>(dst, src, nbytes, t, nt); break;
    case 4: copy_words<4>(dst, src, nbytes, t, nt); break;
    case 2: copy_words<2>(dst, src, nbytes, t, nt); break;
    default: copy_words<1>(dst, src, nbytes, t, nt); break;
  }
}

__global__ void block_gather_kernel(const char* __restrict__ data,
                                    const int* __restrict__ block_idx,
                                    int l, long long row_bytes, int b,
                                    char* __restrict__ out) {
  long long start = static_cast<long long>(*block_idx) * b;
  const long long last = static_cast<long long>(l - b);
  start = start < 0 ? 0 : (start > last ? last : start);
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  copy_bytes(out, data + start * row_bytes, b * row_bytes, t, nt);
}

__global__ void random_gather_kernel(const char* __restrict__ data,
                                     const int* __restrict__ idx, int l,
                                     long long row_bytes, int b,
                                     char* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (i >= b) return;                          // warp-uniform
  int r = idx[i];
  r = r < 0 ? 0 : (r >= l ? l - 1 : r);
  copy_bytes(out + static_cast<long long>(i) * row_bytes,
             data + static_cast<long long>(r) * row_bytes, row_bytes, lane,
             32);
}

}  // namespace

extern "C" {

int repro_block_gather(const void* data, const int* block_idx, int l,
                       long long row_bytes, int b, void* out, void* stream) {
  const long long words = (static_cast<long long>(b) * row_bytes + 15) / 16;
  long long grid = (words + THREADS - 1) / THREADS;
  grid = grid < 1 ? 1 : (grid > MAX_BLOCKS ? MAX_BLOCKS : grid);
  block_gather_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(data), block_idx, l, row_bytes, b,
      static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

int repro_random_gather(const void* data, const int* idx, int l,
                        long long row_bytes, int b, void* out, void* stream) {
  const int grid = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  random_gather_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(data), idx, l, row_bytes, b,
      static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
