// Fused sampled-gather + ERM margin/gradient kernels for Hopper (sm_90a).
//
// These replace the four Pallas TPU kernels of src/repro/kernels/fused_erm.py:
//
//   repro_margins_block  <- fused_margins_block (fused_erm.py:254)
//   repro_margins_rows   <- fused_margins_rows  (fused_erm.py:290)
//   repro_grad_block     <- fused_grad_block    (fused_erm.py:140)
//   repro_grad_rows      <- fused_grad_rows     (fused_erm.py:197)
//
// The sampled batch is read straight from the resident corpus X (row-major
// (l, n) float32 in device memory) and never exists as an array of its own.
// A batch is either the contiguous block [clip(start, 0, l-b), +b) (CS/SS;
// the clamp of lax.dynamic_slice at both ends) or the rows idx[0..b) (RS,
// duplicates and wrap-around included).
//
// Design.  The TPU kernels walk a sequential grid and carry sums from one
// grid step to the next (the feature-tiled z accumulator of the block kernel,
// the gradient accumulator of the rows kernel).  Blocks on Hopper run in no
// order, so nothing is carried between them:
//
//   * margins: one warp per batch row; the 32 lanes stride over the n
//     features and reduce by shuffles, so z_i is complete inside its warp.
//   * gradient: two launches.  The margins kernel, with the loss as a
//     template argument, writes s_i = dloss(z_i, y_row)/b into a (b,) scratch
//     the wrapper allocates; a column kernel then forms g_j = sum_i s_i X[row_i, j]:
//     each thread owns a column and walks a fixed subset of the b rows, and
//     the ROW_GROUPS partial sums are added in shared memory in a fixed order.
//     No atomics, so the same inputs give the same bits on every run.
//
// What bounds them.  At the main-path shape (b = 500, n = 18: 36 KB of X per
// call) each kernel is bound by launch latency, not by bytes: the card moves
// 36 KB in about 11 ns.  At n = 4096 a call reads b*n*4 = 8 MB of X and is
// bound by those bytes; the warp-per-row margins loop and the column-owning
// gradient loop both read 32 consecutive floats per warp (128 B, coalesced).
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LOGISTIC = 0, SQUARE = 1, SMOOTH_HINGE = 2;
constexpr int MARGINS_ONLY = -1;     // margins kernel writes z, not s
constexpr int WARPS_PER_BLOCK = 8;   // margins: one warp per batch row
constexpr int COL_TILE = 32;         // gradient: columns per block
constexpr int ROW_GROUPS = 8;        // gradient: row subsets per column

// d/dz of the per-example margin loss (repro.kernels.fused_erm._dloss).
// expf, not __expf: the logistic branch stays within 1e-6 of jax.nn.sigmoid.
template <int LOSS>
__device__ __forceinline__ float dloss(float z, float y) {
  if (LOSS == LOGISTIC) {
    return -y * (1.0f / (1.0f + expf(y * z)));   // -y * sigmoid(-y z)
  } else if (LOSS == SQUARE) {
    return z - y;
  } else {
    const float t = y * z;
    return -y * (t >= 1.0f ? 0.0f : (t <= 0.0f ? 1.0f : 1.0f - t));
  }
}

// Corpus row of batch entry i: idx[i] (RS) or the clamped block row (CS/SS).
// The block start comes from device memory (start_ptr, a schedule entry that
// is never read back to the host) or, when start_ptr is null, by value.
__device__ __forceinline__ int batch_row(const int* idx, const int* start_ptr,
                                         int start_val, int l, int b, int i) {
  if (idx != nullptr) return idx[i];
  const int s = start_ptr != nullptr ? *start_ptr : start_val;
  return min(max(s, 0), l - b) + i;
}

// z_i = X[row_i] . w, or s_i = dloss(z_i, y[row_i]) / b when LOSS >= 0.
// An index outside [0, l) yields NaN instead of reading out of bounds.
template <int LOSS>
__global__ void margins_kernel(const float* __restrict__ X,
                               const float* __restrict__ y,
                               const float* __restrict__ w,
                               const int* __restrict__ idx,
                               const int* __restrict__ start_ptr,
                               int start_val, int l, int n, int b,
                               float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (i >= b) return;                          // warp-uniform
  const int row = batch_row(idx, start_ptr, start_val, l, b, i);
  const bool valid = row >= 0 && row < l;      // warp-uniform
  float acc = 0.0f;
  if (valid) {
    const float* xr = X + static_cast<size_t>(row) * n;
    for (int k = lane; k < n; k += 32) acc += xr[k] * w[k];
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    if (!valid) {
      out[i] = NAN;
    } else if (LOSS == MARGINS_ONLY) {
      out[i] = acc;
    } else {
      out[i] = dloss<LOSS>(acc, y[row]) / static_cast<float>(b);
    }
  }
}

// g_j = sum_i s_i X[row_i, j]: block (COL_TILE x ROW_GROUPS) threads; thread
// (c, r) owns column blockIdx.x*COL_TILE + c and rows r, r+ROW_GROUPS, ...
__global__ void grad_cols_kernel(const float* __restrict__ X,
                                 const float* __restrict__ s,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ start_ptr,
                                 int start_val, int l, int n, int b,
                                 float* __restrict__ g) {
  __shared__ float part[ROW_GROUPS][COL_TILE];
  const int c = threadIdx.x % COL_TILE;
  const int r = threadIdx.x / COL_TILE;
  const int j = blockIdx.x * COL_TILE + c;
  float acc = 0.0f;
  if (j < n) {
    for (int i = r; i < b; i += ROW_GROUPS) {
      const int row = batch_row(idx, start_ptr, start_val, l, b, i);
      const float x = (row >= 0 && row < l)
                          ? X[static_cast<size_t>(row) * n + j] : NAN;
      acc += s[i] * x;
    }
  }
  part[r][c] = acc;
  __syncthreads();
  if (r == 0 && j < n) {
    float total = 0.0f;
    for (int k = 0; k < ROW_GROUPS; ++k) total += part[k][c];
    g[j] = total;
  }
}

int launch_margins(const float* X, const float* w, const int* idx,
                   const int* start_ptr, int start_val, int l, int n, int b,
                   float* z, cudaStream_t stream) {
  const int grid = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  margins_kernel<MARGINS_ONLY><<<grid, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      X, nullptr, w, idx, start_ptr, start_val, l, n, b, z);
  return static_cast<int>(cudaGetLastError());
}

int launch_grad(const float* X, const float* y, const float* w,
                const int* idx, const int* start_ptr, int start_val, int l,
                int n, int b, int loss, float* s, float* g,
                cudaStream_t stream) {
  const int grid = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const int threads = 32 * WARPS_PER_BLOCK;
  switch (loss) {
    case LOGISTIC:
      margins_kernel<LOGISTIC><<<grid, threads, 0, stream>>>(
          X, y, w, idx, start_ptr, start_val, l, n, b, s);
      break;
    case SQUARE:
      margins_kernel<SQUARE><<<grid, threads, 0, stream>>>(
          X, y, w, idx, start_ptr, start_val, l, n, b, s);
      break;
    case SMOOTH_HINGE:
      margins_kernel<SMOOTH_HINGE><<<grid, threads, 0, stream>>>(
          X, y, w, idx, start_ptr, start_val, l, n, b, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  grad_cols_kernel<<<(n + COL_TILE - 1) / COL_TILE, COL_TILE * ROW_GROUPS, 0,
                     stream>>>(X, s, idx, start_ptr, start_val, l, n, b, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_margins_block(const float* X, const float* w, const int* start_ptr,
                        int start_val, int l, int n, int b, float* z,
                        void* stream) {
  return launch_margins(X, w, nullptr, start_ptr, start_val, l, n, b, z,
                        static_cast<cudaStream_t>(stream));
}

int repro_margins_rows(const float* X, const float* w, const int* idx, int l,
                       int n, int b, float* z, void* stream) {
  return launch_margins(X, w, idx, nullptr, 0, l, n, b, z,
                        static_cast<cudaStream_t>(stream));
}

int repro_grad_block(const float* X, const float* y, const float* w,
                     const int* start_ptr, int start_val, int l, int n, int b,
                     int loss, float* s, float* g, void* stream) {
  return launch_grad(X, y, w, nullptr, start_ptr, start_val, l, n, b, loss, s,
                     g, static_cast<cudaStream_t>(stream));
}

int repro_grad_rows(const float* X, const float* y, const float* w,
                    const int* idx, int l, int n, int b, int loss, float* s,
                    float* g, void* stream) {
  return launch_grad(X, y, w, idx, nullptr, 0, l, n, b, loss, s, g,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
