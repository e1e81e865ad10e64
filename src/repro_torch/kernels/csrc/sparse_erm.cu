// CSR mini-batch margin/gradient kernels for Hopper (sm_90a).
//
// These replace the four Pallas TPU kernels of src/repro/kernels/sparse_erm.py:
//
//   repro_csr_margins_block  <- sparse_margins_block (sparse_erm.py:405)
//   repro_csr_margins_rows   <- sparse_margins_rows  (sparse_erm.py:339)
//   repro_csr_grad_block     <- sparse_grad_block    (sparse_erm.py:260)
//   repro_csr_grad_rows      <- sparse_grad_rows     (sparse_erm.py:180)
//
// The corpus is CSR in device memory: flat vals (f32) and cols (i32) and an
// int32 indptr of l+1 offsets; row r is [indptr[r], indptr[r+1]).  A batch
// is the contiguous block [clip(start, 0, l-b), +b) (CS/SS) or the rows
// idx[0..b) (RS, duplicates and wrap-around included).  The data-term
// gradient is g = (1/b) sum_i s_i x_i with s_i = dloss(x_i . w, y_i).
//
// Design.  The TPU kernels densify each row one feature tile at a time by a
// one-hot contraction on the MXU, inside DMA windows sized by kmax; none of
// that carries over.  Here:
//
//   * margins: one warp per batch row; the lanes walk the row's segment,
//     summing vals[k] * w[cols[k]], and reduce with a fixed shuffle tree.
//     An empty row gives z = 0.
//   * gradient: three launches.  (1) the margins kernel with the loss as a
//     template argument writes s_i = dloss(z_i, y_row) / b.  (2) G row
//     groups, one block each: group q owns a contiguous run of batch rows
//     and an n-wide f32 partial in scratch; it zeroes its partial, then
//     walks its rows in order (a barrier between rows), its threads adding
//     s_i * vals into the partial.  (3) g_j = sum of the G partials at j, in
//     group order.  No float atomics, so the same inputs give the same bits.
//   * repeated columns: rows list their columns in ascending order
//     (csr_to_device checks), so a repeated column is a run of neighbours.
//     Only the thread at the head of a run writes: it sums the run's values
//     in order and adds s_i times that sum once, so no two threads of a row
//     touch one column.
//
// What bounds them.  At the main-path shape (b = 500, ~131 nonzeros a row,
// n = 65,536) a batch is ~65,500 nonzeros, 0.52 MB of vals and cols: the
// margins kernels are bound by those bytes and by launch latency.  The
// gradient also writes the n-wide g; its G partials add 2 * G * n * 4 bytes
// of scratch traffic (16 MB at G = 32), which lives in the 50 MB L2 — the
// price of a fixed summation order without atomics.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches.

#include "erm_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;     // margins: one warp per batch row
constexpr int SCATTER_THREADS = 256;   // gradient: threads of a row group
constexpr int REDUCE_THREADS = 256;    // gradient: columns per block

// z_i = row_i . w, or s_i = dloss(z_i, y[row_i]) / b when LOSS >= 0.
// A row outside [0, l) yields NaN instead of reading out of bounds.
template <int LOSS>
__global__ void csr_margins_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ cols,
                                   const int* __restrict__ indptr,
                                   const float* __restrict__ y,
                                   const float* __restrict__ w,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ start_ptr,
                                   int start_val, int l, int b,
                                   float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (i >= b) return;                          // warp-uniform
  const int row = batch_row(idx, start_ptr, start_val, l, b, i);
  const bool valid = row >= 0 && row < l;      // warp-uniform
  float acc = 0.0f;
  if (valid) {
    const int e1 = indptr[row + 1];
    for (int k = indptr[row] + lane; k < e1; k += 32)
      acc += vals[k] * w[cols[k]];
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

// Block q of `groups`: partial[q] = sum over its batch rows i (in order) of
// s_i * x_i.  A row outside [0, l) poisons the partial with NaN.
__global__ void csr_scatter_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ cols,
                                   const int* __restrict__ indptr,
                                   const float* __restrict__ s,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ start_ptr,
                                   int start_val, int l, int n, int b,
                                   int groups, float* __restrict__ partial) {
  const int grp = static_cast<int>(blockIdx.x);
  float* part = partial + static_cast<size_t>(grp) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) part[j] = 0.0f;
  __syncthreads();
  const int per = (b + groups - 1) / groups;
  const int i1 = min(b, (grp + 1) * per);
  for (int i = grp * per; i < i1; ++i) {
    const int row = batch_row(idx, start_ptr, start_val, l, b, i);
    if (row >= 0 && row < l) {
      const float si = s[i];
      const int e0 = indptr[row], e1 = indptr[row + 1];
      for (int k = e0 + threadIdx.x; k < e1; k += blockDim.x) {
        const int c = cols[k];
        if (k > e0 && cols[k - 1] == c) continue;   // inside a run
        float v = vals[k];
        for (int q = k + 1; q < e1 && cols[q] == c; ++q) v += vals[q];
        part[c] += si * v;
      }
    } else {
      for (int j = threadIdx.x; j < n; j += blockDim.x) part[j] = NAN;
    }
    __syncthreads();     // row i's adds land before row i+1's
  }
}

// g_j = sum_q partial[q][j], q = 0 .. groups-1 in order.
__global__ void reduce_groups_kernel(const float* __restrict__ partial,
                                     int n, int groups,
                                     float* __restrict__ g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float t = 0.0f;
  for (int q = 0; q < groups; ++q)
    t += partial[static_cast<size_t>(q) * n + j];
  g[j] = t;
}

int launch_margins(const float* vals, const int* cols, const int* indptr,
                   const float* w, const int* idx, const int* start_ptr,
                   int start_val, int l, int b, float* z,
                   cudaStream_t stream) {
  const int grid = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  csr_margins_kernel<MARGINS_ONLY><<<grid, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      vals, cols, indptr, nullptr, w, idx, start_ptr, start_val, l, b, z);
  return static_cast<int>(cudaGetLastError());
}

int launch_grad(const float* vals, const int* cols, const int* indptr,
                const float* y, const float* w, const int* idx,
                const int* start_ptr, int start_val, int l, int n, int b,
                int loss, int groups, float* s, float* partial, float* g,
                cudaStream_t stream) {
  const int grid = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const int threads = 32 * WARPS_PER_BLOCK;
  switch (loss) {
    case LOGISTIC:
      csr_margins_kernel<LOGISTIC><<<grid, threads, 0, stream>>>(
          vals, cols, indptr, y, w, idx, start_ptr, start_val, l, b, s);
      break;
    case SQUARE:
      csr_margins_kernel<SQUARE><<<grid, threads, 0, stream>>>(
          vals, cols, indptr, y, w, idx, start_ptr, start_val, l, b, s);
      break;
    case SMOOTH_HINGE:
      csr_margins_kernel<SMOOTH_HINGE><<<grid, threads, 0, stream>>>(
          vals, cols, indptr, y, w, idx, start_ptr, start_val, l, b, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  csr_scatter_kernel<<<groups, SCATTER_THREADS, 0, stream>>>(
      vals, cols, indptr, s, idx, start_ptr, start_val, l, n, b, groups,
      partial);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  reduce_groups_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS,
                         REDUCE_THREADS, 0, stream>>>(partial, n, groups, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_csr_margins_block(const float* vals, const int* cols,
                            const int* indptr, const float* w,
                            const int* start_ptr, int start_val, int l, int b,
                            float* z, void* stream) {
  return launch_margins(vals, cols, indptr, w, nullptr, start_ptr, start_val,
                        l, b, z, static_cast<cudaStream_t>(stream));
}

int repro_csr_margins_rows(const float* vals, const int* cols,
                           const int* indptr, const float* w, const int* idx,
                           int l, int b, float* z, void* stream) {
  return launch_margins(vals, cols, indptr, w, idx, nullptr, 0, l, b, z,
                        static_cast<cudaStream_t>(stream));
}

int repro_csr_grad_block(const float* vals, const int* cols, const int* indptr,
                         const float* y, const float* w, const int* start_ptr,
                         int start_val, int l, int n, int b, int loss,
                         int groups, float* s, float* partial, float* g,
                         void* stream) {
  return launch_grad(vals, cols, indptr, y, w, nullptr, start_ptr, start_val,
                     l, n, b, loss, groups, s, partial, g,
                     static_cast<cudaStream_t>(stream));
}

int repro_csr_grad_rows(const float* vals, const int* cols, const int* indptr,
                        const float* y, const float* w, const int* idx, int l,
                        int n, int b, int loss, int groups, float* s,
                        float* partial, float* g, void* stream) {
  return launch_grad(vals, cols, indptr, y, w, idx, nullptr, 0, l, n, b, loss,
                     groups, s, partial, g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
