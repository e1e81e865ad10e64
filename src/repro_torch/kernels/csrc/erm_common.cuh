// Pieces shared by the ERM kernels (fused_erm.cu, sparse_erm.cu): the loss
// codes, d/dz of the margin loss, and the corpus row of a batch entry.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LOGISTIC = 0, SQUARE = 1, SMOOTH_HINGE = 2;
constexpr int MARGINS_ONLY = -1;     // a margins kernel writes z, not s

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

}  // namespace
