// Multifrontal extend-add of one child set into a batch of parent fronts.
//
// Replaces the TPU kernel superlu_dist_tpu/numeric/pallas_kernels.py:
// extend_add_set_pallas (_extend_add_kernel).  For each child c in
// ascending order, for every child position (i, j):
//     f[slot[c], rel[c,i]*m + rel[c,j]] += pool[off[c] + i*ub + j]
// rel >= m (the sentinel m) drops the pair; a child whose slot is outside
// [0, batch) or whose offset is outside [0, pool_len) is dropped whole; a
// pool read past pool_len reads 0.  Untargeted positions keep their bits.
// Precondition (as for the TPU kernel): the real rel entries of one child
// are distinct, so one child never hits a front position twice.
//
// Bound: bytes.  Each child element is one pool read and one front
// read-modify-write, with no arithmetic beyond one add.
//
// Design: one block per (parent slot, band of kBandRows parent rows).  A
// target position lies in exactly one band, so it has exactly one writing
// block: no atomics.  The block walks the child set in ascending child
// order, skipping children of other slots; for each child it collects the
// child rows that land in its band, then one warp per collected row adds
// that row's pool slab (contiguous in j, so the reads coalesce) into the
// front.  __syncthreads() between children keeps the per-position order
// ascending in c, so the sums equal the in-order scatter bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 32;

template <typename T>
__global__ void extend_add_kernel(T* __restrict__ f,
                                  const T* __restrict__ pool,
                                  const int64_t* __restrict__ child_off,
                                  const int64_t* __restrict__ child_slot,
                                  const int64_t* __restrict__ rel,
                                  int64_t m, int64_t ub, int64_t nc,
                                  int64_t pool_len) {
  __shared__ int64_t band_rows[kBandRows];
  __shared__ int n_band;
  const int64_t s = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kBandRows;
  const int64_t r1 = r0 + kBandRows < m ? r0 + kBandRows : m;
  T* fs = f + s * m * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t off = child_off[c];
    // uniform across the block: every thread skips the same children
    if (child_slot[c] != s || off < 0 || off >= pool_len) continue;
    if (threadIdx.x == 0) n_band = 0;
    __syncthreads();
    const int64_t* rc = rel + c * ub;
    for (int64_t i = threadIdx.x; i < ub; i += blockDim.x) {
      const int64_t r = rc[i];
      if (r >= r0 && r < r1) {
        const int k = atomicAdd(&n_band, 1);
        if (k < kBandRows) band_rows[k] = i;
      }
    }
    __syncthreads();
    const int nb = n_band < kBandRows ? n_band : kBandRows;
    for (int k = warp; k < nb; k += nwarps) {
      const int64_t i = band_rows[k];
      T* frow = fs + rc[i] * m;
      const int64_t src0 = off + i * ub;
      for (int64_t j = lane; j < ub; j += 32) {
        const int64_t cj = rc[j];
        if (cj < 0 || cj >= m) continue;
        const int64_t src = src0 + j;
        const T v = src < pool_len ? pool[src] : T(0);
        frow[cj] = frow[cj] + v;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(T* f, const T* pool, const int64_t* child_off,
           const int64_t* child_slot, const int64_t* rel, int64_t batch,
           int64_t m, int64_t ub, int64_t nc, int64_t pool_len,
           void* stream) {
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>((m + kBandRows - 1) / kBandRows));
  extend_add_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f, pool, child_off, child_slot, rel, m, ub, nc, pool_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slu_extend_add_f32(float* f, const float* pool, const int64_t* child_off,
                       const int64_t* child_slot, const int64_t* rel,
                       int64_t batch, int64_t m, int64_t ub, int64_t nc,
                       int64_t pool_len, void* stream) {
  return launch<float>(f, pool, child_off, child_slot, rel, batch, m, ub, nc,
                       pool_len, stream);
}

int slu_extend_add_f64(double* f, const double* pool,
                       const int64_t* child_off, const int64_t* child_slot,
                       const int64_t* rel, int64_t batch, int64_t m,
                       int64_t ub, int64_t nc, int64_t pool_len,
                       void* stream) {
  return launch<double>(f, pool, child_off, child_slot, rel, batch, m, ub, nc,
                        pool_len, stream);
}

}  // extern "C"
