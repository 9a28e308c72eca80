// A-entry assembly of a dispatch group's fronts.
//
// Replaces the TPU kernel superlu_dist_tpu/numeric/pallas_kernels.py:
// assemble_avals_pallas (_assemble_kernel).  For every entry e:
//     f[a_slot[e], a_flat[e]] += avals[a_src[e]]
// An entry with a_slot outside [0, batch) or a_flat outside [0, m2) is
// dropped; a_src outside [0, n_avals) reads 0.  The host-built maps give
// every entry its own front position (targets are unique).
//
// Bound: bytes, and at the main path's sizes launch latency: each entry
// is three index reads, one value gather and one front read-modify-write.
//
// Design: one thread per entry.  Unique targets mean no two threads write
// one position, so no sort by slot (the TPU kernel's per-slot runs) and no
// atomics; every sum is the same single add as the in-order scatter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void assemble_kernel(T* __restrict__ f, const T* __restrict__ avals,
                                const int64_t* __restrict__ a_slot,
                                const int64_t* __restrict__ a_flat,
                                const int64_t* __restrict__ a_src,
                                int64_t n_entries, int64_t batch, int64_t m2,
                                int64_t n_avals) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int64_t s = a_slot[e];
  const int64_t fl = a_flat[e];
  if (s < 0 || s >= batch || fl < 0 || fl >= m2) return;
  const int64_t src = a_src[e];
  const T v = (src >= 0 && src < n_avals) ? avals[src] : T(0);
  T* p = f + s * m2 + fl;
  *p = *p + v;
}

template <typename T>
int launch(T* f, const T* avals, const int64_t* a_slot, const int64_t* a_flat,
           const int64_t* a_src, int64_t n_entries, int64_t batch, int64_t m2,
           int64_t n_avals, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_entries + kThreads - 1) / kThreads);
  assemble_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      f, avals, a_slot, a_flat, a_src, n_entries, batch, m2, n_avals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slu_assemble_f32(float* f, const float* avals, const int64_t* a_slot,
                     const int64_t* a_flat, const int64_t* a_src,
                     int64_t n_entries, int64_t batch, int64_t m2,
                     int64_t n_avals, void* stream) {
  return launch<float>(f, avals, a_slot, a_flat, a_src, n_entries, batch, m2,
                       n_avals, stream);
}

int slu_assemble_f64(double* f, const double* avals, const int64_t* a_slot,
                     const int64_t* a_flat, const int64_t* a_src,
                     int64_t n_entries, int64_t batch, int64_t m2,
                     int64_t n_avals, void* stream) {
  return launch<double>(f, avals, a_slot, a_flat, a_src, n_entries, batch, m2,
                        n_avals, stream);
}

}  // extern "C"
