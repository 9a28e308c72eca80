// CSR sparse matrix times dense block, in a fixed order: y = A·x.
//
// The refinement residual's SpMV on the card (superlu_dist_tpu_torch/
// parallel/dist.py, DeviceSpMV; the pdgsmv analog, SRC/pdgsmv.c:234).  The
// JAX package computes it with an XLA scatter-add
// (superlu_dist_tpu/parallel/dist.py:181-185); on this card that
// formulation (``index_add_``) would add with floating-point atomics, so
// the residual — and with it x and the BERR history — would change from
// run to run.  This kernel gives each (row, column) pair of y one thread
// that walks the row in CSR order and rounds every multiply and add on its
// own (``__dmul_rn``/``__dadd_rn``, ``__fmul_rn``/``__fadd_rn``: no FMA
// contraction), so y is the same bits on every run and equals the plain
// PyTorch twin (``csr_spmv_plain``) bit for bit.  A complex product is
// explicit component arithmetic in a fixed order:
//     re = ar·xr − ai·xi,  im = ar·xi + ai·xr,  then acc += (re, im).
//
// Bound: bytes (indptr, indices and values read once, x gathered, y
// written once; 2·nnz·k flops are far below the card's rate).  Design: one
// thread per output element, row-major y (n_rows, k), so consecutive
// threads of a k = 1 launch walk consecutive rows; a simple kernel that is
// right — at n = 110,592 the whole product is a few microseconds of bytes.
//
// C interface (ctypes): slu_csr_spmv_<f32|f64|c64|c128>(indptr, indices,
// vals, x, y, n_rows, k, stream) -> cudaError_t as int.  indptr (n_rows+1)
// and indices (nnz) are int64; vals, x (n_cols, k) and y (n_rows, k) are
// contiguous, of the kernel's type.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void spmv_real(const int64_t* __restrict__ indptr,
                          const int64_t* __restrict__ indices,
                          const T* __restrict__ vals, const T* __restrict__ x,
                          T* __restrict__ y, int64_t n_rows, int64_t k) {
    int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n_rows * k) return;
    int64_t row = t / k, j = t - row * k;
    T acc = T(0);
    for (int64_t e = indptr[row]; e < indptr[row + 1]; ++e) {
        acc = add_rn(acc, mul_rn(vals[e], x[indices[e] * k + j]));
    }
    y[t] = acc;
}

// complex values as interleaved (re, im) pairs of T
template <typename T>
__global__ void spmv_complex(const int64_t* __restrict__ indptr,
                             const int64_t* __restrict__ indices,
                             const T* __restrict__ vals,
                             const T* __restrict__ x, T* __restrict__ y,
                             int64_t n_rows, int64_t k) {
    int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n_rows * k) return;
    int64_t row = t / k, j = t - row * k;
    T acc_re = T(0), acc_im = T(0);
    for (int64_t e = indptr[row]; e < indptr[row + 1]; ++e) {
        T ar = vals[2 * e], ai = vals[2 * e + 1];
        int64_t xi_ = 2 * (indices[e] * k + j);
        T xr = x[xi_], xim = x[xi_ + 1];
        T re = sub_rn(mul_rn(ar, xr), mul_rn(ai, xim));
        T im = add_rn(mul_rn(ar, xim), mul_rn(ai, xr));
        acc_re = add_rn(acc_re, re);
        acc_im = add_rn(acc_im, im);
    }
    y[2 * t] = acc_re;
    y[2 * t + 1] = acc_im;
}

constexpr int kThreads = 256;

template <typename T, bool Complex>
int launch(const void* indptr, const void* indices, const void* vals,
           const void* x, void* y, int64_t n_rows, int64_t k,
           cudaStream_t stream) {
    int64_t total = n_rows * k;
    if (total <= 0) return 0;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto ip = static_cast<const int64_t*>(indptr);
    auto ix = static_cast<const int64_t*>(indices);
    auto v = static_cast<const T*>(vals);
    auto xx = static_cast<const T*>(x);
    auto yy = static_cast<T*>(y);
    if constexpr (Complex) {
        spmv_complex<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(ip, ix, v, xx, yy, n_rows, k);
    } else {
        spmv_real<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       stream>>>(ip, ix, v, xx, yy, n_rows, k);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SLU_SPMV(sfx, T, CPLX)                                                \
    extern "C" int slu_csr_spmv_##sfx(const void* indptr, const void* indices, \
                                      const void* vals, const void* x,        \
                                      void* y, int64_t n_rows, int64_t k,     \
                                      void* stream) {                         \
        return launch<T, CPLX>(indptr, indices, vals, x, y, n_rows, k,        \
                               static_cast<cudaStream_t>(stream));            \
    }

SLU_SPMV(f32, float, false)
SLU_SPMV(f64, double, false)
SLU_SPMV(c64, float, true)
SLU_SPMV(c128, double, true)
