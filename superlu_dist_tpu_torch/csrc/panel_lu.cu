// The column loop of one panel of the blocked partial LU, in two launches.
//
// Replaces the column step of the JAX package's blocked partial
// factorization, superlu_dist_tpu/ops/dense.py:_blocked_partial_factor
// (its ``inner`` fori_loop body, :299-323), which the TPU runs inside the
// compiled program of every group step.  It is no Pallas kernel there; the
// port's plain PyTorch version (numeric/kernels.py ``panel_lu_plain``) is
// the loop of ~44 small launches per column that PyTorch issues one at a
// time.  This kernel computes that loop's function bit for bit.
//
// A panel is ``batch`` fronts of m rows by pb <= 128 columns (element
// (b, i, c) at b*sb + i*sr + c).  For each active pivot jj = 0 .. pa-1 in
// order, with j = j0 + jj the front row of that pivot, col = column jj and
// urow = row j as they stand before the step:
//     piv_raw = urow[jj];  (piv, tiny) = fix(piv_raw, thresh)
//     l_i = i > j ? col_i / piv : +0          every row i
//     u_c = c > jj ? urow_c : +0              every column c
//     a[i, c] = a[i, c] - l_i * u_c           every row, every column
//     a[i, jj] = (i > j ? l_i : col_i) + (piv - piv_raw) * (i == j ? 1 : 0)
//     flags[j] += tiny
// fix is GESP's tiny-pivot replacement (pdgstrf2.c:218-232): |piv_raw| <
// thresh gives phase(piv_raw) * thresh (a zero pivot: +thresh).  The
// masked terms are computed, not skipped: a - 0*u turns -0.0 into +0.0
// where u < 0, and 0*u is NaN where u is infinite, exactly as the plain
// loop's full-width products do.  Every operation rounds on its own
// (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn and the __d*_rn forms): no
// FMA contraction, as each eager PyTorch op rounds on its own.
//
// Complex values are spelled out by parts, in the plain version and here
// alike, in this order:
//     |z| = hypot(re, im);  phase(z) = (re / |z|, im / |z|)
//     phase * thresh = (re * thresh, im * thresh)
//     a / c: Smith's method as c10::complex and numpy divide
//     l * u = (lr*ur - li*ui, lr*ui + li*ur), then a - l*u by parts
//     (piv - piv_raw) * e by parts, e real
//
// Launch 1, the pivot block: one block per front runs the pa steps on the
// pa pivot rows (all pb columns) in global memory, three __syncthreads()
// a step, and writes a snapshot of each step to ``snap`` (batch, pa,
// pb + 2): row j's pb values as they stand at the step, then piv_raw and
// piv.  Later steps change row j again, so the rows of launch 2 must read
// it as it was at step jj.  Launch 2, every other row (rows < j0 too: the
// masked steps touch them): one warp per (front, row) holds the row in
// registers (lane l: columns l, l+32, l+64, l+96), replays the pa steps
// from the snapshot, and stores the row once.  Rows are independent once
// the snapshot exists; fixed order, no atomics, so every run gives the
// same bits.
//
// Bound: the pivot rows' dependency chain (pa steps of launch 1, each
// waiting on the last) at small batch; otherwise bytes — the panel read
// and written once, the snapshot written once and read per front (the
// 2*(rows below j)*(pb-jj-1) flops of a step are far below the card's
// rate).  A simple kernel that is right first; the pivot block in shared
// memory and several rows a warp are later work.
//
// C interface (ctypes): slu_panel_lu_<f32|f64|c64|c128>(a, thresh, flags,
// snap, batch, m, pb, sb, sr, j0, pa, fb, stream) -> cudaError_t as int.
// a is the panel (unit column stride), thresh one value of the real
// component type, flags (batch, >= j0+pa) int32 with row stride fb, snap
// (batch, pa, pb+2) of a's type, contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPb = 128;     // the widest panel (ops/dense.py _PANEL_BLOCK)
constexpr int kSlots = kMaxPb / 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ float hypot_(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ double hypot_(double a, double b) { return hypot(a, b); }

// A complex number of R components, laid out as torch stores one.
template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R x, y;
};

// The step's arithmetic on a real type R (V = R) ...
template <typename R>
struct RealOps {
  using V = R;
  static __device__ __forceinline__ V zero() { return R(0); }
  static __device__ __forceinline__ int fix(V raw, R th, V& piv) {
    R ap = abs_(raw);
    bool z = ap == R(0);
    V unit = z ? R(1) : div_rn(raw, ap);
    bool tiny = ap < th;
    piv = tiny ? mul_rn(unit, th) : raw;
    return tiny ? 1 : 0;
  }
  static __device__ __forceinline__ V div(V a, V c) { return div_rn(a, c); }
  // a - l*u
  static __device__ __forceinline__ V msub(V a, V l, V u) {
    return sub_rn(a, mul_rn(l, u));
  }
  // x + (piv - raw)*e
  static __device__ __forceinline__ V wb(V x, V piv, V raw, R e) {
    return add_rn(x, mul_rn(sub_rn(piv, raw), e));
  }
  static __device__ __forceinline__ V shfl(V v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
};

// ... and on a complex one (V = Cx<R>), by parts
template <typename R>
struct ComplexOps {
  using V = Cx<R>;
  static __device__ __forceinline__ V zero() { return V{R(0), R(0)}; }
  static __device__ __forceinline__ int fix(V raw, R th, V& piv) {
    R ap = hypot_(raw.x, raw.y);
    bool z = ap == R(0);
    R ur = z ? R(1) : div_rn(raw.x, ap);
    R ui = z ? R(0) : div_rn(raw.y, ap);
    bool tiny = ap < th;
    piv = tiny ? V{mul_rn(ur, th), mul_rn(ui, th)} : raw;
    return tiny ? 1 : 0;
  }
  static __device__ __forceinline__ V div(V a, V c) {
    R acr = abs_(c.x), aci = abs_(c.y);
    if (acr >= aci) {
      if (acr == R(0) && aci == R(0)) {
        return V{div_rn(a.x, acr), div_rn(a.y, aci)};
      }
      R rat = div_rn(c.y, c.x);
      R scl = div_rn(R(1), add_rn(c.x, mul_rn(c.y, rat)));
      return V{mul_rn(add_rn(a.x, mul_rn(a.y, rat)), scl),
               mul_rn(sub_rn(a.y, mul_rn(a.x, rat)), scl)};
    }
    R rat = div_rn(c.x, c.y);
    R scl = div_rn(R(1), add_rn(c.y, mul_rn(c.x, rat)));
    return V{mul_rn(add_rn(mul_rn(a.x, rat), a.y), scl),
             mul_rn(sub_rn(mul_rn(a.y, rat), a.x), scl)};
  }
  static __device__ __forceinline__ V msub(V a, V l, V u) {
    R pr = sub_rn(mul_rn(l.x, u.x), mul_rn(l.y, u.y));
    R pi = add_rn(mul_rn(l.x, u.y), mul_rn(l.y, u.x));
    return V{sub_rn(a.x, pr), sub_rn(a.y, pi)};
  }
  static __device__ __forceinline__ V wb(V x, V piv, V raw, R e) {
    return V{add_rn(x.x, mul_rn(sub_rn(piv.x, raw.x), e)),
             add_rn(x.y, mul_rn(sub_rn(piv.y, raw.y), e))};
  }
  static __device__ __forceinline__ V shfl(V v, int src) {
    return V{__shfl_sync(0xffffffffu, v.x, src),
             __shfl_sync(0xffffffffu, v.y, src)};
  }
};

// Launch 1: the pa pivot rows of front blockIdx.x, step by step.
template <typename Ops, typename R>
__global__ void __launch_bounds__(kThreads)
pivot_rows(typename Ops::V* __restrict__ a, const R* __restrict__ thresh,
           int32_t* __restrict__ flags, typename Ops::V* __restrict__ snap,
           int pb, int64_t sb, int64_t sr, int64_t j0, int pa, int64_t fb) {
  using V = typename Ops::V;
  __shared__ V u_s[kMaxPb];       // row j at the step
  __shared__ V col_s[kMaxPb];     // column jj of the pivot rows at the step
  __shared__ V l_s[kMaxPb];       // their multipliers
  const int64_t b = blockIdx.x;
  V* f = a + b * sb;
  V* sn = snap + b * static_cast<int64_t>(pa) * (pb + 2);
  const R th = *thresh;
  const V zero = Ops::zero();
  for (int jj = 0; jj < pa; ++jj) {
    const int64_t j = j0 + jj;
    V* s = sn + static_cast<int64_t>(jj) * (pb + 2);
    for (int t = threadIdx.x; t < pb; t += blockDim.x) {
      V v = f[j * sr + t];
      u_s[t] = v;
      s[t] = v;
    }
    for (int t = threadIdx.x; t < pa; t += blockDim.x) {
      col_s[t] = f[(j0 + t) * sr + jj];
    }
    __syncthreads();
    // every thread fixes the pivot (the same bits in each)
    const V raw = u_s[jj];
    V piv;
    const int tiny = Ops::fix(raw, th, piv);
    if (threadIdx.x == 0) {
      s[pb] = raw;
      s[pb + 1] = piv;
      flags[b * fb + j] += tiny;
    }
    for (int t = threadIdx.x; t < pa; t += blockDim.x) {
      l_s[t] = (j0 + t > j) ? Ops::div(col_s[t], piv) : zero;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < pa * pb; e += blockDim.x) {
      const int r = e / pb, c = e - r * pb;
      const int64_t i = j0 + r;
      V* p = f + i * sr + c;
      if (c == jj) {
        *p = Ops::wb(i > j ? l_s[r] : col_s[r], piv, raw,
                     i == j ? R(1) : R(0));
      } else {
        *p = Ops::msub(*p, l_s[r], c > jj ? u_s[c] : zero);
      }
    }
    __syncthreads();
  }
}

// Launch 2: one warp per (front, row outside the pivot rows), the row in
// registers, the pa steps replayed from the snapshot.
template <typename Ops, typename R>
__global__ void __launch_bounds__(kThreads)
other_rows(typename Ops::V* __restrict__ a,
           const typename Ops::V* __restrict__ snap, int64_t nro, int64_t n,
           int pb, int64_t sb, int64_t sr, int64_t j0, int pa) {
  using V = typename Ops::V;
  const int lane = threadIdx.x & 31;
  const int64_t g =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= n) return;             // the whole warp: g is the warp's
  const int64_t b = g / nro, r = g - b * nro;
  const int64_t i = r < j0 ? r : r + pa;
  V* row = a + b * sb + i * sr;
  const V* sn = snap + b * static_cast<int64_t>(pa) * (pb + 2);
  const V zero = Ops::zero();
  V v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < pb ? row[c] : zero;
  }
  for (int jj = 0; jj < pa; ++jj) {
    const int64_t j = j0 + jj;
    const V* s = sn + static_cast<int64_t>(jj) * (pb + 2);
    const V raw = s[pb], piv = s[pb + 1];
    // column jj of this row: lane jj % 32 holds it in slot jj / 32
    const int q = jj >> 5;
    V mine = v[0];
#pragma unroll
    for (int k = 1; k < kSlots; ++k) {
      if (q == k) mine = v[k];
    }
    const V col = Ops::shfl(mine, jj & 31);
    const bool below = i > j;
    const V l = below ? Ops::div(col, piv) : zero;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      if (c < pb) {
        if (c == jj) {
          v[k] = Ops::wb(below ? l : col, piv, raw, R(0));
        } else {
          v[k] = Ops::msub(v[k], l, c > jj ? s[c] : zero);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = lane + 32 * k;
    if (c < pb) row[c] = v[k];
  }
}

template <typename Ops, typename R>
int launch(void* a, const void* thresh, void* flags, void* snap,
           int64_t batch, int64_t m, int64_t pb, int64_t sb, int64_t sr,
           int64_t j0, int64_t pa, int64_t fb, cudaStream_t stream) {
  using V = typename Ops::V;
  if (pb < 1 || pb > kMaxPb || pa < 1 || pa > pb || j0 < 0 ||
      j0 + pa > m || batch < 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  auto av = static_cast<V*>(a);
  auto sv = static_cast<V*>(snap);
  pivot_rows<Ops, R><<<static_cast<unsigned>(batch), kThreads, 0, stream>>>(
      av, static_cast<const R*>(thresh), static_cast<int32_t*>(flags), sv,
      static_cast<int>(pb), sb, sr, j0, static_cast<int>(pa), fb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t nro = m - pa;
  if (nro == 0) return 0;
  const int64_t n = batch * nro;            // warps
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  other_rows<Ops, R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      av, sv, nro, n, static_cast<int>(pb), sb, sr, j0,
      static_cast<int>(pa));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SLU_PANEL_LU(sfx, OPS, R)                                            \
  extern "C" int slu_panel_lu_##sfx(void* a, const void* thresh,            \
                                    void* flags, void* snap, int64_t batch, \
                                    int64_t m, int64_t pb, int64_t sb,      \
                                    int64_t sr, int64_t j0, int64_t pa,     \
                                    int64_t fb, void* stream) {             \
    return launch<OPS, R>(a, thresh, flags, snap, batch, m, pb, sb, sr, j0, \
                          pa, fb, static_cast<cudaStream_t>(stream));       \
  }

SLU_PANEL_LU(f32, RealOps<float>, float)
SLU_PANEL_LU(f64, RealOps<double>, double)
SLU_PANEL_LU(c64, ComplexOps<float>, float)
SLU_PANEL_LU(c128, ComplexOps<double>, double)

#undef SLU_PANEL_LU
