// The column loop of one panel of the blocked partial LU, for Hopper.
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
// Smith's ratio and scale depend on the divisor alone, so they are taken
// once per step (``Pivot``) and applied to each row: the same operations
// on the same values as taking them per row.
//
// Why no tensor cores.  Each element must see one individually rounded
// a - l*u per step, in step order.  A blocked or recursive update of
// several steps at once, wgmma, TF32 or an FMA would round differently,
// and a multiplication by 1/piv gives other bits than the division.  So
// the kernel gains only from where the data lives and how steps are
// synchronised.
//
// The steps run in chunks of kChunk, two launches a chunk (steps s0 ..
// s0+kc-1, pivot rows jc = j0+s0 .. jc+kc-1):
//
// Launch 1 (``pivot_chunk``), one block of kThreads1 per front, holds the
// chunk's kc pivot rows in registers: row r on warp r % kWarps1, lane l
// holding columns l, l+32, l+64, l+96.  Row j of step jj is published into
// shared memory (masked: zeros at c <= jj) with its Pivot, one slot and
// one mbarrier a step (the chunk's kc slots are all kept, so no slot is
// reused and no "empty" barrier is needed); the warp that owns row j+1
// updates that row first at step jj, publishes it for the next step and
// arrives on its barrier, then updates its other rows.  A warp waits only
// for the step it is about to run, never for the others to finish theirs:
// no block-wide barrier in the step loop.  Column jj of a row comes by
// __shfl_sync, and its write-back is selected into the lane that holds it
// (no divergent branch).  After arriving, the publisher writes the row,
// raw and piv to the global snapshot ``snap`` (batch, pa, pb+2); the
// step's tiny flag goes into shared memory and flags[b, j] += tiny
// follows the chunk (one writer each): no global access sits on the step
// chain.  At most kChunk * 128 values a front are live, which fits one
// block's registers in every type (complex128's 256 KB pivot block of a
// 128-step panel included), so no cluster or shared-memory spill of the
// pivot block is needed: the chunk's later pivot rows are updated by
// launch 2 across the card.  A smaller chunk moves more of the pivot
// block's work off the one SM.  Launch 1's shared memory is dynamic
// (complex128's 32 pivot rows take 64 KB); ``slu_panel_lu_init`` raises
// its limit once per device, before the device's first launch.
//
// Launch 2 (``replay_chunk``), every row outside the chunk's pivot rows
// (rows < jc too: the masked steps touch them, and the other chunks'
// pivot rows): one block per (front, tile of rows), a row on G lanes
// (``Lay``: 4 for a real type, 8 for a complex one), each lane holding
// 128/G of its columns in registers, so the row's per-step work — column
// jj fetched, the division, the write-back — is paid by G lanes, not 32.
// The chunk's snapshot is staged into shared memory (masked, with each
// step's Pivot; at most 32 KB a block, so the whole chunk but for
// complex128, which takes it in two), read with 16-byte loads; each value
// serves the 32/G rows of a warp, and the global snapshot is read once a
// block.  The snapshot is row j as it stood before step jj: later steps
// still change row j (-0.0 to +0.0, NaN), so the final pivot rows would
// give other bits.  Rows are independent once the snapshot exists; fixed
// order, no atomics: every run gives the same bits.
//
// Bound: operations and the step chain, not bytes.  Launch 1 runs kc
// dependent steps on one SM per front: a step waits for the warp that
// publishes the next pivot row, and that warp first finishes its own rows
// of the step before it, so a step costs about a warp's share of the SM's
// issue for kRows1 rows plus the publication (the wait on a barrier, the
// arrive and the shared-memory round trip are small beside it); the other
// SMs idle while batch is small.  Launch 2 issues every other row's steps
// across the card: 128/G multiply-subtracts and one division a lane a
// step.  The panel is read and written once a chunk; the snapshot written
// once and read once a block.
//
// C interface (ctypes): slu_panel_lu_init() once, then
// slu_panel_lu_<f32|f64|c64|c128>(a, thresh, flags, snap, batch, m, pb,
// sb, sr, j0, pa, fb, stream), each -> cudaError_t as int.
// a is the panel (unit column stride), thresh one value of the real
// component type, flags (batch, >= j0+pa) int32 with row stride fb, snap
// (batch, pa, pb+2) of a's type, contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPb = 128;     // the widest panel (ops/dense.py _PANEL_BLOCK)
constexpr int kSlots = kMaxPb / 32;        // launch 1: columns a lane
constexpr int kChunk = 32;      // steps a launch pair (kernels.PANEL_CHUNK)
constexpr int kWarps1 = 16;     // launch 1: warps a block
constexpr int kThreads1 = 32 * kWarps1;
constexpr int kRows1 = kChunk / kWarps1;   // pivot rows a warp
constexpr int kWarps2 = 4;      // launch 2: warps a block
constexpr int kThreads2 = 32 * kWarps2;
constexpr int kStageBytes = 32768;   // launch 2: staged snapshot a block
static_assert(kChunk % kWarps1 == 0, "");

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
  static constexpr int kLanes = 4;       // launch 2: lanes a row
  // a step's pivot: the raw and the fixed value (the divisor)
  struct Pivot {
    V raw, piv;
  };
  static __device__ __forceinline__ V zero() { return R(0); }
  // GESP's replacement; the phase is taken only for a tiny pivot (the
  // value it gives is used only then)
  static __device__ __forceinline__ int fix(V raw, R th, V& piv) {
    const R ap = abs_(raw);
    piv = raw;
    if (!(ap < th)) return 0;
    const V unit = ap == R(0) ? R(1) : div_rn(raw, ap);
    piv = mul_rn(unit, th);
    return 1;
  }
  static __device__ __forceinline__ Pivot pivot(V raw, V piv) {
    return Pivot{raw, piv};
  }
  // col / piv
  static __device__ __forceinline__ V quot(V a, const Pivot& p) {
    return div_rn(a, p.piv);
  }
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
  static constexpr int kLanes = 8;       // launch 2: lanes a row
  // Smith's quotient by piv: mode 0 |re| >= |im| (rat = im/re), mode 1
  // the other way (rat = re/im), mode 2 a zero divisor (a.x/|re|,
  // a.y/|im|); scl = 1/(larger part + smaller part * rat)
  struct Pivot {
    V raw, piv;
    R rat, scl;
    int mode;
  };
  static __device__ __forceinline__ V zero() { return V{R(0), R(0)}; }
  static __device__ __forceinline__ int fix(V raw, R th, V& piv) {
    const R ap = hypot_(raw.x, raw.y);
    piv = raw;
    if (!(ap < th)) return 0;
    const bool z = ap == R(0);
    const R ur = z ? R(1) : div_rn(raw.x, ap);
    const R ui = z ? R(0) : div_rn(raw.y, ap);
    piv = V{mul_rn(ur, th), mul_rn(ui, th)};
    return 1;
  }
  static __device__ __forceinline__ Pivot pivot(V raw, V c) {
    R acr = abs_(c.x), aci = abs_(c.y);
    if (acr >= aci) {
      if (acr == R(0) && aci == R(0)) return Pivot{raw, c, R(0), R(0), 2};
      R rat = div_rn(c.y, c.x);
      return Pivot{raw, c, rat, div_rn(R(1), add_rn(c.x, mul_rn(c.y, rat))),
                   0};
    }
    R rat = div_rn(c.x, c.y);
    return Pivot{raw, c, rat, div_rn(R(1), add_rn(c.y, mul_rn(c.x, rat))), 1};
  }
  static __device__ __forceinline__ V quot(V a, const Pivot& p) {
    if (p.mode == 0) {
      return V{mul_rn(add_rn(a.x, mul_rn(a.y, p.rat)), p.scl),
               mul_rn(sub_rn(a.y, mul_rn(a.x, p.rat)), p.scl)};
    }
    if (p.mode == 1) {
      return V{mul_rn(add_rn(mul_rn(a.x, p.rat), a.y), p.scl),
               mul_rn(sub_rn(mul_rn(a.y, p.rat), a.x), p.scl)};
    }
    return V{div_rn(a.x, R(0)), div_rn(a.y, R(0))};
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

// x[q] for a q known only at run time, without indexing registers
template <typename V>
__device__ __forceinline__ V pick(const V (&x)[kSlots], int q) {
  V r = x[0];
#pragma unroll
  for (int k = 1; k < kSlots; ++k) {
    if (q == k) r = x[k];
  }
  return r;
}

// Launch 1's step jj on one row held by a warp (lane l: columns l + 32k),
// from the step's masked pivot row u (zeros at c <= jj) and Pivot.  The
// multiply-subtract runs on every column, column jj then takes its
// write-back (the loop's order: panel -= l u, then column jj), selected
// into the lane that holds it without a branch.
template <typename Ops, typename R>
__device__ __forceinline__ void step_row(
    typename Ops::V (&x)[kSlots], const typename Ops::V (&u)[kSlots],
    const typename Ops::Pivot& pv, int jj, bool below, bool is_j,
    int lane) {
  using V = typename Ops::V;
  const int q = jj >> 5, jl = jj & 31;
  const V col = Ops::shfl(pick(x, q), jl);
  const V l = below ? Ops::quot(col, pv) : Ops::zero();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) x[k] = Ops::msub(x[k], l, u[k]);
  const V w = Ops::wb(below ? l : col, pv.piv, pv.raw, is_j ? R(1) : R(0));
  const bool mine = lane == jl;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) x[k] = (mine && k == q) ? w : x[k];
}

// Publish row x (a warp's) as the pivot row of step jn: the masked row,
// its Pivot and the step's tiny flag into shared memory (the Pivot and
// flag by lane 0; the flag is added to flags once the chunk is done, off
// the step chain).  Returns the Pivot (every lane holds it).
template <typename Ops, typename R>
__device__ __forceinline__ typename Ops::Pivot publish(
    const typename Ops::V (&x)[kSlots], int jn, int lane, int pb, R th,
    typename Ops::V* us, typename Ops::Pivot* ps, int* tiny_s) {
  using V = typename Ops::V;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = lane + 32 * k;
    if (c < pb) us[c] = c > jn ? x[k] : Ops::zero();
  }
  const V raw = Ops::shfl(pick(x, jn >> 5), jn & 31);
  // the divisor's Smith terms taken beside the tiny test (piv is raw
  // unless the pivot is tiny), not after it
  typename Ops::Pivot pr = Ops::pivot(raw, raw);
  V piv;
  const int tiny = Ops::fix(raw, th, piv);
  if (tiny) pr = Ops::pivot(raw, piv);
  if (lane == 0) {
    *ps = pr;
    *tiny_s = tiny;
  }
  return pr;
}

// The published row into the global snapshot row ``sn`` (launch 2 reads
// it), after the step's barrier is released: its stores stay off the
// chain.
template <typename Ops>
__device__ __forceinline__ void snapshot(
    const typename Ops::V (&x)[kSlots], const typename Ops::Pivot& pr,
    int lane, int pb, typename Ops::V* sn) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = lane + 32 * k;
    if (c < pb) sn[c] = x[k];
  }
  if (lane == 0) {
    sn[pb] = pr.raw;
    sn[pb + 1] = pr.piv;
  }
}

// mbarrier helpers (shared::cta)
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// launch 1's shared memory: a barrier, a Pivot, a tiny flag and a masked
// pivot row for each step of the chunk
template <typename Ops>
struct Smem1 {
  using V = typename Ops::V;
  using Pivot = typename Ops::Pivot;
  static constexpr int kBar = 0;
  static constexpr int kPiv = kBar + kChunk * 8;
  static constexpr int kTiny =
      kPiv + ((kChunk * static_cast<int>(sizeof(Pivot)) + 15) / 16) * 16;
  static constexpr int kRows = kTiny + kChunk * 4;
  static constexpr int kBytes =
      kRows + kChunk * kMaxPb * static_cast<int>(sizeof(V));
};

// Launch 1: the kc pivot rows of chunk s0 of front blockIdx.x, step by
// step, in registers; step t's pivot row waits on its own barrier.
template <typename Ops, typename R>
__global__ void __launch_bounds__(kThreads1)
pivot_chunk(typename Ops::V* __restrict__ a, const R* __restrict__ thresh,
            int32_t* __restrict__ flags, typename Ops::V* __restrict__ snap,
            int pb, int64_t sb, int64_t sr, int64_t j0, int pa, int64_t fb,
            int s0, int kc) {
  using V = typename Ops::V;
  using Pivot = typename Ops::Pivot;
  using S = Smem1<Ops>;
  extern __shared__ __align__(16) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::kBar);
  Pivot* ps = reinterpret_cast<Pivot*>(sm + S::kPiv);
  int* tiny_s = reinterpret_cast<int*>(sm + S::kTiny);
  V* us = reinterpret_cast<V*>(sm + S::kRows);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  V* f = a + b * sb + (j0 + s0) * sr;       // row 0 of the chunk
  V* sn = snap + b * static_cast<int64_t>(pa) * (pb + 2);
  const R th = *thresh;
  const V zero = Ops::zero();
  if (threadIdx.x < kc) {
    mbar_init(&full[threadIdx.x], 32);      // the publishing warp's lanes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  V x[kRows1][kSlots];
#pragma unroll
  for (int s = 0; s < kRows1; ++s) {
    const int r = w + s * kWarps1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      x[s][k] = (r < kc && c < pb) ? f[r * sr + c] : zero;
    }
  }
  __syncthreads();                // the barriers are initialised
  if (w == 0) {
    const Pivot pr = publish<Ops, R>(x[0], s0, lane, pb, th, us, &ps[0],
                                     &tiny_s[0]);
    mbar_arrive(&full[0]);
    snapshot<Ops>(x[0], pr, lane, pb, sn + static_cast<int64_t>(s0) * (pb + 2));
  }
  for (int t = 0; t < kc; ++t) {
    const int jj = s0 + t;
    mbar_wait(&full[t], 0);
    V u[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      u[k] = c < pb ? us[t * kMaxPb + c] : zero;
    }
    const Pivot pv = ps[t];
    // row t+1 first: its warp updates it and publishes it for step jj+1
    const int tn = t + 1, nslot = tn / kWarps1;
    const bool pub = tn < kc && w == tn % kWarps1;
    if (pub) {
#pragma unroll
      for (int s = 0; s < kRows1; ++s) {
        if (s == nslot) {
          step_row<Ops, R>(x[s], u, pv, jj, true, false, lane);
          const Pivot pr = publish<Ops, R>(x[s], jj + 1, lane, pb, th,
                                           us + tn * kMaxPb, &ps[tn],
                                           &tiny_s[tn]);
          mbar_arrive(&full[tn]);
          snapshot<Ops>(x[s], pr, lane, pb,
                        sn + static_cast<int64_t>(jj + 1) * (pb + 2));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kRows1; ++s) {
      const int r = w + s * kWarps1;
      if (r < kc && !(pub && s == nslot)) {
        step_row<Ops, R>(x[s], u, pv, jj, r > t, r == t, lane);
      }
    }
  }
  __syncthreads();                // every tiny flag is in
#pragma unroll
  for (int s = 0; s < kRows1; ++s) {
    const int r = w + s * kWarps1;
    if (r < kc) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int c = lane + 32 * k;
        if (c < pb) f[r * sr + c] = x[s][k];
      }
    }
  }
  for (int t = threadIdx.x; t < kc; t += kThreads1) {
    flags[b * fb + j0 + s0 + t] += tiny_s[t];
  }
}

// Launch 2's layout of a row over G = Ops::kLanes lanes: E = 16 bytes of
// values side by side, so lane g holds columns E*G*k + E*g + e (k < NK,
// e < E) in slot E*k + e, and reads its part of a staged pivot row with
// NK 16-byte loads from shared memory (G lanes, G neighbouring 16-byte
// words: no bank conflict).
template <typename Ops>
struct Lay {
  using V = typename Ops::V;
  static constexpr int G = Ops::kLanes;
  static constexpr int E = 16 / static_cast<int>(sizeof(V));
  static constexpr int NC = kMaxPb / G;   // columns a lane
  static constexpr int NK = NC / E;
  static constexpr int EG = E * G;        // columns of one k
  static constexpr int RPW = 32 / G;      // rows a warp
  static constexpr int Tile = kWarps2 * RPW;
  // snapshot steps staged at a time: the whole chunk where it fits
  static constexpr int Stage =
      kChunk * kMaxPb * static_cast<int>(sizeof(V)) <= kStageBytes
          ? kChunk : kStageBytes / (kMaxPb * static_cast<int>(sizeof(V)));
  static_assert(Stage % EG == 0 && kChunk % Stage == 0, "");
  static __device__ __forceinline__ int col(int k, int g, int e) {
    return EG * k + E * g + e;
  }
};

// x[E*k + e] for k in [Lo, Lo+N), k known only at run time: a tree of
// selects on k's bits (N a power of two), log2(N) deep, every index fixed
// at compile time
template <typename L, int Lo, int N, typename V>
__device__ __forceinline__ V pick_k(const V (&x)[L::NC], int k, int e) {
  static_assert((N & (N - 1)) == 0, "");
  if constexpr (N == 1) {
    return x[L::E * Lo + e];
  } else {
    const V lo = pick_k<L, Lo, N / 2>(x, k, e);
    const V hi = pick_k<L, Lo + N / 2, N / 2>(x, k, e);
    return (k & (N / 2)) ? hi : lo;
  }
}

// E values from a 16-byte aligned word in shared memory
template <typename V, int E>
__device__ __forceinline__ void lds16(const V* p, V (&o)[E]) {
  union W {
    float4 f;
    V v[E];
  };
  W w;
  w.f = *reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = w.v[e];
}

// Launch 2: the kc steps of chunk s0 on every row outside its pivot rows,
// a row on G lanes (``Lay``) in registers, the snapshot staged through
// shared memory Stage steps at a time.  Each step: column jj from the
// lane that holds it (a select over k, known only at run time, with e and
// that lane fixed by unrolling the steps of one k), one division a row on
// each of its G lanes, NC multiply-subtracts a lane, the write-back
// selected into the holding lane.
template <typename Ops, typename R>
__global__ void __launch_bounds__(kThreads2)
replay_chunk(typename Ops::V* __restrict__ a,
             const typename Ops::V* __restrict__ snap, int64_t nro,
             int64_t ntiles, int pb, int64_t sb, int64_t sr, int64_t j0,
             int pa, int s0, int kc) {
  using V = typename Ops::V;
  using Pivot = typename Ops::Pivot;
  using L = Lay<Ops>;
  __shared__ __align__(16) V us[L::Stage][kMaxPb];
  __shared__ Pivot ps[L::Stage];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane % L::G, base = lane - g;
  const int64_t b = blockIdx.x / ntiles;
  const int64_t tile = blockIdx.x - b * ntiles;
  const int64_t jc = j0 + s0;
  const V* sn = snap + b * static_cast<int64_t>(pa) * (pb + 2);
  const V zero = Ops::zero();
  const int64_t r = tile * L::Tile + w * L::RPW + lane / L::G;
  const int64_t i = r < nro ? (r < jc ? r : r + kc) : -1;  // front row
  V* row = a + b * sb + (i >= 0 ? i : 0) * sr;
  V x[L::NC];
#pragma unroll
  for (int k = 0; k < L::NK; ++k) {
#pragma unroll
    for (int e = 0; e < L::E; ++e) {
      const int c = L::col(k, g, e);
      x[L::E * k + e] = (i >= 0 && c < pb) ? row[c] : zero;
    }
  }
  for (int t0 = 0; t0 < kc; t0 += L::Stage) {
    const int ns = min(L::Stage, kc - t0);
    const int jb = s0 + t0;       // a multiple of Stage, so of EG
    __syncthreads();              // the last stage's readers are done
    for (int e = threadIdx.x; e < ns * kMaxPb; e += kThreads2) {
      const int t = e / kMaxPb, c = e - t * kMaxPb;
      const int jj = jb + t;
      us[t][c] = (c < pb && c > jj)
                     ? sn[static_cast<int64_t>(jj) * (pb + 2) + c] : zero;
    }
    for (int t = threadIdx.x; t < ns; t += kThreads2) {
      const V* s = sn + static_cast<int64_t>(jb + t) * (pb + 2);
      ps[t] = Ops::pivot(s[pb], s[pb + 1]);
    }
    __syncthreads();
    for (int j0k = jb; j0k < jb + ns; j0k += L::EG) {
      const int k = j0k / L::EG;  // column jj's k, the same for EG steps
#pragma unroll
      for (int ti = 0; ti < L::EG; ++ti) {
        const int jj = j0k + ti;
        if (jj >= jb + ns) break;
        const int e = ti % L::E, gh = ti / L::E;   // its e and its lane
        const Pivot pv = ps[jj - jb];
        const V col = Ops::shfl(pick_k<L, 0, L::NK>(x, k, e), base + gh);
        const bool below = i > j0 + jj;
        const V l = below ? Ops::quot(col, pv) : zero;
        const V* urow = &us[jj - jb][0];
#pragma unroll
        for (int kk = 0; kk < L::NK; ++kk) {
          V u[L::E];
          lds16<V, L::E>(urow + L::col(kk, g, 0), u);
#pragma unroll
          for (int e2 = 0; e2 < L::E; ++e2) {
            x[L::E * kk + e2] = Ops::msub(x[L::E * kk + e2], l, u[e2]);
          }
        }
        const V wv = Ops::wb(below ? l : col, pv.piv, pv.raw, R(0));
        const int to = g == gh ? k : -1;      // the k this lane writes
#pragma unroll
        for (int kk = 0; kk < L::NK; ++kk) {
          x[L::E * kk + e] = kk == to ? wv : x[L::E * kk + e];
        }
      }
    }
  }
  if (i >= 0) {
#pragma unroll
    for (int k = 0; k < L::NK; ++k) {
#pragma unroll
      for (int e = 0; e < L::E; ++e) {
        const int c = L::col(k, g, e);
        if (c < pb) row[c] = x[L::E * k + e];
      }
    }
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
  for (int64_t s0 = 0; s0 < pa; s0 += kChunk) {
    const int kc = static_cast<int>(pa - s0 < kChunk ? pa - s0 : kChunk);
    pivot_chunk<Ops, R><<<static_cast<unsigned>(batch), kThreads1,
                          Smem1<Ops>::kBytes, stream>>>(
        av, static_cast<const R*>(thresh), static_cast<int32_t*>(flags), sv,
        static_cast<int>(pb), sb, sr, j0, static_cast<int>(pa), fb,
        static_cast<int>(s0), kc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t nro = m - kc;
    if (nro == 0) continue;
    const int64_t ntiles = (nro + Lay<Ops>::Tile - 1) / Lay<Ops>::Tile;
    if (ntiles > 0x7fffffffLL / batch) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    replay_chunk<Ops, R><<<static_cast<unsigned>(batch * ntiles), kThreads2,
                           0, stream>>>(
        av, sv, nro, ntiles, static_cast<int>(pb), sb, sr, j0,
        static_cast<int>(pa), static_cast<int>(s0), kc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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

// Once per device, before its first launch: launch 1's dynamic shared
// memory above the default 48 KB (complex128's chunk of pivot rows).
extern "C" int slu_panel_lu_init() {
  cudaError_t e = cudaSuccess;
#define SLU_PANEL_SMEM(OPS, R)                                               \
  if (e == cudaSuccess) {                                                   \
    e = cudaFuncSetAttribute(pivot_chunk<OPS, R>,                           \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             Smem1<OPS>::kBytes);                           \
  }
  SLU_PANEL_SMEM(RealOps<float>, float)
  SLU_PANEL_SMEM(RealOps<double>, double)
  SLU_PANEL_SMEM(ComplexOps<float>, float)
  SLU_PANEL_SMEM(ComplexOps<double>, double)
#undef SLU_PANEL_SMEM
  return static_cast<int>(e);
}
