// Front assembly of one dispatch group in one launch.
//
// Replaces both TPU kernels of superlu_dist_tpu/numeric/pallas_kernels.py:
//   assemble_avals_pallas (_assemble_kernel)  — the A-entry assembly;
//   extend_add_set_pallas (_extend_add_kernel) — the extend-add of one
//                                                child set;
// together with the zero fill and the identity padding that
// superlu_dist_tpu/numeric/factor.py:group_step runs around them.  A front
// is m rows by mc columns: the whole m x m front (mc = m), or the column
// share of one rank of the mesh tier's 2-D grid (parallel/mesh_stream.py),
// whose local column c is global column ((c / pb) * np + p) * pb + c % pb
// (panels of pb columns dealt block-cyclically over np process columns,
// this rank's column p; np = 1 and p = 0 for a whole front).  For every
// position of every front of the batch, in this order:
//   1. start from +0.0 (build mode) or from f's value (accumulate mode);
//   2. build mode: add 1.0 on the diagonal (row == global column) in
//      columns [ws[slot], w);
//   3. add avals[src] of the A entry that targets the position (targets
//      are unique; a src outside [0, n_avals) adds +0.0);
//   4. add pool[off + i*stride + k] of every child pair (row i, column k)
//      that targets it, in the maps' child order — set order, then child
//      order — with a read past pool_len adding 0.  For a whole front
//      stride = ub and k = j; a column share reads either the whole pool
//      (stride ub) or its own compacted pool (stride = the child's own
//      column count).
// x + 0.0 turns -0.0 into +0.0, so no add is skipped.
//
// Maps, built once per plan on the host (numeric/kernels.py
// build_front_maps), with every sentinel already dropped:
//   a_bkt  (batch, nb+1) int64: per slot, the first A entry whose flat
//          target (row * mc + column) is >= b*kBucket*mc
//          (nb = ceil(m / kBucket));
//   a_ent  (na, 2) int64: (flat target, src), sorted by slot, then flat;
//   ch_ptr (batch+1) int64: each slot's run of child records;
//   ch_rec (nch, 6) int64: (pool offset, pool row stride, first row rel
//          entry, first row bucket entry, first column rel entry, first
//          column bucket entry), in the child order above;
//   rel    (npos, 2) int32: a child's real (front row, child row) pairs,
//          sorted by row, and its (local column, child column) pairs,
//          sorted by column (a whole front's child shares one list);
//   ch_bkt int32: per child, nb+1 row buckets (the first row entry whose
//          row is >= b*kBucket, relative to the child's first entry) and
//          nbc+1 column buckets (nbc = ceil(mc / kBucket)).
//
// Bound: bytes.  One write of every front element, one read of every pool
// value and A value used and of every map entry, one add per pair.
//
// Types: float, double, and complex64 / complex128 as Cx<float> /
// Cx<double>, whose add is two real adds, one per component (as torch's and
// XLA's complex add), so the kernel equals the plain version bit for bit in
// every type.
//
// Design (the Hopper counterpart of the TPU kernel's VMEM-resident front
// block): one block per (slot, tile of kRows x kCols front positions).
// The tile lives in dynamic shared memory (64 KB in every type, so three
// blocks share an SM, and kBucket divides both of its sides); every add
// lands there, and the tile is written to f once, with 16-byte stores
// where m allows.  One block owns each position, so there
// are no atomics.  A block visits only its own slot's children; the bucket
// tables give the rows and the columns of a child that fall in the tile
// with four loads and no search, read for a whole chunk of children at
// once, and a child that misses the tile costs no barrier.  For a child
// that hits, the tile's row and column slices of its rel entries are
// staged in shared memory (double-buffered, so one __syncthreads() per
// child keeps the per-position order; the next hitting child's slices are
// loaded while this one adds), then the block adds the nr x nc pairs flat
// over its threads, kWide (kNarrow for a small child) pool loads in
// flight per thread:
// neighbouring threads read neighbouring pool values of one child row
// (coalesced) and add into neighbouring tile columns.  Positions of one
// child are distinct, so one child never adds twice to a position.

#include <cstdint>
#include <cuda_runtime.h>

// A complex number of R components (complex64: R = float, complex128:
// R = double), laid out as torch stores one: real part, then imaginary.
template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R x, y;
  Cx() = default;
  __host__ __device__ constexpr Cx(R re) : x(re), y(R(0)) {}
  __host__ __device__ constexpr Cx(R re, R im) : x(re), y(im) {}
};
template <typename R>
__device__ __forceinline__ Cx<R> operator+(Cx<R> a, Cx<R> b) {
  return Cx<R>(a.x + b.x, a.y + b.y);
}

namespace {

constexpr int kThreads = 256;
constexpr int kBucket = 64;       // divides the tile's rows and columns
constexpr int kWide = 8;          // pool loads in flight per thread for
constexpr int kNarrow = 4;        // a large child / a small one
constexpr int kChunk = 128;       // child records staged at a time

// The tile (kRows x kCols, 64 KB) and the widest store (kVec elements,
// 16 bytes) of each type.
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int kRows = 128, kCols = 128, kVec = 4;
};
template <>
struct Shape<double> {
  static constexpr int kRows = 64, kCols = 128, kVec = 2;
};
template <>
struct Shape<Cx<float>> {
  static constexpr int kRows = 64, kCols = 128, kVec = 2;
};
template <>
struct Shape<Cx<double>> {
  static constexpr int kRows = 64, kCols = 64, kVec = 1;
};

template <typename T>
constexpr bool shape_ok() {
  return Shape<T>::kRows * Shape<T>::kCols * sizeof(T) == 64 * 1024 &&
         Shape<T>::kRows % kBucket == 0 && Shape<T>::kCols % kBucket == 0 &&
         Shape<T>::kRows <= kThreads && Shape<T>::kCols <= kThreads &&
         Shape<T>::kVec * sizeof(T) == 16;
}
// a thread stages at most one entry of a tile's row or column slice
static_assert(shape_ok<float>() && shape_ok<double>() &&
                  shape_ok<Cx<float>>() && shape_ok<Cx<double>>(),
              "tile shapes");

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Visits q = threadIdx.x, +blockDim.x, ... < rows*cols as (r, c) without a
// division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int cols_) : cols(cols_) {
    r = threadIdx.x / cols;
    c = threadIdx.x - r * cols;
    dr = blockDim.x / cols;
    dc = blockDim.x - dr * cols;
  }
  __device__ void step() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Copies the tile between shared memory and f (rows of th, tw elements).
template <typename T, int V>
__device__ void copy_tile(T* tile, T* g, int64_t m, int th, int tw,
                          bool to_global) {
  const int vw = tw / V;
  for (Walk p(vw); p.r < th; p.step()) {
    Pack<T, V>* gp = reinterpret_cast<Pack<T, V>*>(g + p.r * m) + p.c;
    Pack<T, V>* sp = reinterpret_cast<Pack<T, V>*>(tile + p.r * tw) + p.c;
    if (to_global) {
      *gp = *sp;
    } else {
      *sp = *gp;
    }
  }
}

// The first child in [j, n) of the staged chunk that hits the tile.
__device__ __forceinline__ int next_hit(const int4* rng, int j, int n) {
  while (j < n && (rng[j].x == rng[j].y || rng[j].z == rng[j].w)) ++j;
  return j;
}

// This thread's entry of a child's row slice and of its column slice
// (each slice is at most one tile side, so at most one entry a thread).
__device__ __forceinline__ void slice_entries(const int2* row_ent,
                                              const int2* col_ent, int4 rg,
                                              int2* row_e, int2* col_e) {
  if (static_cast<int>(threadIdx.x) < rg.y - rg.x) {
    *row_e = row_ent[rg.x + threadIdx.x];
  }
  if (static_cast<int>(threadIdx.x) < rg.w - rg.z) {
    *col_e = col_ent[rg.z + threadIdx.x];
  }
}

// The global column of local column c of a column share.
__device__ __forceinline__ int64_t global_col(int64_t c, int64_t pb,
                                              int64_t np, int64_t p) {
  if (np == 1) return c;
  const int64_t b = c / pb;
  return (b * np + p) * pb + (c - b * pb);
}

// Adds one child's staged nr x nc pairs into the tile, flat over the
// block, U pool loads in flight per thread; a child index at or past lim
// (the pool's end) reads 0.  ub is the pool row stride.
template <typename T, int U>
__device__ __forceinline__ void add_pairs(T* tile, const int2* rs,
                                          const int2* cs, const T* src,
                                          int64_t lim, int64_t ub, int nr,
                                          int nc, int r0, int c0, int tw) {
  for (Walk p(nc); p.r < nr;) {
    int tgt[U];
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      tgt[u] = -1;
      v[u] = T(0);
      if (p.r < nr) {
        const int2 ri = rs[p.r], ci = cs[p.c];
        const int64_t idx = static_cast<int64_t>(ri.y) * ub + ci.y;
        v[u] = idx < lim ? src[idx] : T(0);
        tgt[u] = (ri.x - r0) * tw + (ci.x - c0);
      }
      p.step();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (tgt[u] >= 0) tile[tgt[u]] = tile[tgt[u]] + v[u];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
front_assemble_kernel(T* __restrict__ f, const T* __restrict__ pool,
                      const T* __restrict__ avals,
                      const int64_t* __restrict__ ws,
                      const int64_t* __restrict__ a_bkt,
                      const int64_t* __restrict__ a_ent,
                      const int64_t* __restrict__ ch_ptr,
                      const int64_t* __restrict__ ch_rec,
                      const int2* __restrict__ rel,
                      const int* __restrict__ ch_bkt, int64_t m, int64_t mc,
                      int64_t w, int64_t pool_len, int64_t n_avals,
                      int64_t col_pb, int64_t col_np, int64_t col_p,
                      int64_t tiles_c, int64_t n_tiles, int accumulate) {
  constexpr int kRows = Shape<T>::kRows;
  constexpr int kTileCols = Shape<T>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ int2 rows_s[2][kRows];
  __shared__ int2 cols_s[2][kTileCols];
  __shared__ int64_t k_off[kChunk];
  __shared__ int64_t k_rel[kChunk];
  __shared__ int64_t k_relc[kChunk];
  __shared__ int k_ub[kChunk];
  __shared__ int4 k_rng[kChunk];

  const int64_t s = blockIdx.x / n_tiles;
  const int64_t t = blockIdx.x - s * n_tiles;
  const int64_t r0 = (t / tiles_c) * kRows;
  const int64_t c0 = (t % tiles_c) * kTileCols;
  const int th = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
  const int tw = static_cast<int>(mc - c0 < kTileCols ? mc - c0 : kTileCols);
  const int64_t nb = (m + kBucket - 1) / kBucket;
  const int64_t b_lo = r0 / kBucket;                  // the tile's row
  const int64_t b_hi = (r0 + th + kBucket - 1) / kBucket;  // bucket range
  const int64_t bc_lo = c0 / kBucket;
  const int64_t bc_hi = (c0 + tw + kBucket - 1) / kBucket;
  T* g = f + (s * m + r0) * mc + c0;

  bool ready = !accumulate;
  if (!accumulate) {
    // steps 1-2: +0.0, and 1.0 on the identity-padding diagonal
    const int64_t lo = ws[s];
    const int vw = tw / V;
    for (Walk p(vw); p.r < th; p.step()) {
      Pack<T, V> z;
      const int64_t gr = r0 + p.r;
      const int64_t lc = c0 + static_cast<int64_t>(p.c) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t gc = global_col(lc + k, col_pb, col_np, col_p);
        z.v[k] = (gr == gc && gr >= lo && gr < w) ? T(1) : T(0);
      }
      reinterpret_cast<Pack<T, V>*>(tile + p.r * tw)[p.c] = z;
    }
    __syncthreads();
  }

  // step 3: the A entries in the tile's rows (one per target position)
  const int64_t e0 = a_bkt[s * (nb + 1) + b_lo];
  const int64_t e1 = a_bkt[s * (nb + 1) + b_hi];
  if (e0 < e1) {
    if (!ready) {
      copy_tile<T, V>(tile, g, mc, th, tw, false);
      ready = true;
      __syncthreads();
    }
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      const int64_t flat = a_ent[2 * e];
      const int64_t r = flat / mc;
      const int64_t c = flat - r * mc;
      if (c >= c0 && c < c0 + tw) {
        const int64_t src = a_ent[2 * e + 1];
        const T v = (src >= 0 && src < n_avals) ? avals[src] : T(0);
        T* p = tile + (r - r0) * tw + (c - c0);
        *p = *p + v;
      }
    }
    __syncthreads();
  }

  // step 4: this slot's children, in order.  For up to kChunk children at
  // a time, the threads first read the records and this tile's bucket
  // bounds in parallel into shared memory, so the walk reads no global
  // memory for a child but its rel slices and its pool values; and the
  // next hitting child's slices (at most one row and one column entry per
  // thread) are loaded while this child's pool values are.
  int buf = 0;
  const int64_t k_end = ch_ptr[s + 1];
  for (int64_t k0 = ch_ptr[s]; k0 < k_end; k0 += kChunk) {
    const int n =
        static_cast<int>(k_end - k0 < kChunk ? k_end - k0 : kChunk);
    __syncthreads();                   // the previous chunk's table is read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int64_t* rec = ch_rec + 6 * (k0 + j);
      const int* bk = ch_bkt + rec[3];
      const int* bkc = ch_bkt + rec[5];
      k_off[j] = rec[0];
      k_rel[j] = rec[2];
      k_relc[j] = rec[4];
      k_ub[j] = static_cast<int>(rec[1]);
      k_rng[j] = make_int4(bk[b_lo], bk[b_hi], bkc[bc_lo], bkc[bc_hi]);
    }
    __syncthreads();
    int j = next_hit(k_rng, 0, n);
    int2 row_e = make_int2(0, 0), col_e = make_int2(0, 0);
    if (j < n) {
      slice_entries(rel + k_rel[j], rel + k_relc[j], k_rng[j], &row_e,
                    &col_e);
    }
    while (j < n) {
      const int4 rg = k_rng[j];
      const int64_t off = k_off[j];
      const int64_t ub = k_ub[j];
      if (!ready) {
        copy_tile<T, V>(tile, g, mc, th, tw, false);  // the barrier below
        ready = true;                                 // covers the load
      }
      const int nr = rg.y - rg.x, nc = rg.w - rg.z;
      int2* rs = rows_s[buf];
      int2* cs = cols_s[buf];
      if (static_cast<int>(threadIdx.x) < nr) rs[threadIdx.x] = row_e;
      if (static_cast<int>(threadIdx.x) < nc) cs[threadIdx.x] = col_e;
      __syncthreads();
      const int jn = next_hit(k_rng, j + 1, n);
      if (jn < n) {
        slice_entries(rel + k_rel[jn], rel + k_relc[jn], k_rng[jn], &row_e,
                      &col_e);
      }
      // a large child keeps more loads in flight; a small one (a few rows
      // of a few entries) walks fewer dead steps with fewer
      if (nr * nc >= kWide * kThreads) {
        add_pairs<T, kWide>(tile, rs, cs, pool + off, pool_len - off, ub, nr,
                            nc, static_cast<int>(r0), static_cast<int>(c0),
                            tw);
      } else {
        add_pairs<T, kNarrow>(tile, rs, cs, pool + off, pool_len - off, ub,
                              nr, nc, static_cast<int>(r0),
                              static_cast<int>(c0), tw);
      }
      buf ^= 1;
      j = jn;
    }
  }

  if (ready) {
    __syncthreads();
    copy_tile<T, V>(tile, g, mc, th, tw, true);
  }
}

template <typename T, int V>
int launch_v(T* f, const T* pool, const T* avals, const int64_t* ws,
             const int64_t* a_bkt, const int64_t* a_ent,
             const int64_t* ch_ptr, const int64_t* ch_rec,
             const int32_t* rel, const int32_t* ch_bkt, int64_t batch,
             int64_t m, int64_t mc, int64_t w, int64_t pool_len,
             int64_t n_avals, int64_t col_pb, int64_t col_np, int64_t col_p,
             int accumulate, cudaStream_t stream) {
  constexpr int kRows = Shape<T>::kRows;
  constexpr int kTileCols = Shape<T>::kCols;
  const int64_t tiles_r = (m + kRows - 1) / kRows;
  const int64_t tiles_c = (mc + kTileCols - 1) / kTileCols;
  const int64_t n_tiles = tiles_r * tiles_c;
  const int64_t blocks = batch * n_tiles;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t th = m < kRows ? m : kRows;
  const int64_t tw = mc < kTileCols ? mc : kTileCols;
  const size_t smem = static_cast<size_t>(th * tw) * sizeof(T);
  auto kernel = front_assemble_kernel<T, V>;
  // a tile and the static shared memory beside it may pass the default
  // 48 KB: raise the limit to a full tile once per device (a bit per
  // device ordinal)
  static uint64_t raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(raised >> (dev & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kRows * kTileCols * sizeof(T)));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised |= uint64_t{1} << (dev & 63);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      f, pool, avals, ws, a_bkt, a_ent, ch_ptr, ch_rec,
      reinterpret_cast<const int2*>(rel), ch_bkt, m, mc, w, pool_len,
      n_avals, col_pb, col_np, col_p, tiles_c, n_tiles, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(T* f, const T* pool, const T* avals, const int64_t* ws,
           const int64_t* a_bkt, const int64_t* a_ent, const int64_t* ch_ptr,
           const int64_t* ch_rec, const int32_t* rel, const int32_t* ch_bkt,
           int64_t batch, int64_t m, int64_t mc, int64_t w, int64_t pool_len,
           int64_t n_avals, int64_t col_pb, int64_t col_np, int64_t col_p,
           int64_t accumulate, void* stream) {
  constexpr int kV = Shape<T>::kVec;
  if (col_pb < 1 || col_np < 1 || col_p < 0 || col_p >= col_np) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte rows need mc % kV == 0 (then every tile row and every front row
  // starts on a 16-byte boundary) and a 16-byte aligned batch
  const bool vec = mc % kV == 0 &&
                   reinterpret_cast<uintptr_t>(f) % (sizeof(T) * kV) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int acc = accumulate ? 1 : 0;
  if (vec) {
    return launch_v<T, kV>(f, pool, avals, ws, a_bkt, a_ent, ch_ptr, ch_rec,
                           rel, ch_bkt, batch, m, mc, w, pool_len, n_avals,
                           col_pb, col_np, col_p, acc, st);
  }
  return launch_v<T, 1>(f, pool, avals, ws, a_bkt, a_ent, ch_ptr, ch_rec, rel,
                        ch_bkt, batch, m, mc, w, pool_len, n_avals, col_pb,
                        col_np, col_p, acc, st);
}

}  // namespace

extern "C" {

#define SLU_FRONT_ASSEMBLE(NAME, T)                                          \
  int NAME(T* f, const T* pool, const T* avals, const int64_t* ws,          \
           const int64_t* a_bkt, const int64_t* a_ent,                      \
           const int64_t* ch_ptr, const int64_t* ch_rec, const int32_t* rel, \
           const int32_t* ch_bkt, int64_t batch, int64_t m, int64_t mc,     \
           int64_t w, int64_t pool_len, int64_t n_avals, int64_t col_pb,    \
           int64_t col_np, int64_t col_p, int64_t accumulate,               \
           void* stream) {                                                  \
    return launch<T>(f, pool, avals, ws, a_bkt, a_ent, ch_ptr, ch_rec, rel, \
                     ch_bkt, batch, m, mc, w, pool_len, n_avals, col_pb,    \
                     col_np, col_p, accumulate, stream);                    \
  }

SLU_FRONT_ASSEMBLE(slu_front_assemble_f32, float)
SLU_FRONT_ASSEMBLE(slu_front_assemble_f64, double)
SLU_FRONT_ASSEMBLE(slu_front_assemble_c64, Cx<float>)
SLU_FRONT_ASSEMBLE(slu_front_assemble_c128, Cx<double>)

#undef SLU_FRONT_ASSEMBLE

}  // extern "C"
