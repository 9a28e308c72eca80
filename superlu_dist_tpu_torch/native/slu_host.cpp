// Native host analysis of the PyTorch/CUDA SuperLU_DIST port.
//
// The reference implements its host analysis in C (SRC/etree.c, symbfact.c,
// mc64ad_dist.c, get_perm_c.c + METIS); the Python twins in this package are
// the specification and test oracle, but cannot reach the n≈1M problem
// class.  This library provides drop-in accelerated versions behind a
// ctypes seam (superlu_dist_tpu_torch/native/__init__.py).  It is the
// analysis part of the JAX package's library, kept identical so that both
// packages compute the same bits:
//
//   slu_etree      — Liu's elimination-tree algorithm with path compression
//                    (analog of sp_coletree_dist, SRC/etree.c:222)
//   slu_postorder  — iterative DFS postorder (TreePostorder_dist analog)
//   slu_symbolic   — relaxed-supernode partition + bottom-up supernodal row
//                    structures + zero-fill chain merging (analog of
//                    symbfact/relax_snode, SRC/symbfact.c:80,224) — exact
//                    mirror of symbolic/symbfact.py semantics
//   slu_mc64       — maximum-product bipartite matching with LP duals
//                    ("MC64 job=5", analog of SRC/mc64ad_dist.c:121) — exact
//                    mirror of rowperm/matching.py
//   slu_mlnd       — multilevel nested dissection (coarsen → bisect → FM
//                    refine → project) with vertex separators; the
//                    METIS_AT_PLUS_A-quality general-graph ordering
//                    (analog of SRC/get_perm_c.c:90,463-530)
//
// All indices are int64 (the XSDK_INDEX_SIZE=64 configuration of the
// reference, superlu_defs.h:80-93): nnz(L) > 2^31 is reachable at the
// target problem class.
//
// The other entry points: slu_postorder, slu_symbolic_mt (threaded
// symbolic), slu_amalgamate, slu_positions (front positions of the plan),
// slu_awpm (approximate-weight matching), slu_mmd, slu_colamd,
// slu_ata_pattern (AᵀA for MMD_ATA) and slu_mlnd_mt (threaded ND).
// After them, the shared-memory tree collectives of the JAX package's
// library, kept identical so that a rank of either package can join the
// other's domain: slu_tree_attach / _attach_shared / _detach, the
// broadcast and sum-reduction (slu_tree_bcast(_tw), slu_tree_reduce_sum
// (_tw)) and the failure detector's slots (slu_tree_set_pid / _get_pid,
// _heartbeat / _get_heartbeat, _post / _peek).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread ... -lrt
// (native/__init__.py builds it at first use; no external deps).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <random>
#include <thread>
#include <utility>
#include <vector>

#if defined(__GLIBC__)
#include <malloc.h>
// The symbolic/ordering phases allocate and free hundreds of thousands of
// row-list vectors totalling ~GBs.  glibc serves large vectors by
// mmap/munmap, so every reuse re-faults its pages — on slow virtualized
// cores that dwarfs the actual merge work.  HeapScope keeps allocations on
// the heap (no mmap, no trim) for the duration of one analysis call, then
// restores the defaults and trims so the process does not retain the
// transient GBs (a load-time global retune would).
// mallopt is process-wide: in a process that also holds torch, every
// allocation made by any thread during an analysis call (torch's host
// allocator included) also stays off mmap, and the destructor's defaults
// replace whatever the process had set before.
struct HeapScope {
  HeapScope() {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
  }
  ~HeapScope() {
    mallopt(M_MMAP_MAX, 65536);
    mallopt(M_TRIM_THRESHOLD, 128 * 1024);
    malloc_trim(0);
  }
};
#else
struct HeapScope {};
#endif

using i64 = int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Elimination tree (Liu's algorithm, path compression).  Pattern must be
// structurally symmetric; only entries j < i of row i are used.
// ---------------------------------------------------------------------------
void slu_etree(i64 n, const i64* indptr, const i64* indices, i64* parent) {
  std::vector<i64> ancestor(n, -1);
  for (i64 i = 0; i < n; ++i) parent[i] = -1;
  for (i64 i = 0; i < n; ++i) {
    for (i64 p = indptr[i]; p < indptr[i + 1]; ++p) {
      i64 j = indices[p];
      while (j != -1 && j < i) {
        i64 nxt = ancestor[j];
        ancestor[j] = i;
        if (nxt == -1) {
          parent[j] = i;
          break;
        }
        j = nxt;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Postorder of the forest: children before parents, smallest-numbered child
// first, roots in natural order.  post[k] = node visited k-th.
// ---------------------------------------------------------------------------
void slu_postorder(i64 n, const i64* parent, i64* post) {
  // children lists via counting sort (stable => ascending child ids)
  std::vector<i64> child_cnt(n + 1, 0);
  for (i64 j = 0; j < n; ++j)
    if (parent[j] >= 0) child_cnt[parent[j] + 1]++;
  std::vector<i64> child_ptr(n + 1, 0);
  for (i64 j = 0; j < n; ++j) child_ptr[j + 1] = child_ptr[j] + child_cnt[j + 1];
  std::vector<i64> child_list(child_ptr[n]);
  {
    std::vector<i64> fill(child_ptr.begin(), child_ptr.end() - 1);
    for (i64 j = 0; j < n; ++j)
      if (parent[j] >= 0) child_list[fill[parent[j]]++] = j;
  }
  // iterative DFS; stack entries: (node, next-child cursor)
  i64 out = 0;
  std::vector<std::pair<i64, i64>> stack;
  stack.reserve(64);
  for (i64 r = 0; r < n; ++r) {
    if (parent[r] != -1) continue;
    stack.emplace_back(r, child_ptr[r]);
    while (!stack.empty()) {
      auto& top = stack.back();
      if (top.second < child_ptr[top.first + 1]) {
        i64 c = child_list[top.second++];
        stack.emplace_back(c, child_ptr[c]);
      } else {
        post[out++] = top.first;
        stack.pop_back();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Supernodal symbolic factorization on a postordered symmetric pattern.
// Mirror of symbolic/symbfact.py: relaxed leaf subtrees (<= relax cols),
// bottom-up per-supernode row structures, zero-fill chain merging capped at
// max_supernode.  Returns ns (supernode count) or -1 on error.
// Outputs (caller-allocated): sn_start (n+1), col_to_sn (n), sn_parent (n),
// sn_level (n), rows_ptr (n+1).  rows_data is malloc'd here (size
// rows_ptr[ns]); caller frees via slu_free_i64.
// ---------------------------------------------------------------------------
static i64 symbolic_impl(i64 n, const i64* indptr, const i64* indices,
                         const i64* parent, i64 relax, i64 max_supernode,
                         i64 nthreads, i64* sn_start, i64* col_to_sn,
                         i64* sn_parent, i64* sn_level, i64* rows_ptr,
                         i64** rows_data) {
  HeapScope heap_scope;
  if (relax > max_supernode) relax = max_supernode;
  // subtree counts (postordered labels: children have smaller ids)
  std::vector<i64> cnt(n, 1);
  for (i64 j = 0; j < n; ++j)
    if (parent[j] >= 0) cnt[parent[j]] += cnt[j];
  // relaxed roots -> contiguous leading partition
  std::vector<i64> first, last;
  first.reserve(n / (relax > 0 ? relax : 1) + 16);
  for (i64 j = 0; j < n;) {
    bool relaxed_root = false;
    // find whether some relaxed root r has its subtree starting at j; the
    // subtree of r covers [r-cnt[r]+1, r]: scan upward from j while counts
    // allow.  Equivalent to python's precomputed flag per node; here walk
    // the chain: r = j + ... cheapest: check each candidate root r >= j with
    // r - cnt[r] + 1 == j and cnt[r] <= relax, take the largest such r.
    // Since subtrees are nested, walk ancestors of j while they start at j.
    i64 r = j;
    i64 best = -1;
    while (r < n && r - cnt[r] + 1 == j) {
      bool is_root = (cnt[r] <= relax) &&
                     (parent[r] < 0 || cnt[parent[r]] > relax);
      if (is_root) best = r;
      if (parent[r] < 0) break;
      r = parent[r];
      if (r - cnt[r] + 1 != j) break;
    }
    first.push_back(j);
    if (best >= 0) {
      relaxed_root = true;
      j = best + 1;
    } else {
      j += 1;
    }
    last.push_back(j - 1);
    (void)relaxed_root;
  }
  i64 ns0 = (i64)first.size();
  std::vector<i64> c2s0(n);
  for (i64 s = 0; s < ns0; ++s)
    for (i64 j = first[s]; j <= last[s]; ++j) c2s0[j] = s;

  std::vector<std::vector<i64>> rows_of(ns0);
  std::vector<std::vector<i64>> kids(ns0);
  std::vector<char> alive(ns0, 1);
  // live supernode by last column
  std::vector<i64> by_last(n, -1);
  for (i64 s = 0; s < ns0; ++s) by_last[last[s]] = s;

  // Row structures via sorted-set unions: every piece (a child's row list,
  // or this supernode's structural entries) is sorted, so fold them with
  // set_union smallest-first instead of sorting the concatenation — the
  // reference's symbolic does the analogous pruned merges column-by-column
  // (symbfact.c:455); at n~1e6 this is the host-analysis hot spot.
  //
  // process_one computes supernode s's rows + chain-merges predecessors
  // within [range_lo, s]; registration of s with its parent is the
  // CALLER's job (serial: immediate; threaded: subtree roots defer to the
  // sequential top phase).  The restriction to range_lo is the only
  // divergence of the threaded result from serial output: chain merges
  // cannot cross a subtree boundary (same class of difference as the
  // reference's parallel symbolic vs serial, psymbfact.c:228-242 — a
  // valid alternative supernode partition over identical fill).
  auto process_one = [&](i64 s, i64 range_lo, std::vector<i64>& buf,
                         std::vector<i64>& acc, std::vector<i64>& tmp) {
    i64 l = last[s];
    // structural piece (small): entries > l from this supernode's columns
    buf.clear();
    for (i64 j = first[s]; j <= l; ++j)
      for (i64 p = indptr[j]; p < indptr[j + 1]; ++p)
        if (indices[p] > l) buf.push_back(indices[p]);
    std::sort(buf.begin(), buf.end());
    buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
    // children pieces: rows > l (sorted views), folded smallest-first
    struct Piece { const i64* lo; const i64* hi; };
    std::vector<Piece> pieces;
    if (!buf.empty()) pieces.push_back({buf.data(), buf.data() + buf.size()});
    for (i64 g : kids[s]) {
      const auto& rg = rows_of[g];
      const i64* lo = std::upper_bound(rg.data(), rg.data() + rg.size(), l);
      if (lo != rg.data() + rg.size()) pieces.push_back({lo, rg.data() + rg.size()});
    }
    std::sort(pieces.begin(), pieces.end(),
              [](const Piece& a, const Piece& b) {
                return a.hi - a.lo < b.hi - b.lo;
              });
    acc.clear();
    for (const auto& pc : pieces) {
      tmp.clear();
      tmp.reserve(acc.size() + (pc.hi - pc.lo));
      std::set_union(acc.begin(), acc.end(), pc.lo, pc.hi,
                     std::back_inserter(tmp));
      acc.swap(tmp);
    }
    // move (not copy): steals acc's buffer, avoiding a second pass over
    // the ~nnz(L)-sized aggregate row volume
    rows_of[s] = std::move(acc);
    acc = std::vector<i64>();
    // chain-merge predecessors while zero fill and within max_supernode
    while (true) {
      if (first[s] == 0) break;
      i64 c = by_last[first[s] - 1];
      if (c < range_lo || !alive[c]) break;
      if (last[s] - first[c] + 1 > max_supernode) break;
      const auto& rc = rows_of[c];
      if (rc.empty() || rc[0] != first[s] ||
          (i64)rc.size() != (last[s] - first[s] + 1) + (i64)rows_of[s].size())
        break;
      by_last[last[c]] = -1;
      alive[c] = 0;
      first[s] = first[c];
    }
  };

  if (nthreads <= 1 || ns0 < 4 * nthreads) {
    std::vector<i64> buf, acc, tmp;
    for (i64 s = 0; s < ns0; ++s) {
      process_one(s, 0, buf, acc, tmp);
      if (!rows_of[s].empty()) kids[c2s0[rows_of[s][0]]].push_back(s);
    }
  } else {
    // ---- threaded bottom-up (the psymbfact subtree-to-worker analog) ----
    // The supernode tree is known upfront: parent supernode of s is the
    // owner of etree-parent(last[s]) (the first below-diagonal row).
    std::vector<i64> p0(ns0, -1), cnt_s(ns0, 1);
    for (i64 s = 0; s < ns0; ++s)
      if (parent[last[s]] >= 0) p0[s] = c2s0[parent[last[s]]];
    for (i64 s = 0; s < ns0; ++s)
      if (p0[s] >= 0) cnt_s[p0[s]] += cnt_s[s];
    // subtree roots: contiguous id ranges [r-cnt_s[r]+1, r] small enough
    // to balance, big enough to amortize a thread
    i64 target = std::max<i64>(64, ns0 / (4 * nthreads));
    std::vector<std::pair<i64, i64>> ranges;   // [lo, r] inclusive
    std::vector<char> in_range(ns0, 0);
    for (i64 r = 0; r < ns0; ++r) {
      bool root = cnt_s[r] <= target &&
                  (p0[r] < 0 || cnt_s[p0[r]] > target);
      if (root && cnt_s[r] >= 16) {
        ranges.emplace_back(r - cnt_s[r] + 1, r);
        for (i64 s = r - cnt_s[r] + 1; s <= r; ++s) in_range[s] = 1;
      }
    }
    std::vector<std::thread> pool;
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      std::vector<i64> buf, acc, tmp;
      while (true) {
        size_t t = next.fetch_add(1);
        if (t >= ranges.size()) break;
        auto [lo, hi] = ranges[t];
        for (i64 s = lo; s <= hi; ++s) {
          process_one(s, lo, buf, acc, tmp);
          // register within the subtree only; roots defer to the top phase
          if (s != hi && !rows_of[s].empty())
            kids[c2s0[rows_of[s][0]]].push_back(s);
        }
      }
    };
    i64 nt = std::min<i64>(nthreads, (i64)ranges.size());
    for (i64 t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    // top phase (sequential): register subtree roots, then process the
    // remaining supernodes in ascending order
    for (auto [lo, hi] : ranges)
      if (!rows_of[hi].empty()) kids[c2s0[rows_of[hi][0]]].push_back(hi);
    std::vector<i64> buf, acc, tmp;
    for (i64 s = 0; s < ns0; ++s) {
      if (in_range[s]) continue;
      process_one(s, 0, buf, acc, tmp);
      if (!rows_of[s].empty()) kids[c2s0[rows_of[s][0]]].push_back(s);
    }
  }

  // compact to live supernodes
  i64 ns = 0;
  std::vector<i64> live;
  live.reserve(ns0);
  for (i64 s = 0; s < ns0; ++s)
    if (alive[s]) live.push_back(s);
  ns = (i64)live.size();
  i64 total_rows = 0;
  for (i64 k = 0; k < ns; ++k) {
    sn_start[k] = first[live[k]];
    total_rows += (i64)rows_of[live[k]].size();
  }
  sn_start[ns] = n;
  for (i64 k = 0; k < ns; ++k)
    for (i64 j = sn_start[k]; j < sn_start[k + 1]; ++j) col_to_sn[j] = k;
  i64* rd = (i64*)std::malloc(sizeof(i64) * (total_rows ? total_rows : 1));
  if (!rd) return -1;
  i64 off = 0;
  for (i64 k = 0; k < ns; ++k) {
    rows_ptr[k] = off;
    const auto& r = rows_of[live[k]];
    std::memcpy(rd + off, r.data(), sizeof(i64) * r.size());
    off += (i64)r.size();
  }
  rows_ptr[ns] = off;
  *rows_data = rd;
  for (i64 k = 0; k < ns; ++k) {
    sn_parent[k] = rows_ptr[k] < rows_ptr[k + 1] ? col_to_sn[rd[rows_ptr[k]]] : -1;
    sn_level[k] = 0;
  }
  for (i64 k = 0; k < ns; ++k) {
    i64 p = sn_parent[k];
    if (p >= 0 && sn_level[p] < sn_level[k] + 1) sn_level[p] = sn_level[k] + 1;
  }
  return ns;
}

i64 slu_symbolic(i64 n, const i64* indptr, const i64* indices,
                 const i64* parent, i64 relax, i64 max_supernode,
                 i64* sn_start, i64* col_to_sn, i64* sn_parent,
                 i64* sn_level, i64* rows_ptr, i64** rows_data) {
  return symbolic_impl(n, indptr, indices, parent, relax, max_supernode, 1,
                       sn_start, col_to_sn, sn_parent, sn_level, rows_ptr,
                       rows_data);
}

// Parallel symbolic factorization — capability analog of symbfact_dist
// (SRC/psymbfact.c:140): subtree-to-worker decomposition over the
// supernode tree (known upfront from the etree), threads computing
// independent subtrees' row structures bottom-up, a sequential pass for
// the top separators.  Produces identical fill; supernode chain merges
// cannot cross subtree boundaries, so the partition may differ slightly
// from the serial one (the reference's parallel symbolic likewise
// produces different-but-valid structures).
i64 slu_symbolic_mt(i64 n, const i64* indptr, const i64* indices,
                    const i64* parent, i64 relax, i64 max_supernode,
                    i64 nthreads, i64* sn_start, i64* col_to_sn,
                    i64* sn_parent, i64* sn_level, i64* rows_ptr,
                    i64** rows_data) {
  if (nthreads <= 0)
    nthreads = (i64)std::max(1u, std::thread::hardware_concurrency());
  return symbolic_impl(n, indptr, indices, parent, relax, max_supernode,
                       nthreads, sn_start, col_to_sn, sn_parent, sn_level,
                       rows_ptr, rows_data);
}

void slu_free_i64(i64* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Fill-tolerant supernode amalgamation — native twin of
// symbolic/symbfact.py:amalgamate_supernodes (the accelerator-first whole-tree
// extension of the reference's leaf-only relax_snode, SRC/symbfact.c:224).
// Greedy merge of the column-adjacent rightmost descendant path, each merge
// tested against the constituents' ORIGINAL front flops (globally bounded
// growth).  Inputs are a symbolic partition in the slu_symbolic output
// protocol; outputs use the same protocol (o_rows_data malloc'd here, freed
// by the caller via slu_free_i64).  Returns the new supernode count, or -1.
// ---------------------------------------------------------------------------
static double front_flops_d(double w, double u) {
  return 2.0 / 3.0 * w * w * w + 2.0 * w * w * u + 2.0 * w * u * u;
}

i64 slu_amalgamate(i64 n, i64 ns, const i64* sn_start, const i64* rows_ptr,
                   const i64* rows_data, double tol, i64 max_width,
                   i64 narrow, double hard_tol, i64* o_sn_start,
                   i64* o_col_to_sn, i64* o_sn_parent, i64* o_sn_level,
                   i64* o_rows_ptr, i64** o_rows_data) {
  if (n < 0 || ns < 0) return -1;
  HeapScope heap_scope;
  std::vector<i64> first(ns), end(ns);
  std::vector<std::vector<i64>> rows(ns);
  for (i64 s = 0; s < ns; ++s) {
    first[s] = sn_start[s];
    end[s] = sn_start[s + 1];
    rows[s].assign(rows_data + rows_ptr[s], rows_data + rows_ptr[s + 1]);
  }
  std::vector<i64> c2s(n);
  for (i64 s = 0; s < ns; ++s)
    for (i64 j = first[s]; j < end[s]; ++j) c2s[j] = s;
  std::vector<i64> rep(ns);
  for (i64 s = 0; s < ns; ++s) rep[s] = s;
  auto find = [&](i64 s) {
    while (rep[s] != s) { rep[s] = rep[rep[s]]; s = rep[s]; }
    return s;
  };
  std::vector<i64> by_end(n + 1, -1);
  for (i64 s = 0; s < ns; ++s) by_end[end[s]] = s;
  std::vector<double> base(ns);
  for (i64 s = 0; s < ns; ++s)
    base[s] = front_flops_d((double)(end[s] - first[s]),
                            (double)rows[s].size());
  std::vector<char> alive(ns, 1);
  std::vector<i64> merged;
  for (i64 p = 0; p < ns; ++p) {
    if (!alive[p]) continue;
    for (;;) {
      i64 c = by_end[first[p]];
      if (c < 0) break;
      c = find(c);
      if (!alive[c]) break;
      const auto& rc = rows[c];
      if (rc.empty()) break;
      if (find(c2s[rc[0]]) != p) break;
      i64 w_m = (end[c] - first[c]) + (end[p] - first[p]);
      if (w_m > max_width) break;
      const i64* lo = std::lower_bound(rc.data(), rc.data() + rc.size(),
                                       end[p]);
      merged.clear();
      std::set_union(lo, rc.data() + rc.size(), rows[p].begin(),
                     rows[p].end(), std::back_inserter(merged));
      double fl = front_flops_d((double)w_m, (double)merged.size());
      double budget = base[p] + base[c];
      if (!(fl <= tol * budget ||
            (w_m <= narrow && fl <= hard_tol * budget)))
        break;
      by_end[first[p]] = -1;
      first[p] = first[c];
      rows[p].swap(merged);
      alive[c] = 0;
      rep[c] = p;
      base[p] = budget;
    }
  }
  // compact to live supernodes (column order is preserved: live first[]
  // ascend because merges only extend a supernode downward); parents are
  // reconstructed from o_col_to_sn[first row] below, so no old->new map
  // is needed
  i64 k = 0;
  i64 total = 0;
  for (i64 s = 0; s < ns; ++s)
    if (alive[s]) {
      ++k;
      total += (i64)rows[s].size();
    }
  i64* rd = (i64*)std::malloc(sizeof(i64) * (size_t)std::max<i64>(total, 1));
  if (!rd) return -1;
  i64 off = 0, i = 0;
  for (i64 s = 0; s < ns; ++s) {
    if (!alive[s]) continue;
    o_sn_start[i] = first[s];
    o_rows_ptr[i] = off;
    std::copy(rows[s].begin(), rows[s].end(), rd + off);
    off += (i64)rows[s].size();
    for (i64 j = first[s]; j < end[s]; ++j) o_col_to_sn[j] = i;
    ++i;
  }
  o_sn_start[k] = n;
  o_rows_ptr[k] = off;
  *o_rows_data = rd;
  for (i64 s2 = 0; s2 < k; ++s2) {
    o_sn_parent[s2] = o_rows_ptr[s2] < o_rows_ptr[s2 + 1]
                          ? o_col_to_sn[rd[o_rows_ptr[s2]]]
                          : -1;
    o_sn_level[s2] = 0;
  }
  for (i64 s2 = 0; s2 < k; ++s2) {
    i64 p = o_sn_parent[s2];
    if (p >= 0 && o_sn_level[p] < o_sn_level[s2] + 1)
      o_sn_level[p] = o_sn_level[s2] + 1;
  }
  return k;
}

// ---------------------------------------------------------------------------
// Batched front-position queries for plan building: for query q, the
// position of global index x[q] within the front of supernode s[q] —
// pivot columns map to x - first[s], below-diagonal rows to
// W[s] + rank of x in rows(s) (binary search in the supernode's sorted
// row list).  One C pass replaces ~30 numpy whole-array passes.
// ---------------------------------------------------------------------------
void slu_positions(i64 nq, const i64* s_arr, const i64* x_arr,
                   const i64* first, const i64* last, const i64* snW,
                   const i64* rows_ptr, const i64* rows_data, i64* pos) {
  for (i64 q = 0; q < nq; ++q) {
    i64 s = s_arr[q], x = x_arr[q];
    if (x <= last[s]) {
      pos[q] = x - first[s];
    } else {
      const i64* lo = rows_data + rows_ptr[s];
      const i64* hi = rows_data + rows_ptr[s + 1];
      pos[q] = snW[s] + (std::lower_bound(lo, hi, x) - lo);
    }
  }
}

// ---------------------------------------------------------------------------
// MC64 job=5: maximum-product matching + scalings via successive shortest
// augmenting paths with potentials.  Inputs: CSC pattern, |a| values.
// cost[k] = log(colmax_j) - log|a_k| (>= 0, +inf for zeros — excluded).
// Outputs: col_match (col -> row, the row_order), u (col duals), v (row
// duals).  Returns 0 ok, 1 structurally singular.
// ---------------------------------------------------------------------------
int slu_mc64(i64 n, const i64* indptr, const i64* indices,
             const double* absval, i64* col_match_out, double* u, double* v) {
  const double INF = 1e300;
  std::vector<double> cost(indptr[n]);
  std::vector<double> colmax(n, 0.0);
  for (i64 j = 0; j < n; ++j)
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k)
      colmax[j] = std::max(colmax[j], absval[k]);
  for (i64 j = 0; j < n; ++j) {
    if (colmax[j] == 0.0) return 1;  // empty column
    double lm = std::log(colmax[j]);
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k)
      cost[k] = absval[k] > 0.0 ? lm - std::log(absval[k]) : INF;
  }
  for (i64 i = 0; i < n; ++i) { u[i] = 0.0; v[i] = 0.0; }
  std::vector<i64> row_match(n, -1), col_match(n, -1);
  // Generation-stamped search state: dist/pred/done are valid for row i
  // only when its stamp equals the current source column j0, and the
  // rows touched this round are collected in `visited`.  Without this,
  // each of the n augmentations pays four O(n) refills/scans — an
  // O(n^2) total that measured ~40 MINUTES at n=1e6 (21 s at n=1e5,
  // the round-5 1M-analysis A/B bottleneck).  Stamped, each round
  // costs O(local search tree): seconds at n=1e6.
  std::vector<double> dist(n);
  std::vector<i64> pred(n);
  std::vector<i64> dstamp(n, -1), done_stamp(n, -1);
  std::vector<i64> visited;
  std::vector<i64> tree_cols;
  std::vector<double> d_col(n);
  using QE = std::pair<double, i64>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;

  for (i64 j0 = 0; j0 < n; ++j0) {
    tree_cols.clear();
    tree_cols.push_back(j0);
    d_col[j0] = 0.0;
    visited.clear();
    while (!heap.empty()) heap.pop();

    auto dget = [&](i64 i) { return dstamp[i] == j0 ? dist[i] : INF; };
    auto relax_col = [&](i64 j, double base) {
      for (i64 k = indptr[j]; k < indptr[j + 1]; ++k) {
        if (cost[k] >= INF) continue;
        i64 i = indices[k];
        if (done_stamp[i] == j0) continue;
        double nd = base + cost[k] - u[j] - v[i];
        if (nd < dget(i) - 1e-30) {
          if (dstamp[i] != j0) {
            dstamp[i] = j0;
            visited.push_back(i);
          }
          dist[i] = nd;
          pred[i] = j;
          heap.emplace(nd, i);
        }
      }
    };
    relax_col(j0, 0.0);
    i64 found = -1;
    double mind = 0.0;
    while (!heap.empty()) {
      auto [d, i] = heap.top();
      heap.pop();
      if (done_stamp[i] == j0 || d > dget(i)) continue;
      done_stamp[i] = j0;
      if (row_match[i] == -1) {
        found = i;
        mind = dist[i];
        break;
      }
      i64 jn = row_match[i];
      tree_cols.push_back(jn);
      d_col[jn] = d;
      relax_col(jn, d);
    }
    if (found == -1) return 1;  // no perfect matching
    for (i64 i : visited)
      if (done_stamp[i] == j0 && dist[i] <= mind) v[i] += dist[i] - mind;
    for (i64 j : tree_cols) u[j] += mind - d_col[j];
    // augment
    i64 i = found;
    while (i != -1) {
      i64 j = pred[i];
      i64 inext = col_match[j];
      row_match[i] = j;
      col_match[j] = i;
      i = inext;
      if (j == j0) break;
    }
  }
  for (i64 j = 0; j < n; ++j) col_match_out[j] = col_match[j];
  // convert duals so caller computes r = exp(v), c = exp(u)/colmax
  return 0;
}

// ---------------------------------------------------------------------------
// Exact-external-degree minimum-degree ordering on a quotient graph with
// element absorption — the MMD capability analog (reference genmmd_dist_,
// SRC/mmd.c, dispatched by get_perm_c.c:463-530).  Exact mirror of
// ordering/minimum_degree.py (same tie-breaking: smallest vertex id on
// equal degree), so the Python implementation remains the test oracle.
// Sets are sorted vectors; element ids are n + elimination step.
// ---------------------------------------------------------------------------
namespace {

using VSet = std::vector<i64>;  // sorted, unique

void vset_subtract(VSet& a, const VSet& b) {
  if (a.empty() || b.empty()) return;
  VSet out;
  out.reserve(a.size());
  std::set_difference(a.begin(), a.end(), b.begin(), b.end(),
                      std::back_inserter(out));
  a.swap(out);
}

void vset_erase(VSet& a, i64 x) {
  auto it = std::lower_bound(a.begin(), a.end(), x);
  if (it != a.end() && *it == x) a.erase(it);
}

void vset_insert(VSet& a, i64 x) {
  auto it = std::lower_bound(a.begin(), a.end(), x);
  if (it == a.end() || *it != x) a.insert(it, x);
}

}  // namespace

void slu_mmd(i64 n, const i64* indptr, const i64* indices, i64* order_out) {
  HeapScope heap_scope;
  std::vector<VSet> adj(n);
  for (i64 i = 0; i < n; ++i)
    for (i64 p = indptr[i]; p < indptr[i + 1]; ++p) {
      i64 j = indices[p];
      if (j != i) {
        adj[i].push_back(j);
        adj[j].push_back(i);
      }
    }
  for (i64 i = 0; i < n; ++i) {
    std::sort(adj[i].begin(), adj[i].end());
    adj[i].erase(std::unique(adj[i].begin(), adj[i].end()), adj[i].end());
  }
  std::vector<VSet> var_elems(n);          // element ids adjacent to var
  std::vector<VSet> elem_vars(n);          // index k <-> element id n+k
  std::vector<char> alive(n, 1);
  std::vector<i64> degree(n);
  using QE = std::pair<i64, i64>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  for (i64 v = 0; v < n; ++v) {
    degree[v] = (i64)adj[v].size();
    heap.emplace(degree[v], v);
  }

  // Epoch-stamped scratch instead of sorted-vector unions: external
  // sets/degrees are computed by flat marking scans (same RESULTS,
  // identical tie-breaking — the Python oracle stays bit-exact), which
  // removes the allocation+merge cost that made 3D-mesh elements
  // (O(n^{2/3}) wide) pathological: 654 s -> measured seconds-class at
  // n=110,592.  The per-step pivot element is marked ONCE and every
  // neighbor's adjacency filtered in O(deg) against it.
  std::vector<i64> mark(n, -1);
  i64 epoch = 0;
  auto external_set = [&](i64 v, VSet& out) {
    ++epoch;
    mark[v] = epoch;
    out.clear();
    for (i64 x : adj[v])
      if (mark[x] != epoch) { mark[x] = epoch; out.push_back(x); }
    for (i64 e : var_elems[v])
      for (i64 x : elem_vars[e - n])
        if (mark[x] != epoch) { mark[x] = epoch; out.push_back(x); }
    std::sort(out.begin(), out.end());
  };
  std::vector<i64> in_le(n, -1);            // step stamp: x in pivot elem
  VSet le, scratch;

  for (i64 k = 0; k < n; ++k) {
    i64 v;
    while (true) {
      auto [d, u] = heap.top();
      heap.pop();
      if (alive[u] && d == degree[u]) {
        v = u;
        break;
      }
    }
    order_out[k] = v;
    alive[v] = 0;
    external_set(v, le);
    const VSet absorbed = var_elems[v];     // copy: elements of v, absorbed
    for (i64 e : absorbed) elem_vars[e - n].clear();
    elem_vars[k] = le;
    i64 eid = n + k;
    for (i64 x : le) in_le[x] = k;
    in_le[v] = k;                           // v leaves every adjacency
    for (i64 u : le) {
      // adj[u] minus (le ∪ {v}) in one linear pass (edges now covered
      // by the new element)
      scratch.clear();
      for (i64 x : adj[u])
        if (in_le[x] != k) scratch.push_back(x);
      adj[u].swap(scratch);
      vset_subtract(var_elems[u], absorbed);
      vset_insert(var_elems[u], eid);
      // exact external degree WITHOUT rescanning the new element for
      // every member (the |le|^2 term that dominated on 3D meshes):
      // le \ {u} are pairwise distinct, alive, disjoint from the
      // just-filtered adj[u]; only the OLD elements need the dedup
      // scan, skipping le members (in_le stamp) and u itself
      degree[u] = (i64)le.size() - 1 + (i64)adj[u].size();
      ++epoch;
      mark[u] = epoch;
      for (i64 x : adj[u]) mark[x] = epoch;
      for (i64 e : var_elems[u]) {
        if (e == eid) continue;
        for (i64 x : elem_vars[e - n])
          if (in_le[x] != k && mark[x] != epoch) {
            mark[x] = epoch;
            ++degree[u];
          }
      }
      heap.emplace(degree[u], u);
    }
  }
}

// ---------------------------------------------------------------------------
// COLAMD-class approximate column minimum-degree ordering — capability
// analog of the reference's colamd (SRC/colamd.c, dispatched for
// colperm_t COLAMD, get_perm_c.c:463-530).  Fresh implementation of the
// published algorithm idea: order the columns of A by approximate minimum
// degree in AᵀA *without forming AᵀA* — the rows of A are the initial
// quotient-graph elements, eliminating a column merges every element that
// contains it into one fill element, and a column's score is the sum of
// its live element sizes (an upper bound on its AᵀA external degree).
// Dense rows are dropped from the analysis and dense columns ordered
// last, as colamd does, so one dense stripe cannot poison every score.
// ---------------------------------------------------------------------------
void slu_colamd(i64 n_rows, i64 n_cols, const i64* indptr,
                const i64* indices, i64* order_out) {
  HeapScope heap_scope;
  const i64 dense_row =
      std::max<i64>(16, (i64)(10.0 * std::sqrt((double)n_cols)));
  const i64 dense_col =
      std::max<i64>(16, (i64)(10.0 * std::sqrt((double)std::max<i64>(
                                         n_rows, 1))));
  // elements: ids 0..n_rows-1 are rows of A; n_rows+k is the k-th fill
  // element.  col_elems[j] lists the live elements containing column j.
  std::vector<VSet> elem_cols(n_rows);
  std::vector<VSet> col_elems(n_cols);
  std::vector<char> elem_alive(n_rows, 0);
  for (i64 r = 0; r < n_rows; ++r) {
    VSet& cols = elem_cols[r];
    cols.assign(indices + indptr[r], indices + indptr[r + 1]);
    std::sort(cols.begin(), cols.end());
    cols.erase(std::unique(cols.begin(), cols.end()), cols.end());
    // dense test on the DEDUPED length — the Python oracle dedups first
    if ((i64)cols.size() > dense_row) {
      cols.clear();
      cols.shrink_to_fit();
      continue;  // dense row: excluded from scores
    }
    elem_alive[r] = 1;
    for (i64 j : cols) col_elems[j].push_back(r);
  }
  std::vector<char> col_alive(n_cols, 1);
  std::vector<i64> score(n_cols, 0);
  std::vector<i64> dense_cols;
  using QE = std::pair<i64, i64>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  auto col_score = [&](i64 j) {
    i64 s = 0;
    for (i64 e : col_elems[j])
      if (elem_alive[e]) s += (i64)elem_cols[e].size() - 1;
    return std::min<i64>(std::max<i64>(s, 0), n_cols - 1);
  };
  for (i64 j = 0; j < n_cols; ++j) {
    if ((i64)col_elems[j].size() > dense_col) {
      col_alive[j] = 0;
      dense_cols.push_back(j);   // ordered last, by original degree
      continue;
    }
    score[j] = col_score(j);
    heap.emplace(score[j], j);
  }
  // dense columns must not linger inside the elements they touch
  for (i64 j : dense_cols)
    for (i64 e : col_elems[j]) vset_erase(elem_cols[e], j);
  std::sort(dense_cols.begin(), dense_cols.end(), [&](i64 a, i64 b) {
    i64 da = col_elems[a].size(), db = col_elems[b].size();
    return da != db ? da < db : a < b;
  });

  elem_cols.resize(n_rows + n_cols);       // room for fill elements
  elem_alive.resize(n_rows + n_cols, 0);
  std::vector<i64> col_mark(n_cols, -1);   // step stamp: col in new elem
  std::vector<i64> elem_tested(n_rows + n_cols, -1);
  VSet keep;
  i64 k = 0;
  i64 n_live = n_cols - (i64)dense_cols.size();
  while (k < n_live) {
    i64 c;
    while (true) {
      auto [s, j] = heap.top();
      heap.pop();
      if (col_alive[j] && s == score[j]) {
        c = j;
        break;
      }
    }
    order_out[k] = c;
    col_alive[c] = 0;
    // merge every live element containing c into one fill element —
    // concatenate then sort+unique once (a chained set_union pays
    // O(k·|merged|) across k absorbed elements)
    VSet merged;
    for (i64 e : col_elems[c])
      if (elem_alive[e]) {
        merged.insert(merged.end(), elem_cols[e].begin(),
                      elem_cols[e].end());
        elem_alive[e] = 0;
        elem_cols[e].clear();
        elem_cols[e].shrink_to_fit();
      }
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    vset_erase(merged, c);
    // drop dead columns so element sizes track live structure
    VSet live;
    live.reserve(merged.size());
    for (i64 j : merged)
      if (col_alive[j]) live.push_back(j);
    i64 eid = n_rows + k;
    elem_cols[eid] = live;
    elem_alive[eid] = 1;
    // aggressive absorption (mirror of ordering/colamd.py): an old
    // element whose every LIVE column lies inside the new element is
    // dominated by it — drop it, which tightens the scores AND stops
    // the per-column element lists from accumulating (the 3D-mesh
    // slowdown's root)
    for (i64 x : live) col_mark[x] = k;
    for (i64 j : live) {
      for (i64 e : col_elems[j]) {
        if (e == eid || !elem_alive[e] || elem_tested[e] == k) continue;
        elem_tested[e] = k;
        bool dominated = true;
        for (i64 x : elem_cols[e])
          if (col_alive[x] && col_mark[x] != k) {
            dominated = false;
            break;
          }
        if (dominated) {
          elem_alive[e] = 0;
          elem_cols[e].clear();
          elem_cols[e].shrink_to_fit();
        }
      }
    }
    // score update without rescanning the new element per member (the
    // |live|^2 term — the 3D-mesh pathology): it contributes
    // |live| - 1 to every member identically; only the OLD live
    // elements need the per-column walk.  The compaction keeps only
    // live elements (drops this step's absorbed AND dominated — both
    // dead now), then appends eid.
    const i64 base = (i64)live.size() - 1;
    for (i64 j : live) {
      keep.clear();
      for (i64 e : col_elems[j])
        if (elem_alive[e]) keep.push_back(e);
      keep.push_back(eid);
      col_elems[j].swap(keep);
      i64 s = base;
      for (i64 e : col_elems[j])
        if (e != eid && elem_alive[e]) s += (i64)elem_cols[e].size() - 1;
      score[j] = std::min<i64>(std::max<i64>(s, 0), n_cols - 1);
      heap.emplace(score[j], j);
    }
    ++k;
  }
  for (i64 j : dense_cols) order_out[k++] = j;
}

// ---------------------------------------------------------------------------
// Pattern of AᵀA (getata_dist analog, SRC/get_perm_c.c:164) for the
// MMD_ATA ordering: every row of A is a clique over its column support.
// Emits a symmetric adjacency (no diagonal) in CSR form.  Rows longer
// than dense_row are dropped (one dense row would produce an O(n²)
// clique; colamd applies the same pruning).  Single pass: the adjacency
// is built once and the index array allocated here — caller copies and
// releases it with slu_free_i64 (same protocol as slu_symbolic_mt).
// Returns total adjacency length.
// ---------------------------------------------------------------------------
i64 slu_ata_pattern(i64 n_rows, i64 n_cols, const i64* indptr,
                    const i64* indices, i64 dense_row,
                    i64* out_indptr, i64** out_indices) {
  HeapScope heap_scope;
  // append row-clique contributions, dedup each column amortized (when a
  // list grows past 4x its last compacted size) — linear appends instead
  // of the quadratic repeated set-union a popular column would pay, with
  // peak memory bounded at ~4x the final pattern instead of the raw
  // O(sum row_len^2) of append-everything
  std::vector<VSet> adj(n_cols);
  std::vector<i64> compacted(n_cols, 16);   // size floor before dedup
  auto compact = [&](i64 j) {
    VSet& a = adj[j];
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    compacted[j] = std::max<i64>((i64)a.size(), 16);
  };
  for (i64 r = 0; r < n_rows; ++r) {
    VSet cols(indices + indptr[r], indices + indptr[r + 1]);
    std::sort(cols.begin(), cols.end());
    cols.erase(std::unique(cols.begin(), cols.end()), cols.end());
    // dense test on the DEDUPED length — matches the Python oracle
    if ((i64)cols.size() <= 1
        || (dense_row > 0 && (i64)cols.size() > dense_row))
      continue;
    for (i64 j : cols) {
      for (i64 u : cols)
        if (u != j) adj[j].push_back(u);
      if ((i64)adj[j].size() > 4 * compacted[j]) compact(j);
    }
  }
  i64 total = 0;
  out_indptr[0] = 0;
  for (i64 j = 0; j < n_cols; ++j) {
    VSet& a = adj[j];
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    total += (i64)a.size();
    out_indptr[j + 1] = total;
  }
  i64* out = (i64*)std::malloc(std::max<i64>(total, 1) * sizeof(i64));
  for (i64 j = 0; j < n_cols; ++j)
    std::copy(adj[j].begin(), adj[j].end(), out + out_indptr[j]);
  *out_indices = out;
  return total;
}

// ---------------------------------------------------------------------------
// Approximate-weight perfect matching ("AWPM") — capability analog of the
// reference's CombBLAS HWPM path (d_c2cpp_GetHWPM.cpp, dHWPM_CombBLAS.hpp):
// a cheap, parallel-friendly alternative to exact MC64.  Greedy matching on
// weight-sorted edges, then max-cardinality augmentation (BFS alternating
// paths) to make it perfect.  Returns the permutation only (like HWPM — no
// scalings).  0 ok, 1 structurally singular.
// ---------------------------------------------------------------------------
int slu_awpm(i64 n, const i64* indptr, const i64* indices,
             const double* absval, i64* col_match_out) {
  i64 nnz = indptr[n];
  std::vector<i64> col_of(nnz);
  for (i64 j = 0; j < n; ++j)
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k) col_of[k] = j;
  // only finite positive weights participate (NaN fails `> 0.0` and would
  // otherwise break std::sort's strict-weak-ordering contract)
  std::vector<i64> order;
  order.reserve(nnz);
  for (i64 k = 0; k < nnz; ++k)
    if (absval[k] > 0.0) order.push_back(k);
  std::sort(order.begin(), order.end(),
            [&](i64 a, i64 b) { return absval[a] > absval[b]; });
  std::vector<i64> row_match(n, -1), col_match(n, -1);
  for (i64 k : order) {
    i64 i = indices[k], j = col_of[k];
    if (row_match[i] == -1 && col_match[j] == -1) {
      row_match[i] = j;
      col_match[j] = i;
    }
  }
  // perfect the matching: BFS alternating paths from each unmatched column
  // (explicit zeros are excluded, matching MC64's cost model — a zero
  // diagonal anchor would defeat the purpose of the row permutation)
  std::vector<i64> pred_row(n), queue_;
  std::vector<i64> stamp(n, -1);
  for (i64 j0 = 0; j0 < n; ++j0) {
    if (col_match[j0] != -1) continue;
    queue_.clear();
    queue_.push_back(j0);
    i64 found = -1;
    for (size_t qh = 0; qh < queue_.size() && found == -1; ++qh) {
      i64 j = queue_[qh];
      for (i64 k = indptr[j]; k < indptr[j + 1]; ++k) {
        i64 i = indices[k];
        if (!(absval[k] > 0.0) || stamp[i] == j0) continue;
        stamp[i] = j0;
        pred_row[i] = j;
        if (row_match[i] == -1) {
          found = i;
          break;
        }
        queue_.push_back(row_match[i]);
      }
    }
    if (found == -1) return 1;     // no perfect matching exists
    // backtrack: flip the alternating path (col_match[j] read before the
    // overwrite is the row displaced from j, which continues the path)
    i64 i = found;
    while (true) {
      i64 j = pred_row[i];
      i64 displaced = col_match[j];
      row_match[i] = j;
      col_match[j] = i;
      if (j == j0) break;
      i = displaced;
    }
  }
  for (i64 j = 0; j < n; ++j) col_match_out[j] = col_match[j];
  return 0;
}

// ---------------------------------------------------------------------------
// Multilevel nested dissection.
//
// Recursive: find a vertex separator of the (sub)graph via multilevel edge
// bisection (heavy-edge-matching coarsening, greedy-growing initial
// bisection, boundary-FM refinement) + vertex cover of the cut; order
// part A, part B recursively, separator last.  Leaves (<= leaf_size) are
// ordered by a local exact minimum-degree.
// ---------------------------------------------------------------------------

namespace {

struct Graph {
  i64 n;
  std::vector<i64> xadj, adj;   // CSR, no self loops
  std::vector<i64> vwgt, ewgt;  // vertex / edge weights
};

// Build coarse graph from matching map (cmap: fine vertex -> coarse id).
Graph coarsen(const Graph& g, const std::vector<i64>& cmap, i64 cn) {
  Graph c;
  c.n = cn;
  c.vwgt.assign(cn, 0);
  for (i64 v = 0; v < g.n; ++v) c.vwgt[cmap[v]] += g.vwgt[v];
  // bucket fine edges by coarse source, merge duplicates with a scratch map
  std::vector<std::vector<std::pair<i64, i64>>> nbr(cn);
  for (i64 v = 0; v < g.n; ++v) {
    i64 cv = cmap[v];
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 cu = cmap[g.adj[p]];
      if (cu != cv) nbr[cv].emplace_back(cu, g.ewgt[p]);
    }
  }
  c.xadj.assign(cn + 1, 0);
  std::vector<std::pair<i64, i64>> tmp;
  std::vector<std::vector<std::pair<i64, i64>>> merged(cn);
  for (i64 v = 0; v < cn; ++v) {
    auto& e = nbr[v];
    std::sort(e.begin(), e.end());
    tmp.clear();
    for (auto& [t, w] : e) {
      if (!tmp.empty() && tmp.back().first == t)
        tmp.back().second += w;
      else
        tmp.emplace_back(t, w);
    }
    merged[v] = tmp;
    c.xadj[v + 1] = c.xadj[v] + (i64)tmp.size();
  }
  c.adj.resize(c.xadj[cn]);
  c.ewgt.resize(c.xadj[cn]);
  for (i64 v = 0; v < cn; ++v) {
    i64 o = c.xadj[v];
    for (auto& [t, w] : merged[v]) {
      c.adj[o] = t;
      c.ewgt[o] = w;
      ++o;
    }
  }
  return c;
}

// Heavy-edge matching; returns coarse count, fills cmap.
i64 hem_match(const Graph& g, std::vector<i64>& cmap, std::mt19937_64& rng) {
  std::vector<i64> order(g.n);
  for (i64 i = 0; i < g.n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), rng);
  cmap.assign(g.n, -1);
  i64 cn = 0;
  for (i64 v : order) {
    if (cmap[v] != -1) continue;
    i64 best = -1, bw = -1;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 u = g.adj[p];
      if (cmap[u] == -1 && g.ewgt[p] > bw) {
        bw = g.ewgt[p];
        best = u;
      }
    }
    cmap[v] = cn;
    if (best != -1) cmap[best] = cn;
    ++cn;
  }
  return cn;
}

// Greedy graph-growing bisection: BFS-grow part 0 from seed to ~half weight.
void grow_bisect(const Graph& g, i64 seed, std::vector<char>& part) {
  i64 total = 0;
  for (i64 v = 0; v < g.n; ++v) total += g.vwgt[v];
  part.assign(g.n, 1);
  i64 w0 = 0;
  std::vector<i64> q{seed};
  std::vector<char> seen(g.n, 0);
  seen[seed] = 1;
  size_t head = 0;
  i64 scan = 0;  // monotone cursor for disconnected-graph pickup
  while (w0 * 2 < total) {
    i64 v;
    if (head < q.size()) {
      v = q[head++];
    } else {
      while (scan < g.n && seen[scan]) ++scan;
      if (scan == g.n) break;
      v = scan;
      seen[v] = 1;
      q.push_back(v);
      ++head;
    }
    part[v] = 0;
    w0 += g.vwgt[v];
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 u = g.adj[p];
      if (!seen[u]) {
        seen[u] = 1;
        q.push_back(u);
      }
    }
  }
}

i64 cut_of(const Graph& g, const std::vector<char>& part) {
  i64 cut = 0;
  for (i64 v = 0; v < g.n; ++v)
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
      if (part[v] != part[g.adj[p]]) cut += g.ewgt[p];
  return cut / 2;
}

// Boundary FM refinement (simplified): passes of greedy single-vertex moves
// with a tolerance on balance; stops when a pass improves nothing.
void fm_refine(const Graph& g, std::vector<char>& part, double balance_tol) {
  i64 total = 0;
  for (i64 v = 0; v < g.n; ++v) total += g.vwgt[v];
  i64 w[2] = {0, 0};
  for (i64 v = 0; v < g.n; ++v) w[part[v]] += g.vwgt[v];
  i64 maxside = (i64)(total * (0.5 + balance_tol));

  std::vector<i64> gain(g.n);
  auto compute_gain = [&](i64 v) {
    i64 ext = 0, in = 0;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      if (part[g.adj[p]] != part[v]) ext += g.ewgt[p];
      else in += g.ewgt[p];
    }
    return ext - in;
  };
  for (int pass = 0; pass < 8; ++pass) {
    // collect boundary vertices
    std::vector<i64> cand;
    for (i64 v = 0; v < g.n; ++v) {
      bool boundary = false;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1] && !boundary; ++p)
        boundary = part[g.adj[p]] != part[v];
      if (boundary) {
        gain[v] = compute_gain(v);
        cand.push_back(v);
      }
    }
    std::sort(cand.begin(), cand.end(),
              [&](i64 a, i64 b) { return gain[a] > gain[b]; });
    i64 moved = 0;
    for (i64 v : cand) {
      i64 from = part[v], to = 1 - from;
      if (w[to] + g.vwgt[v] > maxside) continue;
      i64 gv = compute_gain(v);  // recompute: neighbors may have moved
      if (gv <= 0) continue;
      part[v] = (char)to;
      w[from] -= g.vwgt[v];
      w[to] += g.vwgt[v];
      ++moved;
    }
    if (!moved) break;
  }
}

// Multilevel 2-way partition of g; fills part (0/1 per vertex).
void ml_bisect(const Graph& g0, std::vector<char>& part,
               std::mt19937_64& rng) {
  std::vector<Graph> levels;
  std::vector<std::vector<i64>> cmaps;
  levels.push_back(g0);
  while (levels.back().n > 160) {
    std::vector<i64> cmap;
    const Graph& f = levels.back();
    i64 cn = hem_match(f, cmap, rng);
    if (cn > (i64)(0.95 * f.n)) break;  // coarsening stalled
    Graph c = coarsen(f, cmap, cn);
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
  }
  // initial bisection at coarsest: best of a few grow seeds
  const Graph& c = levels.back();
  std::vector<char> best_part, cur;
  i64 best_cut = -1;
  std::uniform_int_distribution<i64> pick(0, c.n - 1);
  for (int t = 0; t < 4; ++t) {
    grow_bisect(c, pick(rng), cur);
    fm_refine(c, cur, 0.05);
    i64 cut = cut_of(c, cur);
    if (best_cut < 0 || cut < best_cut) {
      best_cut = cut;
      best_part = cur;
    }
  }
  part = best_part;
  // project back with FM refinement at each level
  for (i64 l = (i64)cmaps.size() - 1; l >= 0; --l) {
    const Graph& f = levels[l];
    std::vector<char> fpart(f.n);
    for (i64 v = 0; v < f.n; ++v) fpart[v] = part[cmaps[l][v]];
    fm_refine(f, fpart, 0.03);
    part = std::move(fpart);
  }
}

// Exact minimum-degree ordering of a small dense-ish subgraph (leaf).
// nodes: global ids; writes ordered global ids to out.
void leaf_md(const std::vector<i64>& nodes, const i64* indptr,
             const i64* indices, const std::vector<i64>& glob2loc,
             std::vector<i64>& out) {
  i64 k = (i64)nodes.size();
  if (k <= 2) {
    for (i64 v : nodes) out.push_back(v);
    return;
  }
  // local adjacency as bitsets over k (k <= ~256 so this is cheap)
  i64 words = (k + 63) / 64;
  std::vector<uint64_t> adj(k * words, 0);
  auto set_bit = [&](i64 r, i64 c) { adj[r * words + c / 64] |= 1ull << (c % 64); };
  auto test_bit = [&](i64 r, i64 c) {
    return (adj[r * words + c / 64] >> (c % 64)) & 1ull;
  };
  for (i64 li = 0; li < k; ++li) {
    i64 v = nodes[li];
    for (i64 p = indptr[v]; p < indptr[v + 1]; ++p) {
      i64 lj = glob2loc[indices[p]];
      if (lj >= 0 && lj != li) {
        set_bit(li, lj);
        set_bit(lj, li);
      }
    }
  }
  std::vector<char> elim(k, 0);
  std::vector<uint64_t> elim_mask(words, 0);  // bit set => eliminated
  for (i64 step = 0; step < k; ++step) {
    i64 best = -1, bestdeg = k + 1;
    for (i64 v = 0; v < k; ++v) {
      if (elim[v]) continue;
      i64 deg = 0;
      for (i64 w = 0; w < words; ++w) deg += __builtin_popcountll(adj[v * words + w]);
      if (deg < bestdeg) {
        bestdeg = deg;
        best = v;
      }
    }
    elim[best] = 1;
    elim_mask[best / 64] |= 1ull << (best % 64);
    out.push_back(nodes[best]);
    // eliminate: connect neighbors pairwise (union rows), mask out
    // eliminated vertices + self wordwise
    for (i64 u = 0; u < k; ++u) {
      if (elim[u] || !test_bit(u, best)) continue;
      for (i64 w = 0; w < words; ++w)
        adj[u * words + w] = (adj[u * words + w] | adj[best * words + w]) &
                             ~elim_mask[w];
      adj[u * words + u / 64] &= ~(1ull << (u % 64));
    }
  }
}

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// One nested-dissection task: emits the post-order [A..., B..., sep...]
// into `out`.  `glob2loc` is an n-sized scratch owned by this task's
// thread (every entry it writes is restored to -1 before returning or
// recursing into a spawned sibling).  While depth < spawn_depth the A
// branch runs on a freshly spawned std::thread with its own scratch —
// the subtree-to-thread mapping that makes this the ParMETIS-analog
// parallel ordering (reference get_perm_c_parmetis.c:104,255: separator
// tree computed by 2^q processes).
void mlnd_rec(i64 n, const i64* indptr, const i64* indices, i64 leaf_size,
              std::vector<i64> nodes, uint64_t seed, i64 spawn_depth,
              i64 depth, std::vector<i64>& glob2loc, std::vector<i64>& out) {
  std::mt19937_64 rng(splitmix64(seed));
  if ((i64)nodes.size() <= leaf_size) {
    for (i64 li = 0; li < (i64)nodes.size(); ++li) glob2loc[nodes[li]] = li;
    leaf_md(nodes, indptr, indices, glob2loc, out);
    for (i64 v : nodes) glob2loc[v] = -1;
    return;
  }
  // build local subgraph — scoped so the O(edges) Graph and all bisection
  // scratch are destroyed BEFORE the recursion (a recursion path must hold
  // only its own partition lists, not every ancestor's subgraph, or memory
  // grows to O(E·depth) at the n≈1M target class)
  std::vector<i64> a_part, b_part, sep;
  {
    Graph g;
    g.n = (i64)nodes.size();
    for (i64 li = 0; li < g.n; ++li) glob2loc[nodes[li]] = li;
    g.xadj.assign(g.n + 1, 0);
    for (i64 li = 0; li < g.n; ++li) {
      i64 v = nodes[li];
      i64 deg = 0;
      for (i64 p = indptr[v]; p < indptr[v + 1]; ++p) {
        i64 lj = glob2loc[indices[p]];
        if (lj >= 0 && lj != li) ++deg;
      }
      g.xadj[li + 1] = g.xadj[li] + deg;
    }
    g.adj.resize(g.xadj[g.n]);
    g.ewgt.assign(g.xadj[g.n], 1);
    g.vwgt.assign(g.n, 1);
    for (i64 li = 0; li < g.n; ++li) {
      i64 v = nodes[li], o = g.xadj[li];
      for (i64 p = indptr[v]; p < indptr[v + 1]; ++p) {
        i64 lj = glob2loc[indices[p]];
        if (lj >= 0 && lj != li) g.adj[o++] = lj;
      }
    }
    std::vector<char> part;
    ml_bisect(g, part, rng);
    // vertex separator from the edge cut: greedy cover — move to the
    // separator the endpoint covering the most uncovered cut edges
    std::vector<char> insep(g.n, 0);
    std::vector<i64> cutdeg(g.n, 0);
    for (i64 v = 0; v < g.n; ++v)
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
        if (part[g.adj[p]] != part[v]) ++cutdeg[v];
    std::vector<i64> by_cut;
    for (i64 v = 0; v < g.n; ++v)
      if (cutdeg[v] > 0) by_cut.push_back(v);
    std::sort(by_cut.begin(), by_cut.end(),
              [&](i64 a, i64 b) { return cutdeg[a] > cutdeg[b]; });
    for (i64 v : by_cut) {
      if (cutdeg[v] <= 0) continue;
      bool uncovered = false;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1] && !uncovered; ++p) {
        i64 u = g.adj[p];
        uncovered = part[u] != part[v] && !insep[u];
      }
      if (!uncovered) continue;
      insep[v] = 1;
    }
    for (i64 v = 0; v < g.n; ++v) {
      if (insep[v])
        sep.push_back(nodes[v]);
      else if (part[v] == 0)
        a_part.push_back(nodes[v]);
      else
        b_part.push_back(nodes[v]);
    }
    for (i64 li = 0; li < g.n; ++li) glob2loc[nodes[li]] = -1;
  }
  // degenerate split (e.g. clique): local MD on the blob when the
  // bitset cost (k^2/8 bytes) is affordable, natural order otherwise
  if (a_part.empty() || b_part.empty()) {
    std::sort(nodes.begin(), nodes.end());
    if ((i64)nodes.size() <= 2048) {
      for (i64 li = 0; li < (i64)nodes.size(); ++li)
        glob2loc[nodes[li]] = li;
      leaf_md(nodes, indptr, indices, glob2loc, out);
      for (i64 v : nodes) glob2loc[v] = -1;
    } else {
      for (i64 v : nodes) out.push_back(v);
    }
    return;
  }
  nodes.clear();
  nodes.shrink_to_fit();
  uint64_t sa = splitmix64(seed * 2 + 1), sb = splitmix64(seed * 2 + 2);
  if (depth < spawn_depth) {
    std::vector<i64> a_out, b_out;
    std::thread t([&, sa]() {
      std::vector<i64> scratch(n, -1);
      mlnd_rec(n, indptr, indices, leaf_size, std::move(a_part), sa,
               spawn_depth, depth + 1, scratch, a_out);
    });
    mlnd_rec(n, indptr, indices, leaf_size, std::move(b_part), sb,
             spawn_depth, depth + 1, glob2loc, b_out);
    t.join();
    out.insert(out.end(), a_out.begin(), a_out.end());
    out.insert(out.end(), b_out.begin(), b_out.end());
  } else {
    mlnd_rec(n, indptr, indices, leaf_size, std::move(a_part), sa,
             spawn_depth, depth + 1, glob2loc, out);
    mlnd_rec(n, indptr, indices, leaf_size, std::move(b_part), sb,
             spawn_depth, depth + 1, glob2loc, out);
  }
  out.insert(out.end(), sep.begin(), sep.end());
}

}  // namespace

void slu_mlnd_mt(i64 n, const i64* indptr, const i64* indices,
                 i64 leaf_size, uint64_t seed, i64 nthreads,
                 i64* order_out) {
  HeapScope heap_scope;
  // spawn_depth d gives up to 2^d concurrent subtree tasks (plus the
  // separator work in their ancestors) — the subtree-to-process mapping
  // of the reference's parallel ordering (get_perm_c_parmetis.c:255)
  i64 hc = (i64)std::thread::hardware_concurrency();
  if (hc <= 0) hc = 1;
  if (nthreads > hc) nthreads = hc;   // oversubscription only wastes
  if (nthreads < 1) nthreads = 1;     // scratch memory; a huge env value
                                      // must not exhaust pthreads
  i64 spawn_depth = 0;
  while ((1ll << spawn_depth) < nthreads) ++spawn_depth;
  std::vector<i64> all(n);
  for (i64 i = 0; i < n; ++i) all[i] = i;
  std::vector<i64> glob2loc(n, -1);
  std::vector<i64> out;
  out.reserve(n);
  mlnd_rec(n, indptr, indices, leaf_size, std::move(all), seed,
           spawn_depth, 0, glob2loc, out);
  for (i64 i = 0; i < (i64)out.size() && i < n; ++i) order_out[i] = out[i];
}

void slu_mlnd(i64 n, const i64* indptr, const i64* indices, i64 leaf_size,
              uint64_t seed, i64* order_out) {
  slu_mlnd_mt(n, indptr, indices, leaf_size, seed, 1, order_out);
}

// ---------------------------------------------------------------------------
// Async tree broadcast / reduction over shared memory — capability analog
// of the reference's C++11 tree-collective engine (TreeBcast_slu.hpp,
// TreeReduce_slu.hpp, TreeInterface.cpp) that drives the distributed
// triangular solve.  Same topology rule: flat tree up to 8 ranks, binary
// beyond (TreeBcast_slu.hpp:17-29).  The reference's transport is MPI
// point-to-point; this host runtime uses a POSIX shared-memory segment
// with per-rank sequence/ack counters — single-node multi-process
// orchestration (parallel/treecomm.py), the host tier of the port's
// distributed driver (parallel/pgssvx.py).
//
// Layout of the segment: header {n_ranks, max_len}, then per rank:
//   seq  (atomic u64): last operation index this rank has published
//   ack  (atomic u64): cumulative count of child reads of this rank's slot
//   buf  (max_len doubles)
// Each collective call site must be reached by every rank in the same
// order (the usual collective contract); op indices are tracked per
// attached handle.
// ---------------------------------------------------------------------------
}  // extern "C"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace slu_tree {

struct RankSlot {
  std::atomic<uint64_t> seq;
  std::atomic<uint64_t> ack;
  // failure-detector slots: hb is a heartbeat epoch bumped by
  // the owner's heartbeat thread; pid is the owning process, polled by
  // peers with kill(pid, 0) so death is detected even when the
  // heartbeat thread died WITH the process.  Both are pure telemetry —
  // the collective protocol never reads them.
  std::atomic<uint64_t> hb;
  std::atomic<int64_t> pid;
};

struct Header {
  i64 n_ranks;
  i64 max_len;
  std::atomic<uint64_t> ready;   // == kReadyMagic once fully initialized
};

constexpr uint64_t kReadyMagic = 0x51b17ee5c0113c7ull;

struct Handle {
  Header* hdr = nullptr;
  RankSlot* slots = nullptr;   // n_ranks
  double* bufs = nullptr;      // n_ranks * max_len
  i64 rank = -1;
  uint64_t op = 0;             // shared across bcast+reduce: every rank
                               // reaches the collectives in the same order
  uint64_t my_reads = 0;       // total reads ever promised on my slot
  size_t map_len = 0;
  void* base = nullptr;
};

inline size_t seg_size(i64 n_ranks, i64 max_len) {
  return sizeof(Header) + (size_t)n_ranks * sizeof(RankSlot)
         + (size_t)n_ranks * (size_t)max_len * sizeof(double);
}

// flat <= 8 ranks (every rank a direct child of the root), binary above —
// expressed on the root-relative virtual rank v = (rank - root) mod n
inline i64 parent_of(i64 v, i64 n) {
  if (v == 0) return -1;
  if (n <= 8) return 0;
  return (v - 1) / 2;
}

inline void children_of(i64 v, i64 n, i64* out, i64* n_out) {
  *n_out = 0;
  if (n <= 8) {
    if (v == 0)
      for (i64 c = 1; c < n; ++c) out[(*n_out)++] = c;
    return;
  }
  for (i64 c = 2 * v + 1; c <= 2 * v + 2 && c < n; ++c)
    out[(*n_out)++] = c;
}

inline void backoff(int& spins) {
  if (++spins < 1024) return;
  ::usleep(50);
}

inline double mono_now() {
  struct timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// Bounded spin-wait: a short hot-spin phase, then exponential-backoff
// sleeps with jitter (decorrelates the ranks of a big tree hammering
// the same cache lines) up to a monotonic deadline.  deadline <= 0
// means unbounded — the legacy behavior of the untimed entry points.
struct TimedWait {
  double deadline;
  int spins = 0;
  useconds_t slp = 50;
  uint64_t rng;
  explicit TimedWait(double dl, uint64_t seed)
      : deadline(dl), rng(seed * 2654435769ull + 1) {}
  bool step() {
    if (++spins < 512) return true;
    if (deadline > 0 && mono_now() >= deadline) return false;
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    useconds_t j = (useconds_t)((rng >> 33) % (uint64_t)(slp / 2 + 1));
    ::usleep(slp / 2 + j);
    if (slp < 4000) slp <<= 1;
    return true;
  }
};

}  // namespace slu_tree

extern "C" {

void* slu_tree_attach(const char* name, i64 n_ranks, i64 max_len,
                      i64 rank, i64 create) {
  using namespace slu_tree;
  size_t len = seg_size(n_ranks, max_len);
  int fd;
  if (create) {
    // a stale segment from a crashed run still carries ready==magic and
    // old seq/ack values — unlink first and create exclusively, so
    // attachers genuinely wait for THIS creator's initialization
    ::shm_unlink(name);
    fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  } else {
    fd = ::shm_open(name, O_RDWR, 0600);
  }
  if (fd < 0) return nullptr;
  if (create) {
    if (::ftruncate(fd, (off_t)len) != 0) {
      ::close(fd);
      return nullptr;
    }
  } else {
    // creator may still be between shm_open and ftruncate: mapping a
    // zero-length segment SIGBUSes on first touch.  Wait (bounded) for
    // the segment to reach full size.
    struct stat st;
    int tries = 0;
    while (::fstat(fd, &st) == 0 && (size_t)st.st_size < len) {
      if (++tries > 100000) {       // ~10 s
        ::close(fd);
        return nullptr;
      }
      ::usleep(100);
    }
  }
  void* base = ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED,
                      fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* h = new Handle;
  h->base = base;
  h->map_len = len;
  h->hdr = (Header*)base;
  h->slots = (RankSlot*)((char*)base + sizeof(Header));
  h->bufs = (double*)((char*)base + sizeof(Header)
                      + (size_t)n_ranks * sizeof(RankSlot));
  h->rank = rank;
  if (create) {
    h->hdr->n_ranks = n_ranks;
    h->hdr->max_len = max_len;
    for (i64 r = 0; r < n_ranks; ++r) {
      h->slots[r].seq.store(0, std::memory_order_relaxed);
      h->slots[r].ack.store(0, std::memory_order_relaxed);
    }
    h->hdr->ready.store(kReadyMagic, std::memory_order_release);
  } else {
    // size alone is not enough: the creator may be preempted between
    // ftruncate and the header stores — wait for the ready flag
    int tries = 0;
    while (h->hdr->ready.load(std::memory_order_acquire) != kReadyMagic) {
      if (++tries > 100000) {       // ~10 s
        ::munmap(base, len);
        delete h;
        return nullptr;
      }
      ::usleep(100);
    }
  }
  return h;
}

void slu_tree_detach(void* vh, const char* name, i64 unlink_seg) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  if (!h) return;
  if (h->base) ::munmap(h->base, h->map_len);
  if (unlink_seg) ::shm_unlink(name);
  delete h;
}

// In-process rank handle SHARING the creator's mapping (same virtual
// addresses).  Two uses: threads standing in for ranks, and sanitizer
// runs — TSAN's shadow memory is keyed by virtual address, so races in
// the collective protocol are only visible when all "ranks" touch the
// segment through one mapping.  The returned handle must be detached
// with a null name and unlink_seg=0; it does not own the mapping.
void* slu_tree_attach_shared(void* creator_handle, i64 rank) {
  using namespace slu_tree;
  auto* c = (Handle*)creator_handle;
  if (!c) return nullptr;
  auto* h = new Handle;
  h->hdr = c->hdr;
  h->slots = c->slots;
  h->bufs = c->bufs;
  h->rank = rank;
  h->map_len = 0;
  h->base = nullptr;   // not owned: detach skips munmap
  return h;
}

// Broadcast buf (len doubles) from root to all ranks.  Every rank calls
// with its own buf; non-roots receive into it.  Publish protocol: before
// overwriting my slot I wait until every read promised by my PREVIOUS
// publishes has been acked (cumulative counter), so a slow child can
// still be copying op t while the tree races ahead to t+1 elsewhere.
//
// Timed variant (bounded wait): EVERY wait runs under one
// monotonic deadline with exponential backoff + jitter; all waits
// complete BEFORE any mutation (op bump, memcpy, ack, publish), so a
// timeout is perfectly resumable — the caller consults the failure
// detector and either retries this very op or raises.  Returns 0 on
// success; on timeout, 1 + the rank being waited on, or 1 + n_ranks
// when the stuck party is an unidentified child (cumulative ack drain).
// timeout_s <= 0 waits forever (the legacy untimed behavior).
i64 slu_tree_bcast_tw(void* vh, i64 root, double* buf, i64 len,
                      double timeout_s) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  i64 n = h->hdr->n_ranks;
  uint64_t op = h->op + 1;
  if (n == 1) {
    h->op = op;
    return 0;
  }
  root = ((root % n) + n) % n;   // normalize (root=-1 idiom, bad input)
  i64 v = (h->rank - root + n) % n;
  i64 kids[8];
  i64 n_kids = 0;
  children_of(v, n, kids, &n_kids);
  RankSlot& mine = h->slots[h->rank];
  double* my_buf = h->bufs + (size_t)h->rank * h->hdr->max_len;
  double dl = timeout_s > 0 ? mono_now() + timeout_s : 0.0;
  TimedWait w(dl, (uint64_t)h->rank * 0x9e3779b9u + op);
  // ---- wait phase (side-effect free) ---------------------------------
  if (n_kids) {
    while (mine.ack.load(std::memory_order_acquire) < h->my_reads)
      if (!w.step()) return 1 + n;
  }
  i64 p_rank = -1;
  if (v != 0) {
    p_rank = (parent_of(v, n) + root) % n;
    RankSlot& ps = h->slots[p_rank];
    while (ps.seq.load(std::memory_order_acquire) < op)
      if (!w.step()) return 1 + p_rank;
  }
  // ---- commit phase --------------------------------------------------
  h->op = op;
  if (v != 0) {
    RankSlot& ps = h->slots[p_rank];
    std::memcpy(buf, h->bufs + (size_t)p_rank * h->hdr->max_len,
                (size_t)len * sizeof(double));
    ps.ack.fetch_add(1, std::memory_order_acq_rel);
  }
  if (n_kids) {
    std::memcpy(my_buf, buf, (size_t)len * sizeof(double));
    mine.seq.store(op, std::memory_order_release);
    h->my_reads += (uint64_t)n_kids;
  }
  return 0;
}

void slu_tree_bcast(void* vh, i64 root, double* buf, i64 len) {
  slu_tree_bcast_tw(vh, root, buf, len, 0.0);
}

// Sum-reduce buf (len doubles) onto the root: on return the root's buf
// holds the elementwise sum of every rank's input; other ranks' bufs are
// clobbered with their subtree partial.  Timed contract identical to
// slu_tree_bcast_tw: all waits (children present AND my previous
// publishes acked) precede the first mutation — in particular the
// child-partial accumulation into buf — so a timeout never leaves a
// half-summed buffer behind.
i64 slu_tree_reduce_sum_tw(void* vh, i64 root, double* buf, i64 len,
                           double timeout_s) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  i64 n = h->hdr->n_ranks;
  uint64_t op = h->op + 1;
  if (n == 1) {
    h->op = op;
    return 0;
  }
  root = ((root % n) + n) % n;   // normalize (root=-1 idiom, bad input)
  i64 v = (h->rank - root + n) % n;
  i64 kids[8];
  i64 n_kids = 0;
  children_of(v, n, kids, &n_kids);
  RankSlot& mine = h->slots[h->rank];
  double* my_buf = h->bufs + (size_t)h->rank * h->hdr->max_len;
  double dl = timeout_s > 0 ? mono_now() + timeout_s : 0.0;
  TimedWait w(dl, (uint64_t)h->rank * 0x9e3779b9u + op);
  // ---- wait phase (side-effect free) ---------------------------------
  for (i64 c = 0; c < n_kids; ++c) {
    i64 c_rank = (kids[c] + root) % n;
    RankSlot& cs = h->slots[c_rank];
    while (cs.seq.load(std::memory_order_acquire) < op)
      if (!w.step()) return 1 + c_rank;
  }
  if (v != 0) {
    while (mine.ack.load(std::memory_order_acquire) < h->my_reads)
      if (!w.step()) return 1 + n;
  }
  // ---- commit phase --------------------------------------------------
  h->op = op;
  for (i64 c = 0; c < n_kids; ++c) {
    i64 c_rank = (kids[c] + root) % n;
    RankSlot& cs = h->slots[c_rank];
    const double* cb = h->bufs + (size_t)c_rank * h->hdr->max_len;
    for (i64 i = 0; i < len; ++i) buf[i] += cb[i];
    cs.ack.fetch_add(1, std::memory_order_acq_rel);
  }
  if (v != 0) {                 // publish subtree partial for my parent
    std::memcpy(my_buf, buf, (size_t)len * sizeof(double));
    mine.seq.store(op, std::memory_order_release);
    h->my_reads += 1;
  }
  return 0;
}

void slu_tree_reduce_sum(void* vh, i64 root, double* buf, i64 len) {
  slu_tree_reduce_sum_tw(vh, root, buf, len, 0.0);
}

// ---------------------------------------------------------------------------
// Failure-detector surface.  pid + heartbeat live in the
// RankSlot of the COLLECTIVE domain; the post/peek pair implements the
// wait-free bulletin board of the sibling ".ftx" agreement domain —
// each rank writes only its OWN slot (seqlock versioning via the seq
// counter, which the board domain never uses for collectives), peers
// poll, and nothing ever blocks on a dead rank.
// ---------------------------------------------------------------------------

void slu_tree_set_pid(void* vh, i64 pid) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  h->slots[h->rank].pid.store(pid, std::memory_order_release);
}

i64 slu_tree_get_pid(void* vh, i64 rank) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  return h->slots[rank].pid.load(std::memory_order_acquire);
}

void slu_tree_heartbeat(void* vh) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  h->slots[h->rank].hb.fetch_add(1, std::memory_order_acq_rel);
}

i64 slu_tree_get_heartbeat(void* vh, i64 rank) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  return (i64)h->slots[rank].hb.load(std::memory_order_acquire);
}

// The seqlock payload is copied element-wise through relaxed atomic
// u64 accesses (bit patterns of the doubles): a reader's speculative
// copy RACES the writer's store by design — the version check discards
// torn snapshots — but with plain loads that race is undefined
// behavior and a true ThreadSanitizer report (the classic seqlock
// pitfall).  Atomic accesses make the race defined (any value may be
// read; the seq re-check rejects inconsistent ones) and keep a
// ThreadSanitizer run meaningful for the REAL protocol bugs.  BOARD_LEN is 4 doubles — the per-element cost is noise.
static_assert(sizeof(double) == sizeof(uint64_t), "seqlock payload");

static inline void seqlock_store(double* dst, const double* src, i64 len) {
  auto* d = reinterpret_cast<std::atomic<uint64_t>*>(dst);
  for (i64 i = 0; i < len; ++i) {
    uint64_t bits;
    std::memcpy(&bits, src + i, sizeof bits);
    d[i].store(bits, std::memory_order_relaxed);
  }
}

static inline void seqlock_load(double* dst, const double* src, i64 len) {
  auto* s = reinterpret_cast<const std::atomic<uint64_t>*>(src);
  for (i64 i = 0; i < len; ++i) {
    uint64_t bits = s[i].load(std::memory_order_relaxed);
    std::memcpy(dst + i, &bits, sizeof bits);
  }
}

// Publish len doubles into my board slot.  Odd seq = write in progress,
// even = committed; returns the committed version (>= 2).
i64 slu_tree_post(void* vh, double* buf, i64 len) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  RankSlot& mine = h->slots[h->rank];
  double* my_buf = h->bufs + (size_t)h->rank * h->hdr->max_len;
  uint64_t s = mine.seq.load(std::memory_order_relaxed) & ~1ull;
  mine.seq.store(s + 1, std::memory_order_release);
  std::atomic_thread_fence(std::memory_order_release);
  seqlock_store(my_buf, buf, len);
  mine.seq.store(s + 2, std::memory_order_release);
  return (i64)(s + 2);
}

// Read rank's board slot into out.  Returns the committed version read
// (0 = never posted, -1 = could not get a consistent snapshot — e.g.
// the writer died mid-post; callers treat both as "no data").
i64 slu_tree_peek(void* vh, i64 rank, double* out, i64 len) {
  using namespace slu_tree;
  auto* h = (Handle*)vh;
  RankSlot& rs = h->slots[rank];
  const double* rb = h->bufs + (size_t)rank * h->hdr->max_len;
  for (int tries = 0; tries < 200; ++tries) {
    uint64_t s1 = rs.seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;
    if (s1 & 1) {
      ::usleep(20);
      continue;
    }
    seqlock_load(out, rb, len);
    std::atomic_thread_fence(std::memory_order_acquire);
    if (rs.seq.load(std::memory_order_acquire) == s1) return (i64)s1;
  }
  return -1;
}

}  // extern "C"
