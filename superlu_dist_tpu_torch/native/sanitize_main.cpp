// Sanitizer harness for the threaded native paths of the port's host
// library (superlu_dist_tpu_torch/native/slu_host.cpp).
//
// The reference has no race detection (SURVEY.md §5: "The new framework
// should add TSAN/ASAN CI instead") — this is that CI hook.  Built by
// tests/test_torch_sanitize.py and scripts/check_tsan_native_torch.sh
// with -fsanitize=thread (and again with =address) against the port's
// slu_host.cpp, it drives every code path that shares memory across
// threads or processes:
//   * slu_symbolic_mt  — subtree-range threaded symbolic factorization
//   * slu_mlnd_mt      — subtree-threaded multilevel nested dissection
//   * slu_tree_*       — shared-memory tree collectives (threads stand in
//                        for the ranks; the protocol is the same atomics),
//                        with the failure detector's heartbeat / pid
//                        atomics and the bulletin-board seqlock
// Exit code 0 + no sanitizer report = pass.
//
// Build: g++ -O1 -g -fsanitize=thread -std=c++17 -pthread \
//            sanitize_main.cpp slu_host.cpp -o sanitize_tsan

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using i64 = int64_t;

extern "C" {
i64 slu_symbolic_mt(i64 n, const i64* indptr, const i64* indices,
                    const i64* parent, i64 relax, i64 max_supernode,
                    i64 nthreads, i64* sn_start, i64* col_to_sn,
                    i64* sn_parent, i64* sn_level, i64* rows_ptr,
                    i64** rows_data);
void slu_etree(i64 n, const i64* indptr, const i64* indices, i64* parent);
void slu_postorder(i64 n, const i64* parent, i64* post);
void slu_free_i64(i64* p);
void slu_mlnd_mt(i64 n, const i64* indptr, const i64* indices,
                 i64 leaf_size, uint64_t seed, i64 nthreads, i64* order);
void* slu_tree_attach(const char* name, i64 n_ranks, i64 max_len, i64 rank,
                      i64 create);
void* slu_tree_attach_shared(void* creator_handle, i64 rank);
void slu_tree_detach(void* h, const char* name, i64 unlink_seg);
void slu_tree_bcast(void* h, i64 root, double* buf, i64 len);
void slu_tree_reduce_sum(void* h, i64 root, double* buf, i64 len);
void slu_tree_set_pid(void* h, i64 pid);
i64 slu_tree_get_pid(void* h, i64 rank);
void slu_tree_heartbeat(void* h);
i64 slu_tree_get_heartbeat(void* h, i64 rank);
i64 slu_tree_post(void* h, double* buf, i64 len);
i64 slu_tree_peek(void* h, i64 rank, double* out, i64 len);
}

// 2-D 5-point Poisson pattern (symmetrized, with diagonal), CSR
static void poisson2d(i64 g, std::vector<i64>& indptr,
                      std::vector<i64>& indices) {
  i64 n = g * g;
  indptr.assign(n + 1, 0);
  indices.clear();
  for (i64 i = 0; i < g; ++i)
    for (i64 j = 0; j < g; ++j) {
      i64 v = i * g + j;
      if (i > 0) indices.push_back(v - g);
      if (j > 0) indices.push_back(v - 1);
      indices.push_back(v);
      if (j + 1 < g) indices.push_back(v + 1);
      if (i + 1 < g) indices.push_back(v + g);
      indptr[v + 1] = (i64)indices.size();
    }
}

static int check_perm(const std::vector<i64>& p, i64 n, const char* what) {
  std::vector<char> seen(n, 0);
  for (i64 v : p) {
    if (v < 0 || v >= n || seen[v]) {
      std::fprintf(stderr, "FAIL: %s not a permutation\n", what);
      return 1;
    }
    seen[v] = 1;
  }
  return 0;
}

int main() {
  int rc = 0;
  std::vector<i64> indptr, indices;
  poisson2d(40, indptr, indices);     // n = 1600
  i64 n = (i64)indptr.size() - 1;

  // threaded ND, serial vs 4 threads must agree (determinism contract)
  std::vector<i64> o1(n), o4(n);
  slu_mlnd_mt(n, indptr.data(), indices.data(), 64, 1, 1, o1.data());
  slu_mlnd_mt(n, indptr.data(), indices.data(), 64, 1, 4, o4.data());
  rc |= check_perm(o4, n, "mlnd_mt");
  if (std::memcmp(o1.data(), o4.data(), n * sizeof(i64)) != 0) {
    std::fprintf(stderr, "FAIL: mlnd nthreads changed the ordering\n");
    rc |= 1;
  }

  // threaded symbolic on the ND-ordered pattern
  {
    // permute pattern by o4 (build CSR of P A P^T)
    std::vector<i64> inv(n);
    for (i64 k = 0; k < n; ++k) inv[o4[k]] = k;
    std::vector<std::vector<i64>> rows(n);
    for (i64 i = 0; i < n; ++i)
      for (i64 p = indptr[i]; p < indptr[i + 1]; ++p)
        rows[inv[i]].push_back(inv[indices[p]]);
    std::vector<i64> pp(n + 1, 0), pi;
    for (i64 i = 0; i < n; ++i) {
      for (i64 j : rows[i]) pi.push_back(j);
      pp[i + 1] = (i64)pi.size();
    }
    std::vector<i64> parent(n), post(n);
    slu_etree(n, pp.data(), pi.data(), parent.data());
    slu_postorder(n, parent.data(), post.data());
    // postorder-permute once more so labels are postordered
    std::vector<i64> inv2(n);
    for (i64 k = 0; k < n; ++k) inv2[post[k]] = k;
    std::vector<std::vector<i64>> rows2(n);
    for (i64 i = 0; i < n; ++i)
      for (i64 p = pp[i]; p < pp[i + 1]; ++p)
        rows2[inv2[i]].push_back(inv2[pi[p]]);
    std::vector<i64> qp(n + 1, 0), qi;
    for (i64 i = 0; i < n; ++i) {
      for (i64 j : rows2[i]) qi.push_back(j);
      qp[i + 1] = (i64)qi.size();
    }
    std::vector<i64> parent2(n);
    slu_etree(n, qp.data(), qi.data(), parent2.data());
    std::vector<i64> sn_start(n + 1), col_to_sn(n), sn_parent(n),
        sn_level(n), rows_ptr(n + 1);
    std::vector<i64> ref_c2s;
    std::vector<i64> ref_rows;
    for (i64 t : {1, 4}) {
      i64* rows_data = nullptr;
      i64 ns = slu_symbolic_mt(n, qp.data(), qi.data(), parent2.data(),
                               8, 64, t, sn_start.data(), col_to_sn.data(),
                               sn_parent.data(), sn_level.data(),
                               rows_ptr.data(), &rows_data);
      if (ns <= 0) {
        std::fprintf(stderr, "FAIL: symbolic_mt(t=%ld) ns=%ld\n",
                     (long)t, (long)ns);
        rc |= 1;
        slu_free_i64(rows_data);
        continue;
      }
      // per-column fill must be identical across thread counts (the
      // Python-level contract; chain merges may differ at boundaries,
      // so compare the per-column supernode ROW structures' footprint:
      // total row-list length and the col_to_sn-induced fill per column)
      std::vector<i64> rows_copy(rows_data, rows_data + rows_ptr[ns]);
      if (t == 1) {
        ref_c2s.assign(col_to_sn.begin(), col_to_sn.end());
        ref_rows = rows_copy;
      } else if (ref_c2s == std::vector<i64>(col_to_sn.begin(),
                                             col_to_sn.end())
                 && ref_rows != rows_copy) {
        // same partition but different row structures => real bug
        std::fprintf(stderr, "FAIL: symbolic_mt t=4 row structures "
                             "differ from t=1 on same partition\n");
        rc |= 1;
      }
      slu_free_i64(rows_data);
    }
  }

  // tree collectives: 6 threads as ranks (flat) then 12 (binary)
  for (i64 nr : {6, 12}) {
    char name[64];
    std::snprintf(name, sizeof name, "/slu_tsan_%d_%ld", getpid(),
                  (long)nr);
    void* root_h = slu_tree_attach(name, nr, 64, 0, 1);
    if (!root_h) {
      std::fprintf(stderr, "FAIL: tree attach (creator)\n");
      return rc | 1;
    }
    std::vector<std::thread> ts;
    std::vector<double> results(nr, 0.0);
    std::vector<char> attach_fail(nr, 0);
    for (i64 r = 1; r < nr; ++r)
      ts.emplace_back([&, r]() {
        // share the creator's mapping: TSAN shadow state is keyed by
        // virtual address, so per-thread mmaps of the same segment
        // would hide every race from it
        void* h = slu_tree_attach_shared(root_h, r);
        if (!h) {
          attach_fail[r] = 1;
          return;
        }
        double buf[8];
        for (int i = 0; i < 8; ++i) buf[i] = (double)r;
        slu_tree_bcast(h, 0, buf, 8);
        double acc[8];
        for (int i = 0; i < 8; ++i) acc[i] = 1.0;
        slu_tree_reduce_sum(h, 0, acc, 8);
        results[r] = buf[0];
        slu_tree_detach(h, nullptr, 0);
      });
    double buf[8] = {42, 42, 42, 42, 42, 42, 42, 42};
    slu_tree_bcast(root_h, 0, buf, 8);
    double acc[8];
    for (int i = 0; i < 8; ++i) acc[i] = 1.0;
    slu_tree_reduce_sum(root_h, 0, acc, 8);
    for (auto& t : ts) t.join();
    slu_tree_detach(root_h, name, 1);
    for (i64 r = 1; r < nr; ++r)
      if (attach_fail[r]) {
        std::fprintf(stderr, "FAIL: attach_shared rank %ld\n", (long)r);
        rc |= 1;
      }
    for (i64 r = 1; r < nr; ++r)
      if (results[r] != 42.0) {
        std::fprintf(stderr, "FAIL: bcast payload rank %ld\n", (long)r);
        rc |= 1;
      }
    if (acc[0] != (double)nr) {
      std::fprintf(stderr, "FAIL: reduce total %f != %ld\n", acc[0],
                   (long)nr);
      rc |= 1;
    }
  }

  // ---- heartbeat / bulletin-board / seqlock stress ----------------------
  // The failure-detector surface (pid + heartbeat atomics in the
  // collective domain, wait-free post/peek seqlock on the .ftx board)
  // had never been raced ON PURPOSE: Python-level analysis cannot see
  // these atomics at all, so this is the one component whose
  // thread-safety only a sanitizer run can certify.  8 threads as
  // ranks, every rank concurrently: bumping its heartbeat, re-posting
  // a monotonically-versioned 4-double record into its own board slot,
  // and peeking every peer — asserting each snapshot is INTERNALLY
  // CONSISTENT (all four doubles carry the same value; a torn read the
  // seqlock failed to reject would mix versions).
  {
    const i64 nr = 8, kIters = 400;
    char name[64];
    std::snprintf(name, sizeof name, "/slu_tsan_ftx_%d", getpid());
    void* root_h = slu_tree_attach(name, nr, 8, 0, 1);
    if (!root_h) {
      std::fprintf(stderr, "FAIL: ftx stress attach (creator)\n");
      return rc | 1;
    }
    std::vector<char> fail(nr, 0);
    auto body = [&](void* h, i64 r) {
      slu_tree_set_pid(h, (i64)getpid() + r);
      double rec[4], got[4];
      for (i64 it = 1; it <= kIters; ++it) {
        double v = (double)(r * 1000000 + it);
        for (int j = 0; j < 4; ++j) rec[j] = v;
        slu_tree_post(h, rec, 4);
        slu_tree_heartbeat(h);
        i64 peer = (r + it) % nr;
        i64 ver = slu_tree_peek(h, peer, got, 4);
        if (ver > 0 &&
            (got[0] != got[1] || got[0] != got[2] || got[0] != got[3])) {
          fail[r] = 1;   // torn snapshot slipped past the seqlock
          return;
        }
        if (slu_tree_get_pid(h, peer) < 0) fail[r] = 1;
        (void)slu_tree_get_heartbeat(h, peer);
      }
    };
    std::vector<std::thread> ts;
    for (i64 r = 1; r < nr; ++r)
      ts.emplace_back([&, r]() {
        void* h = slu_tree_attach_shared(root_h, r);
        if (!h) {
          fail[r] = 1;
          return;
        }
        body(h, r);
        slu_tree_detach(h, nullptr, 0);
      });
    body(root_h, 0);
    for (auto& t : ts) t.join();
    // every rank's final post must be readable, committed and exact
    double got[4];
    for (i64 r = 0; r < nr && rc == 0; ++r) {
      i64 ver = slu_tree_peek(root_h, r, got, 4);
      if (ver <= 0 || got[0] != (double)(r * 1000000 + kIters)) {
        std::fprintf(stderr, "FAIL: board slot %ld ver=%ld val=%f\n",
                     (long)r, (long)ver, got[0]);
        rc |= 1;
      }
    }
    slu_tree_detach(root_h, name, 1);
    for (i64 r = 0; r < nr; ++r)
      if (fail[r]) {
        std::fprintf(stderr, "FAIL: ftx stress rank %ld (torn peek or "
                             "attach)\n", (long)r);
        rc |= 1;
      }
  }

  if (rc == 0) std::puts("sanitize harness PASS");
  return rc;
}
