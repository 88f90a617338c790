// tpu-gmrf native symbolic core.
//
// Host-side sparse-Cholesky symbolic analysis, exposed through a C ABI and
// loaded from Python via ctypes. This is the TPU-native replacement for the
// symbolic half of CHOLMOD (reference: CHOLMODBackend,
// reference src/workspace/backend.jl:24-182): fill-reducing ordering,
// elimination tree, postordering, column counts, supernode detection and
// L fill pattern. It runs ONCE per sparsity pattern at model-build time;
// the numeric factorization consumes its output as static index maps and
// runs on-device as batched dense XLA/Pallas ops.
//
// All graph inputs are 0-based CSR/CSC of the SYMMETRIC pattern (both
// triangles; diagonal entries are ignored where irrelevant).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 symbolic.cpp -o libtpugmrf_symbolic.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Approximate minimum degree ordering (quotient-graph scheme in the style of
// Amestoy, Davis & Duff 1996, simplified: external-degree bound + element
// absorption; no supervariable merging).
//
// perm[k] = original index of the vertex eliminated at step k.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int tpugmrf_amd(int32_t n, const int32_t* ap, const int32_t* ai,
                int32_t* perm) {
  if (n <= 0) return 0;
  // Quotient graph:
  //   live variable i: adj[i] = variable neighbours, elems[i] = adjacent
  //   elements (eliminated pivots);  element e: adj[e] = its variable list.
  std::vector<std::vector<int32_t>> adj(n), elems(n);
  std::vector<int32_t> degree(n);
  std::vector<int8_t> state(n, 0);  // 0 = live var, 1 = element, 2 = absorbed
  for (int32_t i = 0; i < n; ++i) {
    adj[i].reserve(ap[i + 1] - ap[i]);
    for (int32_t p = ap[i]; p < ap[i + 1]; ++p) {
      int32_t j = ai[p];
      if (j != i && j >= 0 && j < n) adj[i].push_back(j);
    }
    std::sort(adj[i].begin(), adj[i].end());
    adj[i].erase(std::unique(adj[i].begin(), adj[i].end()), adj[i].end());
    degree[i] = (int32_t)adj[i].size();
  }

  // Bucketed degree lists (bucket = min(degree, n)).
  std::vector<int32_t> head(n + 1, -1), nxt(n, -1), prv(n, -1);
  std::vector<int32_t> bucket_of(n, -1);
  auto bucket_insert = [&](int32_t i) {
    int32_t d = std::min<int32_t>(degree[i], n);
    bucket_of[i] = d;
    nxt[i] = head[d];
    prv[i] = -1;
    if (head[d] != -1) prv[head[d]] = i;
    head[d] = i;
  };
  auto bucket_remove = [&](int32_t i) {
    int32_t d = bucket_of[i];
    if (d < 0) return;
    if (prv[i] != -1)
      nxt[prv[i]] = nxt[i];
    else if (head[d] == i)
      head[d] = nxt[i];
    if (nxt[i] != -1) prv[nxt[i]] = prv[i];
    nxt[i] = prv[i] = -1;
    bucket_of[i] = -1;
  };
  for (int32_t i = 0; i < n; ++i) bucket_insert(i);

  std::vector<int32_t> mark(n, 0);
  int32_t mark_tag = 0;
  std::vector<int32_t> lp;  // pivot element variable list
  int32_t k = 0;
  int32_t mindeg = 0;

  while (k < n) {
    int32_t piv = -1;
    while (mindeg <= n) {
      int32_t i = head[mindeg];
      while (i != -1 && state[i] != 0) i = nxt[i];
      if (i != -1) {
        piv = i;
        break;
      }
      ++mindeg;
    }
    if (piv == -1) break;  // defensive; cannot happen for a valid graph
    bucket_remove(piv);

    // L_p = (live adj vars) ∪ (vars of adjacent elements), minus pivot.
    ++mark_tag;
    lp.clear();
    mark[piv] = mark_tag;
    for (int32_t v : adj[piv]) {
      if (state[v] == 0 && mark[v] != mark_tag) {
        mark[v] = mark_tag;
        lp.push_back(v);
      }
    }
    for (int32_t e : elems[piv]) {
      if (state[e] != 1) continue;
      for (int32_t v : adj[e]) {
        if (state[v] == 0 && mark[v] != mark_tag) {
          mark[v] = mark_tag;
          lp.push_back(v);
        }
      }
      state[e] = 2;  // absorbed into the new element
      adj[e].clear();
      adj[e].shrink_to_fit();
    }

    perm[k++] = piv;
    state[piv] = 1;  // pivot becomes an element
    adj[piv].assign(lp.begin(), lp.end());
    elems[piv].clear();

    // Update degrees of affected variables.
    for (int32_t v : lp) {
      auto& a = adj[v];
      size_t w = 0;
      for (size_t r = 0; r < a.size(); ++r) {
        int32_t u = a[r];
        if (state[u] == 0 && u != v) a[w++] = u;
      }
      a.resize(w);
      auto& el = elems[v];
      size_t we = 0;
      for (size_t r = 0; r < el.size(); ++r)
        if (state[el[r]] == 1 && el[r] != piv) el[we++] = el[r];
      el.resize(we);
      el.push_back(piv);

      // approximate external degree
      int64_t d = (int64_t)a.size();
      ++mark_tag;
      mark[v] = mark_tag;
      for (int32_t u : a) mark[u] = mark_tag;
      for (int32_t e : el) {
        for (int32_t u : adj[e]) {
          if (state[u] == 0 && mark[u] != mark_tag) {
            mark[u] = mark_tag;
            ++d;
          }
        }
      }
      bucket_remove(v);
      degree[v] = (int32_t)std::min<int64_t>(d, n);
      bucket_insert(v);
      if (degree[v] < mindeg) mindeg = degree[v];
    }
  }
  return (k == n) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Elimination tree of A (symmetric pattern) with path compression
// (Liu 1986). parent[j] = etree parent or -1.
// ap/ai: CSR of the full symmetric pattern.
// ---------------------------------------------------------------------------
int tpugmrf_etree(int32_t n, const int32_t* ap, const int32_t* ai,
                  int32_t* parent) {
  std::vector<int32_t> ancestor(n, -1);
  for (int32_t j = 0; j < n; ++j) parent[j] = -1;
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t p = ap[i]; p < ap[i + 1]; ++p) {
      int32_t kcol = ai[p];
      if (kcol >= i) continue;  // entries A[i,k] with k < i
      int32_t r = kcol;
      while (r != -1 && r != i) {
        int32_t next = ancestor[r];
        ancestor[r] = i;  // path compression
        if (next == -1 && r != i) parent[r] = i;
        r = next;
      }
    }
  }
  return 0;
}

// Postorder of the forest; children visited in increasing index order.
int tpugmrf_postorder(int32_t n, const int32_t* parent, int32_t* post) {
  std::vector<int32_t> head(n, -1), next(n, -1);
  for (int32_t j = n - 1; j >= 0; --j) {
    int32_t p = parent[j];
    if (p != -1) {
      next[j] = head[p];
      head[p] = j;
    }
  }
  int32_t top = 0;
  std::vector<int32_t> stack;
  for (int32_t root = 0; root < n; ++root) {
    if (parent[root] != -1) continue;
    stack.push_back(root);
    while (!stack.empty()) {
      int32_t j = stack.back();
      int32_t c = head[j];
      if (c != -1) {
        head[j] = next[c];
        stack.push_back(c);
      } else {
        stack.pop_back();
        post[top++] = j;
      }
    }
  }
  return (top == n) ? 0 : 1;
}

// Column counts of L (including diagonal) via row-subtree traversal.
// O(|A| · avg path length); runs once per pattern.
int tpugmrf_colcounts(int32_t n, const int32_t* ap, const int32_t* ai,
                      const int32_t* parent, int32_t* counts) {
  std::vector<int32_t> mark(n, -1);
  for (int32_t j = 0; j < n; ++j) counts[j] = 1;  // diagonal
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t p = ap[i]; p < ap[i + 1]; ++p) {
      int32_t kcol = ai[p];
      if (kcol >= i) continue;
      int32_t j = kcol;
      while (j != -1 && j < i && mark[j] != i) {
        ++counts[j];
        mark[j] = i;
        j = parent[j];
      }
    }
  }
  return 0;
}

// Row structure of L in CSC (sorted rows per column). Caller allocates
// lp (n+1) and li (sum counts). L[i,j] != 0 iff j lies on the etree path
// from some k with A[i,k] != 0, k <= i, up to i.
int tpugmrf_symbolic_fill(int32_t n, const int32_t* ap, const int32_t* ai,
                          const int32_t* parent, const int32_t* counts,
                          int32_t* lp, int32_t* li) {
  lp[0] = 0;
  for (int32_t j = 0; j < n; ++j) lp[j + 1] = lp[j] + counts[j];
  std::vector<int32_t> fill(n);
  for (int32_t j = 0; j < n; ++j) {
    fill[j] = lp[j];
    li[fill[j]++] = j;  // diagonal first
  }
  std::vector<int32_t> mark(n, -1);
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t p = ap[i]; p < ap[i + 1]; ++p) {
      int32_t kcol = ai[p];
      if (kcol >= i) continue;
      int32_t j = kcol;
      while (j != -1 && j < i && mark[j] != i) {
        li[fill[j]++] = i;
        mark[j] = i;
        j = parent[j];
      }
    }
  }
  return 0;  // rows per column are emitted in increasing i automatically
}

// Fundamental supernode partition with a width cap.
// Column j joins the previous supernode iff parent[j-1] == j and
// colcount[j] == colcount[j-1] - 1 (identical row structure below the
// diagonal) and the supernode stays under max_width.
int tpugmrf_supernodes(int32_t n, const int32_t* parent, const int32_t* counts,
                       int32_t max_width, int32_t* snode) {
  if (n <= 0) return 0;
  int32_t cur = 0, width = 1;
  snode[0] = 0;
  for (int32_t j = 1; j < n; ++j) {
    bool fundamental =
        (parent[j - 1] == j) && (counts[j] == counts[j - 1] - 1);
    if (fundamental && width < max_width) {
      snode[j] = cur;
      ++width;
    } else {
      snode[j] = ++cur;
      width = 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Nested dissection ordering (George 1973 style): recursive BFS level-set
// bisection; separators are ordered last, leaf subgraphs are ordered with
// the AMD routine above. This is the fill-reducing ordering for large
// mesh-like patterns (2D grid fill O(n log n), flops O(n^1.5)) where plain
// AMD's elimination tree is too deep/irregular for the level-scheduled
// batched numeric factorization.
//
// perm[k] = original index of the vertex eliminated at step k.
// ---------------------------------------------------------------------------
namespace {

struct NDWork {
  const int32_t* ap;
  const int32_t* ai;
  int32_t leaf;
  std::vector<int32_t> part;    // current subproblem id per vertex (-1 = done)
  std::vector<int32_t> level;   // BFS levels within a subproblem
  std::vector<int32_t> queue;   // BFS queue
  std::vector<int32_t> localid; // global -> local id for leaf AMD
  std::vector<int32_t> sub_ap, sub_ai, sub_perm;  // leaf subgraph scratch
  int32_t next_id = 0;
};

// Order subproblem `verts` (contiguous slice) into out[0..len).
void nd_recurse(NDWork& W, int32_t* verts, int32_t len, int32_t* out) {
  if (len <= 0) return;
  if (len <= W.leaf) {
    // AMD on the leaf subgraph.
    for (int32_t i = 0; i < len; ++i) W.localid[verts[i]] = i;
    W.sub_ap.assign(len + 1, 0);
    W.sub_ai.clear();
    int32_t myid = W.part[verts[0]];
    for (int32_t i = 0; i < len; ++i) {
      int32_t v = verts[i];
      for (int32_t p = W.ap[v]; p < W.ap[v + 1]; ++p) {
        int32_t u = W.ai[p];
        if (u != v && W.part[u] == myid) W.sub_ai.push_back(W.localid[u]);
      }
      W.sub_ap[i + 1] = (int32_t)W.sub_ai.size();
    }
    W.sub_perm.resize(len);
    if (len > 2 &&
        tpugmrf_amd(len, W.sub_ap.data(), W.sub_ai.data(),
                    W.sub_perm.data()) == 0) {
      for (int32_t i = 0; i < len; ++i) out[i] = verts[W.sub_perm[i]];
    } else {
      for (int32_t i = 0; i < len; ++i) out[i] = verts[i];
    }
    for (int32_t i = 0; i < len; ++i) W.part[out[i]] = -1;
    return;
  }

  int32_t myid = W.part[verts[0]];

  // Pseudo-peripheral start: BFS twice from within the subproblem. BFS
  // restarts cover disconnected pieces (levels keep growing across restarts
  // so components are separated along the level axis).
  int32_t start = verts[0];
  for (int rep = 0; rep < 2; ++rep) {
    for (int32_t i = 0; i < len; ++i) W.level[verts[i]] = -1;
    W.queue.clear();
    W.queue.push_back(start);
    W.level[start] = 0;
    size_t qh = 0;
    int32_t last = start;
    int32_t scanned = 0;  // restart cursor into verts
    while ((int32_t)(W.queue.size()) < len) {
      if (qh == W.queue.size()) {  // disconnected: restart one level deeper
        while (scanned < len && W.level[verts[scanned]] != -1) ++scanned;
        if (scanned >= len) break;
        W.level[verts[scanned]] = W.level[last] + 1;
        W.queue.push_back(verts[scanned]);
      }
      int32_t v = W.queue[qh++];
      last = v;
      for (int32_t p = W.ap[v]; p < W.ap[v + 1]; ++p) {
        int32_t u = W.ai[p];
        if (u != v && W.part[u] == myid && W.level[u] == -1) {
          W.level[u] = W.level[v] + 1;
          W.queue.push_back(u);
        }
      }
    }
    start = last;
  }

  int32_t maxlev = 0;
  for (int32_t i = 0; i < len; ++i)
    maxlev = std::max(maxlev, W.level[verts[i]]);

  if (maxlev < 2) {
    // No usable level structure (clique-like); order as one AMD leaf.
    int32_t save = W.leaf;
    W.leaf = len;
    nd_recurse(W, verts, len, out);
    W.leaf = save;
    return;
  }

  // Cut at the level where the cumulative count reaches half.
  std::vector<int32_t> lcount(maxlev + 1, 0);
  for (int32_t i = 0; i < len; ++i) ++lcount[W.level[verts[i]]];
  int32_t cut = 1, acc = 0;
  for (int32_t l = 0; l <= maxlev; ++l) {
    acc += lcount[l];
    if (acc * 2 >= len) {
      cut = std::min<int32_t>(std::max<int32_t>(l, 1), maxlev - 1);
      break;
    }
  }

  // Separator = cut level set, shrunk to vertices actually adjacent to the
  // far side (level cut+1); the rest of the cut level joins side A.
  int32_t na = 0, nb = 0, ns = 0;
  std::vector<int32_t> A, B, S;
  A.reserve(len);
  B.reserve(len);
  for (int32_t i = 0; i < len; ++i) {
    int32_t v = verts[i];
    int32_t lv = W.level[v];
    if (lv < cut) {
      A.push_back(v);
    } else if (lv > cut) {
      B.push_back(v);
    } else {
      bool touches_b = false;
      for (int32_t p = W.ap[v]; p < W.ap[v + 1] && !touches_b; ++p) {
        int32_t u = W.ai[p];
        if (u != v && W.part[u] == myid && W.level[u] == cut + 1)
          touches_b = true;
      }
      if (touches_b)
        S.push_back(v);
      else
        A.push_back(v);
    }
  }
  na = (int32_t)A.size();
  nb = (int32_t)B.size();
  ns = (int32_t)S.size();
  if (na == 0 || nb == 0) {  // degenerate split: fall back to AMD leaf
    int32_t save = W.leaf;
    W.leaf = len;
    nd_recurse(W, verts, len, out);
    W.leaf = save;
    return;
  }

  // Repack verts as [A | B | S]; give A and B fresh subproblem ids.
  int32_t ida = ++W.next_id, idb = ++W.next_id;
  for (int32_t i = 0; i < na; ++i) {
    verts[i] = A[i];
    W.part[A[i]] = ida;
  }
  for (int32_t i = 0; i < nb; ++i) {
    verts[na + i] = B[i];
    W.part[B[i]] = idb;
  }
  for (int32_t i = 0; i < ns; ++i) {
    verts[na + nb + i] = S[i];
    out[na + nb + i] = S[i];  // separator eliminated last, BFS order
    W.part[S[i]] = -1;
  }
  nd_recurse(W, verts, na, out);
  nd_recurse(W, verts + na, nb, out + na);
}

}  // namespace

int tpugmrf_nd(int32_t n, const int32_t* ap, const int32_t* ai,
               int32_t leaf, int32_t* perm) {
  if (n <= 0) return 0;
  NDWork W;
  W.ap = ap;
  W.ai = ai;
  W.leaf = std::max<int32_t>(leaf, 4);
  W.part.assign(n, 0);
  W.level.assign(n, -1);
  W.localid.assign(n, -1);
  std::vector<int32_t> verts(n);
  for (int32_t i = 0; i < n; ++i) verts[i] = i;
  nd_recurse(W, verts.data(), n, perm);
  // Validate: perm must be a permutation.
  std::vector<int8_t> seen(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    if (perm[i] < 0 || perm[i] >= n || seen[perm[i]]) return 1;
    seen[perm[i]] = 1;
  }
  return 0;
}

}  // extern "C"
