// Native ROBDD engine: the host-side heavy lifting for exact analysis.
//
// The reference implements its performance-native layers in C++ (SURVEY.md
// §2.6); in this rebuild the device math is JAX/XLA, and the one host-side
// component hot enough to justify native code is BDD construction — a
// pointer-chasing, hash-heavy workload where the Python unique/memo tables
// dominate end-to-end time for models beyond a few thousand gates.
//
// Design: array-of-structs node store (var, low, high), open-addressing
// unique table and ITE memo with linear probing, iterative ITE with an
// explicit pending stack (no recursion limits), memoized complement
// traversal, and a memoized k-of-n builder. Exposed through a flat C ABI
// consumed via ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -fPIC -shared bdd.cpp -o libcanopy_bdd.so (see build.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kZero = 0;
constexpr int32_t kOne = 1;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

inline uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

struct HashTable {
  // Open addressing; key = 3 ints packed, value = node index.
  std::vector<uint64_t> keys_lo;  // (a << 32) | b
  std::vector<uint64_t> keys_hi;  // c  (with kEmpty marker in value)
  std::vector<uint32_t> values;
  size_t count = 0;

  explicit HashTable(size_t capacity = 1 << 16) { rehash(capacity); }

  void rehash(size_t capacity) {
    std::vector<uint64_t> old_lo = std::move(keys_lo);
    std::vector<uint64_t> old_hi = std::move(keys_hi);
    std::vector<uint32_t> old_values = std::move(values);
    keys_lo.assign(capacity, 0);
    keys_hi.assign(capacity, 0);
    values.assign(capacity, kEmpty);
    count = 0;
    for (size_t i = 0; i < old_values.size(); ++i) {
      if (old_values[i] != kEmpty) {
        insert_raw(old_lo[i], old_hi[i], old_values[i]);
      }
    }
  }

  inline size_t slot_for(uint64_t lo, uint64_t hi) const {
    return static_cast<size_t>(mix(lo ^ mix(hi))) & (values.size() - 1);
  }

  void insert_raw(uint64_t lo, uint64_t hi, uint32_t value) {
    size_t slot = slot_for(lo, hi);
    while (values[slot] != kEmpty) slot = (slot + 1) & (values.size() - 1);
    keys_lo[slot] = lo;
    keys_hi[slot] = hi;
    values[slot] = value;
    ++count;
  }

  uint32_t find(uint64_t lo, uint64_t hi) const {
    size_t slot = slot_for(lo, hi);
    while (values[slot] != kEmpty) {
      if (keys_lo[slot] == lo && keys_hi[slot] == hi) return values[slot];
      slot = (slot + 1) & (values.size() - 1);
    }
    return kEmpty;
  }

  void insert(uint64_t lo, uint64_t hi, uint32_t value) {
    if ((count + 1) * 10 >= values.size() * 7) rehash(values.size() * 2);
    insert_raw(lo, hi, value);
  }
};

struct Forest {
  int32_t n_vars;
  int64_t max_nodes;
  std::vector<int32_t> var, low, high;
  HashTable unique;
  HashTable ite_memo;
  HashTable not_memo;  // key = (f, 0, 0)
  bool overflow = false;

  Forest(int32_t nv, int64_t mx) : n_vars(nv), max_nodes(mx) {
    var = {nv, nv};
    low = {0, 1};
    high = {0, 1};
  }

  int32_t mk(int32_t v, int32_t lo, int32_t hi) {
    if (lo == hi) return lo;
    uint64_t key_lo = (static_cast<uint64_t>(static_cast<uint32_t>(v)) << 32) |
                      static_cast<uint32_t>(lo);
    uint64_t key_hi = static_cast<uint32_t>(hi);
    uint32_t found = unique.find(key_lo, key_hi);
    if (found != kEmpty) return static_cast<int32_t>(found);
    if (static_cast<int64_t>(var.size()) >= max_nodes) {
      overflow = true;
      return kZero;
    }
    int32_t index = static_cast<int32_t>(var.size());
    var.push_back(v);
    low.push_back(lo);
    high.push_back(hi);
    unique.insert(key_lo, key_hi, static_cast<uint32_t>(index));
    return index;
  }

  inline int32_t cofactor(int32_t node, int32_t top, bool value) const {
    if (var[node] != top) return node;
    return value ? high[node] : low[node];
  }

  int32_t ite(int32_t f, int32_t g, int32_t h) {
    // Iterative two-phase (expand, then combine) with an explicit stack.
    struct Frame {
      int32_t f, g, h;
      int32_t top;
      int32_t hi_result;
      int stage;
    };
    std::vector<Frame> stack;
    std::vector<int32_t> results;
    stack.push_back({f, g, h, 0, 0, 0});
    while (!stack.empty()) {
      Frame &fr = stack.back();
      if (fr.stage == 0) {
        // Terminal cases.
        int32_t quick = -1;
        if (fr.f == kOne) quick = fr.g;
        else if (fr.f == kZero) quick = fr.h;
        else if (fr.g == fr.h) quick = fr.g;
        else if (fr.g == kOne && fr.h == kZero) quick = fr.f;
        if (quick >= 0) {
          results.push_back(quick);
          stack.pop_back();
          continue;
        }
        uint64_t key_lo =
            (static_cast<uint64_t>(static_cast<uint32_t>(fr.f)) << 32) |
            static_cast<uint32_t>(fr.g);
        uint32_t memo = ite_memo.find(key_lo, static_cast<uint32_t>(fr.h));
        if (memo != kEmpty) {
          results.push_back(static_cast<int32_t>(memo));
          stack.pop_back();
          continue;
        }
        int32_t top = var[fr.f];
        if (var[fr.g] < top) top = var[fr.g];
        if (var[fr.h] < top) top = var[fr.h];
        fr.top = top;
        fr.stage = 1;
        stack.push_back({cofactor(fr.f, top, true), cofactor(fr.g, top, true),
                         cofactor(fr.h, top, true), 0, 0, 0});
      } else if (fr.stage == 1) {
        fr.hi_result = results.back();
        results.pop_back();
        fr.stage = 2;
        stack.push_back({cofactor(fr.f, fr.top, false),
                         cofactor(fr.g, fr.top, false),
                         cofactor(fr.h, fr.top, false), 0, 0, 0});
      } else {
        int32_t lo_result = results.back();
        results.pop_back();
        int32_t node = mk(fr.top, lo_result, fr.hi_result);
        uint64_t key_lo =
            (static_cast<uint64_t>(static_cast<uint32_t>(fr.f)) << 32) |
            static_cast<uint32_t>(fr.g);
        ite_memo.insert(key_lo, static_cast<uint32_t>(fr.h),
                        static_cast<uint32_t>(node));
        results.push_back(node);
        stack.pop_back();
      }
    }
    return results.back();
  }

  int32_t not_(int32_t f) {
    if (f == kZero) return kOne;
    if (f == kOne) return kZero;
    uint32_t memo = not_memo.find(static_cast<uint32_t>(f), 0);
    if (memo != kEmpty) return static_cast<int32_t>(memo);
    // Iterative post-order complement.
    std::vector<int32_t> order;
    std::vector<int32_t> dfs = {f};
    std::vector<char> seen(var.size(), 0);
    while (!dfs.empty()) {
      int32_t node = dfs.back();
      dfs.pop_back();
      if (node <= kOne || seen[node]) continue;
      if (not_memo.find(static_cast<uint32_t>(node), 0) != kEmpty) continue;
      seen[node] = 1;
      order.push_back(node);
      dfs.push_back(low[node]);
      dfs.push_back(high[node]);
    }
    // Children before parents: process in reverse discovery won't
    // guarantee it; sort by doing multiple passes over `order` reversed
    // (DFS preorder reversed has children after parents in general, so
    // iterate until fixed point — depth passes at most).
    auto resolved = [&](int32_t node) -> int32_t {
      if (node == kZero) return kOne;
      if (node == kOne) return kZero;
      uint32_t m = not_memo.find(static_cast<uint32_t>(node), 0);
      return m == kEmpty ? -1 : static_cast<int32_t>(m);
    };
    bool progress = true;
    while (progress) {
      progress = false;
      for (auto it = order.rbegin(); it != order.rend(); ++it) {
        int32_t node = *it;
        if (not_memo.find(static_cast<uint32_t>(node), 0) != kEmpty) continue;
        int32_t nl = resolved(low[node]);
        int32_t nh = resolved(high[node]);
        if (nl < 0 || nh < 0) continue;
        int32_t result = mk(var[node], nl, nh);
        not_memo.insert(static_cast<uint32_t>(node), 0,
                        static_cast<uint32_t>(result));
        progress = true;
      }
    }
    return static_cast<int32_t>(not_memo.find(static_cast<uint32_t>(f), 0));
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// ZDD minimal-solutions engine (Rauzy's minsol over an ROBDD).
//
// Mirrors compiler/zbdd.py's transform, but on a zero-suppressed DD so the
// solution family stays compact:
//   ms(0) = {} ; ms(1) = {∅}
//   ms(v ? H : L) = ms(L)  ∪  v · (ms(H) ⊖ ms(L))
// where ⊖ is the subsume-difference ("without").  Node (v, l, h) of the
// ZDD encodes  l ∪ {s ∪ {v} : s ∈ h};  since BDD children carry strictly
// larger variables, ms(L)'s top variable exceeds v and the union folds
// into a single mk(v, ms(L), W).
// ---------------------------------------------------------------------------

namespace {

// Recursion guard for union_/without: depth scales with the variable
// count, and a C-stack overflow would kill the process instead of
// falling back; past this bound the Zdd flags overflow and the Python
// caller uses its own (recursion-limit-raised) transform.
constexpr int32_t kMaxZddDepth = 20000;

struct Zdd {
  int32_t n_vars;
  int64_t max_nodes;
  std::vector<int32_t> var, lo, hi;  // 0 = empty family, 1 = {∅}
  HashTable unique;
  HashTable union_memo;
  HashTable without_memo;
  bool overflow = false;
  int32_t depth = 0;

  Zdd(int32_t nv, int64_t mx) : n_vars(nv), max_nodes(mx) {
    var = {nv, nv};
    lo = {0, 1};
    hi = {0, 1};
  }

  int32_t mk(int32_t v, int32_t l, int32_t h) {
    if (h == kZero) return l;  // Zero-suppression rule.
    uint64_t key_lo = (static_cast<uint64_t>(static_cast<uint32_t>(v)) << 32) |
                      static_cast<uint32_t>(l);
    uint64_t key_hi = static_cast<uint32_t>(h);
    uint32_t found = unique.find(key_lo, key_hi);
    if (found != kEmpty) return static_cast<int32_t>(found);
    if (static_cast<int64_t>(var.size()) >= max_nodes) {
      overflow = true;
      return kZero;
    }
    int32_t index = static_cast<int32_t>(var.size());
    var.push_back(v);
    lo.push_back(l);
    hi.push_back(h);
    unique.insert(key_lo, key_hi, static_cast<uint32_t>(index));
    return index;
  }

  bool contains_empty(int32_t a) const {
    while (a > kOne) a = lo[a];
    return a == kOne;
  }

  int32_t union_(int32_t a, int32_t b) {
    if (a == b) return a;
    if (a == kZero) return b;
    if (b == kZero) return a;
    if (a > b) std::swap(a, b);  // Commutative canonical key.
    uint64_t key_lo = (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
                      static_cast<uint32_t>(b);
    uint32_t memo = union_memo.find(key_lo, 1);
    if (memo != kEmpty) return static_cast<int32_t>(memo);
    if (++depth > kMaxZddDepth) {
      overflow = true;
      --depth;
      return kZero;
    }
    int32_t va = var[a], vb = var[b], r;
    if (va < vb) {
      r = mk(va, union_(lo[a], b), hi[a]);
    } else if (vb < va) {
      r = mk(vb, union_(a, lo[b]), hi[b]);
    } else {
      r = mk(va, union_(lo[a], lo[b]), union_(hi[a], hi[b]));
    }
    --depth;
    union_memo.insert(key_lo, 1, static_cast<uint32_t>(r));
    return r;
  }

  // Sets of `a` not subsumed by (superset-or-equal of) any set of `b`.
  int32_t without(int32_t a, int32_t b) {
    if (a == kZero || b == kZero) return a;
    if (b == kOne || a == b) return kZero;  // ∅ subsumes everything.
    if (a == kOne) return contains_empty(b) ? kZero : kOne;
    uint64_t key_lo = (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
                      static_cast<uint32_t>(b);
    uint32_t memo = without_memo.find(key_lo, 2);
    if (memo != kEmpty) return static_cast<int32_t>(memo);
    if (++depth > kMaxZddDepth) {
      overflow = true;
      --depth;
      return kZero;
    }
    int32_t va = var[a], vb = var[b], r;
    if (vb < va) {
      // Sets of b containing vb cannot be subsets of va-rooted sets.
      r = without(a, lo[b]);
    } else if (va < vb) {
      r = mk(va, without(lo[a], b), without(hi[a], b));
    } else {
      r = mk(va, without(lo[a], lo[b]),
             without(hi[a], union_(lo[b], hi[b])));
    }
    --depth;
    without_memo.insert(key_lo, 2, static_cast<uint32_t>(r));
    return r;
  }
};

struct MinsolHandle {
  Zdd zdd;
  int32_t root = kZero;
  std::vector<int32_t> lens;
  std::vector<int32_t> flat;
  bool truncated = false;

  MinsolHandle(int32_t nv, int64_t mx) : zdd(nv, mx) {}
};

}  // namespace

extern "C" {

// Build the minimal-solutions ZDD for BDD `root` over the exported node
// arrays (terminals at 0/1, children at lower indices than parents), then
// enumerate solutions up to `limit_order` literals and `max_products`
// solutions.  Returns a handle (never null); check _overflow.
void *canopy_minsol(const int32_t *bvar, const int32_t *blow,
                    const int32_t *bhigh, int64_t n_nodes, int32_t n_vars,
                    int32_t root, int32_t limit_order, int64_t max_products,
                    int64_t max_nodes) {
  MinsolHandle *h = new MinsolHandle(n_vars, max_nodes);
  Zdd &z = h->zdd;

  // Reachable set from the root (children precede parents by index).
  std::vector<char> reach(static_cast<size_t>(n_nodes), 0);
  if (root > kOne) {
    std::vector<int32_t> dfs = {root};
    while (!dfs.empty()) {
      int32_t n = dfs.back();
      dfs.pop_back();
      if (n <= kOne || reach[n]) continue;
      reach[n] = 1;
      dfs.push_back(blow[n]);
      dfs.push_back(bhigh[n]);
    }
  }

  // Bottom-up minsol (index order = topological order).
  std::vector<int32_t> ms(static_cast<size_t>(n_nodes), -1);
  if (n_nodes > 0) ms[0] = kZero;
  if (n_nodes > 1) ms[1] = kOne;
  for (int64_t n = 2; n < n_nodes; ++n) {
    if (!reach[n]) continue;
    int32_t L = ms[blow[n]];
    int32_t H = ms[bhigh[n]];
    int32_t W = z.without(H, L);
    ms[n] = z.mk(bvar[n], L, W);  // == union(L, v·W): vars(L) > v.
  }
  h->root = (root <= kOne) ? root : ms[root];
  if (z.overflow) return h;

  // Enumerate: iterative DFS, order-bounded, product-capped.
  struct Frame {
    int32_t node;
    int stage;
  };
  std::vector<Frame> stack;
  std::vector<int32_t> path;
  stack.push_back({h->root, 0});
  while (!stack.empty()) {
    Frame &fr = stack.back();
    if (fr.node == kZero) {
      stack.pop_back();
      continue;
    }
    if (fr.node == kOne) {
      if (static_cast<int64_t>(h->lens.size()) >= max_products) {
        h->truncated = true;
        break;
      }
      h->lens.push_back(static_cast<int32_t>(path.size()));
      h->flat.insert(h->flat.end(), path.begin(), path.end());
      stack.pop_back();
      continue;
    }
    if (fr.stage == 0) {
      fr.stage = 1;
      stack.push_back({z.lo[fr.node], 0});
    } else if (fr.stage == 1) {
      if (static_cast<int32_t>(path.size()) < limit_order) {
        fr.stage = 2;
        path.push_back(z.var[fr.node]);
        stack.push_back({z.hi[fr.node], 0});
      } else {
        // hi != 0 by zero-suppression: solutions beyond the bound exist.
        h->truncated = true;
        stack.pop_back();
      }
    } else {
      path.pop_back();
      stack.pop_back();
    }
  }
  return h;
}

int64_t canopy_minsol_count(void *h) {
  return static_cast<int64_t>(static_cast<MinsolHandle *>(h)->lens.size());
}

int64_t canopy_minsol_total(void *h) {
  return static_cast<int64_t>(static_cast<MinsolHandle *>(h)->flat.size());
}

int32_t canopy_minsol_truncated(void *h) {
  return static_cast<MinsolHandle *>(h)->truncated ? 1 : 0;
}

int32_t canopy_minsol_overflow(void *h) {
  return static_cast<MinsolHandle *>(h)->zdd.overflow ? 1 : 0;
}

int64_t canopy_minsol_zdd_nodes(void *h) {
  return static_cast<int64_t>(
      static_cast<MinsolHandle *>(h)->zdd.var.size());
}

void canopy_minsol_export(void *h, int32_t *out_lens, int32_t *out_flat) {
  MinsolHandle *mh = static_cast<MinsolHandle *>(h);
  std::memcpy(out_lens, mh->lens.data(), mh->lens.size() * sizeof(int32_t));
  std::memcpy(out_flat, mh->flat.data(), mh->flat.size() * sizeof(int32_t));
}

void canopy_minsol_free(void *h) { delete static_cast<MinsolHandle *>(h); }

}  // extern "C"

extern "C" {

void *canopy_bdd_new(int32_t n_vars, int64_t max_nodes) {
  return new Forest(n_vars, max_nodes);
}

void canopy_bdd_free(void *forest) { delete static_cast<Forest *>(forest); }

int32_t canopy_bdd_var(void *forest, int32_t v) {
  return static_cast<Forest *>(forest)->mk(v, kZero, kOne);
}

int32_t canopy_bdd_ite(void *forest, int32_t f, int32_t g, int32_t h) {
  return static_cast<Forest *>(forest)->ite(f, g, h);
}

int32_t canopy_bdd_and(void *forest, int32_t f, int32_t g) {
  return static_cast<Forest *>(forest)->ite(f, g, kZero);
}

int32_t canopy_bdd_or(void *forest, int32_t f, int32_t g) {
  return static_cast<Forest *>(forest)->ite(f, kOne, g);
}

int32_t canopy_bdd_xor(void *forest, int32_t f, int32_t g) {
  Forest *fo = static_cast<Forest *>(forest);
  return fo->ite(f, fo->not_(g), g);
}

int32_t canopy_bdd_not(void *forest, int32_t f) {
  return static_cast<Forest *>(forest)->not_(f);
}

int32_t canopy_bdd_atleast(void *forest, int32_t k, const int32_t *args,
                           int32_t n) {
  Forest *fo = static_cast<Forest *>(forest);
  // rec(need, index) over memo table indexed densely.
  std::vector<int32_t> memo(static_cast<size_t>(k + 1) * (n + 1), -1);
  // Iterative bottom-up: for index from n down to 0.
  for (int32_t index = n; index >= 0; --index) {
    for (int32_t need = k; need >= 0; --need) {
      int32_t &cell = memo[static_cast<size_t>(need) * (n + 1) + index];
      if (need <= 0) {
        cell = kOne;
      } else if (n - index < need) {
        cell = kZero;
      } else {
        int32_t with_arg =
            memo[static_cast<size_t>(need - 1) * (n + 1) + index + 1];
        int32_t without_arg =
            memo[static_cast<size_t>(need) * (n + 1) + index + 1];
        cell = fo->ite(args[index], with_arg, without_arg);
      }
    }
  }
  return memo[static_cast<size_t>(k) * (n + 1)];
}

int64_t canopy_bdd_n_nodes(void *forest) {
  return static_cast<int64_t>(static_cast<Forest *>(forest)->var.size());
}

int32_t canopy_bdd_overflow(void *forest) {
  return static_cast<Forest *>(forest)->overflow ? 1 : 0;
}

// Export the node arrays (length = n_nodes); index 0/1 are terminals.
void canopy_bdd_export(void *forest, int32_t *out_var, int32_t *out_low,
                       int32_t *out_high) {
  Forest *fo = static_cast<Forest *>(forest);
  std::memcpy(out_var, fo->var.data(), fo->var.size() * sizeof(int32_t));
  std::memcpy(out_low, fo->low.data(), fo->low.size() * sizeof(int32_t));
  std::memcpy(out_high, fo->high.data(), fo->high.size() * sizeof(int32_t));
}

}  // extern "C"
