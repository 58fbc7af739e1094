// Capacity-constrained assignment: min sum_i cost[i][a(i)] over a: rows -> k
// clusters with |a^-1(c)| <= cap[c]. Exact successive-shortest-path min-cost
// flow with Johnson potentials, specialized to the bipartite structure (n rows
// of unit supply, k capacitated sinks; k is small).
//
// The port's own copy of breaching_tpu/native/capacitated_assignment.cc, built
// for the host by breaching_tpu_torch/native.py. It replaces
// scipy.optimize.linear_sum_assignment on the column-replicated (n x sum(cap))
// matrix in Decepticon's sentence clustering (the reference delegates to the
// k_means_constrained package, which solves the same transportation problem
// with ortools MCF: reference attacks/analytic_attacks.py:660-680). At the
// GPT-2 notebook's scale (n = 8 x 512 = 4096 slots, k = 8 sentences) the
// replicated matrix holds 16.7M entries; this solver runs the same
// augmentation logic over the n x k cost table directly.
//
// tests/test_torch_assignment.py holds it to the replicated assignment's
// optimum and to the JAX package's solver.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// One augmentation: find the shortest alternating path (by reduced cost) from
// `row` to any cluster with residual capacity, reassigning rows along it.
//
// The search graph only has k cluster nodes: the path row -> c1 -> row' -> c2
// contracts to an edge c1 -> c2 of weight min over rows assigned to c1 of
// (cost[r][c2] - u[r] - v[c2]).  Dijkstra over k nodes, each relaxation
// scanning that cluster's member list: O(n * k) per augmentation.
struct Solver {
  int n, k;
  const double* cost;           // n x k, row-major
  std::vector<int64_t> cap;     // residual capacity per cluster
  std::vector<int> assign;      // row -> cluster (-1 unassigned)
  std::vector<double> u, v;     // row / cluster potentials
  std::vector<std::vector<int>> members;  // cluster -> rows

  Solver(const double* c, int n_, int k_, const int64_t* caps)
      : n(n_), k(k_), cost(c), cap(caps, caps + k_), assign(n_, -1),
        u(n_, 0.0), v(k_, 0.0), members(k_) {}

  double red(int row, int c) const { return cost[(size_t)row * k + c] - u[row] - v[c]; }

  bool augment(int row) {
    std::vector<double> dist(k);
    std::vector<int> prev_cluster(k, -1);  // predecessor cluster on the path
    std::vector<int> prev_row(k, -1);      // row moved from prev_cluster
    std::vector<char> done(k, 0);
    for (int c = 0; c < k; ++c) dist[c] = red(row, c);

    int sink = -1;
    double sink_dist = kInf;
    for (int iter = 0; iter < k; ++iter) {
      int best = -1;
      double best_d = kInf;
      for (int c = 0; c < k; ++c)
        if (!done[c] && dist[c] < best_d) { best_d = dist[c]; best = c; }
      if (best < 0 || best_d == kInf) break;
      done[best] = 1;
      if (cap[best] > 0) { sink = best; sink_dist = best_d; break; }
      // relax: leave `best` through any of its assigned rows
      for (int r : members[best]) {
        const double leave = best_d - red(r, best);  // red() of a tight edge is 0
        for (int c = 0; c < k; ++c) {
          if (done[c]) continue;
          const double nd = leave + red(r, c);
          if (nd < dist[c]) { dist[c] = nd; prev_cluster[c] = best; prev_row[c] = r; }
        }
      }
    }
    if (sink < 0) return false;  // infeasible: all caps exhausted

    // Johnson potential update (textbook SSP): for every scanned node with
    // shortest distance d < D = sink_dist, shift its potential by d - D.
    // Scanned rows are exactly the members of scanned clusters and share
    // their cluster's distance (assigned edges are tight), so tightness of
    // assigned pairs is preserved and Dijkstra's bound dist[c] >= D for
    // unscanned clusters keeps every other reduced cost nonnegative.
    for (int c = 0; c < k; ++c) {
      if (!done[c] && c != sink) continue;
      const double shift = dist[c] - sink_dist;  // <= 0
      v[c] += shift;
      for (int r : members[c]) u[r] -= shift;
    }
    u[row] += sink_dist;  // d(row) = 0: the entering path edge becomes tight

    // walk the path back from the sink, moving rows
    int c = sink;
    while (prev_cluster[c] != -1) {
      const int pc = prev_cluster[c];
      const int r = prev_row[c];
      // detach r from pc
      auto& m = members[pc];
      for (size_t i = 0; i < m.size(); ++i)
        if (m[i] == r) { m[i] = m.back(); m.pop_back(); break; }
      members[c].push_back(r);
      assign[r] = c;
      u[r] = cost[(size_t)r * k + c] - v[c];
      c = pc;
    }
    assign[row] = c;
    members[c].push_back(row);
    u[row] = cost[(size_t)row * k + c] - v[c];
    --cap[sink];
    return true;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 if infeasible (sum caps < n). `out` receives the
// cluster index per row.
int capacitated_assignment(const double* cost, int64_t n, int64_t k,
                           const int64_t* caps, int64_t* out) {
  int64_t total = 0;
  for (int64_t c = 0; c < k; ++c) total += caps[c];
  if (total < n) return -1;
  Solver s(cost, (int)n, (int)k, caps);
  for (int64_t i = 0; i < n; ++i)
    if (!s.augment((int)i)) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = s.assign[i];
  return 0;
}

}  // extern "C"
