// Native batched LAP solver (shortest augmenting path Hungarian with dual
// potentials), C++17, no external dependencies.
//
// Replaces the reference's scipy.optimize.linear_sum_assignment C extension
// (reference: ModelComponents/losses_and_metrics.py:4, :242) with in-repo
// native code: used as the host-side oracle in tests and as the CPU
// fallback matcher for non-TPU deployments. The TPU hot path uses the
// on-device solvers in boosted_detr_tpu/ops (XLA + Pallas); this library is
// the framework's own native runtime piece, not a device kernel.
//
// Semantics: per batch element i, only the first num_objects[i] rows of the
// cost matrix participate; output is a 0/1 mask [B, O, P] with exactly one
// assignment per active row (P >= num_objects required).

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// Classic O(n * p^2 / vectorizable-p) shortest-augmenting-path Hungarian.
// cost: row-major [o, p]; solves rows [0, n); writes matched column per row
// into row_to_col (-1 when unmatched, which cannot happen for n <= p).
void solve_one(const float* cost, int n, int o, int p, int* row_to_col) {
  if (n <= 0) {
    for (int i = 0; i < o; ++i) row_to_col[i] = -1;
    return;
  }
  // 1-indexed classic formulation; column 0 is the virtual start column.
  std::vector<double> u(n + 1, 0.0), v(p + 1, 0.0);
  std::vector<int> match(p + 1, 0);  // column -> row (0 = free)
  std::vector<int> way(p + 1, 0);

  for (int i = 1; i <= n; ++i) {
    match[0] = i;
    int j0 = 0;
    std::vector<double> minv(p + 1, kInf);
    std::vector<char> used(p + 1, 0);
    do {
      used[j0] = 1;
      const int i0 = match[j0];
      double delta = kInf;
      int j1 = -1;
      const float* row = cost + static_cast<size_t>(i0 - 1) * p;
      for (int j = 1; j <= p; ++j) {
        if (used[j]) continue;
        const double cur = static_cast<double>(row[j - 1]) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= p; ++j) {
        if (used[j]) {
          u[match[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (match[j0] != 0);
    // augment
    do {
      const int j1 = way[j0];
      match[j0] = match[j1];
      j0 = j1;
    } while (j0);
  }

  for (int i = 0; i < o; ++i) row_to_col[i] = -1;
  for (int j = 1; j <= p; ++j) {
    if (match[j] > 0) row_to_col[match[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// cost: [b, o, p] row-major f32; num_objects: [b] int32;
// mask_out: [b, o, p] f32, pre-zeroed by the caller or overwritten here.
void lap_solve_batch(const float* cost, int32_t b, int32_t o, int32_t p,
                     const int32_t* num_objects, float* mask_out) {
  std::vector<int> row_to_col(o);
  for (int32_t e = 0; e < b; ++e) {
    const float* c = cost + static_cast<size_t>(e) * o * p;
    float* m = mask_out + static_cast<size_t>(e) * o * p;
    std::memset(m, 0, sizeof(float) * static_cast<size_t>(o) * p);
    int n = num_objects[e];
    if (n > o) n = o;
    if (n > p) n = p;
    solve_one(c, n, o, p, row_to_col.data());
    for (int i = 0; i < n; ++i) {
      if (row_to_col[i] >= 0) m[static_cast<size_t>(i) * p + row_to_col[i]] = 1.0f;
    }
  }
}

// Convenience: total assigned cost (for tests/diagnostics).
double lap_total_cost(const float* cost, int32_t b, int32_t o, int32_t p,
                      const int32_t* num_objects) {
  std::vector<int> row_to_col(o);
  double total = 0.0;
  for (int32_t e = 0; e < b; ++e) {
    const float* c = cost + static_cast<size_t>(e) * o * p;
    int n = num_objects[e];
    if (n > o) n = o;
    if (n > p) n = p;
    solve_one(c, n, o, p, row_to_col.data());
    for (int i = 0; i < n; ++i) {
      if (row_to_col[i] >= 0) total += c[static_cast<size_t>(i) * p + row_to_col[i]];
    }
  }
  return total;
}

}  // extern "C"
