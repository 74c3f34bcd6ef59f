/* Native batch predictor: traverse every tree for every row, OpenMP over
 * rows.
 *
 * TPU-framework analogue of the reference's native prediction stack
 * (ref: src/application/predictor.hpp:30 batch Predictor with OMP;
 * include/LightGBM/tree.h:335 NumericalDecision, :372 CategoricalDecision,
 * :422 GetLeaf).  Trees are passed as flat arrays with per-tree node
 * offsets; leaf values already carry shrinkage, so raw score = sum over
 * trees.  Linear-tree models stay on the Python path (leaf ridge models
 * need per-leaf feature gathers).
 */
#include <math.h>
#include <stdint.h>

#define K_ZERO_THRESHOLD 1e-35 /* ref: include/LightGBM/meta.h:56 */
#define MISSING_ZERO 1
#define MISSING_NAN 2

/* One tree's traversal for one row; mirrors models/tree.py _decision.
 * Returns the LEAF index — the single source of routing semantics for
 * both value prediction and pred_leaf. */
static int32_t get_leaf_node(const double *row, const int32_t *split_feature,
                             const double *threshold, const int8_t *dtype,
                             const int32_t *left, const int32_t *right,
                             const uint32_t *cat_words,
                             const int32_t *cat_bound) {
  int32_t node = 0;
  while (node >= 0) {
    double fv = row[split_feature[node]];
    int8_t dt = dtype[node];
    int missing_type = (dt >> 2) & 3;
    int is_nan = isnan(fv);
    int go_left;
    if (dt & 1) { /* categorical */
      go_left = 0;
      /* match the Python path exactly (tree.py _decision): v = int(fv)
       * truncates toward zero, negatives go right, and values past any
       * bitset word fall out of range (go right).  fv in (-1, 0)
       * truncates to category 0; doubles beyond long range would be UB
       * to cast, and always exceed the bitset anyway. */
      if (!is_nan && fv > -1.0 && fv < 9.2e18) {
        long v = (long)fv;
        long cat_idx = (long)threshold[node];
        long start = cat_bound[cat_idx], end = cat_bound[cat_idx + 1];
        long word = v / 32;
        if (word < end - start)
          go_left = (cat_words[start + word] >> (v % 32)) & 1u;
      }
    } else {
      double f = (is_nan && missing_type != MISSING_NAN) ? 0.0 : fv;
      int is_zero = fabs(f) <= K_ZERO_THRESHOLD;
      int take_default = (missing_type == MISSING_ZERO && is_zero) ||
                         (missing_type == MISSING_NAN && is_nan);
      go_left = take_default ? ((dt & 2) != 0) : (f <= threshold[node]);
    }
    node = go_left ? left[node] : right[node];
  }
  return ~node;
}

/* Sum T trees' outputs into out[n_rows * K] (class k = tree index % K).
 * Flat layout: tree t's nodes live at node_off[t]..node_off[t+1] in the
 * node arrays, leaves at leaf_off[t].., categorical words/bounds at
 * cat_word_off[t] / cat_bound_off[t].  average > 0 divides by T/K (RF). */
void lgbt_predict_batch(const double *X, long n_rows, long n_cols,
                        const int32_t *split_feature, const double *threshold,
                        const int8_t *dtype, const int32_t *left,
                        const int32_t *right, const double *leaf_value,
                        const uint32_t *cat_words, const int32_t *cat_bound,
                        const long *node_off, const long *leaf_off,
                        const long *cat_word_off, const long *cat_bound_off,
                        long T, long K, int average, double *out) {
  long iters = K > 0 ? T / K : 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long r = 0; r < n_rows; ++r) {
    const double *row = X + r * n_cols;
    for (long t = 0; t < T; ++t) {
      long k = t % K;
      double v;
      if (node_off[t + 1] - node_off[t] <= 0) {
        /* stump: single leaf */
        v = leaf_value[leaf_off[t]];
      } else {
        int32_t leaf = get_leaf_node(
            row, split_feature + node_off[t], threshold + node_off[t],
            dtype + node_off[t], left + node_off[t], right + node_off[t],
            cat_words + cat_word_off[t], cat_bound + cat_bound_off[t]);
        v = leaf_value[leaf_off[t] + leaf];
      }
      out[r * K + k] += v;
    }
    if (average && iters > 0)
      for (long k = 0; k < K; ++k) out[r * K + k] /= (double)iters;
  }
}

/* Leaf indices per (row, tree) into out_idx[n_rows * T]
 * (ref: tree.h:422 GetLeaf; used by pred_leaf / refit). */
void lgbt_predict_leaf(const double *X, long n_rows, long n_cols,
                       const int32_t *split_feature, const double *threshold,
                       const int8_t *dtype, const int32_t *left,
                       const int32_t *right, const uint32_t *cat_words,
                       const int32_t *cat_bound, const long *node_off,
                       const long *cat_word_off, const long *cat_bound_off,
                       long T, int32_t *out_idx) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long r = 0; r < n_rows; ++r) {
    const double *row = X + r * n_cols;
    for (long t = 0; t < T; ++t) {
      long base = node_off[t];
      if (node_off[t + 1] - base <= 0) {
        out_idx[r * T + t] = 0; /* stump */
        continue;
      }
      out_idx[r * T + t] = get_leaf_node(
          row, split_feature + base, threshold + base, dtype + base,
          left + base, right + base, cat_words + cat_word_off[t],
          cat_bound + cat_bound_off[t]);
    }
  }
}
