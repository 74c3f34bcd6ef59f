/* TreeSHAP: exact per-row SHAP values for decision-tree ensembles.
 *
 * Native-runtime analogue of the reference's C++ TreeSHAP
 * (ref: include/LightGBM/tree.h:139 PredictContrib; src/io/tree.cpp).
 * Implemented from the published algorithm (Lundberg, Erion & Lee 2018,
 * "Consistent Individualized Feature Attribution for Tree Ensembles",
 * Algorithm 2) — not a translation of the reference source.
 *
 * Tree encoding matches models/tree.py: internal nodes indexed >= 0,
 * leaves as ~leaf; decision_type bit 0 = categorical, bit 1 =
 * default_left, bits 2-3 = missing type (0 none, 1 zero, 2 nan).
 *
 * Compile: gcc -O2 -shared -fPIC -o libtreeshap.so treeshap.c
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

#define MISSING_NONE 0
#define MISSING_ZERO 1
#define MISSING_NAN 2
#define K_ZERO_THRESHOLD 1e-35

typedef struct {
  int feature_index;
  double zero_fraction;
  double one_fraction;
  double pweight;
} PathElement;

typedef struct {
  const int *split_feature;   /* [ni] real feature index */
  const double *threshold;    /* [ni] */
  const int8_t *decision_type;/* [ni] */
  const int *left_child;      /* [ni] */
  const int *right_child;     /* [ni] */
  const double *leaf_value;   /* [nl] */
  const double *internal_count; /* [ni] */
  const double *leaf_count;   /* [nl] */
  const uint32_t *cat_threshold; /* bitset words */
  const int *cat_boundaries;  /* [num_cat+1] */
  int num_cat;
} TreeData;

static double node_count(const TreeData *t, int node) {
  return node < 0 ? t->leaf_count[~node] : t->internal_count[node];
}

static int decision(const TreeData *t, int node, const double *x) {
  /* mirrors tree.h:335 NumericalDecision / :372 CategoricalDecision */
  double fval = x[t->split_feature[node]];
  int8_t dt = t->decision_type[node];
  int missing_type = (dt >> 2) & 3;
  int default_left = (dt & 2) != 0;
  int is_cat = (dt & 1) != 0;
  if (is_cat) {
    if (isnan(fval) || fval < 0) return 0;
    int v = (int)fval;
    int cat_idx = (int)t->threshold[node];
    int start = t->cat_boundaries[cat_idx];
    int end = t->cat_boundaries[cat_idx + 1];
    int word = v / 32;
    if (word >= end - start) return 0;
    return (t->cat_threshold[start + word] >> (v % 32)) & 1u;
  }
  if (isnan(fval) && missing_type != MISSING_NAN) fval = 0.0;
  if ((missing_type == MISSING_ZERO && fabs(fval) <= K_ZERO_THRESHOLD) ||
      (missing_type == MISSING_NAN && isnan(fval)))
    return default_left;
  return fval <= t->threshold[node];
}

static void extend_path(PathElement *path, int unique_depth,
                        double zero_fraction, double one_fraction,
                        int feature_index) {
  path[unique_depth].feature_index = feature_index;
  path[unique_depth].zero_fraction = zero_fraction;
  path[unique_depth].one_fraction = one_fraction;
  path[unique_depth].pweight = unique_depth == 0 ? 1.0 : 0.0;
  for (int i = unique_depth - 1; i >= 0; i--) {
    path[i + 1].pweight +=
        one_fraction * path[i].pweight * (i + 1) / (double)(unique_depth + 1);
    path[i].pweight = zero_fraction * path[i].pweight *
                      (unique_depth - i) / (double)(unique_depth + 1);
  }
}

static void unwind_path(PathElement *path, int unique_depth, int path_index) {
  double one_fraction = path[path_index].one_fraction;
  double zero_fraction = path[path_index].zero_fraction;
  double next_one_portion = path[unique_depth].pweight;
  for (int i = unique_depth - 1; i >= 0; i--) {
    if (one_fraction != 0) {
      double tmp = path[i].pweight;
      path[i].pweight =
          next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction);
      next_one_portion = tmp - path[i].pweight * zero_fraction *
                                   (unique_depth - i) /
                                   (double)(unique_depth + 1);
    } else {
      path[i].pweight = path[i].pweight * (unique_depth + 1) /
                        (zero_fraction * (unique_depth - i));
    }
  }
  for (int i = path_index; i < unique_depth; i++) {
    path[i].feature_index = path[i + 1].feature_index;
    path[i].zero_fraction = path[i + 1].zero_fraction;
    path[i].one_fraction = path[i + 1].one_fraction;
  }
}

static double unwound_path_sum(const PathElement *path, int unique_depth,
                               int path_index) {
  double one_fraction = path[path_index].one_fraction;
  double zero_fraction = path[path_index].zero_fraction;
  double next_one_portion = path[unique_depth].pweight;
  double total = 0.0;
  for (int i = unique_depth - 1; i >= 0; i--) {
    if (one_fraction != 0) {
      double tmp =
          next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction);
      total += tmp;
      next_one_portion = path[i].pweight - tmp * zero_fraction *
                                               (unique_depth - i) /
                                               (double)(unique_depth + 1);
    } else {
      total += path[i].pweight /
               (zero_fraction * (unique_depth - i) /
                (double)(unique_depth + 1));
    }
  }
  return total;
}

static void shap_recurse(const TreeData *t, const double *x, double *phi,
                         int node, PathElement *parent_path, int unique_depth,
                         double parent_zero_fraction,
                         double parent_one_fraction, int parent_feature) {
  PathElement *path = parent_path + unique_depth + 1;
  if (unique_depth > 0)
    memcpy(path, parent_path, unique_depth * sizeof(PathElement));
  extend_path(path, unique_depth, parent_zero_fraction, parent_one_fraction,
              parent_feature);

  if (node < 0) { /* leaf */
    double v = t->leaf_value[~node];
    for (int i = 1; i <= unique_depth; i++) {
      double w = unwound_path_sum(path, unique_depth, i);
      phi[path[i].feature_index] +=
          w * (path[i].one_fraction - path[i].zero_fraction) * v;
    }
    return;
  }

  int feature = t->split_feature[node];
  int lc = t->left_child[node];
  int rc = t->right_child[node];
  int hot = decision(t, node, x) ? lc : rc;
  int cold = hot == lc ? rc : lc;
  double w = node_count(t, node);
  double hot_zero_fraction = node_count(t, hot) / w;
  double cold_zero_fraction = node_count(t, cold) / w;
  double incoming_zero_fraction = 1.0;
  double incoming_one_fraction = 1.0;

  int path_index = 0;
  for (; path_index <= unique_depth; path_index++)
    if (path[path_index].feature_index == feature) break;
  if (path_index != unique_depth + 1) {
    incoming_zero_fraction = path[path_index].zero_fraction;
    incoming_one_fraction = path[path_index].one_fraction;
    unwind_path(path, unique_depth, path_index);
    unique_depth -= 1;
  }

  shap_recurse(t, x, phi, hot, path, unique_depth + 1,
               hot_zero_fraction * incoming_zero_fraction,
               incoming_one_fraction, feature);
  shap_recurse(t, x, phi, cold, path, unique_depth + 1,
               cold_zero_fraction * incoming_zero_fraction, 0.0, feature);
}

/* phi: [num_rows, num_columns] preallocated, num_columns >= max feature
 * index + 2; column num_columns-1 accumulates the expected value.
 * X: [num_rows, num_x_cols] row-major raw features.
 * scratch: at least (max_depth+2)*(max_depth+3)/2 PathElements worth of
 * doubles*4, caller-allocated. Returns 0 on success. */
int treeshap_batch(
    const int *split_feature, const double *threshold,
    const int8_t *decision_type, const int *left_child, const int *right_child,
    const double *leaf_value, const double *internal_count,
    const double *leaf_count, const uint32_t *cat_threshold,
    const int *cat_boundaries, int num_cat, int num_leaves,
    const double *X, long num_rows, int num_x_cols,
    double *phi, int num_columns, double *scratch) {
  TreeData t = {split_feature, threshold, decision_type, left_child,
                right_child, leaf_value, internal_count, leaf_count,
                cat_threshold, cat_boundaries, num_cat};
  if (num_leaves <= 1) {
    for (long r = 0; r < num_rows; r++)
      phi[r * num_columns + num_columns - 1] += leaf_value[0];
    return 0;
  }
  double root_count = t.internal_count[0];
  double expected = 0.0;
  for (int l = 0; l < num_leaves; l++)
    expected += leaf_value[l] * leaf_count[l];
  expected /= root_count;
  PathElement *paths = (PathElement *)scratch;
  for (long r = 0; r < num_rows; r++) {
    const double *x = X + (long)r * num_x_cols;
    double *ph = phi + (long)r * num_columns;
    shap_recurse(&t, x, ph, 0, paths, 0, 1.0, 1.0, -1);
    ph[num_columns - 1] += expected;
  }
  return 0;
}
