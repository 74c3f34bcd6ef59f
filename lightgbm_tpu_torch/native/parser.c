/* Native text parser: dense CSV/TSV and LibSVM hot loops (the PyTorch
 * port's copy of lightgbm_tpu/native/parser.c).
 *
 * The host analogue of the reference's C++ parser layer
 * (ref: src/io/parser.cpp:1-395 CSVParser/TSVParser/LibSVMParser with
 * Common::Atof; dataset_loader.cpp:1263 ExtractFeaturesFromMemory): the
 * format/label detection stays in Python (io/parser.py), the per-token
 * work runs here.  Loaded via ctypes (native/__init__.py), compiled once
 * per source hash into build/native/.
 */
#include <math.h>
#include <stdlib.h>
#include <string.h>

/* strtod accepts "nan"/"inf"; empty tokens and na/null map to NaN.
 * Any other token that strtod cannot FULLY consume sets *err — matching
 * the Python fallback's float(tok) ValueError, so native and fallback
 * reject the same inputs (ref: parser.cpp Common::Atof strictness). */
static double parse_token(const char *s, const char *end, int *err) {
  while (s < end && (*s == ' ' || *s == '\r')) ++s;
  const char *e = end;
  while (e > s && (e[-1] == ' ' || e[-1] == '\r')) --e;
  if (s == e) return NAN;
  if ((e - s) == 2 && (s[0] == 'n' || s[0] == 'N') &&
      (s[1] == 'a' || s[1] == 'A'))
    return NAN;
  if ((e - s) == 4 && (s[0] == 'n' || s[0] == 'N') &&
      (s[1] == 'u' || s[1] == 'U') && (s[2] == 'l' || s[2] == 'L') &&
      (s[3] == 'l' || s[3] == 'L'))
    return NAN;
  char tmp[64];
  size_t len = (size_t)(e - s);
  if (len >= sizeof(tmp)) { *err = 1; return NAN; }
  memcpy(tmp, s, len);
  tmp[len] = '\0';
  char *endp = NULL;
  double v = strtod(tmp, &endp);
  if (endp != tmp + len) { *err = 1; return NAN; }
  return v;
}

/* Parse dense delimiter-separated text into out[n_rows * n_cols].
 * Blank lines are skipped.  Returns rows filled, or -(line_no) when a
 * non-blank line has a different column count (1-based over data lines). */
long lgbt_parse_dense(const char *buf, long len, char delim, long n_rows,
                      long n_cols, double *out) {
  long row = 0;
  const char *p = buf, *bend = buf + len;
  while (p < bend && row < n_rows) {
    const char *line_end = memchr(p, '\n', (size_t)(bend - p));
    if (!line_end) line_end = bend;
    /* skip blank lines */
    const char *q = p;
    while (q < line_end && (*q == ' ' || *q == '\r' || *q == '\t')) ++q;
    if (q == line_end) { p = line_end + 1; continue; }
    double *dst = out + row * n_cols;
    long col = 0;
    const char *tok = p;
    for (const char *c = p; ; ++c) {
      if (c == line_end || *c == delim) {
        if (col >= n_cols) return -(row + 1);
        int err = 0;
        dst[col++] = parse_token(tok, c, &err);
        if (err) return -(row + 1);
        tok = c + 1;
        if (c == line_end) break;
      }
    }
    if (col != n_cols) return -(row + 1);
    ++row;
    p = line_end + 1;
  }
  return row;
}

/* LibSVM pass 1: count data rows and the max feature index.
 * Returns row count; *max_idx gets the largest k seen in "k:v" (or -1). */
long lgbt_libsvm_scan(const char *buf, long len, long *max_idx) {
  long rows = 0, mx = -1;
  const char *p = buf, *bend = buf + len;
  while (p < bend) {
    const char *line_end = memchr(p, '\n', (size_t)(bend - p));
    if (!line_end) line_end = bend;
    const char *q = p;
    while (q < line_end && (*q == ' ' || *q == '\r' || *q == '\t')) ++q;
    if (q < line_end) {
      ++rows;
      for (const char *c = q; c < line_end; ++c) {
        if (*c == ':') {
          long k = 0;
          const char *d = c - 1;
          long mul = 1;
          while (d >= q && *d >= '0' && *d <= '9') {
            k += (*d - '0') * mul;
            mul *= 10;
            --d;
          }
          if (mul > 1 && k > mx) mx = k;
        }
      }
    }
    p = line_end + 1;
  }
  *max_idx = mx;
  return rows;
}

/* LibSVM pass 2: labels[n_rows] and dense out[n_rows * n_cols] (caller
 * zero-fills; absent entries mean 0 in LibSVM).  Returns rows filled,
 * or -(line_no) on a malformed pair / out-of-range index. */
long lgbt_parse_libsvm(const char *buf, long len, long n_rows, long n_cols,
                       double *labels, double *out) {
  long row = 0;
  const char *p = buf, *bend = buf + len;
  while (p < bend && row < n_rows) {
    const char *line_end = memchr(p, '\n', (size_t)(bend - p));
    if (!line_end) line_end = bend;
    const char *q = p;
    while (q < line_end && (*q == ' ' || *q == '\r' || *q == '\t')) ++q;
    if (q == line_end) { p = line_end + 1; continue; }
    /* label = first whitespace-separated token */
    const char *t = q;
    while (t < line_end && *t != ' ' && *t != '\t') ++t;
    int err = 0;
    labels[row] = parse_token(q, t, &err);
    if (err) return -(row + 1);
    double *dst = out + row * n_cols;
    const char *c = t;
    while (c < line_end) {
      while (c < line_end && (*c == ' ' || *c == '\t' || *c == '\r')) ++c;
      if (c == line_end) break;
      const char *pair_end = c;
      while (pair_end < line_end && *pair_end != ' ' && *pair_end != '\t' &&
             *pair_end != '\r')
        ++pair_end;
      const char *colon = memchr(c, ':', (size_t)(pair_end - c));
      if (!colon) return -(row + 1);
      char *idx_end = NULL;
      long k = strtol(c, &idx_end, 10);
      if (idx_end != colon || k < 0 || k >= n_cols) return -(row + 1);
      dst[k] = parse_token(colon + 1, pair_end, &err);
      if (err) return -(row + 1);
      c = pair_end;
    }
    ++row;
    p = line_end + 1;
  }
  return row;
}
