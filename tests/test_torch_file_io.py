"""PyTorch port: the file front end (text parsers, the native parser,
`Dataset(path)` with `.weight` / `.query` side files, two-round
streaming, `Sequence` input, binary files) against the JAX package, on
the CPU.

Files are written from seeded NumPy data into pytest's temporary
directory.  Everything here is exact: the port's parser is a copy of the
JAX package's, so parsed matrices, labels and names are equal (NaN where
a value is missing), and the bin mappers, bin codes, labels, weights and
query boundaries of a Dataset built from the same file are equal.  The
cases are those of tests/test_native_parser.py, tests/test_two_round.py
and tests/test_dataset.py::test_binary_save_load, held against the JAX
package's results.
"""

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.io import parser as jparser
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.binning import BIN_CATEGORICAL
from lightgbm_tpu_torch.io.dataset import Dataset as TCore

CPU = {"device_type": "cpu", "verbosity": -1}
N, F = 1500, 5


def _rows(n=N, seed=0):
    """Features with 5% missing, a graded label, query sizes, weights."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, F), 4)
    X[:, 3] = rng.randint(0, 6, n)           # a categorical column
    X[rng.rand(n, F) < 0.05] = np.nan
    X[:, 3] = np.where(np.isnan(X[:, 3]), 0, X[:, 3])
    y = rng.randint(0, 4, n)
    sizes, tot = [], 0
    while tot < n:
        s = min(int(rng.randint(1, 40)), n - tot)
        sizes.append(s)
        tot += s
    w = np.round(0.5 + rng.rand(n), 4)
    return X, y, np.asarray(sizes), w


def _fmt(v):
    return "" if np.isnan(v) else f"{v:.6g}"


def _write(tmp_path, name, X, y, sizes=None, w=None, delim="\t",
           header=False, libsvm=False):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        if header:
            f.write(delim.join(["target"] + [f"f{i}" for i in
                                             range(X.shape[1])]) + "\n")
        for xi, yi in zip(X, y):
            if libsvm:
                f.write(f"{yi} " + " ".join(
                    f"{j}:{v:.6g}" for j, v in enumerate(xi)
                    if not np.isnan(v) and v != 0) + "\n")
            else:
                f.write(delim.join([str(yi)] + [_fmt(v) for v in xi])
                        + "\n")
    if sizes is not None:
        with open(path + ".query", "w") as f:
            f.write("\n".join(map(str, sizes)) + "\n")
    if w is not None:
        with open(path + ".weight", "w") as f:
            f.write("\n".join(f"{v:.6g}" for v in w) + "\n")
    return path


def _cores(path, params, reference=None):
    """The constructed core Datasets of both packages for one file."""
    dj = jlgb.Dataset(path, params=params,
                      reference=None if reference is None else reference[0])
    dt = tlgb.Dataset(path, params={**params, **CPU},
                      reference=None if reference is None else reference[1])
    return dj.construct(), dt.construct()


def assert_same_dataset(cj, ct):
    """Bin mappers, bin codes, labels, weights, query boundaries and
    names equal."""
    np.testing.assert_equal([m.to_dict() for m in ct.bin_mappers],
                            [m.to_dict() for m in cj.bin_mappers])
    assert ct.used_features == cj.used_features
    assert ct.feature_names == cj.feature_names
    np.testing.assert_array_equal(ct.binned_host(),
                                  np.asarray(cj.binned_host()))
    for field in ("label", "weight", "init_score", "query_boundaries"):
        a, b = getattr(ct.metadata, field), getattr(cj.metadata, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- parsers
def _without_native(monkeypatch):
    monkeypatch.setattr(tnative, "parser_lib", lambda: None)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["tsv", "csv_header", "libsvm"])
def test_parse_file_equals_jax(tmp_path, monkeypatch, kind, native):
    X, y, _, _ = _rows()
    path = _write(tmp_path, f"d.{kind}", X, y,
                  delim="," if kind.startswith("csv") else "\t",
                  header=kind == "csv_header", libsvm=kind == "libsvm")
    want = jparser.parse_file(path, has_header=kind == "csv_header")
    if native:
        assert tnative.parser_lib() is not None
    else:
        _without_native(monkeypatch)
    got = tparser.parse_file(path, has_header=kind == "csv_header")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_native_dense_parser():
    txt = ("1\t0.5\t\t3.25\n"
           "0\tna\t2e-3\t-1\n"
           "\n"
           "1\tNaN\t7\tnull\n")
    mat = tnative.parse_dense_native(txt.encode(), "\t", 4, 4)
    assert mat.shape == (3, 4)
    np.testing.assert_array_equal(mat[0], [1, 0.5, np.nan, 3.25])
    np.testing.assert_array_equal(mat[1], [0, np.nan, 2e-3, -1])
    np.testing.assert_array_equal(mat[2], [1, np.nan, 7, np.nan])
    with pytest.raises(ValueError, match="line 2"):
        tnative.parse_dense_native(b"1,2,3\n4,5\n", ",", 2, 3)
    with pytest.raises(ValueError, match="line 2"):
        tnative.parse_dense_native(b"1,2\n3,abc\n", ",", 2, 2)
    m = tnative.parse_dense_native(b"inf,nan\n", ",", 1, 2)
    assert np.isinf(m[0, 0]) and np.isnan(m[0, 1])


def test_native_libsvm_parser():
    feats, labels = tnative.parse_libsvm_native(b"1 0:0.5 3:2.5\n0 1:-1\n1\n")
    np.testing.assert_array_equal(labels, [1, 0, 1])
    np.testing.assert_array_equal(
        feats, [[0.5, 0, 0, 2.5], [0, -1, 0, 0], [0, 0, 0, 0]])
    with pytest.raises(ValueError, match="line 1"):
        tnative.parse_libsvm_native(b"1 0x10:1\n")
    with pytest.raises(ValueError, match="line 2"):
        tnative.parse_libsvm_native(b"1 0:1\n0 1:2q\n")


@pytest.mark.parametrize("native", [True, False])
def test_libsvm_negative_index_rejected(tmp_path, monkeypatch, native):
    f = tmp_path / "bad.svm"
    f.write_text("1 0:1.5 -2:3.0\n0 1:2.0\n")
    if not native:
        _without_native(monkeypatch)
    with pytest.raises(ValueError, match="malformed libsvm pair"):
        tparser.parse_file(str(f))


def test_native_parser_builds_into_build_native():
    lib = tnative.parser_lib()
    assert lib is not None
    assert str(tnative.BUILD_DIR) in lib._name


# ------------------------------------------------------ Dataset(path)
FILE_CASES = {
    "tsv_side_files": dict(kind="tsv", params={}),
    "csv_header_names": dict(kind="csv", params={
        "header": True, "label_column": "name:target",
        "categorical_feature": "name:f3"}),
    "tsv_label_index": dict(kind="tsv", params={
        "label_column": "0", "categorical_feature": "3"}),
    "libsvm": dict(kind="libsvm", params={}),
}


@pytest.mark.parametrize("two_round", [False, True])
@pytest.mark.parametrize("case", list(FILE_CASES))
def test_dataset_from_file_equals_jax(tmp_path, case, two_round):
    c = FILE_CASES[case]
    X, y, sizes, w = _rows()
    path = _write(tmp_path, f"r.{c['kind']}", X, y, sizes, w,
                  delim="," if c["kind"] == "csv" else "\t",
                  header=c["params"].get("header", False),
                  libsvm=c["kind"] == "libsvm")
    params = {**c["params"], "two_round": two_round,
              "bin_construct_sample_cnt": 500}
    dj, dt = _cores(path, params)
    assert_same_dataset(dj._core, dt._core)
    assert dt._core.metadata.weight is not None
    np.testing.assert_array_equal(np.diff(dt._core.metadata.query_boundaries),
                                  sizes)
    if "categorical_feature" in c["params"]:
        assert dt._core.bin_mappers[3].bin_type == BIN_CATEGORICAL
    # a valid file against it, streamed or whole as the training file
    Xv, yv, sv, _ = _rows(400, seed=1)
    vpath = _write(tmp_path, f"v.{c['kind']}", Xv, yv, sv,
                   delim="," if c["kind"] == "csv" else "\t",
                   header=c["params"].get("header", False),
                   libsvm=c["kind"] == "libsvm")
    vj, vt = _cores(vpath, params, reference=(dj, dt))
    assert_same_dataset(vj._core, vt._core)
    assert vt._core.bin_mappers is dt._core.bin_mappers


def test_two_round_matches_in_memory(tmp_path):
    """tests/test_two_round.py: when the bin sample holds every row the
    streamed and the whole file give the same bins and the same model."""
    X, y, sizes, _ = _rows()
    path = _write(tmp_path, "s.tsv", X, (y > 1).astype(int))
    params = {"objective": "binary", "num_leaves": 15, **CPU}
    ds_mem = tlgb.Dataset(path, params=params)
    ds_two = tlgb.Dataset(path, params={**params, "two_round": True})
    b_mem = tlgb.train(params, ds_mem, 5)
    b_two = tlgb.train(params, ds_two, 5)
    np.testing.assert_array_equal(ds_mem._core.binned_host(),
                                  ds_two._core.binned_host())
    assert (b_mem.model_to_string().split("\nparameters:")[0]
            == b_two.model_to_string().split("\nparameters:")[0])


def test_two_round_libsvm_late_wide_feature(tmp_path):
    path = str(tmp_path / "wide.svm")
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for _ in range(2000):
            f.write(f"{rng.randint(0, 2)} 0:{rng.rand():.4f} "
                    f"2:{rng.rand():.4f}\n")
        f.write("1 0:0.5 9:1.25\n")
    dj, dt = _cores(path, {"two_round": True})
    assert dt._core.num_data == 2001
    assert dt._core.num_total_features == 10
    assert_same_dataset(dj._core, dt._core)
    b = tlgb.train({"objective": "binary", "num_leaves": 7, **CPU}, dt, 3)
    assert np.isfinite(b.predict(np.zeros((2, 10)))).all()


def test_two_round_rejects_linear_tree(tmp_path):
    X, y, _, _ = _rows(300)
    path = _write(tmp_path, "lt.tsv", X, y)
    with pytest.raises(tlgb.LightGBMError, match="two_round"):
        tlgb.Dataset(path, params={"two_round": True, "linear_tree": True,
                                   **CPU}).construct()


def test_two_round_validation_set_streams(tmp_path):
    """tests/test_two_round.py: the valid file streamed against the
    training mappers evaluates as the whole file does."""
    X, y, _, _ = _rows()
    Xv, yv, _, _ = _rows(600, seed=9)
    tr = _write(tmp_path, "tr.tsv", X, (y > 1).astype(int))
    va = _write(tmp_path, "va.tsv", Xv, (yv > 1).astype(int))
    p = {"objective": "binary", "num_leaves": 15,
         "metric": "binary_logloss", **CPU}

    def run(two):
        ds = tlgb.Dataset(tr, params={**CPU, "two_round": two})
        vs = tlgb.Dataset(va, params={**CPU, "two_round": two},
                          reference=ds)
        rec = {}
        tlgb.train(p, ds, 5, valid_sets=[vs],
                   callbacks=[tlgb.record_evaluation(rec)])
        return rec["valid_0"]["binary_logloss"]

    np.testing.assert_allclose(run(True), run(False), rtol=1e-12)


def test_create_valid_from_path(tmp_path):
    X, y, sizes, w = _rows()
    Xv, yv, sv, _ = _rows(400, seed=1)
    path = _write(tmp_path, "t.tsv", X, y, sizes, w)
    vpath = _write(tmp_path, "t.valid", Xv, yv, sv)
    ds = tlgb.Dataset(path, params=CPU)
    vs = ds.create_valid(vpath).construct()
    want = tlgb.Dataset(Xv, label=yv, group=sv, reference=ds).construct()
    np.testing.assert_array_equal(vs._core.binned_host(),
                                  want._core.binned_host())
    np.testing.assert_array_equal(vs._core.metadata.query_boundaries,
                                  want._core.metadata.query_boundaries)


# --------------------------------------------------------- Sequence
class _Rows(tlgb.Sequence):
    def __init__(self, X, batch_size=128):
        self.X, self.batch_size = X, batch_size

    def __getitem__(self, idx):
        return self.X[idx]

    def __len__(self):
        return len(self.X)


class _JRows(jlgb.Sequence):
    def __init__(self, X, batch_size=128):
        self.X, self.batch_size = X, batch_size

    def __getitem__(self, idx):
        return self.X[idx]

    def __len__(self):
        return len(self.X)


@pytest.mark.parametrize("two_round", [False, True])
def test_sequence_input_equals_jax(two_round):
    X, y, sizes, _ = _rows()
    params = {"two_round": two_round, "bin_construct_sample_cnt": 700}
    dj = jlgb.Dataset([_JRows(X[:900]), _JRows(X[900:])], label=y,
                      group=sizes, params=params).construct()
    dt = tlgb.Dataset([_Rows(X[:900]), _Rows(X[900:])], label=y,
                      group=sizes, params={**params, **CPU}).construct()
    assert_same_dataset(dj._core, dt._core)
    if not two_round:
        arr = tlgb.Dataset(X, label=y, group=sizes,
                           params={**params, **CPU}).construct()
        np.testing.assert_array_equal(arr._core.binned_host(),
                                      dt._core.binned_host())


# ------------------------------------------------------ binary files
def test_binary_save_load(tmp_path):
    """tests/test_dataset.py::test_binary_save_load on the port."""
    rng = np.random.RandomState(0)
    X = rng.randn(500, 4)
    y = X[:, 0] > 0
    ds = TCore.construct_from_arrays(X, label=y, max_bin=32,
                                     device_type="cpu")
    path = str(tmp_path / "data.bin")
    ds.save_binary(path)
    ds2 = TCore.load_binary(path, device_type="cpu")
    np.testing.assert_array_equal(ds.binned, ds2.binned)
    np.testing.assert_array_equal(ds.metadata.label, ds2.metadata.label)
    assert ds2.bin_mappers[0].num_bin == ds.bin_mappers[0].num_bin


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_files_cross_both_ways(tmp_path, writer):
    X, y, sizes, w = _rows()
    path = _write(tmp_path, "b.tsv", X, y, sizes, w)
    dj, dt = _cores(path, {})
    binpath = str(tmp_path / f"{writer}.bin")
    (dt if writer == "port" else dj).save_binary(binpath)
    lj = jlgb.Dataset(binpath).construct()
    lt = tlgb.Dataset(binpath, params=CPU).construct()
    for core in (lj._core, lt._core):
        assert_same_dataset(dj._core, core)


def test_binary_file_of_sparse_input_keeps_its_bundles(tmp_path):
    import scipy.sparse as sps
    rng = np.random.RandomState(2)
    dense = rng.rand(800, 12) * (rng.rand(800, 12) < 0.15)
    y = (dense[:, 0] + dense[:, 1] > 0.2).astype(float)
    dt = tlgb.Dataset(sps.csr_matrix(dense), label=y, params=CPU)
    path = str(tmp_path / "sp.bin")
    dt.save_binary(path)
    lt = tlgb.Dataset(path, params=CPU).construct()
    lj = jlgb.Dataset(path).construct()
    for core in (lt._core, lj._core):
        assert core.pre_bundled_plan is not None
        assert (core.pre_bundled_plan.groups
                == dt._core.pre_bundled_plan.groups)
        np.testing.assert_array_equal(np.asarray(core.binned_host()),
                                      dt._core.binned_host())
    p = {"objective": "binary", "num_leaves": 7, **CPU}
    assert (tlgb.train(p, lt, 3).model_to_string()
            .split("\nparameters:")[0]
            == tlgb.train(p, dt, 3).model_to_string()
            .split("\nparameters:")[0])


# --------------------------------------------- ranking from a file
def test_lambdarank_from_file_equals_arrays(tmp_path):
    """A ranking file with its .query and .weight side files trains the
    trees of the same rows given as arrays."""
    X, y, sizes, w = _rows()
    path = _write(tmp_path, "rank.tsv", X, y, sizes, w)
    p = {"objective": "lambdarank", "num_leaves": 15, "min_data_in_leaf": 5,
         **CPU}
    b_file = tlgb.train(p, tlgb.Dataset(path, params=p), 3)
    Xp, yp, _ = tparser.parse_file(path)
    b_arr = tlgb.train(p, tlgb.Dataset(Xp, label=yp, group=sizes,
                                       weight=w.astype(np.float32),
                                       params=p), 3)
    assert (b_file.model_to_string().split("\nparameters:")[0]
            == b_arr.model_to_string().split("\nparameters:")[0])
