"""The port's host library (``dfgnn_tpu_torch.native``) against its numpy
plain versions, bitwise (CPU).

Each routine gets seeded graphs with rows of degree 0, at and above the
fanout or bucket width, unsorted rows and isolated tail nodes; each call
site (``Graph.from_coo``, ``bucket_rows_numpy``,
``DenseBatch.from_graph_list``, ``NeighborSampler``) gives the arrays its
plain version gives.  Ids out of range raise ``ValueError`` before the C
call; the build is cached by a hash of the source and flags, and a missing
compiler raises with nothing falling back to numpy.  The comparison with
the JAX package's own library is in ``tests/test_torch_sampling.py``.
"""

import shutil

import numpy as np
import pytest

from dfgnn_tpu_torch import formats, native
from dfgnn_tpu_torch.data.sampling import NeighborSampler, sample_neighbors_plain
from dfgnn_tpu_torch.graph import (DenseBatch, Graph, csr_from_coo_plain,
                                   fill_dense_adj_plain)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def _degree_csr(max_deg, n_tail=3, seed=0):
    """CSR of rows of every degree from 0 to max_deg (3 rows each, in a
    shuffled order), distinct neighbours, then ``n_tail`` isolated nodes."""
    rng = np.random.default_rng(seed)
    degs = rng.permutation(np.repeat(np.arange(max_deg + 1), 3))
    n = degs.size + n_tail
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    indptr = np.concatenate([indptr, np.full(n_tail, indptr[-1])])
    cols = np.concatenate([rng.choice(n, d, replace=False) for d in degs]).astype(np.int64)
    val = rng.standard_normal(cols.size).astype(np.float32)
    return indptr, cols, val, degs


def _coo(seed=1, n=50, e=400):
    """Unsorted COO rows with repeats; the last 5 nodes have no edge."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n - 5, e), rng.integers(0, n, e),
            rng.standard_normal(e).astype(np.float32), n)


@pytest.mark.parametrize("case", ["unsorted", "empty"])
def test_csr_from_coo_matches_plain(case):
    rows, cols, val, n = _coo()
    if case == "empty":
        rows, cols, val = rows[:0], cols[:0], val[:0]
    _equal(native.csr_from_coo(rows, cols, n), csr_from_coo_plain(rows, cols, n))
    # Graph.from_coo: the rows, cols and values of a stable sort by row
    g = Graph.from_coo(rows, cols, n, val=val, device="cpu")
    indptr, cols_s, order = csr_from_coo_plain(rows, cols, n)
    e = rows.size
    np.testing.assert_array_equal(g.indptr.numpy(), indptr)
    np.testing.assert_array_equal(g.rows[:e].numpy(), rows[order])
    np.testing.assert_array_equal(g.cols[:e].numpy(), cols_s)
    np.testing.assert_array_equal(g.val[:e].numpy(), val[order])
    assert (g.rows[e:] == n).all() and (g.cols[e:] == n).all() and (g.val[e:] == 0).all()


@pytest.mark.parametrize("with_val", [False, True])
def test_bucket_fill_matches_plain(with_val, monkeypatch):
    indptr, cols, val, degs = _degree_csr(8)
    val = val if with_val else None
    deg = np.diff(indptr)
    sel = np.nonzero((deg > 2) & (deg <= 8))[0][::-1]  # widths 3 to 8, unsorted
    width, r_pad, sent = 8, sel.size + 5, indptr.size - 1
    want_nbr = np.full((r_pad, width), sent, np.int32)
    want_mask = np.zeros((r_pad, width), bool)
    want_val = None if val is None else np.zeros((r_pad, width), np.float32)
    formats._fill_rows(sel, indptr, cols, val, want_nbr, want_mask, want_val)
    _equal(native.bucket_fill(sel, indptr, cols, val, width, r_pad, sent),
           (want_nbr, want_mask, want_val))

    # the whole builder, edge ids too, against the same builder on the plain fill
    def plain_fill(sel, indptr, cols, val, width, r_pad, sentinel):
        nbr = np.full((r_pad, width), sentinel, np.int32)
        emask = np.zeros((r_pad, width), bool)
        bval = None if val is None else np.zeros((r_pad, width), np.float32)
        formats._fill_rows(sel, indptr, cols, val, nbr, emask, bval)
        return nbr, emask, bval

    kw = dict(n_rows_space=sent, n_cols_space=sent, min_width=2,
              edge_index_map=(None if with_val else np.arange(cols.size)[::-1] * 3, 999))
    got = formats.bucket_rows_numpy(indptr, cols, val, **kw)
    monkeypatch.setattr(native, "bucket_fill", plain_fill)
    want = formats.bucket_rows_numpy(indptr, cols, val, **kw)
    assert [b.width for b in got] == [b.width for b in want] == [2, 4, 8]
    for gb, wb in zip(got, want):
        _equal((gb.row_ids, gb.nbr, gb.emask, gb.val, gb.edge_ids),
               (wb.row_ids, wb.nbr, wb.emask, wb.val, wb.edge_ids))
        assert (gb.n_rows, gb.row_chunk) == (wb.n_rows, wb.row_chunk)


def test_fill_dense_adj_matches_plain():
    rng = np.random.default_rng(2)
    graphs = []
    for n in (7, 0, 16, 1, 12):  # an empty graph and a one-node one among them
        e = 3 * n
        graphs.append((rng.integers(0, max(n, 1), e), rng.integers(0, max(n, 1), e), n))
    offs = np.concatenate([[0], np.cumsum([len(r) for r, _, _ in graphs])])
    rows = np.concatenate([r for r, _, _ in graphs])
    cols = np.concatenate([c for _, c, _ in graphs])
    want = fill_dense_adj_plain(offs, rows, cols, 16)
    _equal((native.fill_dense_adj(offs, rows, cols, 16),), (want,))
    batch = DenseBatch.from_graph_list(graphs, np_pad=16, device="cpu")
    np.testing.assert_array_equal(batch.adj.numpy(), want)
    assert batch.n_edges == int(np.count_nonzero(want))


@pytest.mark.parametrize("fanout,seeds,seed", [
    (4, "all", 0),                # degrees 0 to 12 against fanout 4
    (4, "repeated", 12345),       # repeated seeds, zero-degree ones among them
    (1, "high", 2 ** 63 + 5),     # a seed past 2**63; fanout 1
    (4, "none", 7),               # no seed at all
])
def test_sample_neighbors_matches_plain(fanout, seeds, seed):
    indptr, cols, _, degs = _degree_csr(3 * fanout)
    n = indptr.size - 1
    ids = {"all": np.arange(n), "none": np.arange(0),
           "repeated": np.r_[np.arange(0, n, 3), [0, 0, 5, 5, n - 1, n - 1, 1, 2, 3]],
           "high": np.arange(n)[::-1]}[seeds]
    got = native.sample_neighbors(ids, indptr, cols, fanout, n, seed)
    _equal(got, sample_neighbors_plain(ids, indptr, cols, fanout, n, seed))
    np.testing.assert_array_equal(got[1].sum(1), np.minimum(np.diff(indptr)[ids], fanout))
    # the seed is taken modulo 2**64, as sample()'s seed * 1000003 + li may pass it
    _equal(native.sample_neighbors(ids, indptr, cols, fanout, n, seed + 2 ** 64), got)
    # the sampler's blocks come from the library
    g = Graph.from_coo(np.repeat(np.arange(n), np.diff(indptr)), cols, n, device="cpu")
    b = NeighborSampler(g).sample_layer(ids, fanout, seed).bg.buckets[0]
    np.testing.assert_array_equal(b.nbr[: ids.size], got[0])
    np.testing.assert_array_equal(b.emask[: ids.size], got[1])


def _bad_call(routine, end):
    """A call of ``routine`` with one id past the low or high ``end`` of its
    range, the rest in range."""
    indptr, cols, val, _ = _degree_csr(4)
    n = indptr.size - 1
    bad = -1 if end == "low" else (4 if routine == "fill_dense_adj" else n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return {
        "csr_from_coo": lambda: native.csr_from_coo(np.r_[rows, bad], np.r_[cols, 0], n),
        "bucket_fill": lambda: native.bucket_fill(np.r_[0, 1, bad], indptr, cols, val, 4, 8, n),
        "fill_dense_adj": lambda: native.fill_dense_adj(
            np.array([0, 2, 4]), np.array([0, 1, 2, 3]), np.array([1, 0, 3, bad]), 4),
        "sample_neighbors": lambda: native.sample_neighbors(np.r_[0, bad, 1], indptr, cols, 2,
                                                            n, 0),
    }[routine]


@pytest.mark.parametrize("routine", ["csr_from_coo", "bucket_fill", "fill_dense_adj",
                                     "sample_neighbors"])
def test_out_of_range_ids_raise(routine):
    """An id past either end raises ValueError before the C call writes;
    so do a row wider than its bucket and an indptr past the edges."""
    for end in ("low", "high"):
        with pytest.raises(ValueError, match="out of range"):
            _bad_call(routine, end)()
    indptr, cols, _, _ = _degree_csr(4)
    every, short = np.arange(indptr.size - 1), cols[: cols.size // 2]
    if routine == "bucket_fill":
        wide = np.array([np.argmax(np.diff(indptr))])
        with pytest.raises(ValueError, match="more than width"):
            native.bucket_fill(wide, indptr, cols, None, 3, 1, 0)
        with pytest.raises(ValueError, match="indptr"):
            native.bucket_fill(every, indptr, short, None, 4, every.size, 0)
    if routine == "sample_neighbors":
        with pytest.raises(ValueError, match="indptr"):
            native.sample_neighbors(every, indptr, short, 2, 0, 0)


def test_build_is_cached_and_named_by_source(tmp_path, monkeypatch):
    """A second build returns the same library without compiling; a changed
    copy of the source gets another name; a broken one raises with the
    compiler's message."""
    lib, _ = native.build()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libdfgnn_host-")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    assert native.build() == (lib, "")  # no compiler needed: nothing is compiled
    monkeypatch.undo()
    src = tmp_path / "graph_builder.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// changed\n")
    other, log = native.build(src, tmp_path / "build")
    assert other.exists() and other.name != lib.name and other.name.startswith("libdfgnn_host-")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [other.name]  # no temp left
    src.write_text(native.SOURCE.read_text() + "\nint broken(;\n")
    with pytest.raises(RuntimeError, match="failed to build graph_builder.cpp"):
        native.build(src, tmp_path / "build")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [other.name]


def test_missing_compiler_raises_without_fallback(tmp_path, monkeypatch):
    """With no compiler and no library built, every call site raises
    RuntimeError: none falls back to its numpy plain version."""
    assert shutil.which("g++"), "the host library needs g++"
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        indptr, cols, val, _ = _degree_csr(4)
        n = indptr.size - 1
        rows = np.repeat(np.arange(n), np.diff(indptr))
        calls = [
            lambda: Graph.from_coo(rows[::-1], cols, n, device="cpu"),
            lambda: formats.bucket_rows_numpy(indptr, cols, val, n_rows_space=n,
                                              n_cols_space=n),
            lambda: DenseBatch.from_graph_list([(rows[:3], rows[:3], n)], device="cpu"),
            lambda: native.sample_neighbors(np.arange(n), indptr, cols, 2, n, 0),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="cannot run .*no-such-compiler"):
                call()
    finally:
        native.library.cache_clear()
