"""Full-graph and batched-graph datasets (numpy only).

A copy of :mod:`dfgnn_tpu.data.datasets`: the same registry, the same
``zlib.crc32(name)``-seeded synthetic stand-ins and the same loaders, so the
two packages make identical datasets.  The copy exists because importing
anything under ``dfgnn_tpu`` imports JAX.

Loading policy, as in the JAX package:
1. ``<data_dir>/<name>.npz`` (full graphs) or ``<name>_batched.npz`` when
   present;
2. Planetoid pickles (``ind.<name>.*``) for cora / citeseer / pubmed;
   ``digits`` / ``digits-func``: sklearn's handwritten digits as pixel graphs;
3. otherwise a deterministic synthetic stand-in at the reference's scale
   anchors, marked ``synthetic=True``.  scipy (the full-graph stand-ins'
   planted labels and the Planetoid reader) and scikit-learn are imported
   only where they are used.
"""

from __future__ import annotations

import os
import pickle
import sys
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from dfgnn_tpu_torch.data import synthetic as syn


@dataclass
class FullGraphDataset:
    """One large graph with node features, labels and split masks."""

    name: str
    rows: np.ndarray
    cols: np.ndarray
    features: np.ndarray       # [n, d] float or int
    labels: np.ndarray         # [n]
    num_classes: int
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    synthetic: bool = False

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def n_edges(self) -> int:
        return len(self.rows)


@dataclass
class BatchedGraphDataset:
    """List of small graphs with graph- or node-level targets."""

    name: str
    graphs: List[Tuple[np.ndarray, np.ndarray, int]]  # (rows, cols, n_nodes)
    node_features: List[np.ndarray]
    labels: np.ndarray          # graph-level [G, ...] or node-level list
    task: str                   # 'graph_classification' | 'node_classification' | 'graph_regression' | 'graph_classification_multilabel'
    num_classes: int
    feature_kind: str           # 'float' | 'category' | 'atom'
    in_dim: int
    synthetic: bool = False

    def __len__(self):
        return len(self.graphs)


# scale anchors from the reference's measured statistics
_FULL_ANCHORS = {
    # name: (n_nodes, avg_deg, n_feat, n_classes, power_law)
    "cora": (2708, 4, 1433, 7, False),
    "cite": (3327, 3, 3703, 6, False),
    "citeseer": (3327, 3, 3703, 6, False),
    "pubmed": (19717, 5, 500, 3, False),
    "arxiv": (169343, 13, 128, 40, False),
    "reddit": (232965, 492, 602, 41, True),
    "ppa": (576289, 73, 58, 47, True),
    "protein": (132534, 300, 8, 112, True),
}

_BATCH_ANCHORS = {
    # name: (mean_nodes, deg, feature_kind, in_dim, n_classes, task)
    "PATTERN": (119, 51, "category", 3, 2, "node_classification"),
    "CLUSTER": (117, 36, "category", 7, 6, "node_classification"),
    "MNIST": (70, 8, "float", 3, 10, "graph_classification"),
    "CIFAR10": (117, 8, "float", 5, 10, "graph_classification"),
    "PascalVOC-SP": (479, 8, "float", 14, 21, "node_classification"),
    "COCO-SP": (477, 8, "float", 14, 81, "node_classification"),
    # multi-label: C independent binary tasks; molpcba has NaN holes
    "Peptides-func": (151, 2, "atom", 9, 10, "graph_classification_multilabel"),
    "Peptides-struct": (151, 2, "atom", 9, 11, "graph_regression"),
    "ogbg-molhiv": (26, 2, "atom", 9, 1, "graph_classification"),
    "ogbg-molpcba": (26, 2, "atom", 9, 128, "graph_classification_multilabel"),
    # real data: sklearn's handwritten digits as pixel graphs
    "digits": (64, 8, "float", 3, 10, "graph_classification"),
    "digits-func": (64, 8, "float", 3, 10, "graph_classification_multilabel"),
}


def _parse_planetoid(name: str, data_dir: str) -> Optional[FullGraphDataset]:
    """Planetoid ``ind.<name>.*`` pickle format (cora / citeseer / pubmed)."""
    alias = {"cite": "citeseer"}.get(name, name)
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    paths = [os.path.join(data_dir, f"ind.{alias}.{s}") for s in names]
    ti_path = os.path.join(data_dir, f"ind.{alias}.test.index")
    if not all(os.path.exists(p) for p in paths) or not os.path.exists(ti_path):
        return None
    objs = []
    for p in paths:
        with open(p, "rb") as f:
            objs.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objs
    test_idx = np.loadtxt(ti_path, dtype=np.int64)
    test_range = np.sort(test_idx)

    import scipy.sparse as sp

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_range, :]
    features = np.asarray(features.todense(), dtype=np.float32)
    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx, :] = labels_oh[test_range, :]
    labels = labels_oh.argmax(axis=1)

    rows_l, cols_l = [], []
    for src, nbrs in graph.items():
        for dst in nbrs:
            rows_l.append(src)
            cols_l.append(dst)
    rows = np.asarray(rows_l)
    cols = np.asarray(cols_l)

    n = features.shape[0]
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[: y.shape[0]] = True
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask[test_idx] = True
    return FullGraphDataset(
        name=name, rows=rows, cols=cols, features=features,
        labels=labels, num_classes=int(labels.max()) + 1,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
    )


def _load_npz_full(name: str, data_dir: str) -> Optional[FullGraphDataset]:
    p = os.path.join(data_dir, f"{name}.npz")
    if not os.path.exists(p):
        return None
    z = np.load(p, allow_pickle=False)
    n = z["features"].shape[0]

    def mask(key):
        return z[key] if key in z else np.zeros(n, bool)

    return FullGraphDataset(
        name=name, rows=z["rows"], cols=z["cols"], features=z["features"],
        labels=z["labels"], num_classes=int(z["labels"].max()) + 1,
        train_mask=mask("train_mask"), val_mask=mask("val_mask"),
        test_mask=mask("test_mask"),
    )


def _synthetic_full(name: str, scale: float = 1.0) -> FullGraphDataset:
    n, deg, d, c, power = _FULL_ANCHORS[name]
    n = max(64, int(n * scale))
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if power:
        # reddit keeps the JAX package's deg-64 cap so its stand-in is the
        # one the JAX package measured; the other super-node graphs use their
        # true average degree
        cap = 64 if name == "reddit" else 300
        rows, cols = syn.power_law_graph(rng, n, avg_deg=min(deg, cap), alpha=1.6)
    else:
        rows, cols = syn.constant_degree_graph(rng, n, deg)
    d_eff = min(d, 256)  # cap synthetic feature width
    features = rng.standard_normal((n, d_eff)).astype(np.float32)
    # planted learnable labels: class = argmax of a random projection of
    # (own + mean-neighbour) features, so message passing helps
    try:
        import scipy.sparse as sp

        A = sp.coo_matrix(
            (np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)
        ).tocsr()
        h = features + np.asarray(A.dot(features)) / np.maximum(
            np.asarray(A.sum(axis=1)), 1.0)
        w = rng.standard_normal((d_eff, c)).astype(np.float32)
        labels = (h @ w).argmax(axis=1)
    except ImportError:  # scipy-free: feature-only labels, as the JAX package
        w = rng.standard_normal((d_eff, c)).astype(np.float32)
        labels = (features @ w).argmax(axis=1)
    masks = rng.random(n)
    return FullGraphDataset(
        name=name, rows=rows, cols=cols, features=features, labels=labels,
        num_classes=c,
        train_mask=masks < 0.6, val_mask=(masks >= 0.6) & (masks < 0.8),
        test_mask=masks >= 0.8, synthetic=True,
    )


def load_full_graph(name: str, data_dir: str = "data", *, scale: float = 1.0,
                    quiet: bool = False) -> FullGraphDataset:
    """A full-graph dataset by name (role of the reference's
    ``load_data_full_graph``); ``scale`` shrinks a synthetic stand-in's node
    count."""
    if name not in _FULL_ANCHORS:
        raise KeyError(f"unknown full-graph dataset {name!r}; choose from {sorted(_FULL_ANCHORS)}")
    ds = _load_npz_full(name, data_dir)
    if ds is None and name in ("cora", "cite", "citeseer", "pubmed"):
        ds = _parse_planetoid(name, data_dir)
    if ds is None:
        ds = _synthetic_full(name, scale)
        if not quiet:
            print(f"[dfgnn-tpu] {name}: no local data found, using synthetic "
                  f"stand-in (n={ds.n_nodes}, e={ds.n_edges})", file=sys.stderr)
    return ds


def _synthetic_batched(name: str, n_graphs: int) -> BatchedGraphDataset:
    mean_nodes, deg, kind, in_dim, n_classes, task = _BATCH_ANCHORS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    graphs, feats = [], []
    if name in ("PATTERN", "CLUSTER"):
        raw = syn.pattern_like_batch(rng, n_graphs, mean_nodes=mean_nodes, avg_deg=deg)
        node_labels = []
        for r, c, n, block in raw:
            graphs.append((r, c, n))
            feats.append(rng.integers(0, in_dim, size=n))
            node_labels.append(block % n_classes)
        labels = node_labels
    else:
        np_cap = 512 if "SP" in name else 128
        raw = syn.small_graph_batch(
            rng, n_graphs, mean_nodes=min(mean_nodes, np_cap), deg=deg,
            max_nodes=np_cap,
        )
        labels_l = []
        for r, c, n, _ in raw:
            graphs.append((r, c, n))
            if kind == "float":
                feats.append(rng.standard_normal((n, in_dim)).astype(np.float32))
            elif kind == "atom":
                feats.append(rng.integers(0, 2, size=(n, 9)))
            else:
                feats.append(rng.integers(0, in_dim, size=n))
            if task == "node_classification":
                labels_l.append(rng.integers(0, n_classes, size=n))
            elif task == "graph_regression":
                labels_l.append(rng.standard_normal(n_classes).astype(np.float32))
            elif task == "graph_classification_multilabel":
                y = rng.integers(0, 2, size=n_classes).astype(np.float32)
                if name == "ogbg-molpcba":  # molpcba-style missing labels
                    y[rng.random(n_classes) < 0.3] = np.nan
                labels_l.append(y)
            else:
                labels_l.append(rng.integers(0, 2 if n_classes == 1 else n_classes))
        labels = labels_l if task == "node_classification" else np.asarray(labels_l)
    return BatchedGraphDataset(
        name=name, graphs=graphs, node_features=feats, labels=labels,
        task=task, num_classes=n_classes, feature_kind=kind, in_dim=in_dim,
        synthetic=True,
    )


def _load_digits(name: str) -> BatchedGraphDataset:
    """Real batched graphs from sklearn's handwritten digits.

    Each 8x8 image is a pixel graph: 64 nodes, 8-neighbourhood grid links
    kept where at least one end is inked; features [intensity/16, row/7,
    col/7].  ``digits-func``: 10 one-vs-all binary targets with a fixed 20%
    of (graph, task) cells set to NaN.  Needs scikit-learn, imported here
    only: where it is missing (the card's machine has none) this raises
    ``ImportError``.
    """
    from sklearn import datasets as skd

    d = skd.load_digits()
    images = d.images  # [1797, 8, 8] float (0..16)
    target = d.target.astype(np.int64)

    # 8-neighbourhood grid edge template (both directions)
    idx = np.arange(64).reshape(8, 8)
    src_l, dst_l = [], []
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            rs = slice(max(0, -dr), 8 - max(0, dr))
            cs = slice(max(0, -dc), 8 - max(0, dc))
            src_l.append(idx[rs, cs].ravel())
            dst_l.append(idx[max(0, dr):8 + min(0, dr),
                             max(0, dc):8 + min(0, dc)].ravel())
    src_t = np.concatenate(src_l)
    dst_t = np.concatenate(dst_l)

    rr, cc = np.divmod(np.arange(64), 8)
    coord = np.stack([rr / 7.0, cc / 7.0], axis=1).astype(np.float32)

    graphs, feats = [], []
    for img in images:
        pix = img.ravel().astype(np.float32)
        keep = (pix[src_t] > 0) | (pix[dst_t] > 0)
        graphs.append((src_t[keep].astype(np.int32),
                       dst_t[keep].astype(np.int32), 64))
        feats.append(np.concatenate([pix[:, None] / 16.0, coord], axis=1))

    if name == "digits":
        labels = target
        task, n_classes = "graph_classification", 10
    else:
        labels = np.zeros((len(target), 10), np.float32)
        labels[np.arange(len(target)), target] = 1.0
        hole_rng = np.random.default_rng(0)  # deterministic missing-label mask
        labels[hole_rng.random(labels.shape) < 0.2] = np.nan
        task, n_classes = "graph_classification_multilabel", 10
    return BatchedGraphDataset(
        name=name, graphs=graphs, node_features=feats, labels=labels,
        task=task, num_classes=n_classes, feature_kind="float", in_dim=3,
        synthetic=False,
    )


def _load_npz_batched(name: str, data_dir: str) -> Optional[BatchedGraphDataset]:
    p = os.path.join(data_dir, f"{name}_batched.npz")
    if not os.path.exists(p):
        return None
    z = np.load(p, allow_pickle=True)
    mean_nodes, deg, kind, in_dim, n_classes, task = _BATCH_ANCHORS[name]
    return BatchedGraphDataset(
        name=name,
        graphs=[tuple(g) for g in z["graphs"]],
        node_features=list(z["node_features"]),
        labels=z["labels"],
        task=task, num_classes=n_classes, feature_kind=kind, in_dim=in_dim,
    )


def load_batched(name: str, data_dir: str = "data", *, n_graphs: int = 1024,
                 quiet: bool = False) -> BatchedGraphDataset:
    """A batched-graph dataset by name (role of the reference's ``load_dataset_fn``)."""
    if name not in _BATCH_ANCHORS:
        raise KeyError(f"unknown batched dataset {name!r}; choose from {sorted(_BATCH_ANCHORS)}")
    if name in ("digits", "digits-func"):
        return _load_digits(name)
    ds = _load_npz_batched(name, data_dir)
    if ds is None:
        ds = _synthetic_batched(name, n_graphs)
        if not quiet:
            print(f"[dfgnn-tpu] {name}: no local data found, using synthetic "
                  f"stand-in ({len(ds)} graphs)", file=sys.stderr)
    return ds


def dataset_names():
    """Datasets this module loads."""
    return {"full": sorted(_FULL_ANCHORS), "batched": sorted(_BATCH_ANCHORS)}
