"""Batched-graph datasets (numpy only).

A copy of the batched half of :mod:`dfgnn_tpu.data.datasets`: the same
registry, the same ``zlib.crc32(name)``-seeded synthetic stand-ins and the
same loaders, so the two packages make identical datasets.  The copy exists
because importing anything under ``dfgnn_tpu`` imports JAX.  The full-graph
half (planetoid, ``load_full_graph``) comes with the full-graph path.

Loading policy, as in the JAX package:
1. ``<data_dir>/<name>_batched.npz`` when present;
2. ``digits`` / ``digits-func``: sklearn's handwritten digits as pixel graphs;
3. otherwise a deterministic synthetic stand-in at the reference's scale
   anchors, marked ``synthetic=True``.
"""

from __future__ import annotations

import os
import sys
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from dfgnn_tpu_torch.data import synthetic as syn


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
    """Datasets this module loads (the full-graph ones are not ported yet)."""
    return {"batched": sorted(_BATCH_ANCHORS)}
