"""Synthetic graph generators (numpy only).

A copy of the generators of :mod:`dfgnn_tpu.data.synthetic`:
given the same ``np.random.Generator`` each returns the same arrays, so the
two packages can be fed identical inputs.  The copy exists because importing
anything under ``dfgnn_tpu`` imports JAX.
"""

from __future__ import annotations

import numpy as np


def constant_degree_graph(rng, n: int, deg: int):
    """Every node has exactly ``deg`` out-edges to uniform targets.
    Returns (rows, cols)."""
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    return rows, cols


def sbm_graph(rng, n: int, n_blocks: int = 2, avg_deg: float = 51.0,
              p_ratio: float = 4.0):
    """Stochastic-block-model graph (GraphWorld / PATTERN style).

    ``p_ratio`` = intra/inter block edge-probability ratio.  Returns
    (rows, cols, block) with symmetric edges.
    """
    block = rng.integers(0, n_blocks, size=n)
    # solve p_intra from expected degree: deg = p_in*(n/b) + p_out*n*(b-1)/b
    nb = n / n_blocks
    p_out = avg_deg / (nb * p_ratio + (n - nb))
    p_in = p_out * p_ratio
    same = block[:, None] == block[None, :]
    probs = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < probs, k=1)
    r, c = np.nonzero(upper)
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    return rows, cols, block


def pattern_like_batch(rng, n_graphs: int, mean_nodes: int = 119,
                       avg_deg: float = 51.0):
    """Batch of SBM graphs shaped like the PATTERN workload.

    Returns a list of (rows, cols, n_nodes, node_labels); the labels are the
    SBM block ids.
    """
    out = []
    for _ in range(n_graphs):
        n = int(np.clip(rng.normal(mean_nodes, 15), 40, 128))
        deg = min(avg_deg, n - 1)
        rows, cols, block = sbm_graph(rng, n, avg_deg=deg)
        out.append((rows, cols, n, block))
    return out


def small_graph_batch(rng, n_graphs: int, mean_nodes: int = 70, deg: int = 8,
                      max_nodes: int = 128):
    """MNIST/CIFAR10-style batch: k-regular-ish sparse graphs."""
    out = []
    for _ in range(n_graphs):
        n = int(np.clip(rng.normal(mean_nodes, mean_nodes / 8), 10, max_nodes))
        rows, cols = constant_degree_graph(rng, n, min(deg, n - 1))
        out.append((rows, cols, n, None))
    return out


def community_graph(rng, n: int, n_communities: int, avg_deg: float = 10.0,
                    intra_frac: float = 0.9):
    """Locality-structured full graph: nodes are grouped into contiguous
    communities and each edge lands inside its source's community with
    probability ``intra_frac`` (reddit-like community structure).  Returns
    (rows, cols)."""
    deg = np.maximum(rng.poisson(avg_deg, size=n), 1)
    rows = np.repeat(np.arange(n), deg)
    E = int(deg.sum())
    csize = -(-n // n_communities)
    com_lo = (rows // csize) * csize
    com_hi = np.minimum(com_lo + csize, n)
    intra = rng.random(E) < intra_frac
    local = com_lo + rng.integers(0, csize, size=E) % (com_hi - com_lo)
    remote = rng.integers(0, n, size=E)
    cols = np.where(intra, local, remote)
    return rows, cols


def power_law_graph(rng, n: int, avg_deg: float = 10.0, alpha: float = 1.8,
                    max_deg_frac: float = 0.1):
    """Full graph with power-law in-row degrees: the reddit / super-node
    regime (single rows with 1e4+ neighbours) that exercises the segment and
    tiled paths.  Returns (rows, cols)."""
    raw = rng.pareto(alpha, size=n) + 1.0
    deg = np.minimum((raw / raw.mean() * avg_deg).astype(np.int64),
                     int(n * max_deg_frac))
    deg = np.maximum(deg, 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=int(deg.sum()))
    return rows, cols


def attention_inputs(rng, B: int, h: int, P: int, f: int):
    """Random inputs of one masked-attention call, as numpy arrays.

    Returns q (scaled by f**-0.5), k, v ``[B, P, h, f]`` fp32, a uint8
    adjacency ``[B, P, P]`` of density 0.4 over each graph's first n nodes
    (n uniform in [P/2, P]) with about a tenth of the rows left empty, and
    fp32 edge values ``[B, P, P]`` on the edges.
    """
    q, k, v = (rng.standard_normal((B, P, h, f)).astype(np.float32) for _ in range(3))
    q *= f ** -0.5
    n = rng.integers(P // 2, P + 1, size=B)
    live = np.arange(P)[None, :] < n[:, None]
    adj = (rng.random((B, P, P)) < 0.4) & live[:, :, None] & live[:, None, :]
    adj &= rng.random((B, P, 1)) > 0.1
    val = np.where(adj, rng.standard_normal(adj.shape), 0.0).astype(np.float32)
    return q, k, v, adj.astype(np.uint8), val
