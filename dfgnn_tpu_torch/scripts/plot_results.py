"""The reference's paper figures from the port's stored result JSONs.

The twin of the JAX package's ``scripts/plot_results.py`` (the reference's
``bash/experiment/fig[1-5]*.sh`` and ``DFGNN/utils/plot_fig[1-5].py``).  It
draws the same five figures, from the files the port's twins store with
``--store-result``, and from no other:

  fig1  batched-graph throughput per (dataset, format)  <- batch_torch_*.json
  fig2  full-graph throughput per (dataset, format)     <- full_torch_*.json
  fig3  super-node full graphs (reddit/ppa/protein)     <- full_torch_*.json
  fig4  feature-dim shmoo                               <- h100_shmoo_*.json
  fig5  batch-size shmoo                                <- h100_shmoo_*.json

The JAX package's ``batch_*``, ``full_*`` and ``shmoo_*`` files hold TPU
times and are never read.  A format without a device time (a CPU run stores
``edges_per_s: null``) is left out of its bars.  matplotlib is imported in
:func:`main`: the card's machine has none, and there this raises
``ImportError``.  The default output directory, ``figures_torch``, keeps
the JAX package's figures under ``figures/`` as they are.  ``--device`` is
taken as every twin takes it; the figures are drawn on the host.

    python -m dfgnn_tpu_torch.scripts.plot_results [--results results] [--out figures_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

_SUPER = ("reddit", "ppa", "protein")
BATCH_PREFIX, FULL_PREFIX, SHMOO_PREFIX = "batch_torch", "full_torch", "h100_shmoo"
# the keys of a shmoo row that are not an impl's ms (scripts/shmoo.py run_point)
SHMOO_NOT_IMPLS = ("winner", "auto", "default_ok", "n_edges")


def _load(results_dir, prefix):
    out = {}
    for p in sorted(glob.glob(os.path.join(results_dir, f"{prefix}_*.json"))):
        with open(p) as f:
            out[os.path.basename(p)[:-5]] = json.load(f)
    return out


def _throughputs(blobs, keep=lambda ds: True):
    """``{dataset: {format: edges/s}}`` of the batch or full twins' blobs
    (``{"args": {"dataset"}, "results": {format: {"edges_per_s"}}}``),
    without the formats that have no device time."""
    data = {}
    for name, blob in blobs.items():
        ds = blob["args"].get("dataset", name)
        rates = {f: r["edges_per_s"] for f, r in blob["results"].items()
                 if r.get("edges_per_s") is not None}
        if keep(ds) and rates:
            data[ds] = rates
    return data


def _bars(ax, data, title):
    """data: {dataset: {format: edges/s}}"""
    datasets = sorted(data)
    formats = sorted({f for d in data.values() for f in d})
    w = 0.8 / max(len(formats), 1)
    for i, fmt in enumerate(formats):
        xs = [j + i * w for j in range(len(datasets))]
        ys = [data[d].get(fmt, 0) / 1e6 for d in datasets]
        ax.bar(xs, ys, width=w, label=fmt)
    ax.set_xticks([j + 0.4 - w / 2 for j in range(len(datasets))])
    ax.set_xticklabels(datasets, rotation=20)
    ax.set_ylabel("Medges/s")
    ax.set_title(title)
    ax.legend(fontsize=7)


def main(argv=None) -> dict:
    """Returns ``{path written: the data plotted}``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", default="results")
    ap.add_argument("--out", default="figures_torch")
    ap.add_argument("--device", default="cuda", help="taken as every twin takes it; unused")
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out, exist_ok=True)
    made = {}

    def save(fig, name, data):
        fig.tight_layout()
        p = os.path.join(args.out, f"{name}.png")
        fig.savefig(p)
        plt.close(fig)
        made[p] = data

    data = _throughputs(_load(args.results, BATCH_PREFIX))
    if data:
        fig, ax = plt.subplots(figsize=(7, 3.2), dpi=120)
        _bars(ax, data, "fig1: batched graphs, fused attn conv")
        save(fig, "fig1_batch", data)

    full = _load(args.results, FULL_PREFIX)
    for fig_id, keep in (("fig2_full", lambda d: d not in _SUPER),
                         ("fig3_super", lambda d: d in _SUPER)):
        data = _throughputs(full, keep)
        if data:
            fig, ax = plt.subplots(figsize=(6, 3.2), dpi=120)
            _bars(ax, data, fig_id.replace("_", ": "))
            save(fig, fig_id, data)

    for blob in _load(args.results, SHMOO_PREFIX).values():
        # schema: results -> {conv: {axis: {x: {impl: ms, ..., "n_edges"}}}}
        for conv, axes in blob["results"].items():
            for fig_id, key in (("fig4_dim", "dim"), ("fig5_batch", "batch_size")):
                grid = axes.get(key) or {}
                if not grid:
                    continue
                impls = sorted({i for r in grid.values() for i in r if i not in SHMOO_NOT_IMPLS})
                lines = {impl: sorted((int(x), r["n_edges"] / (r[impl] / 1e3) / 1e6)
                                      for x, r in grid.items() if impl in r)
                         for impl in impls}
                fig, ax = plt.subplots(figsize=(5, 3.2), dpi=120)
                for impl, pts in lines.items():
                    if pts:
                        ax.plot([x for x, _ in pts], [y for _, y in pts],
                                marker="o", label=impl, lw=1.2, ms=3)
                ax.set_xlabel(key)
                ax.set_ylabel("Medges/s")
                ax.set_xscale("log", base=2)
                ax.set_title(f"{fig_id}: {conv} (bf16 impls + fp32 flash)")
                ax.legend(fontsize=7)
                save(fig, f"{fig_id}_{conv}", lines)

    if not made:
        print(f"no {BATCH_PREFIX}_*, {FULL_PREFIX}_* or {SHMOO_PREFIX}_* JSON under "
              f"{args.results} — run the port's test/bench twins with --store-result first")
    for p in made:
        print("wrote", p)
    return made


if __name__ == "__main__":
    main()
