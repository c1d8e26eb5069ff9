"""Training loop building blocks.

The counterpart of :mod:`dfgnn_tpu.train.loop`: Adam (AdamW with weight
decay) with an optional StepLR schedule, the task losses, and the ROC-AUC,
mean-AP and accuracy metrics.  The metrics need numpy and scipy only (no
scikit-learn), and follow scikit-learn's definitions, which the JAX package
calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfgnn_tpu_torch.device import resolve_device


@dataclass
class TrainState:
    model: nn.Module
    opt: torch.optim.Optimizer
    sched: Optional[torch.optim.lr_scheduler.StepLR] = None

    @staticmethod
    def create(model: nn.Module, lr: float = 1e-3, *, step_lr_every: int = 0,
               step_lr_gamma: float = 0.5, weight_decay: float = 0.0,
               device="cuda") -> "TrainState":
        """Moves ``model`` to ``device`` and pairs it with Adam, or AdamW when
        ``weight_decay`` is set (betas 0.9 / 0.999, eps 1e-8, as optax's).

        ``step_lr_every`` > 0 multiplies the rate by ``step_lr_gamma`` every
        ``step_lr_every`` optimizer updates, as the JAX package's
        ``optax.exponential_decay(..., staircase=True)``: :func:`train_step`
        steps the schedule after every update, not every epoch.
        """
        model.to(resolve_device(device))
        params = list(model.parameters())
        opt = (torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
               if weight_decay else torch.optim.Adam(params, lr=lr))
        sched = (torch.optim.lr_scheduler.StepLR(opt, step_size=step_lr_every,
                                                 gamma=step_lr_gamma)
                 if step_lr_every else None)
        return TrainState(model=model, opt=opt, sched=sched)


def _masked_mean(l: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(l * mask) / torch.clamp_min(torch.sum(mask), 1)


def _task_loss(task: str, num_classes: int):
    """``loss(logits, y, mask)`` of a task, as the JAX package's
    ``make_loss_fn`` computes it from the model's output."""
    if task == "graph_classification" and num_classes == 1:
        def loss(logits, y, mask):
            l = F.binary_cross_entropy_with_logits(logits.squeeze(-1), y.float(),
                                                   reduction="none")
            return _masked_mean(l, mask)
    elif task == "graph_classification_multilabel":
        # C independent binary tasks; NaN = missing label, masked out
        def loss(logits, y, mask):
            y = y.float()
            labeled = ~torch.isnan(y) & mask[:, None].bool()
            y_safe = torch.where(labeled, y, 0.0)
            l = F.binary_cross_entropy_with_logits(logits, y_safe, reduction="none")
            l = torch.where(labeled, l, 0.0)
            return torch.sum(l) / torch.clamp_min(torch.sum(labeled), 1)
    elif task in ("graph_classification", "node_classification"):
        def loss(logits, y, mask):
            l = F.cross_entropy(logits, torch.clamp_min(y, 0), reduction="none")
            return _masked_mean(l, mask)
    elif task == "graph_regression":
        def loss(pred, y, mask):
            return _masked_mean(torch.abs(pred - y).mean(-1), mask)
    else:
        raise ValueError(task)
    return loss


def make_loss_fn(model: nn.Module, task: str, num_classes: int):
    """``loss(g, x, y, mask, impl=None)``: the model's forward, then the
    task's loss (BCE-with-logits, masked multilabel BCE, cross-entropy or
    L1), averaged over the masked entries with a denominator of at least 1."""
    per_task = _task_loss(task, num_classes)

    def loss(g, x, y, mask, impl: Optional[str] = None):
        return per_task(model(g, x, impl=impl), y, mask)

    return loss


def train_step(state: TrainState, loss_fn, g, x, y, mask):
    """One update: forward, backward, optimizer step, then schedule step.
    Returns ``(state, loss)``; the state is updated in place."""
    state.opt.zero_grad(set_to_none=True)
    loss = loss_fn(g, x, y, mask)
    loss.backward()
    state.opt.step()
    if state.sched is not None:
        state.sched.step()
    return state, loss.detach()


def evaluate_rocauc(y_true, y_score) -> float:
    """ROC-AUC as the Mann-Whitney statistic, with average ranks for tied
    scores (scikit-learn's ``roc_auc_score`` for binary labels; the larger
    label is the positive class).  NaN when fewer than two classes occur."""
    from scipy.stats import rankdata

    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score, dtype=np.float64).reshape(-1)
    classes = np.unique(y_true)
    if len(classes) < 2:
        return float("nan")
    if len(classes) > 2:
        raise ValueError(f"ROC-AUC takes binary labels, got classes {classes}")
    pos = y_true == classes[1]
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    ranks = rankdata(y_score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _average_precision(y: np.ndarray, score: np.ndarray) -> float:
    """scikit-learn's step-wise AP: thresholds at the distinct scores (tied
    scores form one threshold), AP = sum of (R_n - R_{n-1}) * P_n."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(score)), y.size - 1]
    tps = np.cumsum(y)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def evaluate_mean_ap(y_true, y_score, mask=None) -> float:
    """Mean average precision over C binary tasks, NaN = missing label.
    Tasks without both classes are skipped; NaN when none is left."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        y_true, y_score = y_true[m], y_score[m]
    aps = []
    for t in range(y_true.shape[1]):
        lab = ~np.isnan(y_true[:, t])
        if lab.any() and len(np.unique(y_true[lab, t])) == 2:
            aps.append(_average_precision(y_true[lab, t] == 1, y_score[lab, t]))
    return float(np.mean(aps)) if aps else float("nan")


def evaluate_accuracy(y_true, y_pred, mask=None) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        y_true, y_pred = y_true[m], y_pred[m]
    return float((y_true == y_pred).mean())
