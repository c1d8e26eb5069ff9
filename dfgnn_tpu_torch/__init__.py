"""dfgnn_tpu_torch: the PyTorch and CUDA port of dfgnn_tpu, for NVIDIA Hopper.

A second package beside the JAX reference, with the same module names.  It
imports torch and numpy, and never JAX or ``dfgnn_tpu``.

    dfgnn_tpu_torch/graph.py              DenseBatch
    dfgnn_tpu_torch/device.py             "cuda" by default; raises without a card
    dfgnn_tpu_torch/data/                 numpy generators, batched datasets, collation
    dfgnn_tpu_torch/ops/dense_block.py    dense masked attention (the oracle)
    dfgnn_tpu_torch/ops/flash_mask.py     flash attention: CUDA kernel wrappers, autograd
    dfgnn_tpu_torch/ops/dispatch.py       graph_attention
    dfgnn_tpu_torch/models/               GTConv, GTModel, inproj, pooling
    dfgnn_tpu_torch/train/                Adam + StepLR, losses, train_step, metrics
    dfgnn_tpu_torch/weights.py            flax GTModel params -> state_dict
    dfgnn_tpu_torch/utils/                CUDA-event timing, CLI and YAML config
    dfgnn_tpu_torch/scripts/              the train_gtconv twin, a train-step profile
    dfgnn_tpu_torch/csrc/                 hand-written CUDA kernels (sm_90a)

Entry points build on the card unless the caller asks for the CPU.
"""

from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTConv, GTModel
from dfgnn_tpu_torch.ops import graph_attention

__all__ = ["DenseBatch", "GTConv", "GTModel", "graph_attention"]
