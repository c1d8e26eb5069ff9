"""dfgnn_tpu_torch: the PyTorch and CUDA port of dfgnn_tpu, for NVIDIA Hopper.

A second package beside the JAX reference, with the same module names.  It
imports torch and numpy, and never JAX or ``dfgnn_tpu``.

    dfgnn_tpu_torch/graph.py              DenseBatch
    dfgnn_tpu_torch/data/synthetic.py     numpy graph generators
    dfgnn_tpu_torch/ops/dense_block.py    dense masked attention (the oracle)
    dfgnn_tpu_torch/ops/flash_mask.py     flash attention forward: CUDA kernel wrapper
    dfgnn_tpu_torch/ops/dispatch.py       graph_attention
    dfgnn_tpu_torch/models/               GTConv, GTModel, inproj, pooling
    dfgnn_tpu_torch/weights.py            flax GTModel params -> state_dict
    dfgnn_tpu_torch/utils/benchmark.py    CUDA-event timing
    dfgnn_tpu_torch/csrc/                 hand-written CUDA kernels (sm_90a)
"""

from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTConv, GTModel
from dfgnn_tpu_torch.ops import graph_attention

__all__ = ["DenseBatch", "GTConv", "GTModel", "graph_attention"]
