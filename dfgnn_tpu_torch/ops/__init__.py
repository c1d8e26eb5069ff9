"""Attention-aggregate operators of the PyTorch port.

``reference``   the unfused segment-op oracle (any device), the correctness
                bar every fused path is checked against.
``bucket``      the degree-bucketed padded-CSR path for full graphs and
                sampled blocks (torch ops).
``dense_block`` the dense masked formulation for batched small graphs.
``flash_mask``  the flash-attention and whole-layer CUDA kernels (#1 to #6).
``gather``      the gather probe's CUDA kernels (#7, #8).
"""

from dfgnn_tpu_torch.ops.reference import (
    edge_softmax,
    graph_attention_reference,
    sddmm_add,
    sddmm_dot,
    spmm,
)
from dfgnn_tpu_torch.ops.dispatch import graph_attention

__all__ = ["edge_softmax", "graph_attention", "graph_attention_reference", "sddmm_add",
           "sddmm_dot", "spmm"]
