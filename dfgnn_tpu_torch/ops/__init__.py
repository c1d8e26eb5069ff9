"""Attention-aggregate operators of the PyTorch port."""

from dfgnn_tpu_torch.ops.dispatch import graph_attention

__all__ = ["graph_attention"]
