"""Utilities of the PyTorch port."""

from dfgnn_tpu_torch.utils.benchmark import Timer, benchmark, check_correct

__all__ = ["Timer", "benchmark", "check_correct"]
