"""Conv layers and model assembly of the PyTorch port."""

from dfgnn_tpu_torch.models.conv import GTConv
from dfgnn_tpu_torch.models.model import AtomEncoder, GTModel, choose_inproj, graph_pool

__all__ = ["AtomEncoder", "GTConv", "GTModel", "choose_inproj", "graph_pool"]
