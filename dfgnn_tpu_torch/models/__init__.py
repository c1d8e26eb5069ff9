"""Conv layers and model assembly of the PyTorch port."""

from dfgnn_tpu_torch.models.conv import AGNNConv, DotGATConv, GATConv, GTConv, make_conv
from dfgnn_tpu_torch.models.model import (
    AtomEncoder,
    FullGraphNet,
    GATNet,
    GTModel,
    Model,
    choose_inproj,
    graph_pool,
)

__all__ = ["AGNNConv", "AtomEncoder", "DotGATConv", "FullGraphNet", "GATConv", "GATNet",
           "GTConv", "GTModel", "Model", "choose_inproj", "graph_pool", "make_conv"]
