"""dfgnn_tpu_torch: the PyTorch and CUDA port of dfgnn_tpu, for NVIDIA Hopper.

A second package beside the JAX reference, with the same module names.  It
imports torch and numpy, and never JAX or ``dfgnn_tpu``.

    dfgnn_tpu_torch/graph.py              Graph (edge list), CSCAux, DenseBatch
    dfgnn_tpu_torch/formats.py            the bucketed full-graph layouts
    dfgnn_tpu_torch/device.py             "cuda" by default; raises without a card
    dfgnn_tpu_torch/data/                 numpy generators, full-graph and batched
                                          datasets, collation; sampling.py: the
                                          neighbour sampler and SampledBlock
    dfgnn_tpu_torch/ops/reference.py      the segment-op oracle on a Graph
    dfgnn_tpu_torch/ops/dense_block.py    dense masked attention (the DenseBatch oracle)
    dfgnn_tpu_torch/ops/edge_dropout.py   the per-edge dropout hash
    dfgnn_tpu_torch/ops/flash_mask.py     flash attention: CUDA kernel wrappers, autograd
    dfgnn_tpu_torch/ops/bucket.py         the full-graph bucket attention, custom backward
    dfgnn_tpu_torch/ops/gather.py         the gather probe's CUDA kernels
    dfgnn_tpu_torch/ops/_cuda.py          builds and loads the CUDA library
    dfgnn_tpu_torch/ops/dispatch.py       graph_attention (DenseBatch, Graph, the bucketed
                                          layouts, SampledBlock, EdgePartitionedGraph)
    dfgnn_tpu_torch/parallel/             the multi-device layer over torch.distributed:
                                          the edge-partitioned plan and its distributed
                                          forward and backward, collectives, meshes, data
                                          and head parallelism, torchrun set-up
    dfgnn_tpu_torch/models/               GT, GAT, AGNN, DotGAT convs; Model, GTModel,
                                          FullGraphNet, GATNet; inproj, pooling
    dfgnn_tpu_torch/train/                Adam + StepLR, losses, train_step, metrics, parity
    dfgnn_tpu_torch/weights.py            flax params -> state_dict
    dfgnn_tpu_torch/utils/                CUDA-event timing, Timer, CLI and YAML config,
                                          torch.profiler traces, checkpoints
    dfgnn_tpu_torch/scripts/              twins of train_gtconv, train_parity,
                                          test_batch_graph, test_full_graph,
                                          train_gatconv, shmoo, microbench_gather,
                                          train_sampled, train_batch_graph_timing,
                                          train_full_graph_timing, test_gt_graphworld,
                                          ablation, train_real, graph_stats,
                                          plot_results, bench_partition_build,
                                          bench_scaling, dryrun_multichip; a
                                          train-step profile
    dfgnn_tpu_torch/csrc/                 hand-written CUDA kernels (sm_90a)

Entry points build on the card unless the caller asks for the CPU.
"""

from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.graph import CSCAux, DenseBatch, Graph
from dfgnn_tpu_torch.models import (
    AGNNConv,
    DotGATConv,
    FullGraphNet,
    GATConv,
    GATNet,
    GTConv,
    GTModel,
    Model,
    make_conv,
)
from dfgnn_tpu_torch.ops import graph_attention

__all__ = ["AGNNConv", "CSCAux", "DenseBatch", "DotGATConv", "FullGraphNet", "GATConv",
           "GATNet", "GTConv", "GTModel", "Graph", "Model", "formats", "graph_attention",
           "make_conv"]
