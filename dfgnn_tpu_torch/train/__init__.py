"""Training building blocks of the PyTorch port."""

from dfgnn_tpu_torch.train.loop import (
    TrainState,
    evaluate_accuracy,
    evaluate_mean_ap,
    evaluate_rocauc,
    make_loss_fn,
    train_step,
)

__all__ = ["TrainState", "evaluate_accuracy", "evaluate_mean_ap", "evaluate_rocauc",
           "make_loss_fn", "train_step"]
