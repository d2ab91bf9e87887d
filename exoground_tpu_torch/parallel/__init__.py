"""Train steps of the port (counterpart of ``exoground_tpu/parallel``; one
device for now)."""

from exoground_tpu_torch.parallel.train_step import TanTrainStep, make_tan_train_step  # noqa: F401
