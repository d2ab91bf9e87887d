"""Training of the port (counterpart of ``exoground_tpu/train``)."""

from exoground_tpu_torch.train.config import ExperimentConfig  # noqa: F401
from exoground_tpu_torch.train.optim import (  # noqa: F401
    FusedAdamWEMA,
    make_fused_optimizer,
    trainable_mask,
    warmup_cosine_schedule,
    weight_decay_mask,
)
from exoground_tpu_torch.train.trainer import TANTrainer  # noqa: F401
