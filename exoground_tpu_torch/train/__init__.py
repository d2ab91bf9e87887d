"""Training of the port (counterpart of ``exoground_tpu/train``)."""

from exoground_tpu_torch.train.config import ExperimentConfig  # noqa: F401
from exoground_tpu_torch.train.optim import (  # noqa: F401
    ChainState,
    FusedAdamWEMA,
    OptaxChain,
    adapt_optimizer_state,
    make_fused_optimizer,
    make_optimizer,
    optimizer_state_dict,
    trainable_mask,
    warmup_cosine_schedule,
    weight_decay_mask,
)
from exoground_tpu_torch.train.trainer import EgoExoTrainer, S3DTrainer, TANTrainer  # noqa: F401
