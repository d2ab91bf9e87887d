"""Train steps of the port (counterpart of ``exoground_tpu/parallel``; one
device for now)."""

from exoground_tpu_torch.parallel.train_step import (  # noqa: F401
    GroundingEvalStep,
    GroundingTrainStep,
    ScanStep,
    TanEvalStep,
    TanTrainStep,
    make_grounding_eval_step,
    make_grounding_train_step,
    make_tan_eval_step,
    make_tan_train_step,
)
