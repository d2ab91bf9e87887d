"""Train and eval steps of the port, data parallel over a process group,
and sequence parallelism, the ring attention over the time axis
(counterpart of ``exoground_tpu/parallel``)."""

from exoground_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch  # noqa: F401
from exoground_tpu_torch.parallel.train_step import (  # noqa: F401
    GroundingEvalStep,
    GroundingTrainStep,
    S3DNceStep,
    ScanStep,
    TanEvalStep,
    TanTrainStep,
    make_grounding_eval_step,
    make_grounding_train_step,
    make_s3d_nce_step,
    make_tan_eval_step,
    make_tan_train_step,
)
from exoground_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    sequence_parallel_dual_sim,
    sequence_parallel_sim,
    sequence_sharded_self_attention,
)
