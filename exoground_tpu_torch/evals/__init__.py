"""HTM-Align evaluation: host protocol and device-resident evaluator."""

from exoground_tpu_torch.evals.align import (  # noqa: F401
    NEG_FILL,
    AlignEvalConfig,
    make_tan_sim_fn,
    roc_auc,
)
from exoground_tpu_torch.evals.align_fused import FusedAlignEvaluator  # noqa: F401
