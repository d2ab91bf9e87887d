"""HTM-Align evaluation (host protocol and device-resident evaluator) and
YouCook2 retrieval."""

from exoground_tpu_torch.evals.align import (  # noqa: F401
    NEG_FILL,
    AlignEvalConfig,
    make_tan_sim_fn,
    roc_auc,
)
from exoground_tpu_torch.evals.align_fused import FusedAlignEvaluator  # noqa: F401
from exoground_tpu_torch.evals.retrieval import (  # noqa: F401
    compute_retrieval_metrics,
    test_retrieval_yc2,
)
