"""Losses of the port (counterpart of ``exoground_tpu/losses``)."""

from exoground_tpu_torch.losses.grounding import (
    GroundingLossConfig,
    egoexo_loss,
    grounding_loss,
    view_invariant_loss,
)
from exoground_tpu_torch.losses.infonce import (
    cross_view_info_nce,
    info_nce_diag,
    l1_cosine_metrics,
    pairwise_view_info_nce,
    symmetric_info_nce,
)
from exoground_tpu_torch.losses.milnce import TANLossConfig, set_grid_impl, tan_loss

__all__ = ["GroundingLossConfig", "TANLossConfig", "cross_view_info_nce", "egoexo_loss",
           "grounding_loss", "info_nce_diag", "l1_cosine_metrics", "pairwise_view_info_nce",
           "set_grid_impl", "symmetric_info_nce", "tan_loss", "view_invariant_loss"]
