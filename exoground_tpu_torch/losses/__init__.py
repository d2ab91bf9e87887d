"""Losses of the port (counterpart of ``exoground_tpu/losses``)."""

from exoground_tpu_torch.losses.infonce import info_nce_diag, pairwise_view_info_nce
from exoground_tpu_torch.losses.milnce import TANLossConfig, set_grid_impl, tan_loss

__all__ = ["TANLossConfig", "info_nce_diag", "pairwise_view_info_nce", "set_grid_impl",
           "tan_loss"]
