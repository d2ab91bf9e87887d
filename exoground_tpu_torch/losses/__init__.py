"""Losses of the port (counterpart of ``exoground_tpu/losses``)."""

from exoground_tpu_torch.losses.milnce import TANLossConfig, set_grid_impl, tan_loss

__all__ = ["TANLossConfig", "set_grid_impl", "tan_loss"]
