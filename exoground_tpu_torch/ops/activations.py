"""Activations.

QuickGELU is the CLIP-style gated activation the reference transformer uses
everywhere (reference: model/tfm_model.py:11-13); counterpart of
``exoground_tpu/ops/activations.py``.
"""

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 * x)."""
    return x * torch.sigmoid(1.702 * x)
