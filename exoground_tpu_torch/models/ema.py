"""EMA twin ("co-training target") as a dictionary of tensors.

Counterpart of ``exoground_tpu/models/ema.py`` (reference
model/tan_model.py:309-345): the target is a second set of parameters,
keyed like the online ones, and its forward is the same module run through
``torch.func.functional_call`` with ``deterministic=True`` under
``torch.no_grad()``.

Unlike the JAX package's pure tree update, ``ema_update`` updates the
target in place with ``torch._foreach_mul_``/``torch._foreach_add_`` (one
multi-tensor pass, no second copy of the parameters).
"""

from __future__ import annotations

from typing import Dict

import torch


def ema_init(online_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the online parameters (tan_model.py:329-332): real
    buffers, never aliases of the online tensors."""
    return {k: v.detach().clone() for k, v in online_params.items()}


@torch.no_grad()
def ema_update(target: Dict[str, torch.Tensor], online: Dict[str, torch.Tensor],
               m: float = 0.999) -> Dict[str, torch.Tensor]:
    """target = m * target + (1 - m) * online, in place (tan_model.py:334-338);
    returns ``target``."""
    keys = list(target)
    t = [target[k] for k in keys]
    torch._foreach_mul_(t, m)
    torch._foreach_add_(t, [online[k].detach() for k in keys], alpha=1.0 - m)
    return target
