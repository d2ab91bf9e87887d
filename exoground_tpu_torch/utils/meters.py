"""Console/metric meters (reference utils/utils.py:139-231).

A copy of ``AverageMeter`` and ``ProgressMeter`` from
``exoground_tpu/utils/meters.py`` (the port imports nothing of the JAX
package)."""

from __future__ import annotations

from typing import Iterable


class AverageMeter:
    """Running average of a scalar (reference utils/utils.py:139-214)."""

    def __init__(self, name: str = "", fmt: str = ":.4f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0
        self.history = []

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def save_history(self, val: float):
        self.history.append(float(val))

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class ProgressMeter:
    """Console progress line (reference utils/utils.py:217-231)."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter], prefix: str = ""):
        fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("  ".join(entries), flush=True)
