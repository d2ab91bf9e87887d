"""Async metric logging, device memory stats and a wall-clock timer.

Counterpart of ``exoground_tpu/train/logging.py`` (reference
utils/tensorboard_utils.py: PlotterThread pushed scalars through a queue to
a daemon thread so TB IO never blocks the train loop, :76-110):

  * AsyncWriter — the same queue + daemon design over
    ``torch.utils.tensorboard``'s SummaryWriter, with the JAX module's JSONL
    fallback (``metrics.jsonl``) when that cannot be imported;
  * DeviceMonitor — memory of the card from ``torch.cuda.memory_stats``
    (bytes allocated) beside the card's total memory;
  * Timer — the data/compute wall-clock split of the train loop.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict

import torch


class AsyncWriter:
    """add_data(tag, value, step) from the train loop; IO on a daemon thread."""

    _STOP = object()

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        else:
            self._writer = SummaryWriter(logdir)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                break
            tag, value, step = item
            if self._writer is not None:
                self._writer.add_scalar(tag, value, step)
            else:
                self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
        if self._jsonl is not None:
            self._jsonl.close()

    def add_data(self, tag: str, value, step: int):
        self._q.put((tag, float(value), int(step)))

    def add_dict(self, metrics: Dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            try:
                self.add_data(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        self._q.put(self._STOP)
        self._thread.join(timeout=10)


class DeviceMonitor:
    """Memory of the card (the JAX module's per-device memory snapshot);
    nothing on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)

    def stats(self) -> Dict[str, float]:
        if self.device.type != "cuda":
            return {}
        i = self.device.index if self.device.index is not None else torch.cuda.current_device()
        in_use = torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
        limit = torch.cuda.get_device_properties(i).total_memory
        return {f"device{i}/mem_gb": in_use / 2**30, f"device{i}/mem_frac": in_use / limit}

    def log_to(self, writer: AsyncWriter, step: int):
        writer.add_dict(self.stats(), step, prefix="device/")


class Timer:
    """Data/compute wall-clock split (reference AverageMeter('Time'/'Data'))."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        return dt
