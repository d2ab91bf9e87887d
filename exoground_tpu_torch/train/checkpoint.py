"""Checkpoint save/resume with the reference's lifecycle semantics.

Counterpart of ``exoground_tpu/train/checkpoint.py`` (:32-165). Format: one
``torch.save`` file holding the top-level keys of the JAX trainer's
``_ckpt_state`` (trainer.py:110-125) — ``epoch``, ``state_dict``,
``best_acc``, ``optimizer``, ``iteration`` and, when cotraining,
``target_state_dict`` — the reference's dict fields (train/main.py:532-537).
Every tensor is on the CPU and every value is a tensor, a number or a dict
of them, so ``torch.load(weights_only=True)`` reads it. Writes are atomic:
``<path>.tmp``, then ``os.replace``.

Lifecycle as utils/utils.py:23-57 of the reference:
  * save_checkpoint: writes epoch%d.pth.tar, deletes the previous epoch's
    file unless keep_all, keeps the 2 newest model_best_epoch%d.pth.tar;
  * save_runtime_checkpoint: a timestamped snapshot, keeping only the newest;
  * load modes (the trainer's ``load_checkpoint``): resume, pretrain, test.

``load_state`` also reads the JAX package's two formats, and
``checkpoint_format`` tells the three apart:

  * 'torch': a ``torch.save`` zip (the port's own file);
  * 'flax_msgpack': one flax msgpack map, the JAX ``save_state``
    (``exoground_tpu/train/checkpoint.py:32-44``), read by the port's own
    pure-Python reader (``utils/flax_msgpack.py``);
  * 'orbax': an orbax checkpoint directory, the JAX ``save_state_orbax``
    (:54-70; its ``load_state`` sends every directory there), read by
    ``utils/orbax.py`` over the port's OCDBT store (``utils/ocdbt.py``) and
    the system's zstd (``utils/zstd.py``), none of them orbax or
    TensorStore. ``save_state_orbax`` writes such a directory.

Either JAX format returns the tree as the JAX package's loader would (a
``bfloat16`` array as a ``torch.bfloat16`` tensor) in the JAX package's
layout (``jax_layout``), which ``utils/convert.py::tan_checkpoint_from_jax``
bridges to this module's.
"""

from __future__ import annotations

import glob
import os
import re
from datetime import datetime
from typing import Any, Dict, Mapping, Optional

import torch

from exoground_tpu_torch.utils import flax_msgpack, orbax

_ZIP = b"PK\x03\x04"  # torch.save's zip container
ORBAX_FILES = ("_METADATA", "manifest.ocdbt")


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_state(path: str, state: Dict[str, Any]) -> None:
    """``state`` with every tensor moved to the CPU, written atomically."""
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)


def save_state_orbax(path: str, state: Dict[str, Any]) -> None:
    """``state`` as an orbax checkpoint directory at ``path``, as the JAX
    ``save_state_orbax`` writes one (``utils/orbax.py``), replacing what
    was there."""
    orbax.save(path, _to_cpu(state))


def checkpoint_format(path: str) -> str:
    """'torch' (a ``torch.save`` zip) or 'flax_msgpack' (the JAX package's
    file: a msgpack map), from the file's first bytes, or 'orbax' (a
    directory holding ``_METADATA`` and ``manifest.ocdbt``); anything else
    raises ``ValueError``, saying what was missing."""
    if os.path.isdir(path):
        missing = [f for f in ORBAX_FILES if not os.path.isfile(os.path.join(path, f))]
        if missing:
            raise ValueError(f"{path} is a directory without {' and '.join(missing)}: "
                             "not an orbax checkpoint")
        return "orbax"
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP:
        return "torch"
    if head and head[0] in flax_msgpack.MAP_MARKERS:
        return "flax_msgpack"
    raise ValueError(f"{path} is neither a torch.save zip nor a flax msgpack checkpoint "
                     f"(first bytes {head!r})")


def jax_layout(fmt: str) -> bool:
    """Whether a checkpoint of format ``fmt`` holds the JAX package's
    layout (its trainer writes both of its formats from one tree)."""
    return fmt in ("flax_msgpack", "orbax")


def load_state(path: str) -> Dict[str, Any]:
    """The checkpoint at ``path``: a port file as ``torch.load`` reads it
    (tensors on the CPU), a JAX package file or directory as its
    ``load_state`` would return it (``flax_msgpack``, ``orbax``)."""
    fmt = checkpoint_format(path)
    if fmt == "torch":
        return torch.load(path, map_location="cpu", weights_only=True)
    if fmt == "orbax":
        return orbax.load(path)
    return flax_msgpack.load(path)


def save_checkpoint(state: Dict[str, Any], is_best: bool = False, gap: int = 1,
                    filename: str = "model/epoch0.pth.tar", keep_all: bool = False,
                    save_best_n: int = 2) -> None:
    """Reference utils/utils.py:39-57: prune the previous epoch's file unless
    keep_all; on is_best write model_best_epoch*.pth.tar keeping the newest
    ``save_best_n``."""
    save_state(filename, state)
    m = re.search(r"epoch(\d+)", os.path.basename(filename))
    if m and not keep_all:
        last = os.path.join(os.path.dirname(filename), f"epoch{int(m.group(1)) - gap}.pth.tar")
        if os.path.exists(last):
            os.remove(last)
    if is_best:
        best_path = os.path.join(os.path.dirname(filename),
                                 f"model_best_epoch{state.get('epoch', 0)}.pth.tar")
        save_state(best_path, state)
        past_best = sorted(glob.glob(os.path.join(os.path.dirname(filename),
                                                  "model_best_*.pth.tar")),
                           key=os.path.getmtime)
        for p in past_best[:-save_best_n]:
            os.remove(p)


def save_runtime_checkpoint(state: Dict[str, Any], filename: str,
                            rm_history: bool = True) -> None:
    """Timestamped snapshot keeping only the newest (utils/utils.py:23-36)."""
    if not filename.endswith(".pth.tar"):
        raise ValueError(f"runtime checkpoint {filename!r} must end in .pth.tar")
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    save_state(filename.replace(".pth.tar", f"_{ts}.pth.tar"), state)
    if rm_history:
        for p in _history(filename)[:-1]:
            os.remove(p)


def _history(filename: str):
    return sorted(glob.glob(filename.replace(".pth.tar", "_*.pth.tar")), key=os.path.getmtime)


def latest_runtime_checkpoint(filename: str) -> Optional[str]:
    history = _history(filename)
    return history[-1] if history else None


@torch.no_grad()
def restore_into(template: Dict[str, torch.Tensor], state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """Non-strict restore (reference neq_load_customized,
    utils/utils.py:302-312): every key present in both with the same shape
    is copied into the template's tensor in place (so parameters shared with
    a module stay shared); missing and unused keys are reported. Returns
    ``template``."""
    missing = []
    for k, t in template.items():
        src = state_dict.get(k)
        if torch.is_tensor(src) and tuple(src.shape) == tuple(t.shape):
            t.copy_(src)
        else:
            missing.append(k)
    extra = [k for k in state_dict if k not in template]
    if missing:
        print(f"[checkpoint] {len(missing)} params NOT restored: {missing[:8]}...")
    if extra:
        print(f"[checkpoint] {len(extra)} checkpoint keys unused: {extra[:8]}...")
    return template
