"""Visual feature extraction (htm_zoo rebuild) on the card.

Counterpart of ``exoground_tpu/tools/extract_features.py`` (reference
htm_zoo/visual/extract_feature_template.py): decode long videos at 1 fps
(CLIP-L14) or 8 fps (InternVideo) with ffmpeg, run a half-precision image or
video encoder over the frames, write one feature file per video.

  * ``bf16_params_keep_layernorm`` is the reference's fp16 conversion with
    its float32-LayerNorm shim (:67-108), as the JAX package casts: every
    floating tensor to bfloat16 except those whose JAX name holds a
    normalization key (``ln_``, ``layernorm``, ``layer_norm``, ``scale``) or
    ``logit_scale``, which stay float32. The names are the JAX ones each
    port tensor is converted from (``utils/convert.py::jax_name``, the
    inverse of the converters' renames: a norm's ``weight`` is JAX's
    ``scale``, so a BatchNorm keeps its scale in float32 and casts its bias,
    as the JAX cast does);
  * the encoder is the caller's ``nn.Module`` (a copy is cast, put in eval
    mode, and its LayerNorms, GroupNorms and BatchNorms normalize in
    float32 and return the activation's dtype, as the reference's shim
    does) or any callable on (B, H, W, 3) tensors, which gets the frames in
    the compute dtype as they are;
  * frames go to the encoder in fixed buckets of ``frame_bucket``, the last
    one filled with its last frame (on the device: only the real frames
    travel), and the features of the filler are dropped;
  * the run is on the card unless the caller passes a CPU device; the
    decode stays ffmpeg on the host (gated: None without ffmpeg), and
    decoded frame arrays are taken as they are.
"""

from __future__ import annotations

import copy
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from exoground_tpu_torch.models.s3d import BatchNorm as S3DBatchNorm
from exoground_tpu_torch.utils.convert import NORMS, jax_name
from exoground_tpu_torch.utils.device import resolve_device

LN_KEYS = ("ln_", "layernorm", "layer_norm", "scale")


def bf16_params_keep_layernorm(module: nn.Module,
                               tensors: Optional[Mapping[str, torch.Tensor]] = None,
                               ln_keys=LN_KEYS) -> Dict[str, torch.Tensor]:
    """``tensors`` (by default the module's parameters and floating
    buffers, by name; an S3D's ``batch_stats`` may be passed beside them)
    cast to bfloat16, but those whose JAX name (``jax_name``, lower case)
    holds one of ``ln_keys`` or ``logit_scale``, which come back float32;
    integer tensors as they are."""
    if tensors is None:
        tensors = dict(module.named_parameters())
        tensors.update((k, v) for k, v in module.named_buffers() if v.is_floating_point())
    out = {}
    for name, t in tensors.items():
        path = jax_name(name, module).lower()
        if any(k in path for k in ln_keys) or "logit_scale" in path:
            out[name] = t.detach().float()
        else:
            out[name] = t.detach().to(torch.bfloat16) if t.is_floating_point() else t
    return out


def _float32_norm(m: nn.Module) -> None:
    """``m`` (a LayerNorm, GroupNorm or BatchNorm in eval mode) normalizes
    in float32, its weights upcast, and returns its input's dtype."""
    def f32(t):
        return None if t is None else t.float()

    if isinstance(m, nn.LayerNorm):
        def forward(x):
            return F.layer_norm(x.float(), m.normalized_shape, f32(m.weight), f32(m.bias),
                                m.eps).to(x.dtype)
    elif isinstance(m, nn.GroupNorm):
        def forward(x):
            return F.group_norm(x.float(), m.num_groups, f32(m.weight), f32(m.bias),
                                m.eps).to(x.dtype)
    else:
        def forward(x):
            return F.batch_norm(x.float(), f32(m.running_mean), f32(m.running_var),
                                f32(m.weight), f32(m.bias), False, 0.0, m.eps).to(x.dtype)
    m.forward = forward


def half_copy(encoder: nn.Module) -> nn.Module:
    """A copy of ``encoder`` in eval mode with ``bf16_params_keep_layernorm``'s
    dtypes and its norms in float32 (``_float32_norm``; an S3D BatchNorm
    normalizes in float32 already)."""
    enc = copy.deepcopy(encoder).eval()
    cast = bf16_params_keep_layernorm(enc)
    for name, t in cast.items():
        owner, _, leaf = name.rpartition(".")
        sub = enc.get_submodule(owner) if owner else enc
        if leaf in sub._parameters:
            sub._parameters[leaf].data = t
        else:
            sub._buffers[leaf] = t
    for m in enc.modules():
        if isinstance(m, NORMS) and not isinstance(m, S3DBatchNorm):
            _float32_norm(m)
    return enc


def probe_duration(path: str) -> Optional[float]:
    """Video duration in seconds via ffprobe (reference :159-179); None
    without ffprobe or on a failure."""
    if shutil.which("ffprobe") is None:
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries", "format=duration", "-of", "csv=p=0",
             path], capture_output=True, timeout=30, check=True).stdout.decode().strip()
        return float(out)
    except (subprocess.SubprocessError, ValueError):
        return None


def decode_frames(path: str, fps: int = 1, size: int = 224,
                  center_crop: bool = True) -> Optional[np.ndarray]:
    """Full-video frame decode at ``fps`` -> (T, size, size, 3) float32 in
    [0, 1] (the reference decodes through ffmpeg-python filter graphs,
    :199-216); None without ffmpeg, for a missing file or on a failure."""
    if shutil.which("ffmpeg") is None or not os.path.exists(path):
        return None
    vf = (f"fps={fps},scale={size}:{size}:force_original_aspect_ratio=increase,"
          f"crop={size}:{size}" if center_crop else f"fps={fps},scale={size}:{size}")
    try:
        raw = subprocess.run(
            ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", path, "-vf", vf, "-pix_fmt",
             "rgb24", "-f", "rawvideo", "-"], capture_output=True, timeout=600,
            check=True).stdout
    except subprocess.SubprocessError:
        return None
    n = len(raw) // (size * size * 3)
    if n == 0:
        return None
    return (np.frombuffer(raw[: n * size * size * 3], np.uint8)
            .reshape(n, size, size, 3).astype(np.float32) / 255.0)


@dataclass
class ExtractConfig:
    fps: int = 1  # 1 for CLIP-style per-second, 8 for InternVideo
    frame_bucket: int = 256  # frames per encoder call (a fixed shape)
    half: bool = True  # bf16 weights, float32 normalization kept
    out_dtype: str = "float16"  # feature file dtype (the reference saves fp16)


def _prepare(encoder, cfg: ExtractConfig, dev):
    """A module as the run takes it (``half_copy`` under ``cfg.half``, else
    an eval-mode copy) on ``dev``; any other callable as it is."""
    if isinstance(encoder, nn.Module):
        encoder = (half_copy(encoder) if cfg.half else copy.deepcopy(encoder).eval()).to(dev)
    return encoder


def _features(encoder, frames: np.ndarray, cfg: ExtractConfig, dev) -> np.ndarray:
    t = frames.shape[0]
    if t == 0:  # decode succeeded but yielded no frames: an empty feature track
        return np.zeros((0, 1), cfg.out_dtype)
    dtype = torch.bfloat16 if cfg.half else torch.float32
    feats: List[np.ndarray] = []
    with torch.no_grad():
        for i in range(0, t, cfg.frame_bucket):
            chunk = np.ascontiguousarray(frames[i: i + cfg.frame_bucket], np.float32)
            valid = chunk.shape[0]
            x = torch.from_numpy(chunk).to(dev).to(dtype)
            if valid < cfg.frame_bucket:  # the last frame repeated, on the device
                x = torch.cat([x, x[-1:].expand((cfg.frame_bucket - valid,) + x.shape[1:])])
            feats.append(encoder(x)[:valid].float().cpu().numpy())
    per_frame = np.concatenate(feats, 0)
    if cfg.fps > 1:  # pool fps frames -> one per-second vector
        sec = per_frame.shape[0] // cfg.fps
        per_frame = per_frame[: sec * cfg.fps].reshape(sec, cfg.fps, -1).mean(1)
    return per_frame.astype(cfg.out_dtype)


def extract_video_features(encoder, frames: np.ndarray, cfg: Optional[ExtractConfig] = None,
                           device="cuda") -> np.ndarray:
    """Run ``encoder`` ((B, H, W, 3) frames -> (B, D); an ``nn.Module`` or a
    callable) over a video's frames (T, H, W, 3), decoded at ``cfg.fps``, in
    buckets of ``cfg.frame_bucket`` on ``device``, and pool ``cfg.fps``
    frames to one feature a second -> (seconds, D) in ``cfg.out_dtype``.
    Under ``cfg.half`` a module runs as ``half_copy`` makes it and the
    frames go in bfloat16."""
    cfg = ExtractConfig() if cfg is None else cfg
    dev = resolve_device(device)
    if frames.shape[0] == 0:
        return _features(encoder, frames, cfg, dev)
    return _features(_prepare(encoder, cfg, dev), frames, cfg, dev)


def extract_corpus(encoder, video_paths: Iterable[str], out_dir: str,
                   cfg: Optional[ExtractConfig] = None,
                   frame_loader: Optional[Callable[[str], Optional[np.ndarray]]] = None,
                   device="cuda") -> List[str]:
    """Corpus run: decode -> encode -> save ``{vid}.npy`` a video,
    skipping files already written (restartable, as the reference
    template) and videos that do not decode; the module is cast once.
    Returns the files written."""
    cfg = ExtractConfig() if cfg is None else cfg
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    loader = frame_loader or (lambda p: decode_frames(p, cfg.fps))
    encoder = _prepare(encoder, cfg, dev)
    written = []
    for path in video_paths:
        vid = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(out_dir, f"{vid}.npy")
        if os.path.exists(out_path):
            continue
        frames = loader(path)
        if frames is None:
            print(f"[extract] decode failed, skipping {path}")
            continue
        np.save(out_path, _features(encoder, frames, cfg, dev))
        written.append(out_path)
    return written
