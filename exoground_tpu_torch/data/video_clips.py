"""Raw-video clip reader of the end-to-end S3D finetune (HTM-AA).

Counterpart of ``exoground_tpu/data/video_clips.py`` (reference
end2end/video_loader.py:39-174, HTM_ClipLoader): decode an HTM video at
``fps`` around a narration timestamp through the ``ffmpeg`` binary (a
rawvideo pipe), random-crop to ``crop_size``², and return (num_clips, T, H,
W, 3) frames with the tokenized text of the HTM-AA alignment csv row.

Clips are uint8 by default: they cross to the card at one byte a pixel and
the train step divides by 255 in float32 there (``parallel/train_step.py::
S3DNceStep``), which equals the host's ``/ 255`` bit for bit. A decode that
fails (no ffmpeg, no file, no frame) gives grey frames, the reference's own
decode-failure behaviour (video_loader.py:164-166): 128 in uint8, 0.5 in
float32. ``HTMClipDataset`` counts both outcomes (``decoded``, ``grey``) so
a run can say which it trained on.

Each item draws from its own ``RandomState`` seeded by (seed, epoch, index),
in the JAX reader's order: the clip's jitter inside the aligned span, then,
only when the decode succeeded, the crop's y and x.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from exoground_tpu_torch.data.collate import collate_dicts


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _decode(path: str, start_sec: float, num_frames: int, fps: int, crop: int, scale: int,
            rng: Optional[np.random.RandomState], dtype: str) -> Tuple[np.ndarray, bool]:
    """(the clip, whether ffmpeg decoded it) as ``decode_clip`` says."""
    duration = num_frames / fps
    if ffmpeg_available() and os.path.exists(path):
        cmd = ["ffmpeg", "-nostdin", "-loglevel", "error",
               "-ss", f"{start_sec:.3f}", "-t", f"{duration + 0.5:.3f}", "-i", path,
               "-vf", f"fps={fps},scale={scale}:{scale}",
               "-pix_fmt", "rgb24", "-f", "rawvideo", "-"]
        try:
            raw = subprocess.run(cmd, capture_output=True, timeout=60, check=True).stdout
            n = len(raw) // (scale * scale * 3)
            if n >= 1:
                frames = np.frombuffer(raw[: n * scale * scale * 3], np.uint8).reshape(
                    n, scale, scale, 3)
                if n < num_frames:  # the last frame repeated
                    frames = np.concatenate(
                        [frames, np.repeat(frames[-1:], num_frames - n, 0)], 0)
                frames = frames[:num_frames]
                if rng is not None:
                    y = rng.randint(0, scale - crop + 1)
                    x = rng.randint(0, scale - crop + 1)
                else:
                    y = x = (scale - crop) // 2
                cropped = frames[:, y: y + crop, x: x + crop]
                if dtype == "uint8":
                    return np.ascontiguousarray(cropped), True
                return cropped.astype(np.float32) / 255.0, True
        except (subprocess.SubprocessError, ValueError, OSError):
            pass
    if dtype == "uint8":  # 128 / 255 ~ 0.502: uint8 holds no 0.5
        return np.full((num_frames, crop, crop, 3), 128, np.uint8), False
    return np.full((num_frames, crop, crop, 3), 0.5, np.float32), False


def decode_clip(path: str, start_sec: float, num_frames: int = 16, fps: int = 5,
                crop: int = 224, scale: int = 256, rng: Optional[np.random.RandomState] = None,
                dtype: str = "float32") -> np.ndarray:
    """``num_frames`` frames at ``fps`` from ``start_sec``, scaled to
    ``scale``² and cropped to ``crop``² at random (the centre when ``rng`` is
    None): (T, H, W, 3) float32 in [0, 1], or uint8 with ``dtype="uint8"``;
    grey frames when the decode fails."""
    return _decode(path, start_sec, num_frames, fps, crop, scale, rng, dtype)[0]


@dataclass
class ClipConfig:
    video_root: str = ""
    fps: int = 5
    num_frames: int = 16
    num_clips: int = 1
    crop_size: int = 224
    scale_size: int = 256
    token_len: int = 16
    seed: int = 0
    clip_dtype: str = "uint8"  # "float32": the reference's host-side / 255


class HTMClipDataset:
    """HTM-AA clips (reference end2end/video_loader.py:39-174). ``pairs``:
    [{'vid', 'text', 'start', 'end'}, ...], one a csv row; each item samples
    ``num_clips`` clip windows inside the row's span and tokenizes its text.
    ``decoded`` / ``grey`` count the clips ffmpeg decoded and those that
    came out grey, ``item_s`` the seconds spent in items (every thread's)."""

    def __init__(self, cfg: ClipConfig, pairs: List[Dict], tokenizer):
        self.cfg = cfg
        self.pairs = pairs
        self.tokenizer = tokenizer
        self.epoch = 0
        self.decoded = self.grey = 0
        self.item_s = 0.0
        self._lock = threading.Lock()  # the loader's threads count together

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.pairs)

    def _rng(self, idx):
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + self.epoch * 7919 + idx) % (2**31 - 1))

    def __getitem__(self, idx: int) -> Dict:
        t0 = time.perf_counter()
        cfg = self.cfg
        rng = self._rng(idx)
        row = self.pairs[idx]
        span = max(float(row["end"]) - float(row["start"]), 0.0)
        clip_dur = cfg.num_frames / cfg.fps
        clips, ok = [], 0
        for _ in range(cfg.num_clips):
            start = float(row["start"]) + rng.rand() * max(span - clip_dur, 0.0)
            clip, decoded = _decode(os.path.join(cfg.video_root, f"{row['vid']}.mp4"), start,
                                    cfg.num_frames, cfg.fps, cfg.crop_size, cfg.scale_size,
                                    rng, cfg.clip_dtype)
            clips.append(clip)
            ok += decoded
        token = np.asarray(self.tokenizer(str(row["text"]))["input_ids"], np.int32).reshape(
            -1)[: cfg.token_len]
        token = np.pad(token, (0, cfg.token_len - token.shape[0]))
        with self._lock:
            self.decoded += ok
            self.grey += cfg.num_clips - ok
            self.item_s += time.perf_counter() - t0
        return {"video": np.stack(clips), "token": token, "vid": row["vid"]}

    collate_fn = staticmethod(collate_dicts)
