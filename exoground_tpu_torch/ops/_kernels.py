"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into a shared library with a plain C interface, loaded through ``ctypes``.
The library name carries a hash of its source, so an edited source builds
anew and a stale library is never loaded. Nothing here runs at import: the
CPU tests import every module of the port and have no ``nvcc``.

Every kernel entry point takes its pointers and the CUDA stream as
``c_void_p``, launches on the stream it is given (the wrappers pass
``torch.cuda.current_stream()``) and returns ``cudaGetLastError()``; the
wrapper raises on any non-zero value. Each wrapper counts its launches in
``LAUNCHES`` under its own name (one per launch, nowhere else, through
``count_launch``), so a run can show that a path went through the kernels.
The counts are taken under a lock: the HTTP front serves each connection on
a thread of its own, and ``+= 1`` on a dict entry is not atomic.

A launch made while a CUDA graph is being captured goes into the graph (the
capturing stream is the current one) and runs only when the graph is
replayed: ``captured_launches`` takes the capture's counts back out of
``LAUNCHES`` and ``add_launches`` adds them once per replay, so
``LAUNCHES`` keeps counting the kernels the card ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points, by source
SIGNATURES = {
    "fused_mha": {
        # x, kpad, w_in, b_in, w_out, b_out, attn scratch, qkv scratch (wide
        # heads; else null), out, B, S, C, H, dtype (0 f32, 1 bf16), stream
        "fused_mha_forward": (_P,) * 9 + (_I,) * 5 + (_P,),
    },
    "fused_mlp": {
        # x, c_fc w, c_fc b, c_proj w, c_proj b, out, f32 workspace, rows, C,
        # slab, split, dtype, stream
        "fused_mlp_forward": (_P,) * 7 + (_I,) * 5 + (_P,),
    },
    "fused_mha_int8": {
        # x, kpad, w_in int8, w_in scales, b_in, w_out, b_out, x int8, x scales,
        # attn scratch, qkv scratch, out, B, S, C, H, dtype, stream
        "fused_mha_int8_forward": (_P,) * 12 + (_I,) * 5 + (_P,),
    },
    "fused_mlp_int8": {
        # x, c_fc w int8, c_fc scales, c_fc b, c_proj w, c_proj b, out, f32
        # workspace, rows, C, slab, split, dtype, stream
        "fused_mlp_int8_forward": (_P,) * 8 + (_I,) * 5 + (_P,),
    },
    "milnce_grid": {
        # video3, text3, cvalid, v_den, t_den, part_m, part_l,
        # S, St, R, Cc, C, nR, inv_temp, dtype, stream
        "milnce_grid_forward": (_P,) * 7 + (_I,) * 6 + (_F, _I, _P),
        # video3, text3, cvalid, v_den, t_den, g_v, g_t, dv, dt, dt_part,
        # S, St, R, Cc, C, nsplit, slab, inv_temp, dtype, stream
        "milnce_grid_backward": (_P,) * 10 + (_I,) * 7 + (_F, _I, _P),
    },
    "block_attn": {
        # x, kpad, ln w, ln b, w_in, b_in, w_out, b_out, attn scratch, qkv
        # scratch, out, x_norm, B, S, C, H, dtype, stream
        "block_attn_forward": (_P,) * 12 + (_I,) * 5 + (_P,),
    },
    "block_attn_int8": {
        # x, kpad, ln w, ln b, w_in int8, w_in scales, b_in, w_out, b_out,
        # x_norm int8, x_norm scales, attn scratch, qkv scratch, out, x_norm,
        # B, S, C, H, dtype, stream
        "block_attn_int8_forward": (_P,) * 15 + (_I,) * 5 + (_P,),
    },
    "block_mlp": {
        # x, ln w, ln b, c_fc w, c_fc b, c_proj w, c_proj b, out, f32
        # workspace, rows, C, slab, split, dtype, stream
        "block_mlp_forward": (_P,) * 9 + (_I,) * 5 + (_P,),
        # x, ln w, ln b, c_fc w int8, c_fc scales, c_fc b, c_proj w,
        # c_proj b, out, f32 workspace, rows, C, slab, split, dtype, stream
        "block_mlp_int8_forward": (_P,) * 10 + (_I,) * 5 + (_P,),
    },
    "small_attn": {
        # q, k, v, kpad (bool, or null), o, B, H, S, D, the (batch, head, row) element
        # strides of q, k, v and o, scale, dtype, stream
        "small_attn_forward": (_P,) * 5 + (_I,) * 4 + (_L,) * 12 + (_F, _I, _P),
    },
    "flash_attn": {
        # q, k, v, kpad, o, lse, BH, H, Sq, Sk, D, dtype, stream
        "flash_attn_forward": (_P,) * 6 + (_I,) * 6 + (_P,),
        # q, k, v, kpad, do, lse, delta, dq, BH, H, Sq, Sk, D, dtype, stream
        "flash_attn_dq": (_P,) * 8 + (_I,) * 6 + (_P,),
        # q, k, v, kpad, do, lse, delta, dk, dv, BH, H, Sq, Sk, D, dtype, stream
        "flash_attn_dkv": (_P,) * 9 + (_I,) * 6 + (_P,),
    },
}

# one counter per wrapper
LAUNCHES: Dict[str, int] = {
    name: 0 for name in ("fused_mha", "fused_mlp", "fused_mha_int8", "fused_mlp_int8",
                         "milnce_grid_fwd", "milnce_grid_bwd", "flash_fwd", "flash_dq",
                         "flash_dkv", "block_attn", "block_attn_int8", "block_mlp",
                         "block_mlp_int8", "small_attn")
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    """One launch of wrapper ``name``'s kernel (the wrappers' one count)."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a graph capture: yields a dict that holds, at exit, the
    launches the capture recorded by wrapper name; ``LAUNCHES`` is left as
    it was before the capture."""
    with _count_lock:
        before = dict(LAUNCHES)
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        with _count_lock:
            for name, n in before.items():
                if LAUNCHES[name] != n:
                    counts[name] = LAUNCHES[name] - n
                    LAUNCHES[name] = n


def add_launches(counts: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all started together) and load the
    libraries of ``names``; returns them by name. A failed build raises with
    nvcc's output, stops the other compilers and leaves no partial file."""
    names = list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        jobs = []
        try:
            for n in todo:
                jobs.append((n, _start_build(n)))
            for n, job in jobs:
                _finish_build(n, job)
        finally:
            for _, job in jobs:
                if job is None:
                    continue
                proc, tmp, _ = job
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                proc.stdout.close()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        for n in todo:
            _libs[n] = _bind(n)
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def check_inference(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is inference-only, as the TPU kernel is. Run under "
            "torch.no_grad()/torch.inference_mode(), or differentiate inside "
            "ops.fused_mlp.disable_fused_kernels(), as the train step does."
        )


def check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """The tensor-core bodies stage these operands by 16-byte ``cp.async``:
    each must start on a 16-byte boundary (a fresh allocation does; a view
    at an odd offset may not). The kernels return
    cudaErrorMisalignedAddress otherwise; this names the operand first."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary for the "
                             "kernel's 16-byte copies (pass a fresh or .clone()d tensor)")


def check_cuda_inputs(name: str, device: torch.device, dtype: torch.dtype,
                      **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
