"""PyTorch/CUDA port of exoground_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops/``, ``models/``, ``losses/``,
``parallel/``, ``train/``, ``evals/``, ``utils/``, ``serve.py``). Each module with a hand-written CUDA kernel keeps
a plain PyTorch twin: a wrapper takes the plain version only for tensors on
the CPU, and on a CUDA tensor launches its kernel or raises.

Entry points default to ``device="cuda"`` and raise when CUDA is missing;
pass ``device="cpu"`` to run the plain path.
"""
