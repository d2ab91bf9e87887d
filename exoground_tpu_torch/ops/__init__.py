"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers.

Kernel libraries build at first use (``ops/_kernels.py``), never at import.
"""
