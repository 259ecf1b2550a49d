"""PyTorch/CUDA port of ``repro`` (Fast Feedforward Networks).

Mirrors ``src/repro/`` module for module, so each function here has its
JAX counterpart at the same path.  Every Pallas TPU kernel on a ported path
is a hand-written CUDA kernel under ``kernels/csrc/``; the plain PyTorch
version beside each one (``kernels/<pkg>/ref.py``) is what CPU tensors run.
Entry points default to ``device="cuda"`` and raise when no card is present.
"""
