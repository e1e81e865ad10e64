"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package computes the same
things with PyTorch tensors, and its hot path runs hand-written CUDA kernels
(:mod:`repro_torch.kernels.fused_erm`).  It imports neither JAX nor anything
of ``repro``.

The reference is strict float32, so importing the package turns TF32 off for
matrix products and convolutions.  Entry points run on the card unless the
caller asks for the CPU (``plan(spec, device="cpu")``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
