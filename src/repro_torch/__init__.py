"""PyTorch/CUDA port of the encoded-MAC serving path (DESIGN.md §3, §8).

Mirrors the layout of the JAX package ``repro`` (``repro_torch.kernels.
encoded_matmul`` is the port of ``repro.kernels.encoded_matmul``) and is
held against it by ``tests/test_torch_*.py``.  It imports ``torch`` and
never ``jax`` or ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its
plain PyTorch version, on CUDA tensors it launches the hand-written Hopper
kernel under ``repro_torch/csrc`` or raises.
"""
