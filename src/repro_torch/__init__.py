"""PyTorch + CUDA port of the ``repro`` stream-sampling system.

Mirrors the reference package's layout (``core/``, ``kernels/<name>/``,
``stats/``) so every module here has exactly one counterpart in
``src/repro/``.  Plain tensor code is PyTorch; each Pallas kernel on the
ported path is a hand-written CUDA kernel for Hopper (``kernels/csrc``),
dispatched by the device of its input tensors: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the kernel.

The package imports neither ``jax`` nor ``repro``; the parity tests
(``tests/test_torch_*.py``) are the only place both meet.
"""
