"""``repro_torch`` — the continuum platform in PyTorch, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the same module
names and the same semantics, held against the reference by the
``tests/test_torch_*.py`` parity tests.  Attention runs through the
hand-written CUDA kernels in ``repro_torch.kernels`` on a CUDA tensor
and through their plain PyTorch versions on a CPU tensor.

Entry points default to ``device="cuda"`` and raise when no card is
present; the CPU is used only when the caller asks for it.
"""
