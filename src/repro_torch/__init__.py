"""PyTorch/CUDA port of the symplectic adjoint method for neural ODEs.

A package beside the JAX package ``repro``, with the same layout and names:
``repro_torch.core`` (tableaus, stage combiner, steppers, drivers, the
symplectic adjoint and the ``solve`` API), ``repro_torch.kernels`` (the
hand-written CUDA kernels and their plain PyTorch versions),
``repro_torch.models`` (the CNF workload) and ``repro_torch.launch`` (the
CNF trainer).  It imports neither JAX nor ``repro``.
"""
