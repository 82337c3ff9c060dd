"""Dispatch for the stage-combine kernels: a CPU tensor goes to the plain
PyTorch version (``kernels/ref.py``); any other tensor goes to the CUDA
kernel (``kernels/butcher_combine.py``), whose wrapper launches it or
raises.  There is no fallback from the kernel to the plain version.

``hc``/``sc`` are the final coefficient rows, already multiplied by the
step size, in ``promote(x.dtype, float32)`` on x's device.
"""
from __future__ import annotations

import torch

from . import butcher_combine as _kernels
from . import ref


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i]."""
    if x.device.type == "cpu":
        return ref.butcher_combine_ref(x, ks, hc, 1.0)
    return _kernels.butcher_combine(x, ks, hc)


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i]; (m,) + x.shape."""
    if x.device.type == "cpu":
        return ref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
    return _kernels.butcher_combine_rows(x, ks, hc, sc)
