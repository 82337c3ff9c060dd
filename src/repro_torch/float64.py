"""Float64 runs of the port's float32 arithmetic, the reference that
measures a float32 run's rounding.

The port computes some steps in float32 whatever its inputs' dtype (a norm's
or softmax's accumulation, the router, a recurrent state, the optimizer's
moments), as the JAX package does.  While ``lifted()`` is active, the
``torch`` of each module in ``CAST_MODULES`` is a ``Float64Torch``, whose
``float32`` is ``float64``: a model run on float64 weights and inputs then
rounds in float64 throughout.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Iterator, List

import torch

__all__ = ["CAST_MODULES", "Float64Torch", "cast_modules", "lifted"]

# every module of the model zoo's serving and training paths that casts to
# float32
CAST_MODULES = ("repro_torch.kernels.ref", "repro_torch.nn.attention",
                "repro_torch.nn.rope", "repro_torch.nn.moe",
                "repro_torch.nn.mamba", "repro_torch.nn.xlstm",
                "repro_torch.nn.norm", "repro_torch.models.lm",
                "repro_torch.models.encdec", "repro_torch.train.serve_step",
                "repro_torch.train.losses", "repro_torch.train.train_step",
                "repro_torch.train.data_parallel", "repro_torch.optim.adamw",
                "repro_torch.optim.clip", "repro_torch.optim.compress")


class Float64Torch:
    """``torch`` with ``float32`` taken to ``float64``."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def cast_modules() -> List[object]:
    """The modules of ``CAST_MODULES``, imported."""
    return [importlib.import_module(m) for m in CAST_MODULES]


@contextlib.contextmanager
def lifted() -> Iterator[None]:
    """Every module of ``CAST_MODULES`` on a ``Float64Torch`` while
    active, then as it was."""
    saved = [(m, m.torch) for m in cast_modules()]
    try:
        for m, _ in saved:
            m.torch = Float64Torch()
        yield
    finally:
        for m, t in saved:
            m.torch = t
