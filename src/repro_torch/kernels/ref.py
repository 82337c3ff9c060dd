"""Plain PyTorch versions of the CUDA kernels in this package.

They compute what the kernels compute, in the same accumulation dtype
(``promote(x.dtype, float32)``: float32 for float32/bfloat16/float16
states, float64 for float64 states) and in the same stage order i =
0..s-1.  On CPU tensors they ARE the stage combine (``kernels/ops.py``);
on the card they are only the yardstick the kernels are checked against.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a stage combine over ``dtype`` states."""
    return torch.promote_types(dtype, torch.float32)


def butcher_combine_ref(x: torch.Tensor, ks: torch.Tensor, coefs,
                        h) -> torch.Tensor:
    """x + h * sum_i coefs[i] * ks[i].

    x: (...,), ks: (s, ...), coefs: (s,).  Accumulates in
    promote(x.dtype, float32), strictly in stage order.
    """
    acc_dt = acc_dtype(x.dtype)
    hc = torch.as_tensor(h * coefs).to(acc_dt)
    acc = x.to(acc_dt)
    for i in range(ks.shape[0]):
        acc = acc + hc[i] * ks[i].to(acc_dt)
    return acc.to(x.dtype)


def butcher_combine_rows_ref(x: torch.Tensor, ks: torch.Tensor, coefs,
                             base_scale, h) -> torch.Tensor:
    """Multi-row combine: out[r] = base_scale[r]*x + h*sum_i coefs[r,i]*ks[i].

    x: (...,), ks: (s, ...), coefs: (m, s), base_scale: (m,).  Returns
    (m,) + x.shape, with the same accumulation dtype and order as
    ``butcher_combine_ref``.
    """
    acc_dt = acc_dtype(x.dtype)
    hc = torch.as_tensor(h * coefs).to(acc_dt)
    sc = torch.as_tensor(base_scale).to(acc_dt)
    xf = x.to(acc_dt)
    outs = []
    for r in range(hc.shape[0]):
        acc = sc[r] * xf
        for i in range(ks.shape[0]):
            acc = acc + hc[r, i] * ks[i].to(acc_dt)
        outs.append(acc.to(x.dtype))
    return torch.stack(outs)
