"""CUDA kernel for flash attention (Hopper, sm_90a), in
``csrc/flash_attention.cu``: online-softmax attention with causal masking,
GQA (kv head = h // (H // Hkv)), a sliding window, a query offset and a
padded-kv mask (replaces the JAX package's ``flash_attention_pallas``).
The plain PyTorch version is ``kernels/ref.py::attention_ref``;
``kernels/ops.py`` routes CPU tensors there and CUDA tensors here.

Design (the source note has the details): both products on the tensor
cores with ``wgmma`` in 3xTF32 (each float split into a TF32 hi and a lo
part; hi.hi plus hi.lo + lo.hi, the small sum first), which keeps float32
accuracy; bound by operations, 3 x flops over the 495 TFLOP/s of TF32
(0.208 ms at the LM's prefill, B 8, H 16, S 1024, D 128, causal).  One CTA
of 384 threads per 128 query rows: two consumer warpgroups of 64 rows, and
a producer warpgroup whose first lane brings Q once and the K/V tiles of
32 keys (16 for float64) by TMA into a two-slot ring, while its other
three warps write K's lo part beside K and V transposed; mbarriers order
the roles.  Shared memory at D 128 float32: 224 KB (Q hi 64 KB, and per
slot K hi/lo 32 KB, raw V 16 KB, V transposed hi/lo 32 KB).

The kernel reads q, k and v by TMA through their strides, so the
transposed (B, H, S, D) views of (B, S, H, D) projections need no copy;
the last dim must be contiguous, and the bases and the b, h, s strides
16-byte aligned (TMA's rule; the wrapper raises ``ValueError`` otherwise).
At D 160 (stablelm-12b) a float32 CTA takes kv tiles of 16 keys, which
keeps its shared memory at 181 KB (32-key tiles would need 280 KB) and
its registers at D 128's count; 16-bit inputs keep 32 keys and land in
TMA's 64-byte swizzle (a 320-byte row is no multiple of 128).  float64
does not fit at D 160 and raises, as does the backward at D 160 (ROADMAP
queue 2).
It writes its output into a (B, Sq, H, D) buffer and returns the
(B, H, Sq, D) view of it, so that the caller's transpose back to
(B, Sq, H*D) is free.

With ``return_lse=True`` the forward also returns each query row's
log-sum-exp of its scaled scores, (B, H, Sq) float32: what the backward
recomputes the probabilities from.  The backward, ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``, float32 and float64), takes q, k, v, the
output, lse and the output's cotangent and returns (dq, dk, dv) from three
deterministic kernels (a row-dot pass, one CTA per kv tile for dk/dv
summing its GQA group in a fixed order, one CTA per query tile for dq; no
atomics).  float32 runs its five products on the tensor cores with
``wgmma`` in 3xTF32 from TMA-fed tiles, and the dk/dv kernel hands dS to
the dq kernel through a scratch tensor of the tiles the masks keep (0.285
GB at the LM's training shape, B 8, H 16, S 1024, causal), allocated here
per call; float64 runs FMA on the CUDA cores.  ``kernels/ops.py`` makes the
pair a ``torch.autograd.Function``; the plain version is
``kernels/ref.py::attention_bwd_ref``.

Each wrapper counts its calls in ``<wrapper>.launches`` (one per call:
the backward's three kernels count once), a plain integer that callers may
reset.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import CudaLibrary, call, raise_on

__all__ = ["flash_attention", "flash_attention_bwd", "tma_ready", "SOURCE",
           "BWD_SOURCE", "HEAD_DIMS", "BWD_HEAD_DIMS", "check_bwd_head_dim"]

# the forward's head dims; 160 (stablelm-12b) in float32, float16 and
# bfloat16 only: float64's tiles at D 160 do not fit a CTA's shared memory
HEAD_DIMS = (16, 32, 64, 128, 160)
BWD_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_vp, _i32 = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("flash_attention", {
    "flash_attention_launch": [_i32, _vp, _vp, _vp, _vp, _vp, _vp, _i32,
                               _i32, _i32, _i32, _i32, _i32, ctypes.c_float,
                               _i32, _i32, _i32, _i32, _vp],
})
SOURCE = LIBRARY.source
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", {
    "flash_attention_bwd_launch": [_i32] + [_vp] * 12 + [_i32] * 6 + [
        ctypes.c_double] + [_i32] * 4 + [_vp],
    "flash_attention_bwd_scratch_bytes": [_i32] * 9 + [
        ctypes.POINTER(ctypes.c_longlong)],
})
BWD_SOURCE = BWD_LIBRARY.source
_BWD_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _strides(t: torch.Tensor):
    """The b, h, s element strides, with the stride of a dim of size 1 (never
    stepped along, and free in PyTorch) replaced by a contiguous one."""
    B, H, S, D = t.shape
    dense = (H * S * D, S * D, D)
    return tuple(st if n > 1 else c
                 for st, n, c in zip(t.stride()[:3], (B, H, S), dense))


def tma_ready(t: torch.Tensor) -> bool:
    """t can be read by TMA: the last dim contiguous, and the base and the
    b, h, s strides 16-byte aligned."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(
        st * t.element_size() % 16 for st in _strides(t))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: need q (B,H,Sq,D) and k, v (B,Hkv,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit "
                         f"q shape {tuple(q.shape)} (H % Hkv must be 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if D == 160 and q.dtype == torch.float64:
        raise ValueError(f"{name}: head dim 160 takes float32, float16 or "
                         f"bfloat16, not float64")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous (got "
                             f"strides {tuple(t.stride())}); the kernel "
                             f"reads rows through the other strides")
        if not tma_ready(t):
            raise ValueError(f"{name}: TMA needs a 16-byte aligned base and "
                             f"b, h, s strides (got storage offset "
                             f"{t.storage_offset()}, strides "
                             f"{tuple(t.stride())}, {t.dtype})")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")


def check_bwd_head_dim(D: int):
    """Raise for a head dim that the backward kernels do not take."""
    if D not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd: head dim {D} is not ported (the backward "
            f"takes {BWD_HEAD_DIMS}; D 160 is open in ROADMAP queue 2, "
            f"\"flash backward at D 160\")")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention on the card.  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), one
    float dtype, D in ``HEAD_DIMS`` (160 not in float64), last dim
    contiguous.  ``q_offset`` is the absolute position of query 0; with
    ``window`` w, query i attends keys j with i - w < j <= i (absolute).  Returns (B, H, Sq, D) in q's
    dtype, a view of a (B, Sq, H, D) buffer; with ``return_lse``, also the
    rows' log-sum-exp (B, H, Sq) float32 (log(1e-30) for a row that sees no
    key)."""
    name = "flash_attention"
    _check(q, k, v, name)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    view = out.transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel() == 0 or Sk == 0:
        view.zero_()
        if lse is not None:
            lse.fill_(math.log(1e-30))
        return (view, lse) if return_lse else view
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, view) for s in _strides(t)))
    err = call(LIBRARY.load().flash_attention_launch, q.get_device(),
               _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), None if lse is None else lse.data_ptr(),
               strides, B, H, Hkv, Sq, Sk, D, float(scale),
               int(causal), int(window is not None),
               0 if window is None else int(window), int(q_offset))
    raise_on(err, name)
    flash_attention.launches += 1
    return (view, lse) if return_lse else view


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)`` for
    the output cotangent ``dout``, on the card, from the forward's output
    ``out`` and ``lse`` (its ``return_lse``).  q, k, v, out, dout: float32
    or float64 (another dtype raises ``TypeError``), any strides with the
    last dim contiguous (float32 reads dout by TMA too: ``tma_ready``);
    lse: (B, H, Sq) float32.  dq comes back as the
    (B, H, Sq, D) view of a (B, Sq, H, D) buffer, like the forward's output;
    dk and dv as (B, Hkv, Sk, D) views of (B, Sk, Hkv, D) buffers."""
    name = "flash_attention_bwd"
    check_bwd_head_dim(q.shape[-1])
    code = _BWD_DTYPE_CODE.get(q.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(have {sorted(map(str, _BWD_DTYPE_CODE))})")
    _check(q, k, v, name)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for t, nm in ((out, "out"), (dout, "dout")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"{name}: {nm} {t.dtype} {tuple(t.shape)} "
                             f"strides {tuple(t.stride())} is not like q "
                             f"{q.dtype} {tuple(q.shape)} with its last dim "
                             f"contiguous")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{name}: lse {lse.dtype} {tuple(lse.shape)} is not "
                         f"a contiguous ({B}, {H}, {Sq}) float32 tensor")
    if code == 0 and not tma_ready(dout):
        raise ValueError(f"{name}: TMA needs dout's base and b, h, s strides "
                         f"16-byte aligned (got storage offset "
                         f"{dout.storage_offset()}, strides "
                         f"{tuple(dout.stride())})")
    scale = scale if scale is not None else D ** -0.5
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    views = (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2))
    if q.numel() == 0 or Sk == 0:
        return tuple(t.zero_() for t in views)
    lib = BWD_LIBRARY.load()
    mask = (int(causal), int(window is not None),
            0 if window is None else int(window), int(q_offset))
    nbytes = ctypes.c_longlong(0)
    raise_on(lib.flash_attention_bwd_scratch_bytes(
        code, B, H, Sq, Sk, *mask, ctypes.byref(nbytes)), name)
    # float32's dS scratch: only the (query, key) tiles the masks keep
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=q.device) \
        if nbytes.value else None
    dvec = torch.empty((B, H, Sq), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, dout) + views for s in _strides(t)))
    err = call(lib.flash_attention_bwd_launch, q.get_device(), code,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, B, H,
               Hkv, Sq, Sk, D, float(scale), *mask)
    raise_on(err, name)
    flash_attention_bwd.launches += 1
    return views


flash_attention.launches = 0
flash_attention_bwd.launches = 0
