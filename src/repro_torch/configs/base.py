"""Architecture configuration dataclasses, field for field the JAX
package's.

An ArchConfig is a complete, declarative description of one model: the
layer pattern (a repeating unit looped over depth + optional prefix
layers), the mixer/FFN hyperparameters, and the training-mode knobs
(node_mode = the paper's neural-ODE depth formulation + gradient scheme).
The mixer configs (``AttnConfig``, ``MambaConfig``, ``XLSTMConfig``,
``MoEConfig``) are the port's own, beside their modules in ``nn/``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mamba import MambaConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.xlstm import XLSTMConfig


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # "attn" | "mla" | "mamba" | "mlstm" | "slstm"
    ffn: str     # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """The paper's technique as a training mode.

    mode:
      "off"    — standard discrete residual stack.
      "node"   — depth-time neural ODE over the layer stack:
                 f(x, t) = R * (unit_n(x) - x), n = floor(t*R) (with the
                 offset of ``models.lm.depth_unit``, so that step n runs
                 unit n), integrated with ``method`` over [0,1] with n_steps
                 (= R by default) by ``repro_torch.core.solve``.  Training
                 only: prefill and decode run the discrete stack.
    grad_mode: a gradient strategy for ``repro_torch.core.solve``, by name
      or instance.
    combine_backend: auto | torch | cuda — how RK stage combinations run
      (core/combine.py).
    """
    mode: str = "off"
    method: str = "euler"
    n_steps: int = 0               # 0 => one step per repeat unit
    grad_mode: object = "symplectic"
    combine_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...]
    prefix: Tuple[LayerSpec, ...] = ()
    # attention
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mla_kv_lora: int = 0           # >0 enables MLA fields
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128
    # moe
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared: int = 0
    moe_shared_d_ff: int = 0
    # ssm
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    xlstm_heads: int = 4
    # enc-dec / frontends
    encdec: bool = False
    enc_layers: int = 0
    frontend: str = "none"         # none | audio | patch
    d_frontend: int = 0
    # misc
    norm_eps: float = 1e-6
    residual_scale: float = 1.0    # minicpm depth-scaled residuals
    tie_embeddings: bool = False
    # training mode
    node: NodeConfig = NodeConfig()
    remat: bool = True             # checkpoint each unit (training)
    scan_unit: bool = True         # JAX: lax.scan over units; here a loop
    # the JAX package's ``use_pallas``: None = kernels for CUDA tensors and
    # plain versions for CPU tensors; False = plain versions everywhere
    use_kernels: Optional[bool] = None

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.prefix)
        if body % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: {body} body layers is not a "
                             f"multiple of the pattern's {len(self.pattern)}")
        return body // len(self.pattern)

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qk_norm=self.qk_norm, window=self.window,
            rope_theta=self.rope_theta, rotary_pct=self.rotary_pct,
            mla=self.mla_kv_lora > 0, kv_lora=self.mla_kv_lora or 512,
            rope_head_dim=self.mla_rope_dim, nope_head_dim=self.mla_nope_dim,
            v_head_dim=self.mla_v_dim)

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model, d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.moe_experts, top_k=self.moe_top_k,
            n_shared=self.moe_shared, shared_d_ff=self.moe_shared_d_ff)

    def mamba_config(self) -> MambaConfig:
        return MambaConfig(d_model=self.d_model,
                           d_state=self.mamba_d_state,
                           d_conv=self.mamba_d_conv,
                           expand=self.mamba_expand)

    def xlstm_config(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, n_heads=self.xlstm_heads)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
