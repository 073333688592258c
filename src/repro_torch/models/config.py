"""Model configuration for the assigned architecture pool.

One dataclass covers dense GQA transformers, MoE, Mamba2 (SSD), and
hybrid (Jamba) stacks, plus frontend-stub modalities (audio frames /
vision patches). Layers are grouped into repeating *blocks* whose
parameters are stacked on a leading ``n_blocks`` dimension; the forward
pass loops over that dimension. A copy of ``repro.models.config`` (the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 => d_model // n_heads
    # --- attention ---
    rope: str = "standard"        # "standard" | "2d" | "none"
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_window: int = 0          # 0 = full attention; >0 = sliding window
    pos_embed: str = "none"       # "none" | "sinusoidal"
    # --- mlp ---
    activation: str = "swiglu"    # "swiglu" | "gelu"
    # --- moe ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_ff: int = 0        # shared-expert ffn width (qwen2-moe)
    moe_ff: int = 0               # routed-expert ffn width
    moe_every: int = 1            # MoE on layers with (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- ssm / hybrid ---
    ssm: bool = False             # attention-free (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0           # hybrid: attention on (i % attn_every ==
    attn_offset: int = 0          # attn_offset), mamba elsewhere. 0 = all attn
    # --- modality frontend (a stub: precomputed embeddings) ---
    frontend: str = "none"        # "none" | "audio_frames" | "vision_patches"
    frontend_tokens: int = 0      # prepended patch/frame embeddings
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, mlp) kinds for the whole stack."""
        out = []
        for i in range(self.n_layers):
            if self.ssm and self.attn_every == 0:
                mixer = "mamba"
            elif self.attn_every > 0:
                mixer = "attn" if i % self.attn_every == self.attn_offset else "mamba"
            else:
                mixer = "attn"
            if self.d_ff == 0 and self.moe_experts == 0:
                mlp = "none"
            elif self.moe_experts > 0 and i % self.moe_every == self.moe_offset:
                mlp = "moe"
            else:
                mlp = "dense"
            out.append((mixer, mlp))
        return out

    def block_pattern(self) -> List[Tuple[str, str]]:
        """The repeating block of layer kinds (scan unit)."""
        kinds = self.layer_kinds()
        # find the smallest repeating period that divides n_layers
        for period in range(1, self.n_layers + 1):
            if self.n_layers % period:
                continue
            if all(kinds[i] == kinds[i % period] for i in range(self.n_layers)):
                return kinds[:period]
        return kinds

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern())

    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode without O(S) full-
        attention KV on every layer growing quadratic prefill cost."""
        if self.ssm and self.attn_every == 0:
            return True
        if self.attn_every > 0:  # hybrid: few attention layers, rest SSM
            return True
        return self.attn_window > 0  # sliding window

    def num_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += d * self.vocab
        total += d  # final norm
        for mixer, mlp in self.layer_kinds():
            total += d  # pre-mixer norm
            if mixer == "attn":
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += qkv + (self.n_heads * hd) * d
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:
                din, n, h = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * din * 2        # wz, wx
                total += 2 * d * n          # wb, wc
                total += d * h + h          # wdt + bias
                total += self.ssm_conv * (din + 2 * n)
                total += 2 * h              # A_log, D
                total += din                # gated norm
                total += din * d            # out_proj
            if mlp == "dense":
                total += d  # pre-mlp norm
                mult = 3 if self.activation == "swiglu" else 2
                total += mult * d * self.d_ff
            elif mlp == "moe":
                total += d  # pre-mlp norm
                total += d * self.moe_experts  # router
                mult = 3 if self.activation == "swiglu" else 2
                total += self.moe_experts * mult * d * self.moe_ff
                if self.moe_shared_ff:
                    total += mult * d * self.moe_shared_ff + d
        return total

    def active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe_experts == 0:
            return self.num_params()
        d = self.d_model
        mult = 3 if self.activation == "swiglu" else 2
        per_expert = mult * d * self.moe_ff
        n_moe_layers = sum(1 for _, m in self.layer_kinds() if m == "moe")
        inactive = n_moe_layers * (self.moe_experts - self.moe_top_k) * per_expert
        return self.num_params() - inactive
