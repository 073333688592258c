"""Architecture registry: the 10 assigned configs (exact numbers from the
public sources cited beside each), each with a reduced smoke config and
per-shape applicability (long_500k only for sub-quadratic archs). A copy
of ``repro.configs.registry`` over the port's own ``ModelConfig``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.shapes import ALL_SHAPES, ShapeSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig
    train_microbatches: int = 1  # gradient-accumulation chunks for train_4k


def _smoke(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config: few layers/width, tiny vocab."""
    base = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, len(cfg.block_pattern())),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=101,
        head_dim=16,
        rope=cfg.rope,
        rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias,
        attn_window=min(cfg.attn_window, 8) if cfg.attn_window else 0,
        pos_embed=cfg.pos_embed,
        activation=cfg.activation,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_shared_ff=64 if cfg.moe_shared_ff else 0,
        moe_ff=32 if cfg.moe_ff else 0,
        moe_every=cfg.moe_every,
        moe_offset=cfg.moe_offset,
        capacity_factor=8.0,
        ssm=cfg.ssm,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_expand=cfg.ssm_expand,
        ssm_conv=cfg.ssm_conv,
        attn_every=cfg.attn_every,
        attn_offset=min(cfg.attn_offset, max(0, cfg.attn_every - 1)),
        frontend=cfg.frontend,
        frontend_tokens=4 if cfg.frontend_tokens else 0,
        tie_embeddings=cfg.tie_embeddings,
        dtype="float32",
    )
    base.update(over)
    c = ModelConfig(**base)
    # keep the hybrid pattern length dividing n_layers
    if cfg.attn_every:
        c = dataclasses.replace(c, n_layers=cfg.attn_every)
    return c


# --- the 10 assigned architectures (exact configs) ---

MUSICGEN_MEDIUM = ModelConfig(
    # [arXiv:2306.05284; hf] decoder-only over EnCodec tokens; frontend stub
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab=2048, activation="gelu", rope="none",
    pos_embed="sinusoidal", frontend="audio_frames",
)

MAMBA2_130M = ModelConfig(
    # [arXiv:2405.21060] SSD; d_inner=1536, headdim=64 => 24 ssm heads
    name="mamba2-130m", n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=0, vocab=50280, ssm=True, ssm_state=128, ssm_head_dim=64,
    rope="none", tie_embeddings=True,
)

CHATGLM3_6B = ModelConfig(
    # [arXiv:2406.12793; hf] 2d (partial) RoPE, GQA kv=2, qkv bias
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, rope="2d", qkv_bias=True,
)

GRANITE_8B = ModelConfig(
    # [arXiv:2405.04324; hf] llama-arch code model
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152,
)

QWEN15_32B = ModelConfig(
    # [hf:Qwen/Qwen1.5 family] MHA (kv=40), QKV bias
    name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, qkv_bias=True,
)

QWEN2_7B = ModelConfig(
    # [arXiv:2407.10671; hf] GQA kv=4, QKV bias
    name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, qkv_bias=True,
)

MIXTRAL_8X7B = ModelConfig(
    # [arXiv:2401.04088; hf] 8 experts top-2, sliding window 4096
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, moe_experts=8, moe_top_k=2, moe_ff=14336,
    moe_every=1, attn_window=4096,
)

QWEN2_MOE_A27B = ModelConfig(
    # [hf:Qwen/Qwen1.5-MoE-A2.7B] 60 routed top-4 + 4 shared (5632 shared ff)
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936, moe_experts=60, moe_top_k=4,
    moe_ff=1408, moe_shared_ff=5632, moe_every=1, qkv_bias=True,
)

INTERNVL2_2B = ModelConfig(
    # [arXiv:2404.16821; hf] InternViT stub + InternLM2 backbone
    name="internvl2-2b", n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, frontend="vision_patches", frontend_tokens=256,
)

JAMBA_15_LARGE = ModelConfig(
    # [arXiv:2403.19887; hf] 1:7 attn:mamba interleave, MoE 16e top-2
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=24576, vocab=65536, moe_experts=16, moe_top_k=2,
    moe_ff=24576, moe_every=2, moe_offset=1, ssm_state=128, ssm_head_dim=64,
    attn_every=8, attn_offset=3,
)

ARCHS: Dict[str, ArchSpec] = {
    "musicgen-medium": ArchSpec(MUSICGEN_MEDIUM, _smoke(MUSICGEN_MEDIUM), 1),
    "mamba2-130m": ArchSpec(MAMBA2_130M, _smoke(MAMBA2_130M), 1),
    "chatglm3-6b": ArchSpec(CHATGLM3_6B, _smoke(CHATGLM3_6B), 2),
    "granite-8b": ArchSpec(GRANITE_8B, _smoke(GRANITE_8B), 2),
    "qwen1.5-32b": ArchSpec(QWEN15_32B, _smoke(QWEN15_32B), 4),
    "qwen2-7b": ArchSpec(QWEN2_7B, _smoke(QWEN2_7B), 2),
    "mixtral-8x7b": ArchSpec(MIXTRAL_8X7B, _smoke(MIXTRAL_8X7B), 4),
    "qwen2-moe-a2.7b": ArchSpec(QWEN2_MOE_A27B, _smoke(QWEN2_MOE_A27B), 1),
    "internvl2-2b": ArchSpec(INTERNVL2_2B, _smoke(INTERNVL2_2B), 1),
    "jamba-1.5-large-398b": ArchSpec(JAMBA_15_LARGE, _smoke(JAMBA_15_LARGE), 8),
}


def shape_applicable(arch: str, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason string."""
    cfg = ARCHS[arch].config
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return ("pure full-attention arch: 500k-token decode needs "
                "sub-quadratic attention (skip per task spec)")
    return None


def cells(include_skipped=False):
    """All (arch, shape) dry-run cells."""
    out = []
    for arch in ARCHS:
        for shape in ALL_SHAPES.values():
            reason = shape_applicable(arch, shape)
            if reason is None or include_skipped:
                out.append((arch, shape, reason))
    return out
