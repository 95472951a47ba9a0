"""internvl2-1b [vlm] — Qwen2-0.5B LM backbone + InternViT stub
[arXiv:2404.16821].  As in the reference the vision tower is a stub:
``prefill`` takes precomputed patch embeddings (B, P, d) under
``"patches"`` and puts them in front of the token stream; the serving
engine passes tokens only."""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "internvl2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151655,
        qkv_bias=True, rope_theta=1_000_000.0, activation="swiglu",
        norm_type="rmsnorm", frontend="vision", num_patches=256,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, qkv_bias=True, frontend="vision",
        num_patches=8,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
