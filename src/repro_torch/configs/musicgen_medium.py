"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  As in the reference the EnCodec frontend is a stub:
the interface is token ids over the 2048-entry codebook (a plain LM
backbone with gelu MLPs and LayerNorm)."""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048,
        rope_theta=10_000.0, activation="gelu", norm_type="layernorm",
        frontend="audio",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, activation="gelu", norm_type="layernorm",
        frontend="audio",
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
