"""stablelm-1.6b [dense] — MHA (kv=heads), LayerNorm [hf:stabilityai/stablelm-2-1_6b].

Same adaptation as the reference config: full rotary instead of
StableLM-2's 25% partial rotary (no effect on systems behaviour).
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100352,
        rope_theta=10_000.0, activation="swiglu", norm_type="layernorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, activation="swiglu", norm_type="layernorm",
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
