"""qwen2.5-14b [dense] — GQA (40 query heads over 8 kv heads) with QKV
bias [hf:Qwen/Qwen2.5-14B]."""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=13824, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0, activation="swiglu",
        norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, qkv_bias=True, activation="swiglu",
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
