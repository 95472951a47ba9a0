"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, moe_d_ff=1408, vocab_size=151936,
        num_experts=60, num_shared_experts=4, top_k=4, shared_d_ff=5632,
        qkv_bias=True, rope_theta=1_000_000.0, activation="swiglu",
        norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, moe_d_ff=96, vocab_size=256, num_experts=8,
        num_shared_experts=2, top_k=2, shared_d_ff=192, qkv_bias=True,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
