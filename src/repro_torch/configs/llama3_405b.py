"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783].

At full width its bf16 weights are about 811 GB, ten H100s' worth: the
port prices it (``launch/tier_cost.py``) and serves its smoke model.
The smoke model's head_dim 8 is outside the kernels' head dims, so it
runs on the CPU only (on the card the attention launchers raise).
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "llama3-405b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        head_dim=128, d_ff=53248, vocab_size=128256,
        rope_theta=500_000.0, activation="swiglu", norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=256, activation="swiglu",
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
