"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

At full width its bf16 weights are about 680 GB: the port prices it
(``launch/tier_cost.py``) and serves its smoke model, on the card too
(head_dim 16).  The full model's head_dim 192 is outside the kernels'
head dims.
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "nemotron-4-340b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        head_dim=192, d_ff=73728, vocab_size=256_000,
        rope_theta=10_000.0, activation="relu2", norm_type="layernorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, activation="relu2", norm_type="layernorm",
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
