"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

46.7 B parameters, 93.4 GB in bf16: more than one 80 GB card holds, so
the port serves it at smoke width only.  Its 4096-token window makes
every cache a rolling row of ``min(max_len, 4096)`` positions per slot;
a paged tier raises (the reference keeps rolling-window rows per slot).
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, moe_d_ff=14336, vocab_size=32000,
        num_experts=8, num_shared_experts=0, top_k=2,
        sliding_window=4096, rope_theta=1_000_000.0, activation="swiglu",
        norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, moe_d_ff=96, vocab_size=256, num_experts=4, top_k=2,
        sliding_window=16,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
