"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892].  64 heads of 64 on d 4096; the recurrent state is
O(1) in the context length (no KV cache), so a row holds the same bytes
at every position."""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="rwkv6",
        num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
        head_dim=64, rwkv_head_dim=64, d_ff=14336, vocab_size=65536,
        activation="swiglu", norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="rwkv6",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, rwkv_head_dim=16, d_ff=128, vocab_size=256,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
