"""hymba-1.5b [hybrid] — parallel attention + SSM heads [arXiv:2411.13676].

Sliding-window attention everywhere except the first, middle and last
layers (the paper's layout).  Meta tokens are out of scope, as in the
reference config.  The layers' KV caches differ in width (rolling on the
window layers, ``max_len`` on the global ones), so the cache keeps one
stack per width (``models/transformer.init_cache``).
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hymba",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_expand=2, ssm_conv=4,
        sliding_window=1024, global_layers=(0, 15, 31),
        rope_theta=10_000.0, activation="swiglu", norm_type="rmsnorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="hymba",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=4, ssm_expand=2, ssm_conv=4,
        sliding_window=16, global_layers=(1,),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        ce_chunk=16)
