"""A configuration file's widths as the port's ``ModelConfig``, and the
weights the benchmark draws for it.

The file keeps the source's own keys (``hidden_size``,
``num_hidden_layers``, ...); :func:`model_config` maps them onto the
port's fields.  The weights are the benchmark's input: drawn here, on the
device, from the run's seed, in one ``normal_`` over one flat buffer
(then scaled leaf by leaf in place), in the type they are served in.
The port's parameter table gives only the keys and shapes it takes them
under.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_fields(conf: dict) -> dict:
    """The port's ``ModelConfig`` fields of a configuration file."""
    act = conf["hidden_act"]
    fields = dict(
        name=conf["name"], family=conf["family"],
        num_layers=int(conf["num_hidden_layers"]),
        d_model=int(conf["hidden_size"]),
        num_heads=int(conf["num_attention_heads"]),
        num_kv_heads=int(conf["num_key_value_heads"]),
        head_dim=int(conf["head_dim"]),
        d_ff=int(conf["intermediate_size"]),
        vocab_size=int(conf["vocab_size"]),
        qkv_bias=bool(conf["use_qkv_bias"]),
        rope_theta=float(conf["rope_theta"]),
        activation={"silu": "swiglu"}[act],
        norm_type=conf["norm_type"],
        norm_eps=float(conf["norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        param_dtype=DTYPES[conf["torch_dtype"]],
        compute_dtype=DTYPES[conf["torch_dtype"]])
    if conf["family"] == "moe":
        fields.update(
            num_experts=int(conf["num_experts"]),
            top_k=int(conf["num_experts_per_tok"]),
            moe_d_ff=int(conf["moe_intermediate_size"]),
            d_ff=int(conf["moe_intermediate_size"]),
            shared_d_ff=int(conf["shared_expert_intermediate_size"]),
            num_shared_experts=int(conf["num_shared_experts"]),
            capacity_factor=float(conf["capacity_factor"]))
    return fields


def model_config(conf: dict, **overrides):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(**{**model_fields(conf), **overrides})


def fan_in(key: str, shape, conf: dict) -> int:
    """The contraction length of a weight: what its rows are summed over
    (a stacked leaf's leading layer axis and an expert axis excluded)."""
    d = int(conf["hidden_size"])
    last = key.rsplit("/", 1)[-1]
    if key == "lm_head":
        return d
    per = shape[1:] if key.startswith("layers/") else shape
    if "experts/" in key:
        per = per[1:]
    if last == "wo":                   # down projections: all but d_out
        return int(math.prod(per[:-1]))
    return int(per[0])                 # wq/wk/wv/wi/wg/router/gate: d


def draw_weights(cfg, conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights under the port's keys and shapes, on ``device``:

    * matrices ~ N(0, 1/fan_in), the embedding ~ N(0, 1);
    * norm scales 1 + 0.1 N(0, 1), norm and q/k/v biases 0.1 N(0, 1)
      (not the port's ones and zeros, so the comparison sees them).

    One generator on the device, one ``normal_`` over a flat buffer of
    every parameter, then one in-place scale per leaf."""
    from repro_torch.models import model_zoo
    table = model_zoo.param_table(cfg)
    dtype = cfg.param_dtype
    keys = sorted(table)
    sizes = [int(math.prod(table[k].shape)) for k in keys]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    params, at = {}, 0
    for k, n in zip(keys, sizes):
        leaf = flat[at:at + n].view(table[k].shape)
        at += n
        last = k.rsplit("/", 1)[-1]
        if last == "scale":
            leaf.mul_(0.1).add_(1.0)
        elif last in ("bias", "bq", "bk", "bv"):
            leaf.mul_(0.1)
        elif k != "embed":
            leaf.mul_(1.0 / math.sqrt(fan_in(k, table[k].shape, conf)))
        params[k] = leaf
    return params
