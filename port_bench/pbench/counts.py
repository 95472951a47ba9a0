"""Operations and bytes from shapes: the yardstick of every roofline and
of ``mfu``, whatever implements the kernel.

A kernel's bytes count each input read once and each output written
once, at the live slots its inputs fill; its operations count what
these inputs need (a causal prefill's pairs, a decode row's live keys),
never the padding a program adds.  ``conf`` is a configuration file
(the source's keys); ``peaks`` is ``port_bench/peaks.json``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BYTES = {"bfloat16": 2, "float32": 4}
POS_BYTES = 4                     # int32 positions


def _dims(conf: dict) -> Tuple[int, int, int, int]:
    return (int(conf["num_attention_heads"]), int(conf["num_key_value_heads"]),
            int(conf["head_dim"]), BYTES[conf["torch_dtype"]])


def k1_counts(conf: dict, lengths: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one K1 launch (one layer's causal prefill)
    over prompts of ``lengths``: q, k, v read and o written once, both
    position vectors read once; 4 * D operations (QK^T and PV) per
    (query head, causal pair)."""
    Hq, Hkv, D, e = _dims(conf)
    flops = bytes_ = 0.0
    for L in lengths:
        flops += 4.0 * Hq * D * L * (L + 1) / 2
        bytes_ += L * (2 * Hq + 2 * Hkv) * D * e + 2 * L * POS_BYTES
    return flops, bytes_


def k2_counts(conf: dict, rows: int, max_len: int,
              live: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one K2 launch (one layer's decode step) over
    a ``rows`` x ``max_len`` cache of which the stepping rows hold ``live``
    keys each: q read and o written for every row, the cache's position
    vector read whole (the kernel reads it to find the live slots), k and
    v at the live slots; 4 * D operations per (query head, live key)."""
    Hq, Hkv, D, e = _dims(conf)
    n = float(sum(live))
    flops = 4.0 * Hq * D * n
    bytes_ = (2.0 * rows * Hq * D * e + rows * POS_BYTES
              + rows * max_len * POS_BYTES + 2.0 * n * Hkv * D * e)
    return flops, bytes_


def roofline_s(flops: float, bytes_: float, peaks: dict,
               dtype: str = "bfloat16") -> Tuple[float, str]:
    """The least time the chip could take, and which term bounds it."""
    t_ops = flops / float(peaks["flops_per_s"][dtype])
    t_mem = bytes_ / float(peaks["hbm_bytes_per_s"])
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def active_params(conf: dict) -> Dict[str, int]:
    """Parameters a token's forward pass multiplies by, from the widths:
    ``body`` (every layer's attention and FFN: for a MoE its router, its
    shared expert and ``num_experts_per_tok`` of its routed experts) and
    ``head`` (the output projection).  The embedding is a lookup, not a
    product, and norms and biases are not counted."""
    d, L = int(conf["hidden_size"]), int(conf["num_hidden_layers"])
    Hq, Hkv, D, _ = _dims(conf)
    attn = d * Hq * D * 2 + d * Hkv * D * 2
    if conf["family"] == "moe":
        F, Fs = int(conf["moe_intermediate_size"]), int(
            conf["shared_expert_intermediate_size"])
        ffn = (int(conf["num_experts_per_tok"]) * 3 * d * F + 3 * d * Fs
               + d * int(conf["num_experts"]) + d)
    else:
        ffn = 3 * d * int(conf["intermediate_size"])
    return {"body": L * (attn + ffn), "head": int(conf["vocab_size"]) * d}


def step_flops(conf: dict, prompt_lens: Iterable[int] = (),
               decode_live: Iterable[int] = ()) -> float:
    """Useful operations of served work: prefills of ``prompt_lens``
    (every prompt token through the body, the head at each prompt's last
    position) and decode rows whose caches hold ``decode_live`` keys each
    (one token through the body and the head), plus attention from the
    shapes (:func:`k1_counts`, :func:`k2_counts`)."""
    p = active_params(conf)
    L = int(conf["num_hidden_layers"])
    prompt_lens, decode_live = list(prompt_lens), list(decode_live)
    tokens = sum(prompt_lens) + len(decode_live)
    heads = len(prompt_lens) + len(decode_live)
    attn = L * (k1_counts(conf, prompt_lens)[0]
                + k2_counts(conf, 0, 0, decode_live)[0])
    return 2.0 * p["body"] * tokens + 2.0 * p["head"] * heads + attn
