"""Shared model substrate: config, param tables, norms, rotary embeddings,
activations, the token embedding and the memory-safe cross-entropy.

The counterpart of ``repro/models/common.py``.  Parameters live in a flat
dict ``{path: tensor}`` under the reference's keys, and per-layer
parameters are stacked along a leading ``layers`` axis, so the reference's
parameters carry over unchanged (``repro_torch.bridge``).  The transformer
walks that axis with a Python loop instead of ``lax.scan``.

Mixed precision follows the reference: parameters are stored in
``cfg.param_dtype``, matmuls run in ``cfg.compute_dtype`` and reductions
(norms, softmax, logits) accumulate in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (the subset of the reference's config
    that the ported families read) with torch dtypes.

    The reference's XLA-path and sharding knobs (``attn_chunk``,
    ``q_chunk``, ``scan_layers``, ``scan_layers_train``, the ``opt_*``
    toggles, ``use_pallas`` and ``fsdp``) have no counterpart: the port
    loops over layers in Python, picks its kernels by the tensors'
    device and does not shard its training state."""

    name: str = "model"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024

    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()  # full-attention layers (hymba)
    attn_logit_softcap: Optional[float] = None

    # selective SSM (hymba)
    ssm_state: int = 0               # mamba N (hymba: 16)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv: int = 4                # depthwise conv width

    # RWKV6
    rwkv_head_dim: int = 64

    activation: str = "swiglu"       # swiglu | relu2 | gelu

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # routed-expert hidden size
    shared_d_ff: int = 0             # shared-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # modality frontend: a stub, as in the reference (precomputed patch
    # embeddings arrive as inputs; audio is token ids over the codebook)
    frontend: Optional[str] = None   # None | "vision" | "audio"
    num_patches: int = 256           # vision prefix length

    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    # training
    remat: bool = True               # recompute each layer in the backward
    # recompute groups of this many layers (each layer inside recomputed
    # again), where num_layers % remat_group == 0
    remat_group: int = 1
    ce_chunk: int = 512              # sequence chunk of the CE loss

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Total parameters (exact, from the spec table)."""
        from repro_torch.models import model_zoo
        return sum(int(math.prod(s.shape))
                   for s in model_zoo.param_table(self).values())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        from repro_torch.models import model_zoo
        total = 0
        for path, spec in model_zoo.param_table(self).items():
            n = int(math.prod(spec.shape))
            if "experts/" in path and self.num_experts > 0:
                n = n * self.top_k // self.num_experts
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declared parameter: shape, logical axis names and initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"             # normal | zeros | ones | const | uniform_pm
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"must have the same rank")


def stack_layers(table: Mapping[str, ParamSpec], num_layers: int,
                 prefix: str = "layers/") -> Dict[str, ParamSpec]:
    """Stack a single-layer table along a leading 'layers' axis."""
    return {prefix + k: ParamSpec((num_layers,) + s.shape,
                                  ("layers",) + s.axes, s.init, s.scale)
            for k, s in table.items()}


def _init_leaf(spec: ParamSpec, dtype: torch.dtype,
               generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "const":        # constant fill with value = scale
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=dev)
    if spec.init == "uniform_pm":   # uniform in [-scale, scale]
        u = torch.rand(spec.shape, generator=generator, device=dev,
                       dtype=torch.float32)
        return ((2.0 * u - 1.0) * spec.scale).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown initializer {spec.init!r}")
    # fan-in scaled normal over the per-layer shape (as the reference)
    shape = (spec.shape[1:] if spec.axes and spec.axes[0] == "layers"
             else spec.shape)
    fan_in = max(int(math.prod(shape[:-1])), 1)
    std = spec.scale / math.sqrt(fan_in)
    w = torch.randn(spec.shape, generator=generator, device=dev,
                    dtype=torch.float32)
    # in place: a full-width expert stack is 16.6 GB in float32
    return w.mul_(std).to(dtype)


def init_params(table: Mapping[str, ParamSpec], dtype: torch.dtype,
                generator: torch.Generator) -> Params:
    """Materialize a parameter dict from a spec table, deterministically
    from ``generator`` and on its device (so the full width initialises
    on the card).  Draws differ from ``jax.random``; tests that compare
    with the reference carry its parameters over with
    :func:`repro_torch.bridge.params_from_numpy` instead."""
    return {path: _init_leaf(spec, dtype, generator)
            for path, spec in sorted(table.items())}


def layer_slice(params: Params, prefix: str = "layers/"
                ) -> Tuple[Params, Params]:
    """Split params into (stacked per-layer, rest)."""
    stacked = {k[len(prefix):]: v for k, v in params.items()
               if k.startswith(prefix)}
    rest = {k: v for k, v in params.items() if not k.startswith(prefix)}
    return stacked, rest


# --------------------------------------------------------------------------
# Norms / activations / rotary
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in float32 (population variance, as the
    reference), cast back to x.dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(x.dtype)


def apply_norm(cfg: ModelConfig, params: Params, prefix: str,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params[prefix + "/scale"],
                          params[prefix + "/bias"], cfg.norm_eps)
    return rms_norm(x, params[prefix + "/scale"], cfg.norm_eps)


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Specs for one norm under a caller-supplied prefix."""
    d = cfg.d_model
    specs = {"scale": ParamSpec((d,), ("embed",), "ones")}
    if cfg.norm_type == "layernorm":
        specs["bias"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


def activate(cfg: ModelConfig, gate: torch.Tensor,
             up: Optional[torch.Tensor]) -> torch.Tensor:
    """MLP nonlinearity. swiglu: silu(gate)*up; relu2: relu(gate)^2
    (nemotron); gelu: the tanh approximation, ``jax.nn.gelu``'s default
    (torch's default is the erf form)."""
    if cfg.activation == "swiglu":
        if up is None:
            raise ValueError("swiglu activation requires the `up` "
                             "projection")
        return F.silu(gate) * up
    if cfg.activation == "relu2":
        r = F.relu(gate)
        return r * r
    if cfg.activation == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(cfg.activation)


def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-float base: a tensor built from ``theta`` on the card would
    # be a host-to-device copy, which waits for the stream on every call
    return 1.0 / torch.pow(float(theta), exps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (..., S, 1, D/2) float32, for positions (..., S).
    Every layer rotates by the same tables, so a forward pass builds them
    once."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Rotary position embedding over the full head dim.

    x: (..., S, H, D); positions: broadcastable to (..., S); ``tables``
    are :func:`rope_tables` of the same positions, when already built.
    """
    cos, sin = tables or rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Input embedding lookup.  ``F.embedding`` rather than indexing: its
    backward on the card sums each row's gradients in a fixed order (a
    sort, then a segmented sum), where indexing's accumulates with
    atomics, so a train step is repeatable."""
    return F.embedding(tokens, embed).to(compute_dtype)


# --------------------------------------------------------------------------
# Memory-safe cross-entropy (sequence-chunked; never keeps (B,S,V))
# --------------------------------------------------------------------------


def _chunk_xent(xc: torch.Tensor, w32: torch.Tensor,
                lc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (sum of masked token losses, token count), float32:
    xc (B,c,d), w32 (V,d) float32, lc (B,c) (negative = masked)."""
    logits = xc.float() @ w32.t()                             # (B,c,V)
    lse = torch.logsumexp(logits, dim=-1)                     # (B,c)
    # the reference contracts a one-hot of the label; every other term of
    # that sum is an exact zero, so a gather of the label's logit equals it
    correct = logits.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - correct) * mask).sum(), mask.sum()


def xent_sums(x: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token losses, token count) of ``x @ w_out.T``
    against ``labels``, float32 scalars: the terms that
    :func:`chunked_softmax_xent` divides, and that a sharded step sums
    over its data replicas before it divides.

    x: (B,S,d) final hidden states; w_out: (V,d); labels: (B,S), negative
    labels masked out; S is padded up to a multiple of ``chunk`` with
    label -1.  Each chunk's (B, chunk, V) float32 logits live only inside
    that chunk: under autograd the chunk runs under
    ``torch.utils.checkpoint``, so its backward recomputes them instead
    of keeping them."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:                             # masked labels: loss-neutral
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w32 = w_out.float()
    grad = torch.is_grad_enabled() and (x.requires_grad or w32.requires_grad)
    loss_sum = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S + pad, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if grad:
            part, n = torch.utils.checkpoint.checkpoint(
                _chunk_xent, xc, w32, lc, use_reentrant=False,
                preserve_rng_state=False)
        else:
            part, n = _chunk_xent(xc, w32, lc)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum, count


def chunked_softmax_xent(x: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy of ``x @ w_out.T`` against ``labels``
    (``repro/models/common.py:297-351``): (mean_loss, token_count),
    float32 scalars, from :func:`xent_sums`."""
    loss_sum, count = xent_sums(x, w_out, labels, chunk)
    return loss_sum / count.clamp_min(1.0), count
