"""How ``correct`` is decided for a served model: a sample of the requests
the window finished, drawn from the seed, with the longest in it and
both tiers in it where both served, run through the plain reference
(:mod:`pbench.reference`) teacher-forced over each prompt and its served
tokens.  A served token's gap is how far its reference logit lies below
the reference's best at that position (every served token is greedy);
a cell's limit file bounds the widest gap or the mean gap.  The control
(the reference in fp8, in the program's place) reads, at the same
positions, the gap of the token it puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from pbench import reference

#: the numbers a cell's limit file may bound, each by its own limit
COMPARED = ("max_logit_gap", "mean_logit_gap")


def sample(done: Sequence, served_by: Dict[int, str], seed: int,
           min_tokens: int) -> List:
    """The longest finished request (prompt and output), then requests
    drawn from the seed, alternating between the tiers that served them
    (the longest's tier last), until ``min_tokens`` served tokens are in
    the sample."""
    done = sorted(done, key=lambda s: s.plan.index)
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 63, 5])
    longest = max(done, key=lambda s: (len(s.req.tokens) + len(s.req.output),
                                       -s.plan.index))
    pools: Dict[str, list] = {}
    for s in done:
        if s is not longest:
            pools.setdefault(served_by.get(id(s.req.tokens), "?"), []).append(s)
    for pool in pools.values():
        rng.shuffle(pool)
    out, n = [longest], len(longest.req.output)
    first = served_by.get(id(longest.req.tokens), "?")
    names = sorted(pools, key=lambda t: (t == first, t))
    k = 0
    while n < min_tokens and any(pools.values()):
        pool = pools[names[k % len(names)]]
        k += 1
        if pool:
            s = pool.pop()
            out.append(s)
            n += len(s.req.output)
    return out


def _seqs(picked) -> list:
    seqs = []
    for s in picked:
        prompt = np.asarray(s.req.tokens, np.int64)
        out = np.asarray(s.req.output, np.int64)
        L = len(prompt)
        toks = np.concatenate([prompt, out[:-1]])
        seqs.append((toks, L, range(L - 1, L - 1 + len(out))))
    return seqs


def _stats(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The widest gap and the mean gap."""
    g = torch.cat(gaps)
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def served_gaps(conf: dict, params, picked, device) -> Dict[str, float]:
    """The gaps of the served tokens below the reference's best."""
    if not picked:
        return {name: float("nan") for name in COMPARED}
    ref = reference.logits_at(conf, params, _seqs(picked), device)
    gaps = []
    for lg, s in zip(ref, picked):
        out = torch.as_tensor(np.asarray(s.req.output, np.int64),
                              device=lg.device)
        gaps.append(lg.max(dim=-1).values - lg.gather(1, out[:, None])[:, 0])
    return _stats(gaps)


def control_gaps(conf: dict, params, picked, device,
                 quant: str) -> Dict[str, float]:
    """The gaps, below the reference's best, of the token the control (the
    reference in ``quant``, the cell's limit file's ``control``) puts
    first at each position of the same prompts and served tokens."""
    seqs = _seqs(picked)
    ref = reference.logits_at(conf, params, seqs, device)
    ctl = reference.logits_at(conf, params, seqs, device, quant=quant)
    gaps = []
    for r, c in zip(ref, ctl):
        top = c.argmax(dim=-1)
        gaps.append(r.max(dim=-1).values - r.gather(1, top[:, None])[:, 0])
    return _stats(gaps)


def well_formed(sent, vocab: int) -> int:
    """How many finished requests carry an output of the wrong length or
    with an id outside the vocabulary (a served answer that cannot be
    right whatever the logits)."""
    bad = 0
    for s in sent:
        if s.done:
            o = np.asarray(s.req.output)
            if (o.shape != (s.plan.max_new,) or o.min() < 0
                    or o.max() >= vocab):
                bad += 1
    return bad
