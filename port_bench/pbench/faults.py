"""Faults a served cell can have, planted in the port's decode path from
outside: the timed path broken underneath a whole run, to see the
comparison decide ``correct`` false.  Each planter takes the
continuum after the harness instrumented it (``bench.run_cell``'s
``fault``).  The exchange between cards is not among them: every cell
runs on one card.

    with faults.planted("state") as plant:
        bench.run_cell(cell, seed, seconds, False, fault=plant)
"""

from __future__ import annotations

import contextlib


def token_altered(cc) -> None:
    """One token a decode step changed where it is produced, in each
    tier's rows in turn, so that every request in flight carries some."""
    for tier in cc.tiers:
        ep = tier.endpoints["fn"]
        turn = [0]

        def decode_all(tokens_by_slot, _fn=ep.decode_all, _ep=ep, _turn=turn):
            out = _fn(tokens_by_slot)
            if out:
                s = sorted(out)[_turn[0] % len(out)]
                _turn[0] += 1
                out[s] = (out[s] + 1) % _ep.cfg.vocab_size
            return out
        ep.decode_all = decode_all


def half_batch(cc) -> None:
    """A decode step that computes the first half of its rows; the rest
    repeat their last token."""
    for tier in cc.tiers:
        ep = tier.endpoints["fn"]

        def decode_all(tokens_by_slot, _fn=ep.decode_all, _ep=ep):
            slots = sorted(tokens_by_slot)
            keep = slots[:max(1, len(slots) // 2)]
            out = _fn({s: tokens_by_slot[s] for s in keep})
            for s in slots[len(keep):]:
                out[s] = tokens_by_slot[s]
                _ep.slot_pos[s] += 1
            return out
        ep.decode_all = decode_all


def state_unchanged(cc) -> None:
    """A decode step that returns its state unchanged: the cache's keys
    and values never written, and each row's position not advanced."""
    from repro_torch.models import transformer
    write = transformer._cache_write

    def no_decode_write(cache, k, v, positions, rows=None):
        if positions.shape[1] == 1:
            return None
        return write(cache, k, v, positions, rows)

    transformer._cache_write = no_decode_write
    for tier in cc.tiers:
        ep = tier.endpoints["fn"]

        def decode_all(tokens_by_slot, _fn=ep.decode_all, _ep=ep):
            pos = _ep.slot_pos.copy()
            out = _fn(tokens_by_slot)
            for s in tokens_by_slot:
                _ep.slot_pos[s] = pos[s]
            return out
        ep.decode_all = decode_all


PLANTERS = {"token": token_altered, "half_batch": half_batch,
            "state": state_unchanged}


@contextlib.contextmanager
def planted(name: str):
    """The planter of fault ``name``; what it patched in the port's
    modules is restored on exit."""
    from repro_torch.models import transformer
    saved = transformer._cache_write
    try:
        yield PLANTERS[name]
    finally:
        transformer._cache_write = saved
