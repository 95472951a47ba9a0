#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel), report the build time and, per
   instantiation, registers, spills, stack and shared memory, and for K1
   its tensor-core instructions (``HGMMA`` in ``cuobjdump -sass``); fails
   if K1 spills or a bfloat16 instantiation of K1 has no HGMMA;
3. parity on the card: each kernel against its plain PyTorch version, in
   bfloat16 (2e-2) and float32 (2e-5 abs / 2e-4 rel), at the main path's
   shapes and at ragged, windowed, soft-capped and grouped-query ones,
   hymba-1.5b's attention shapes among them (25 query heads over 5 kv
   heads, window 1024), and those of qwen2-moe-a2.7b (16/16 at head_dim
   128), qwen2.5-14b (40/8 at 128) and internvl2-1b (14/2 at 64) for K1
   at B=1 S=512 and K2 at B=16 T=1024 and the edge's B=2, and one shard of
   a tp-2 endpoint of qwen2.5-14b (20/4 at 128) and stablelm-1.6b (16/16
   at 64) at the same shapes (K2's cluster printed beside the unsharded
   launch's), K3 at B=16 with
   64 pages a row of 16 for qwen2-moe, and K3 at hymba's global layers
   (B=16, 128 pages a row of 16, 25/5 heads, D=64, no window); K1 also
   with kv positions out of
   slot order, with rows that see no key (exactly zero), with a
   5-token prompt and at stablelm-1.6b's training microbatch (B=4,
   S=T=2048, 32/32, D=64);
   K2 and K3 at shapes their launcher splits over clusters of 1, 2, 4
   and 8 blocks (the cluster size is printed); the paged kernel K3 over
   shuffled pages, and bitwise against K2 on the gathered view; the
   selective-SSM scan K5 at
   hymba-1.5b's width (I=3200, N=16; S = 1, 128, 512, 1024 and a
   strong-decay case) in float32 (1e-4 abs / 1e-4 rel); the WKV6 scan K4
   at rwkv6-7b's width (H=64, D=64; S = 1, 128, 512, B=4 S=256, a ragged
   3x77x5x64 and a strong-decay case) and at the reference's sweep shapes,
   in float32 (5e-4 abs / 5e-3 rel) and on bfloat16-rounded inputs
   (5e-2); at B=1 and every prompt length of the rwkv6 main path (64,
   100, 128, 256, 384, 512, 1024), under normal and the strongest decay;
   and scan(512) against scan(256) then scan(256);
4. the stablelm smoke model served on the card against the same model on
   the CPU through the plain versions (greedy ids must match, and the
   card's run must launch exactly the family's kernels);
4b. the same for the hymba smoke model (K1, K2 and K5 on the card), and
   for the hymba and nemotron-4-340b smoke models on paged endpoints
   whose claims register their prompts, the second prompt served again
   as an exact prefix hit (hymba: K1, K2, K3 and K5; nemotron: K1, K3);
4c. the same for the rwkv6 smoke model (K4 alone on the card);
4d. the same for the smoke models of qwen2-moe-a2.7b, mixtral-8x7b
   (window 16 over a 48-token context), qwen2.5-14b, internvl2-1b,
   musicgen-medium and nemotron-4-340b (K1 and K2), and for qwen2-moe on
   paged endpoints (K1 and K3); llama3-405b's smoke model (head_dim 8)
   must raise from the launcher on the card and launch nothing;
4e. the smoke models of stablelm-1.6b (tp 2 and 4) and qwen2.5-14b (tp 2)
   on tensor-parallel endpoints, the shards over ``forced_devices(tp)`` on
   the one card, through phase 4's schedule: the ids must equal the same
   model's unsharded endpoint on the card, every shard launch K1 and K2
   and nothing else run; qwen2.5's smoke model at tp 4 (2 kv heads) must
   raise ``validate_tp``'s ValueError before any launch;
4f. training at smoke width: every smoke config but llama3-405b's (whose
   train step must raise from the launcher at head_dim 8) takes 3 train
   steps (accum 2, int8 error-feedback compression, the reference smoke
   test's optimizer) on the card and on the CPU from the same parameters
   and batches: each step's loss and grad_norm within 2e-5 abs / 2e-4
   rel, the updated params, moments and error buffer within 2 x lr x 3
   with 99.9 % of each within 1e-6, K1 (attention layers), K4 (rwkv6) and K5 (hymba) launched layers
   x microbatches x 2 (remat) times a step, nothing else; then the
   reference's resume test on the card (smoke stablelm, 12 steps,
   preempted at 7, resumed from step 5): every resumed loss within rtol
   1e-6 of the uninterrupted run's;
4g. sharded training at smoke width, single-controller over a (2, 2)
   mesh of ``forced_devices(4)`` on the one card: the int8 ring
   (``ring_allreduce_int8``, 4 members) and ``allreduce_compressed`` on
   the card bit for bit the CPU's, the ring the int32 sum; the smoke
   stablelm, hymba and qwen2-moe configs take 2 sharded steps (accum 2,
   int8 compression, 4f's optimizer) on the card and on the CPU from
   one state, each step from the card's: loss and grad_norm within 2e-5
   abs / 2e-4 rel, the joined state within 4f's gate, K1 (and hymba's
   K5) launched layers x microbatches x 2 replicas x 2 (remat) times a
   step; stablelm's sharded state saved and restored onto a (4, 1) mesh
   bit for bit;
4h. the serve step over a mesh at smoke width
   (``serving/engine.make_serve_step(..., mesh=)``, single-controller over
   a (2, 2) mesh of ``forced_devices(4)`` on the one card): the smoke
   stablelm, hymba, rwkv6 and qwen2-moe configs prefill 4 prompts of 64
   tokens into a 128-position cache and decode 8 greedy steps; the ids
   must equal the same step's over a (2, 2) CPU mesh and the unsharded
   step's on the card, the logits within 2e-2, and the mesh run launch
   each family kernel (K1, K2; hymba K5, rwkv6 K4) twice as often as the
   unsharded run (once a data replica) and no plain version;
5. the dense main path: full-width stablelm-1.6b (bf16, seeded random
   weights drawn on the card) served by ``repro_torch.platform.Continuum``
   over a 2-tier edge -> cloud continuum (edge 2 slots, cloud 16,
   max_len 1024, policy auto), 49 requests with prompts of 64..512 tokens
   and 32 new tokens each, ramped over the rounds, then drained.  Fails
   unless every request is served with 32 tokens, K1's and K2's launch
   counts are > 0 and the plain versions' are 0;
5b. paged == dense: a dense and a paged endpoint (page 16, no prefix
   cache) over the same weights, 16 slots, driven through one fixed
   admit / decode / retire schedule of 24 requests; the token ids must
   agree at every step;
5c. the paged main path: the continuum over two paged tiers (edge 8 slots
   in 128 pages = the KV bytes of 2 dense rows, cloud 16 slots in 1024
   pages), 48 requests, three in four drawn by Zipf(1.1) popularity from
   4 function prompts (prefix hits, copy-on-write forks).  Fails unless
   every request is served with 32 tokens, K3 (and K1) launched and no
   plain version did, some tier hit its prefix registry, and every pool
   drains balanced, holding only registry-pinned pages;
5d. the hymba main path: full-width hymba-1.5b (bf16, 1.97 B parameters,
   seeded random weights drawn on the card) served by the continuum over
   edge 2 slots and cloud 16 (max_len 2048, policy auto), 16 requests of
   32 new tokens ramped over 5 rounds, prompts of 64..512 tokens (the
   lengths the SSM scan's rule admits) and three of 1024, whose 29
   sliding-window layers wrap their 1024-wide rolling caches while the 3
   global layers do not.  Fails unless every request is served with 32
   tokens, K1, K2 and K5 launched (K5 once a layer a prefill call) and no
   plain version did; then times one cloud endpoint's 512-token prefill
   and 16-row decode step, with the device's busy share of each and its
   time by kernel;
5e. the rwkv6 main path, shared with 5d: full-width rwkv6-7b (bf16, 7.58
   B parameters, seeded random weights drawn on the card) served the same
   way, the same prompt lengths.  Fails unless every request is served
   with 32 tokens, K4 launched once a layer a prefill call and no other
   kernel or plain version did, and a row's bytes (34,078,720: the WKV
   state and two token shifts of 32 layers) do not grow with its
   position; then the same prefill and decode-step times.  Both
   prefill breakdowns also print the scan kernel's own share (K5, K4);
5f. (run after 5c, on phase 5's weights, shared by every tier) the
   three-tier chain: full-width stablelm-1.6b served by
   ``Continuum.from_topology`` over a device -> edge -> cloud chain with waterfall spill (device 2 dense
   slots, depth 4; edge 8 slots paged in 128 pages of 16, depth 8; cloud
   16 dense slots, unbounded; links 5 ms / 50 MB/s and 40 ms / 100 MB/s),
   policy ``"auto+net"`` with ``req_bytes`` 6.0e6, arrivals from
   ``Trace.bursty(0.5, 8.0, 30.0, mean_on_s=5, mean_off_s=10, seed=0)``
   (68 requests, prompts of 64..512 tokens, 32 new tokens) through
   ``trace=``, ticked to its end and drained.  Fails unless served +
   rejected == submitted with every served request holding 32 tokens,
   K1, K2 and K3 launched and nothing else did, and the simulator's
   control loop over the same chain (``ContinuumSimulator("matmult",
   "auto+net", ...).control``) replays the recorded controller inputs to
   the live R_t exactly (``np.array_equal``).  Prints served per tier,
   rejected, spilled, link MB, R_t per boundary per tick, the ticks the
   net-aware cap bound on, ``controller_update``'s host time (median and
   p95), tokens/s and one decode step per tier (wall, device time, busy
   share);
5h. (run after 5f on phase 5's weights, and after 5d on its hymba
   weights) the live controls: a request migrated mid-stream must give
   the ids of the same request unmigrated, at every step.  Each case
   serves one 512-token prompt (32 new tokens) alone, then again beside
   a keeper (256 tokens, 18 new) on a two-tier edge -> cloud pair of one
   shape over a 40 ms / 100 MB/s link, where it migrates after 8 decode
   steps (``max_steps_per_tick=8``, a static split of 50 whose arrivals
   stay at the edge and whose migrate threshold drops to 50): (a)
   stablelm dense -> dense, 16 slots, max_len 1024 (K1, K2; the landing
   crosses a tick); (b) stablelm paged -> paged, page 16, 8 slots in 128
   pages (K1, K3; the row ships its filled pages only); (c) hymba dense
   -> dense, 16 slots, max_len 2048 (K1, K5, K2; window KV, global KV and
   SSM state); (e), after 5e on its weights, rwkv6 dense -> dense, 16
   slots, max_len 2048 (K4 prefill; the row is the WKV state and token
   shifts, 34,078,720 B at every position).  Fails unless the ids agree
   at every step, one migration completed and the link carried the
   row's cache bytes + 4 B a token.
   (d) phase 5f's chain with the edge and the cloud paged under
   ``"auto+net+hedge+migrate"`` with ``max_steps_per_tick=4``, 5f's
   trace, a brownout of link 0 and an edge outage while it holds
   residents, hedges seeded by short ingress latencies: fails unless
   served + failed == submitted, the hedge and migration identities
   hold after every tick, faults applied >= 2, replayed >= 1, and K1, K2
   and K3 launched.  The ``kernels`` rows carry ``launches_5h``;
5i. (run after 5f, on its weights) phase 5f's chain again with
   ``eq1="sketch"``: the controller reads Eq (1) from decayed log-bucket
   histograms fed each scrape's fresh samples.  The same checks as 5f
   (conservation, K1-K3 launched and nothing else, sim R_t == live R_t
   on every scrape, the recorded ``step_stream`` inputs replayed through
   the simulator's sketch loop over the chain); prints its served per
   tier, rejected, final R_t, tokens/s and ``controller_update`` host
   time beside 5f's (no per-tier decode step: 5f times those), then the
   sketch tick alone on the host at F = 1024 and 4096 (one boundary,
   window 64, F samples a tick) beside the window tick.  The K1-K3 rows
   carry ``launches_5i``;
5j. (after 5e, its weights freed) the MoE main path: full-width
   qwen2-moe-a2.7b (bf16, 14.3 B parameters, seeded random weights drawn
   on the card): (a) phase 5's 2-tier continuum (edge 2 slots, cloud 16,
   max_len 1024, auto), 24 requests of 32 new tokens, prompts of 64, 128,
   256, 384 and 512 tokens; (c) its cloud endpoint's 512-token prefill
   and 16-row decode step, wall, device time, busy share and device time
   by category (attention kernels, routed expert products, shared
   experts, routing / dispatch / combine glue, the rest); (b) 5b's paged
   == dense schedule.  Fails unless every request is served with 32
   tokens, K1 and K2 launched (K3 in (b)) and nothing else did, and the
   paged ids equal the dense ones at every step;
5k. (after 5j, its weights freed) full-width qwen2.5-14b (bf16, 14.8 B
   parameters): 16 requests through 5j's continuum, the same checks and
   cloud endpoint times;
5l. (after 5d and 5h (c), on 5d's weights) full-width hymba-1.5b on a
   paged tier: its 3 global layers' KV in the page pool (K3), its 29
   window layers' rolling rows and its SSM state per slot (K2).  (a)
   5b's paged == dense schedule at max_len 2048, 24 prompts of 64..512
   tokens and two of 1024 (the window rows wrap): the ids must agree at
   every step, K1, K2, K3 and K5 launch and nothing else, and every
   paged step launches K3 3 times and K2 29 times; (b) 5d's 2-tier
   continuum with both tiers paged (page 16), 16 requests, three in four
   drawn by Zipf(1.1) from 4 function prompts: every request served with
   32 tokens, a prefix hit on some tier, the pools drained to their
   registries; (c) 5h's case on two paged tiers of 16 slots: the migrated
   ids equal the unmigrated ones, and the link carries the row's
   ``PagedRow`` bytes (filled pages, window rows, SSM state) + 4 B a
   token.  The ``kernels`` rows carry ``launches_5l``;
5m. (after 5h, on phase 5's weights) the cost-priced chain
   ``Topology.device_edge_cloud(cost_model=True, max_len=1024)``
   resolved on the H100 SXM5 record: each tier's priced slots,
   ``decode_step_ms``, rate, dominant roofline term and per-device bytes
   are printed; full-width stablelm-1.6b serves it through
   ``Continuum.from_topology`` with 5f's trace, ``"auto+net"`` and links,
   the edge's (1, 2) and the cloud's (16, 16) meshes deployed unsharded
   on the one card with the reference's warning.  Fails unless served +
   rejected == submitted, K1 and K2 launched and nothing else did, and
   sim R_t == live R_t on every scrape; then prints the device tier's
   decode step device time at its priced slot count beside the priced
   ``decode_step_ms``.  The K1-K3 rows carry ``launches_5m``;
5n. tensor parallelism on the one card (shards over ``forced_devices(2)``).
   (a) (after 5k, on its weights) full-width qwen2.5-14b at tp 2: 16
   slots, max_len 1024, 16 prompts of 64..512 tokens, 32 new tokens; the
   unsharded endpoint runs greedily (ids, every step's logits and every
   decode layer's residual stream kept), then, as a control, one more
   decode step from the same cache with K2 and with K2's plain version;
   it is dropped, and the sharded endpoint is fed the same prompts and,
   at every decode step, the unsharded ids (teacher forcing): once as
   it is, once with every decode layer reading the unsharded stream
   (forced layer by layer), once free-running.  Fails unless, forced
   layer by layer, every layer's residual update and every step's logits
   lie within 2e-2 of the unsharded ones in relative L2, each shard
   launched K1 and K2 and nothing else ran; prints the token-forced
   errors beside the control's, the near ties (unsharded top-2 gap under
   2e-2 times the row's largest logit) and how many changed argmax, the
   free-running agreement of the two greedy streams, the bytes gathered
   a step, and both decode steps (wall, device time) beside 5k's.  (b) (after 5m, on phase 5's weights) 5m's
   chain again: the edge's (1, 2) mesh deploys as two shards, the
   cloud's (16, 16) unsharded with the warning; 5m's checks, and both
   edge shards must launch K1 and K2; prints the share of requests whose
   ids equal 5m's.  The K1 and K2 rows carry ``launches_5n_b``;
5o. (last, alone on the card) full-width stablelm-1.6b trains 6 steps
   through ``launch/train.py``'s ``main`` (batch 8 of 2048 tokens,
   accum 2 as ``train_preset`` gives, bf16 weights seeded on the card):
   every loss finite, the first in (1, 20), the last below it, K1 96
   launches a step (24 layers x 2 microbatches x 2) and no plain
   version; a control recomputes step 1 with every attention forward
   through the plain version (grad_norm within 2e-3 relative, the
   kernel check; loss within 2e-2, a sanity check only: at random init
   it is about ln V whatever attention computes).
   Prints the median step wall of steps 2-6, one more step's device time
   by category (K1, the attention VJP, GEMMs, CE, optimizer, rest; the
   profiler), tokens/s, the peak memory beside its reckoning and 6 N
   tokens / step time as a share of the dense-bf16 peak;
5p. (after 5o, alone on the card) full-width stablelm-1.6b, 2 steps of
   5o's batches (8 x 2048 tokens, accum 2, remat) through the unsharded
   step and, as a control, at accum 4 (bf16 gradients of two rows
   summed, as the sharded step's replicas give them), then, the states
   kept on the host and the card freed, through the sharded step over a
   (2, 2) mesh on the one card from the same initial state: loss and
   grad_norm within 2e-3 relative, the joined mu and nu within 4f's
   gate, the bf16 params within 4f's largest |d| and with no more than
   twice the control's share moved by more than 1e-6, K1 192 launches a
   step (24 layers x 2 microbatches x 2 replicas x 2); prints the step
   walls, the first step's device time by category (the profiler; the
   second step's wall runs without it), the bytes the gathers and
   reductions would move on a real mesh, and the peak memory;
5q. (after 5g, on phase 5's weights) full-width stablelm-1.6b through
   the serve step over a (2, 2) mesh of ``forced_devices(4)`` on the
   card against the unsharded step: a prefill of 4 x 2048 tokens, then
   8 decode steps of 16 rows over a 2048-position cache (6.4 GB) filled
   by the unsharded step with 2040-token prompts, both fed the unsharded
   ids.  Fails unless the logits and cache entries equal bit for bit a
   control, the unsharded step run on each data replica's rows alone, the
   ids equal the unsharded step's on the whole batch but at near ties
   (the batch's shape reorders bf16 sums), the bytes each mesh step
   joined and
   wrote back equal ``launch/serve_cost.serve_step_counts``' collective
   bytes for that (2, 2) shape term by term, and K1 launched 48 and K2
   384 times (24 layers x 2 replicas, x 8 steps) and no plain version;
   prints the logits' relative L2 to the whole batch's beside the
   control's, the walls, a prefill's and a decode step's device time
   both ways and the peak memory.  The kernels rows carry
   ``launches_4h`` and ``launches_5q``;
5g. the paper's four FaaS bodies (matmult n=256, image_proc 128,
   random_io 2^16, mixed 128) on the card, each against its CPU run on
   the same drawn tensors (1e-4 abs / 1e-4 rel), timed with CUDA events;
   then ``Continuum.sweep("matmult")`` on the host over 0, 25, 50, 75,
   100, ``"auto"`` and ``"auto+net"``, printing successes / failures;
6. timing of each kernel at the server's shapes (median over CUDA events,
   L2 flushed between launches) beside its bound, its plain version and a
   yardstick of PyTorch library calls (the port never calls them), printed
   as one ``{"kernels": [...]}`` line (K1 and K2 at stablelm's shapes, K3
   at the paged tier's, K4 at rwkv6's, K5 at hymba's, and K3 again at
   hymba's paged global layers with its launches from 5l, and K1 and K2
   at a qwen2.5-14b tp-2 shard's shapes with their launches from 5n (a),
   and K1 at stablelm-1.6b's training microbatch with its launches from
   5o, ``"case"`` naming each; the main-path rows also carry their
   launches in 4f, ``launches_4f``, and every row its launches in 4g
   and 5p, ``launches_4g`` and ``launches_5p``).  Each row also
   gives the kernel's and the library call's time on the device alone
   (``device_ms``, ``library_device_ms``: the card kept busy while the
   host enqueues) and the host's time to enqueue the kernel
   (``host_ms``); K2 and K3 rows carry the cluster size their launcher
   ran with.  K1, K2 and K5 are also timed at hymba's
   shapes, K4 at every (B, S) phase 5e launched it at (each row with its
   launches there; a line sums launches x device time over phase 5e, and
   the shapes and launches are left in ``build/rwkv6_main_path_k4.json``),
   and K1 at the smaller prefill
   buckets phase 5 launched and K2 at the edge's B = 2, and K1, K2 and K3
   at qwen2-moe's shapes (K2 also at its edge's B = 2; launches from 5j)
   and K1 and K2 at qwen2.5-14b's (launches from 5k), on lines of their
   own.

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the package beside this script, it prints no result and exits
non-zero.

    python3 chip_smoke.py --baseline DIR

instead builds the kernel sources ``DIR`` holds (an earlier revision's,
say from ``git show``): ``flash_attention.cu`` and ``decode_attention.cu``
(K1 and K2/K3), ``rwkv6_scan.cu`` (K4), beside this checkout's, and
times both in one process at the main path's shapes, in the order
baseline, new, new, baseline (events, device alone and host time, as in
phase 6; the host time of both through direct ctypes calls, and the
port's launcher's besides), after checking both against the plain
versions (float32 K1 and the unsplit K2/K3 must also be bitwise equal to
the baseline's; for K4 whether y and s_final are is printed).  K4 is
timed at every main-path prompt length and at the shapes the last phase
6 in this checkout recorded (the file's path and time are printed),
whose launches weigh a sum of device time for both; with
``nvidia-smi``'s SM clock and power draw sampled beside each shape.  It
prints ``[ab]`` lines and no result line.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# phase 6 leaves the (B, S, H, D) -> launches of K4 on the rwkv6 main path
# here, for ``--baseline`` to weigh both revisions' times by (git-ignored)
MAIN_PATH_K4 = ROOT / "build" / "rwkv6_main_path_k4.json"

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=2e-5, rtol=2e-4)}
# the reference's WKV6 tolerance (tests/test_kernels.py:137-138)
RWKV_TOL = {"bfloat16": dict(atol=5e-2, rtol=5e-2),
            "float32": dict(atol=5e-4, rtol=5e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _demangle(names: list, bindir: Path) -> dict:
    """Mangled -> short readable kernel names (``cu++filt`` of the CUDA
    toolkit; the return type, the anonymous namespace and the parameter
    list dropped)."""
    try:
        out = subprocess.run([str(bindir / "cu++filt")], input="\n".join(
            names), capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}

    def short(d: str) -> str:
        d = d.replace("(anonymous namespace)::", "").replace("<unnamed>::",
                                                             "")
        d = d.removeprefix("void ")
        depth = 0
        for i in range(len(d) - 1, -1, -1):      # the last "(...)" group
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if d[i] == "(" and depth == 0:
                return d[:i]
        return d

    return {n: short(d) for n, d in zip(names, out)}


def _sass_counts(lib: Path, bindir: Path, op: str) -> dict:
    """Mangled kernel name -> count of ``op`` instructions in its SASS."""
    text = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and op in line:
            counts[cur] += 1
    return counts


def build_kernels() -> float:
    """Phase 2: build every source; print, per instantiation, registers,
    spills, stack and shared memory (ptxas) and, for K1, its tensor-core
    instructions (``HGMMA`` in the SASS).  Fails if K1 spills or a bf16
    instantiation of K1 has no HGMMA."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    bindir = Path(_build.nvcc_path()).parent
    for name, path in paths.items():
        report = path.with_suffix(".log").read_text()
        blocks = report.split("Compiling entry function '")[1:]
        mangled = [b.split("'", 1)[0] for b in blocks]
        short = _demangle(mangled, bindir)
        hgmma = (_sass_counts(path, bindir, "HGMMA")
                 if name == "flash_attention" else {})
        for mname, block in zip(mangled, blocks):
            num = {key: int(m.group(1)) if m else 0 for key, m in (
                (key, re.search(pat, block)) for key, pat in (
                    ("registers", r"Used (\d+) registers"),
                    ("stack", r"(\d+) bytes stack frame"),
                    ("smem", r"(\d+) bytes smem")))}
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                    block))
            extra = (f", HGMMA {hgmma.get(mname, 0)}"
                     if name == "flash_attention" else "")
            log(f"[build] {name} {short[mname]}: registers "
                f"{num['registers']}, spill bytes {spill}, stack "
                f"{num['stack']}, static smem {num['smem']}{extra}")
            if name == "flash_attention" and (spill or (
                    "flash_fwd_tc" in short[mname]
                    and not hgmma.get(mname))):
                raise RuntimeError(f"K1 {short[mname]}: spills {spill}, "
                                   f"HGMMA {hgmma.get(mname, 0)}")
        log(f"[build] {name}: {path.name}, {len(blocks)} instantiations")
    return secs


# ---------------------------------------------------------------- phase 3


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def prefill_inputs(B, S, T, Hq, Hkv, D, dtype, gen):
    """q/k/v and positions of a prefill: queries are the last S of T
    ordered positions (S == T is plain causal prefill)."""
    import torch
    q = _rand((B, S, Hq, D), dtype, gen)
    k = _rand((B, T, Hkv, D), dtype, gen)
    v = _rand((B, T, Hkv, D), dtype, gen)
    kp = torch.arange(T, dtype=torch.int32, device="cuda")[None].expand(
        B, T).contiguous()
    qp = kp[:, T - S:].contiguous()
    return q, k, v, qp, kp


def decode_inputs(B, T, Hq, Hkv, D, dtype, gen, fill=None):
    """q, a rolling cache k/v and positions: row b holds ``n_b`` tokens at
    unordered slots (pos % T after wrapping), the rest empty (pos -1); a
    few rows have wrapped, one row is empty (all masked -> zeros)."""
    import torch
    q = _rand((B, Hq, D), dtype, gen)
    k = _rand((B, T, Hkv, D), dtype, gen)
    v = _rand((B, T, Hkv, D), dtype, gen)
    kp = torch.full((B, T), -1, dtype=torch.int32)
    qp = torch.zeros(B, dtype=torch.int32)
    cpu = torch.Generator().manual_seed(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device="cuda").item()))
    for b in range(B):
        if fill is not None:
            n = int(fill[b])
            kp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
            continue
        if b == 0:
            continue                                   # an empty row
        n = int(torch.randint(1, 2 * T, (1,), generator=cpu))
        pos = torch.arange(max(0, n - T), n, dtype=torch.int32)
        kp[b, pos.long() % T] = pos                    # rolling, unordered
        qp[b] = n - 1 - int(torch.randint(0, 3, (1,), generator=cpu))
    return q, k, v, qp.cuda(), kp.cuda()


def _launched_split(name: str) -> tuple:
    """(cluster size, slots a block) that K2's or K3's launcher (``name``)
    ran its last launch with."""
    from repro_torch.kernels import decode_attention as kdec
    return kdec.last_split[name]


def check_close(name, got, want, dtype_name):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[dtype_name], msg=lambda m: f"{name}: {m}")
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    return err


def parity() -> None:
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [  # (label, B, S, T, Hq, Hkv, D, causal, window, softcap)
        ("main", 4, 512, 512, 32, 32, 64, True, None, None),
        ("ragged", 2, 200, 200, 32, 32, 64, True, None, None),
        ("ragged-suffix", 2, 40, 200, 8, 8, 64, True, None, None),
        ("window128", 2, 512, 512, 32, 32, 64, True, 128, None),
        ("softcap30", 2, 512, 512, 32, 32, 64, True, None, 30.0),
        ("gqa4", 2, 512, 512, 32, 8, 64, True, None, None),
        ("noncausal", 1, 100, 130, 4, 2, 64, False, None, None),
        ("d16", 2, 70, 70, 4, 2, 16, True, None, None),
        ("d32", 2, 70, 70, 4, 4, 32, True, 16, 20.0),
        ("d128", 2, 130, 130, 4, 1, 128, True, None, None),
        # hymba-1.5b: 25 query heads over 5 kv heads, window 1024 on 29
        # layers (it masks only past 1024 tokens), none on 3
        ("hymba-512", 2, 512, 512, 25, 5, 64, True, 1024, None),
        ("hymba-win1024", 1, 1280, 1280, 25, 5, 64, True, 1024, None),
        ("hymba-global", 1, 1024, 1024, 25, 5, 64, True, None, None),
        # qwen2-moe-a2.7b 16/16 and qwen2.5-14b 40/8 at head_dim 128,
        # internvl2-1b 14/2 (G = 7) at 64
        ("qwen2-moe", 1, 512, 512, 16, 16, 128, True, None, None),
        ("qwen2.5-g5", 1, 512, 512, 40, 8, 128, True, None, None),
        ("internvl2-g7", 1, 512, 512, 14, 2, 64, True, None, None),
        # one shard of a tensor-parallel endpoint at tp 2 (phase 5n):
        # qwen2.5-14b 20/4 at 128, stablelm-1.6b 16/16 at 64
        ("qwen2.5-tp2", 1, 512, 512, 20, 4, 128, True, None, None),
        ("stablelm-tp2", 1, 512, 512, 16, 16, 64, True, None, None),
        # stablelm-1.6b's training microbatch (phase 5o): 4 x 2048 tokens
        ("train", 4, 2048, 2048, 32, 32, 64, True, None, None),
    ]
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for label, B, S, T, Hq, Hkv, D, causal, win, cap in k1:
            q, k, v, qp, kp = prefill_inputs(B, S, T, Hq, Hkv, D, dt, gen)
            got = ops.flash_attention(q, k, v, qp, kp, causal=causal,
                                      window=win, softcap=cap)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, qp, kp, causal=causal,
                                       window=win, softcap=cap)
            err = check_close(f"K1 {label} {dname}", got, want, dname)
            log(f"[parity] K1 flash_attention {label:14s} {dname:8s} "
                f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                f"max_abs_err={err:.3e} ok")
        # kv positions out of slot order (some slots empty), and queries
        # that see no key at all (their rows must come out exactly zero)
        for label, B, S, Hq, Hkv, D in (("shuffled", 2, 300, 8, 2, 64),
                                         ("shuffled-d128", 1, 150, 4, 4, 128),
                                         ("masked-rows", 2, 200, 8, 8, 32),
                                         ("short", 1, 5, 32, 32, 64)):
            q, k, v, qp, kp = prefill_inputs(B, S, S, Hq, Hkv, D, dt, gen)
            if label.startswith("shuffled"):
                kp = torch.stack([r[torch.randperm(S, generator=gen,
                                                   device="cuda")]
                                  for r in kp])
                kp[:, ::7] = -1
            if label == "masked-rows":
                kp[:, :50] = -1
            got = ops.flash_attention(q, k, v, qp, kp)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, qp, kp)
            err = check_close(f"K1 {label} {dname}", got, want, dname)
            if label == "masked-rows" and got[:, :50].abs().max().item():
                raise RuntimeError(f"K1 {label} {dname}: rows that see no "
                                   f"key are not zero")
            log(f"[parity] K1 flash_attention {label:14s} {dname:8s} "
                f"B={B} S={S} T={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"max_abs_err={err:.3e} ok")
    k2 = [  # (label, B, T, Hq, Hkv, D, window, softcap)
        ("main", 16, 1024, 32, 32, 64, None, None),
        ("gqa4", 16, 1024, 32, 8, 64, None, None),
        ("gqa3", 4, 300, 12, 4, 64, None, None),
        ("gqa16", 2, 300, 32, 2, 64, None, None),
        ("window", 8, 512, 8, 8, 64, 100, None),
        ("softcap", 8, 512, 8, 8, 64, None, 30.0),
        ("d16", 4, 200, 4, 2, 16, None, None),
        ("d32", 4, 200, 4, 4, 32, None, None),
        ("d128", 4, 200, 8, 2, 128, None, None),
        # hymba-1.5b: rolling 1024-wide caches (window 1024), global 2048
        ("hymba-rolling", 16, 1024, 25, 5, 64, 1024, None),
        ("hymba-edge", 2, 1024, 25, 5, 64, 1024, None),
        ("hymba-global", 16, 2048, 25, 5, 64, None, None),
        ("cluster2", 16, 512, 10, 10, 64, None, None),
        ("edge", 2, 1024, 32, 32, 64, None, None),
        # the same three layouts at the cloud's B = 16 and the edge's B = 2
        ("qwen2-moe", 16, 1024, 16, 16, 128, None, None),
        ("qwen2.5-g5", 16, 1024, 40, 8, 128, None, None),
        ("internvl2-g7", 16, 1024, 14, 2, 64, None, None),
        ("qwen2-moe-edge", 2, 1024, 16, 16, 128, None, None),
        ("qwen2.5-edge", 2, 1024, 40, 8, 128, None, None),
        ("internvl2-edge", 2, 1024, 14, 2, 64, None, None),
        # a tp-2 shard's local heads (phase 5n), cloud and edge batches
        ("qwen2.5-tp2", 16, 1024, 20, 4, 128, None, None),
        ("qwen2.5-tp2-edge", 2, 1024, 20, 4, 128, None, None),
        ("stablelm-tp2", 16, 1024, 16, 16, 64, None, None),
        ("stablelm-tp2-edge", 2, 1024, 16, 16, 64, None, None),
    ]
    clusters = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for label, B, T, Hq, Hkv, D, win, cap in k2:
            q, k, v, qp, kp = decode_inputs(B, T, Hq, Hkv, D, dt, gen)
            got = ops.decode_attention(q, k, v, qp, kp, window=win,
                                       softcap=cap)
            C = clusters[label] = _launched_split("decode_attention")[0]
            torch.cuda.synchronize()
            want = ref.decode_attention(q, k, v, qp, kp, window=win,
                                        softcap=cap)
            err = check_close(f"K2 {label} {dname}", got, want, dname)
            if got[0].abs().max().item() != 0.0:
                raise RuntimeError(f"K2 {label} {dname}: the empty row is "
                                   f"not zero")
            log(f"[parity] K2 decode_attention {label:14s} {dname:8s} "
                f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                f"cluster={C} max_abs_err={err:.3e} ok")
    for shard, whole in (("qwen2.5-tp2", "qwen2.5-g5"),
                         ("qwen2.5-tp2-edge", "qwen2.5-edge"),
                         ("stablelm-tp2", "main"),
                         ("stablelm-tp2-edge", "edge")):
        log(f"[parity] K2 cluster of a tp-2 shard {shard}: "
            f"{clusters[shard]}, of the unsharded launch {whole}: "
            f"{clusters[whole]}")


def paged_inputs(B, ppr, page, Hq, Hkv, D, dtype, gen, fill=None):
    """q, a paged pool and its tables in the engine's layout: row b holds
    its last ``n_b`` tokens at slots pos % W (W = ppr*page; a wrapped row
    uses every page), its pages drawn from a random permutation of the
    pool (no row's pages are contiguous), short rows padded with the null
    page P (pos -1).  Without ``fill`` row 0 is empty and the rest are
    random; with it row b holds ``fill[b]`` tokens."""
    import torch
    W = ppr * page
    cpu = torch.Generator().manual_seed(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device="cuda").item()))
    if fill is None:
        ns = [0] + [int(torch.randint(1, 2 * W, (1,), generator=cpu))
                    for _ in range(B - 1)]
    else:
        ns = [int(n) for n in fill]
    used = [ppr if n > W else -(-n // page) for n in ns]
    P = sum(used) + 7                      # a few pages no table uses
    perm = torch.randperm(P, generator=cpu).tolist()
    tables = torch.full((B, ppr), P, dtype=torch.int32)
    kvp = torch.full((P + 1, page), -1, dtype=torch.int32)
    qp = torch.zeros(B, dtype=torch.int32)
    for b, (n, u) in enumerate(zip(ns, used)):
        tables[b, :u] = torch.tensor(perm[:u], dtype=torch.int32)
        perm = perm[u:]
        pos = torch.arange(max(0, n - W), n, dtype=torch.int32)
        slot = pos.long() % W
        kvp[tables[b, slot // page].long(), slot % page] = pos
        qp[b] = n - 1 if fill is not None else max(
            n - 1 - int(torch.randint(0, 3, (1,), generator=cpu)), 0)
    q = _rand((B, Hq, D), dtype, gen)
    k = _rand((P + 1, page, Hkv, D), dtype, gen)
    v = _rand((P + 1, page, Hkv, D), dtype, gen)
    return q, k, v, tables.cuda(), qp.cuda(), kvp.cuda()


def gathered(k_pages, v_pages, tables, kv_pos_pages):
    """The contiguous (B, ppr*page, ...) view a page table describes."""
    B, ppr = tables.shape
    page = k_pages.shape[1]
    idx = tables.long()
    return (k_pages[idx].reshape(B, ppr * page, *k_pages.shape[2:]),
            v_pages[idx].reshape(B, ppr * page, *v_pages.shape[2:]),
            kv_pos_pages[idx].reshape(B, ppr * page))


def parity_paged() -> None:
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    k3 = [  # (label, B, ppr, page, Hq, Hkv, D, window, softcap)
        ("main", 16, 64, 16, 32, 32, 64, None, None),
        ("gqa4", 16, 64, 16, 32, 8, 64, None, None),
        ("ragged", 5, 7, 16, 12, 4, 64, None, None),
        ("window", 8, 32, 16, 8, 8, 64, 100, None),
        ("softcap", 8, 32, 16, 8, 8, 64, None, 30.0),
        ("page8-d16", 4, 12, 8, 4, 2, 16, 37, 20.0),
        ("page32-d128", 4, 8, 32, 8, 2, 128, None, None),
        ("cluster2", 16, 32, 16, 10, 10, 64, None, None),
        ("hymba", 16, 64, 16, 25, 5, 64, 1024, None),
        ("edge", 2, 64, 16, 32, 32, 64, None, None),
        ("qwen2-moe", 16, 64, 16, 16, 16, 128, None, None),
        ("hymba-glob", 16, 128, 16, 25, 5, 64, None, None),
    ]
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for label, B, ppr, page, Hq, Hkv, D, win, cap in k3:
            q, k, v, tab, qp, kvp = paged_inputs(B, ppr, page, Hq, Hkv, D,
                                                 dt, gen)
            got = ops.paged_decode_attention(q, k, v, tab, qp, kvp,
                                             window=win, softcap=cap)
            C = _launched_split("paged_decode_attention")[0]
            torch.cuda.synchronize()
            want = ref.paged_decode_attention(q, k, v, tab, qp, kvp,
                                              window=win, softcap=cap)
            err = check_close(f"K3 {label} {dname}", got, want, dname)
            if got[0].abs().max().item() != 0.0:
                raise RuntimeError(f"K3 {label} {dname}: the empty row is "
                                   f"not zero")
            kd, vd, kpd = gathered(k, v, tab, kvp)
            dense = ops.decode_attention(q, kd.contiguous(), vd.contiguous(),
                                         qp, kpd.contiguous(), window=win,
                                         softcap=cap)
            if not torch.equal(got, dense):
                raise RuntimeError(f"K3 {label} {dname}: not bitwise equal "
                                   f"to K2 on the gathered view")
            log(f"[parity] K3 paged_decode_attention {label:11s} {dname:8s} "
                f"B={B} ppr={ppr} page={page} Hq={Hq} Hkv={Hkv} D={D} "
                f"cluster={C} max_abs_err={err:.3e} ok, == K2 on the "
                f"gathered view")


def ssd_inputs(B, S, I, N, gen, strong_decay=False):
    """a in (0, 1) (sigmoid of 2x a normal, or 0.01 everywhere: the regime
    where a cumprod closed form underflows), b and h0 normal, float32."""
    import torch
    a = (torch.full((B, S, I, N), 0.01, device="cuda") if strong_decay else
         torch.sigmoid(2.0 * _rand((B, S, I, N), torch.float32, gen)))
    b = 0.5 * _rand((B, S, I, N), torch.float32, gen)
    h0 = 0.2 * _rand((B, I, N), torch.float32, gen)
    return a, b, h0


def parity_ssd() -> None:
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    k5 = [  # (label, B, S, I, N, strong_decay): hymba-1.5b's I and N
        ("decode-like", 1, 1, 3200, 16, False),
        ("chunk", 1, 128, 3200, 16, False),
        ("main", 1, 512, 3200, 16, False),
        ("long", 1, 1024, 3200, 16, False),
        ("batch4", 4, 256, 3200, 16, False),
        ("strong-decay", 1, 512, 3200, 16, True),
        ("ragged", 3, 77, 40, 16, False),
    ]
    for label, B, S, I, N, strong in k5:
        a, b, h0 = ssd_inputs(B, S, I, N, gen, strong)
        hs, hf = ops.ssd_scan(a, b, h0)
        torch.cuda.synchronize()
        want_hs, want_hf = ref.ssd_scan(a, b, h0)
        errs = []
        for name, got, want in (("hs", hs, want_hs), ("h_final", hf, want_hf)):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"K5 {label} {name}: {m}")
            if not torch.isfinite(got).all():
                raise RuntimeError(f"K5 {label} {name}: non-finite output")
            errs.append((got - want).abs().max().item())
        bitwise = torch.equal(hs, want_hs) and torch.equal(hf, want_hf)
        log(f"[parity] K5 ssd_scan {label:12s} float32  B={B} S={S} I={I} "
            f"N={N} max_abs_err={max(errs):.3e} bitwise={bitwise} ok")


def rwkv_inputs(B, S, H, D, gen, bf16=False, strong_decay=False):
    """r, k, v normal (rounded through bfloat16 with ``bf16``, as the
    model's bf16 projections feed the scan, then float32), lw = -0.4
    |normal| (or -e^10, the clip's strongest decay), u = 0.3 normal, s0 =
    0.1 normal, float32."""
    import torch
    r, k, v = (_rand((B, S, H, D), torch.float32, gen) for _ in range(3))
    if bf16:
        r, k, v = (x.bfloat16().float() for x in (r, k, v))
    lw = (torch.full((B, S, H, D), -math.exp(10.0), device="cuda")
          if strong_decay else
          -0.4 * _rand((B, S, H, D), torch.float32, gen).abs())
    u = 0.3 * _rand((H, D), torch.float32, gen)
    s0 = 0.1 * _rand((B, H, D, D), torch.float32, gen)
    return r, k, v, lw, u, s0


def _rwkv_close(label, got, want, dname):
    """Max abs error of K4's (y, s_final) against the plain version's,
    raising outside the reference's tolerance."""
    import torch
    errs = []
    for name, g, w in zip(("y", "s_final"), got, want):
        torch.testing.assert_close(g, w, **RWKV_TOL[dname],
                                   msg=lambda m: f"K4 {label} {name}: {m}")
        if not torch.isfinite(g).all():
            raise RuntimeError(f"K4 {label} {name}: non-finite output")
        errs.append((g - w).abs().max().item())
    return max(errs)


def parity_rwkv() -> None:
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    k4 = [  # (label, B, S, H, D, strong_decay)
        ("sweep-d8", 1, 32, 2, 8, False),      # tests/test_kernels.py sweep
        ("sweep-d16", 2, 128, 4, 16, False),
        ("sweep-d64", 2, 64, 1, 64, False),
        ("decode-like", 1, 1, 64, 64, False),  # rwkv6-7b: H 64, D 64
        ("chunk", 1, 128, 64, 64, False),
        ("main", 1, 512, 64, 64, False),
        ("batch4", 4, 256, 64, 64, False),
        ("ragged", 3, 77, 5, 64, False),
        ("strong-decay", 1, 512, 64, 64, True),
    ]
    for dname in ("float32", "bfloat16"):
        for label, B, S, H, D, strong in k4:
            xs = rwkv_inputs(B, S, H, D, gen, dname == "bfloat16", strong)
            got = ops.rwkv6_scan(*xs)
            torch.cuda.synchronize()
            err = _rwkv_close(label, got, ref.rwkv6_scan(*xs), dname)
            inputs = "float32" if dname == "float32" else "bf16-rounded"
            log(f"[parity] K4 rwkv6_scan {label:12s} {inputs:12s} B={B} "
                f"S={S} H={H} D={D} max_abs_err={err:.3e} ok")
    # every prompt length the rwkv6 main path serves, under normal and the
    # strongest decay
    for S in SCAN_PROMPTS + (LONG_PROMPT,):
        for strong in (False, True):
            xs = rwkv_inputs(1, S, 64, 64, gen, strong_decay=strong)
            got = ops.rwkv6_scan(*xs)
            torch.cuda.synchronize()
            label = f"main-path S={S}" + (" strong" if strong else "")
            err = _rwkv_close(label, got, ref.rwkv6_scan(*xs), "float32")
            log(f"[parity] K4 rwkv6_scan main-path    float32      B=1 "
                f"S={S} H=64 D=64{' strong-decay' if strong else ''} "
                f"max_abs_err={err:.3e} ok")
    # the state carries: one 512-token scan against two of 256
    r, k, v, lw, u, s0 = rwkv_inputs(1, 512, 64, 64, gen)
    y_all, s_all = ops.rwkv6_scan(r, k, v, lw, u, s0)
    y1, s1 = ops.rwkv6_scan(*(t[:, :256].contiguous() for t in (r, k, v, lw)),
                            u, s0)
    y2, s2 = ops.rwkv6_scan(*(t[:, 256:].contiguous() for t in (r, k, v, lw)),
                            u, s1)
    torch.cuda.synchronize()
    y_two = torch.cat([y1, y2], dim=1)
    err = _rwkv_close("scan(256)+scan(256)", (y_two, s2), (y_all, s_all),
                      "float32")
    bitwise = torch.equal(y_two, y_all) and torch.equal(s2, s_all)
    log(f"[parity] K4 rwkv6_scan scan(512) vs scan(256) then scan(256) from "
        f"the carried state, B=1 H=64 D=64: max_abs_err={err:.3e} "
        f"bitwise={bitwise} ok")


# ---------------------------------------------------------------- phase 4


def _smoke_prompts(cfg, rng) -> dict:
    """Phase 4's four prompts: 5, 17, 17 and 30 tokens."""
    import numpy as np
    return {i: rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
            for i, L in enumerate((5, 17, 17, 30))}


def _smoke_schedule(ep, prompts: dict, hit: bool = False) -> tuple:
    """Phase 4's schedule: the prompts claimed (sized from the requests
    when ``hit``) and prefilled, then 24 decode steps (they wrap a
    48-slot cache).  Returns (the slots, the last tokens, the ids by
    slot)."""
    slots = [ep.try_claim(tokens=prompts[i], max_new=25) if hit
             else ep.try_claim() for i in prompts]
    toks = dict(ep.prefill_batch({s: prompts[i]
                                  for i, s in enumerate(slots)}))
    out = {s: [t] for s, t in toks.items()}
    for _ in range(24):
        toks = ep.decode_all(toks)
        for s, t in toks.items():
            out[s].append(t)
    return slots, toks, out


def smoke_model_vs_cpu(arch: str, kernels=("flash_attention",
                                             "decode_attention"),
                       paged: bool = False, hit: bool = False) -> None:
    """The smoke model of ``arch`` on the card (kernels) and on the CPU
    (plain versions), same weights, same requests: greedy ids must match,
    and the card's run must have launched each of ``kernels`` and nothing
    else.  ``paged``: both endpoints hold a page pool (page 16).  ``hit``
    (paged): claims are sized from the requests, so the prompts register
    in the prefix registry, and after the 24 steps the second prompt is
    served again in a fresh claim, an exact hit (no prefill), and every
    live row decodes 8 more steps."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import Endpoint
    cfg = configs.get_smoke_config(arch)
    params_cpu = model_zoo.init(cfg, torch.Generator().manual_seed(0))
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    rng = np.random.default_rng(0)
    kw = dict(paged=True, page_size=16) if paged else {}
    if hit:
        kw["total_pages"] = 24              # room for the registry's pages
    eps = {dev: Endpoint(cfg, p, slots=4, max_len=48, device=dev, **kw)
           for dev, p in (("cpu", params_cpu), ("cuda", params_gpu))}
    prompts = _smoke_prompts(cfg, rng)
    streams = {}
    for dev, ep in eps.items():
        ops.reset_launches()
        slots, toks, out = _smoke_schedule(ep, prompts, hit)
        if hit:
            ep.release(slots[1])
            again = ep.try_claim(tokens=prompts[1], max_new=25)
            toks[again] = ep.prefill_batch({again: prompts[1]})[again]
            out["again"] = [toks[again]]
            for _ in range(8):
                toks = ep.decode_all(toks)
                out["again"].append(toks[again])
                for s, t in toks.items():
                    if s != again:
                        out[s].append(t)
            if ep.prefill_hit_tokens != len(prompts[1]):
                raise RuntimeError(f"{arch} smoke model on {dev}: "
                                   f"{ep.prefill_hit_tokens} prefill hit "
                                   f"tokens, not the repeated prompt's")
        streams[dev] = out
    launched = dict(ops.launches)                 # of the card's run
    if streams["cpu"] != streams["cuda"]:
        raise RuntimeError(f"{arch} smoke model: greedy ids on the card "
                           f"differ from the CPU plain path")
    if any(launched[k] <= 0 for k in kernels) or any(
            n for k, n in launched.items() if k not in kernels):
        raise RuntimeError(f"{arch} smoke model on the card: {launched}")
    log(f"[model] {arch}{' paged' if paged else ''}"
        f"{' with an exact prefix hit' if hit else ''} smoke model on cuda "
        f"== cpu plain path: "
        f"{sum(len(v) for v in streams['cuda'].values())} tokens identical; "
        f"card launches { {k: launched[k] for k in kernels} }")


# ---------------------------------------------------------------- phase 5


class recording:
    """Within the block, record the shapes each kernel launcher is called
    with (``shapes``: kernel -> shapes -> launches): (q, k) for K1 and K2,
    (q, pages, tables) for K3, (r,) for K4, (a, b) for K5; and, given
    ``calls``, count the model-level prefill and decode calls."""

    def __init__(self, shapes: dict, calls: dict = None):
        from repro_torch.kernels import decode_attention as _dec
        from repro_torch.kernels import flash_attention as _fa
        from repro_torch.kernels import rwkv6_scan as _rwkv
        from repro_torch.kernels import ssd_scan as _ssd
        from repro_torch.models import model_zoo
        self.shapes, self.calls = shapes, calls
        self.targets = [(_fa, "flash_attention", "K1", (0, 1)),
                        (_dec, "decode_attention", "K2", (0, 1)),
                        (_dec, "paged_decode_attention", "K3", (0, 1, 3)),
                        (_rwkv, "rwkv6_scan", "K4", (0,)),
                        (_ssd, "ssd_scan", "K5", (0, 1))]
        if calls is not None:
            self.targets += [(model_zoo, "prefill", "prefill", None),
                             (model_zoo, "decode", "decode", None)]
        self.saved = [getattr(m, name) for m, name, _, _ in self.targets]

    def _wrap(self, fn, tag, args):
        def rec(*a, **kw):
            if args is None:
                self.calls[tag] += 1
            else:
                key = tuple(tuple(a[i].shape) for i in args)
                per = self.shapes.setdefault(tag, {})
                per[key] = per.get(key, 0) + 1
            return fn(*a, **kw)
        return rec

    def __enter__(self):
        for (m, name, tag, args), fn in zip(self.targets, self.saved):
            setattr(m, name, self._wrap(fn, tag, args))
        return self

    def __exit__(self, *exc):
        for (m, name, _, _), fn in zip(self.targets, self.saved):
            setattr(m, name, fn)
        return False


def serve_full(cfg, params, shapes: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec, Request, TierConfig)
    nparams = sum(p.numel() for p in params.values())
    log(f"[serve] stablelm-1.6b full width: {cfg.num_layers} layers, "
        f"d={cfg.d_model}, heads={cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim={cfg.head_dim}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
        f"{nparams / 1e9:.3f}B params bf16")
    max_len, max_new = 1024, 32
    cc = Continuum(edge=TierConfig(slots=2, max_len=max_len),
                   cloud=TierConfig(slots=16, max_len=max_len,
                                    extra_latency_s=0.02),
                   policy="auto", seed=0, device="cuda")
    cc.deploy(FunctionSpec(name="stablelm", arch="stablelm-1.6b",
                           autoscaling=AutoscalingPolicy()), cfg, params)
    if any(t.endpoints["stablelm"].params is not params for t in cc.tiers):
        raise RuntimeError("tiers do not share the one set of weights")

    calls = {"prefill": 0, "decode": 0}
    rng = np.random.default_rng(0)
    reqs = []
    rounds, rps_low, rps_high = 8, 2.0, 8.0
    ops.reset_launches()
    torch.cuda.synchronize()
    t_serve = time.perf_counter()
    with recording(shapes, calls):
        for rnd in range(rounds):
            frac = min(rnd / max(rounds * 0.5, 1), 1.0)
            n = int(round(rps_low + (rps_high - rps_low) * frac))
            for _ in range(n):
                L = int(rng.integers(64, 513))
                toks = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
                req = Request(rid=len(reqs), tokens=toks, max_new=max_new)
                reqs.append(req)
                if not cc.submit("stablelm", req):
                    raise RuntimeError(f"request {req.rid} rejected")
            rec = cc.tick()
            log(f"[serve] round={rnd} submitted={n} "
                f"edge={rec['tiers']['edge']} cloud={rec['tiers']['cloud']} "
                f"steps={rec['steps']} R_t={rec['R']:.1f}%")
        drained = cc.drain()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t_serve
    launches = dict(ops.launches)

    served = {t.name: sum(r["tiers"][t.name] for r in cc.log)
              for t in cc.tiers}
    n_served = sum(served.values())
    if n_served != len(reqs) or any(r.failed for r in reqs):
        raise RuntimeError(f"served {n_served} of {len(reqs)} requests")
    for r in reqs:
        if (r.output is None or r.output.shape != (max_new,)
                or r.output.min() < 0 or r.output.max() >= cfg.vocab_size):
            raise RuntimeError(f"request {r.rid}: bad output {r.output}")
    if launches["flash_attention"] <= 0 or launches["decode_attention"] <= 0:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    if launches["flash_attention_plain"] or launches["decode_attention_plain"]:
        raise RuntimeError(f"main path ran a plain version: {launches}")
    tokens = len(reqs) * max_new
    log(f"[serve] served {n_served}/{len(reqs)} edge={served['edge']} "
        f"cloud={served['cloud']} drain_ticks={drained} "
        f"tokens={tokens} wall={secs:.2f}s tokens_per_s={tokens / secs:.1f} "
        f"final_R_t={cc.log[-1]['R']:.2f}% launches={launches}")
    log(f"[serve] {calls['prefill']} prefill calls, {calls['decode']} decode "
        f"steps: K1 launches per prefill "
        f"{launches['flash_attention'] / max(calls['prefill'], 1):g}, K2 "
        f"launches per decode step "
        f"{launches['decode_attention'] / max(calls['decode'], 1):g}")
    log(f"[serve] K1 shapes (q, k) -> launches: "
        f"{ {str(k): v for k, v in sorted(shapes['K1'].items())} }")
    log(f"[serve] K2 shapes (q, k) -> launches: "
        f"{ {str(k): v for k, v in sorted(shapes['K2'].items())} }")
    return launches


def full_model(arch: str):
    """``arch`` at full width, bf16, seeded random weights drawn on the
    card."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo
    cfg = configs.get_config(arch)
    params = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return cfg, params


def free_card(what: str) -> None:
    """Free a model's weights and every cache built over them: the
    continua and endpoints of a phase hold them in reference cycles, which
    only the collector breaks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mem] after {what}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated on the card")


def paged_vs_dense(cfg, params, card: str, shapes: dict, tag: str,
                   max_len: int = 1024, lengths=None,
                   want=("flash_attention", "decode_attention",
                         "paged_decode_attention")) -> dict:
    """Phases 5b, 5j (b) and 5l (a): a dense and a paged endpoint (page
    16, no prefix cache) over one set of weights, driven through one fixed
    admit / decode / retire schedule of 24 requests (prompts of
    ``lengths``, default 64..512 tokens); the token ids must agree at
    every step, each of ``want`` must launch and nothing else, and every
    paged step must launch K3 once a layer whose KV the pool pages and K2
    once a layer it keeps per slot.  Records the kernels' shapes in
    ``shapes``; returns the launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Endpoint
    slots, max_new, n_req = 16, 32, 24
    dense = Endpoint(cfg, params, slots=slots, max_len=max_len,
                     device="cuda")
    paged = Endpoint(cfg, params, slots=slots, max_len=max_len,
                     device="cuda", paged=True, page_size=16,
                     prefix_cache=False)
    groups = {n[:n.rfind("/") + 1] for n in paged._paged}
    n_k3 = sum(len(layers) for g, layers in
               transformer.cache_groups(cfg).items() if g in groups)
    rng = np.random.default_rng(5)
    if lengths is None:
        lengths = rng.integers(64, 513, n_req)
    waiting = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
               for L in lengths]
    cur, left = {}, {}
    times = {"dense": [], "paged": []}
    steps = tokens = 0
    ops.reset_launches()
    with recording(shapes):
        while waiting or cur:
            # admit up to 4 waiting requests a step into free slots
            batch = {}
            while waiting and len(batch) < 4 and dense.active < slots:
                toks = waiting.pop(0)
                sd = dense.try_claim(tokens=toks, max_new=max_new)
                sp = paged.try_claim(tokens=toks, max_new=max_new)
                if sd != sp or sd is None:
                    raise RuntimeError(f"claims diverged: dense {sd} "
                                       f"paged {sp}")
                batch[sd] = toks
            if batch:
                fd = dense.prefill_batch(batch)
                fp = paged.prefill_batch(batch)
                if fd != fp:
                    raise RuntimeError(f"first tokens differ: {fd} vs {fp}")
                for s, t in fd.items():
                    cur[s], left[s] = t, max_new - 1
                    tokens += 1
            if not cur:
                continue
            for name, ep in (("dense", dense), ("paged", paged)):
                before = (ops.launches["decode_attention"],
                          ops.launches["paged_decode_attention"])
                t0 = time.perf_counter()
                out = ep.decode_all(dict(cur))
                times[name].append(time.perf_counter() - t0)
                if name == "dense":
                    nd = out
                    continue
                if out != nd:
                    raise RuntimeError(f"step {steps}: paged tokens {out} != "
                                       f"dense {nd}")
                step = (ops.launches["decode_attention"] - before[0],
                        ops.launches["paged_decode_attention"] - before[1])
                if step != (cfg.num_layers - n_k3, n_k3):
                    raise RuntimeError(f"[{tag}] paged step {steps} "
                                       f"launched K2, K3 {step}")
            steps += 1
            for s in list(cur):
                cur[s], left[s] = nd[s], left[s] - 1
                tokens += 1
                if left[s] <= 0:
                    dense.release(s)
                    paged.release(s)
                    del cur[s], left[s]
    launches = dict(ops.launches)
    if min(launches[k] for k in want) <= 0 or any(
            n for k, n in launches.items() if k not in want):
        raise RuntimeError(f"[{tag}] paged == dense ran {launches}")
    if not paged.pool.check_balanced() or paged.free_pages != \
            paged.total_pages:
        raise RuntimeError("paged pool not balanced after the schedule")
    log(f"[{tag}] paged==dense: {n_req} requests, {steps} decode steps, "
        f"{tokens} tokens: paged token ids == dense at every step; "
        f"each paged step launched K3 {n_k3} and K2 "
        f"{cfg.num_layers - n_k3} times (paged leaves {paged._paged}); "
        f"launches {launches}")
    log(f"[{tag}] paged==dense: median decode_all wall, 16 slots: dense "
        f"{1e3 * statistics.median(times['dense']):.3f} ms, paged "
        f"{1e3 * statistics.median(times['paged']):.3f} ms ({card})")
    return launches


def serve_paged(cfg, params, shapes: dict, tag: str = "paged",
                topo=None, per_round=(2, 3, 4, 5, 6, 8, 10, 10),
                fn_lengths=(100, 237, 330, 509), lengths=None,
                kernels=("flash_attention", "paged_decode_attention")
                ) -> dict:
    """Phases 5c and 5l (b): the paged path, the continuum over two paged
    tiers (``topo``, default 5c's) serving function-prompt traffic:
    ``per_round`` requests a round (5c: 48), three in four drawn by
    Zipf(1.1) from prompts of ``fn_lengths``, the rest of a length drawn
    from ``lengths`` (default 64..512).  Fails unless every request is
    served with 32 tokens, each of ``kernels`` launched and nothing else
    did, some tier hit its prefix registry and every pool drains to the
    pages its registry pins."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec, LinkSpec, Request,
                                      TierSpec, Topology)
    max_new = 32
    if topo is None:
        topo = Topology(
            (TierSpec("edge", slots=8, max_len=1024, page_size=16,
                      pool_pages=128),
             TierSpec("cloud", slots=16, max_len=1024, page_size=16,
                      extra_latency_s=0.02, queue_depth_per_slot=None)),
            (LinkSpec(rtt_s=0.0),), waterfall=False)
    fn = cfg.name.split("-")[0]
    cc = Continuum(topology=topo, policy="auto", seed=0, device="cuda")
    cc.deploy(FunctionSpec(name=fn, arch=cfg.name,
                           autoscaling=AutoscalingPolicy()), cfg, params)
    for t in cc.tiers:
        ep = t.endpoints[fn]
        log(f"[{tag}] tier {t.name}: {ep.slots} slots, {ep.total_pages} "
            f"pages of {ep.page_size} tokens, pool "
            f"{ep.pool_nbytes / 2**20:.1f} MiB, paged leaves {ep._paged}")
    rng = np.random.default_rng(7)
    fn_prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
                  for L in fn_lengths]
    zipf = 1.0 / np.arange(1, 5) ** 1.1
    zipf /= zipf.sum()
    reqs = []
    ops.reset_launches()
    torch.cuda.synchronize()
    t_serve = time.perf_counter()
    with recording(shapes):
        for rnd, n in enumerate(per_round):
            for _ in range(n):
                if rng.uniform() < 0.75:
                    toks = fn_prompts[int(rng.choice(4, p=zipf))].copy()
                else:
                    L = (rng.integers(64, 513) if lengths is None
                         else rng.choice(lengths))
                    toks = rng.integers(0, cfg.vocab_size,
                                        int(L)).astype(np.int32)
                req = Request(rid=len(reqs), tokens=toks, max_new=max_new)
                reqs.append(req)
                if not cc.submit(fn, req):
                    raise RuntimeError(f"request {req.rid} rejected")
            r = cc.tick()
            log(f"[{tag}] round={rnd} submitted={n} "
                f"edge={r['tiers']['edge']} cloud={r['tiers']['cloud']} "
                f"steps={r['steps']} R_t={r['R']:.1f}%")
        drained = cc.drain()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t_serve
    launches = dict(ops.launches)
    served = {t.name: sum(r["tiers"][t.name] for r in cc.log)
              for t in cc.tiers}
    if sum(served.values()) != len(reqs) or any(r.failed for r in reqs):
        raise RuntimeError(f"{tag}: served {served} of {len(reqs)}")
    for r in reqs:
        if (r.output is None or r.output.shape != (max_new,)
                or r.output.min() < 0 or r.output.max() >= cfg.vocab_size):
            raise RuntimeError(f"{tag} request {r.rid}: bad output "
                               f"{r.output}")
    if min(launches[k] for k in kernels) <= 0:
        raise RuntimeError(f"{tag} path skipped a kernel: {launches}")
    if any(n for k, n in launches.items() if k not in kernels):
        raise RuntimeError(f"{tag} path ran another kernel or a plain "
                           f"version: {launches}")
    eps = {t.name: t.endpoints[fn] for t in cc.tiers}
    if not any(ep.prefill_hit_rate > 0 for ep in eps.values()):
        raise RuntimeError(f"{tag}: no prefix hit on any tier")
    for name, ep in eps.items():
        if (not ep.pool.check_balanced() or ep.active
                or ep.used_pages != len(ep.prefix.pinned_pages())):
            raise RuntimeError(f"{tag} tier {name}: pool not drained to "
                               f"its registry")
        log(f"[{tag}] tier {name}: served {served[name]}, prefill hit rate "
            f"{ep.prefill_hit_rate:.4f}, peak resident requests "
            f"{ep.peak_active}, registry {len(ep.prefix)} prompts in "
            f"{ep.used_pages} pages")
    tokens = len(reqs) * max_new
    log(f"[{tag}] served {len(reqs)}/{len(reqs)} drain_ticks={drained} "
        f"tokens={tokens} wall={secs:.2f}s "
        f"tokens_per_s={tokens / secs:.1f} final_R_t={cc.log[-1]['R']:.2f}% "
        f"launches={launches}")
    log(f"[{tag}] K3 shapes (q, pool, tables) -> launches: "
        f"{ {str(k): v for k, v in sorted(shapes['K3'].items())} }")
    return launches


# phase 4d: the smoke models of the MoE family and the other one-card
# configurations
NEW_SMOKE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b", "qwen2.5-14b",
                   "internvl2-1b", "musicgen-medium", "nemotron-4-340b")


def llama3_smoke_refuses_the_card() -> None:
    """Phase 4d: llama3-405b's smoke model has head_dim 8, which no
    kernel takes; on the card its prefill must raise from the launcher,
    not fall back to the plain version (it is held on the CPU only)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import Endpoint
    cfg = configs.get_smoke_config("llama3-405b")
    params = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    ep = Endpoint(cfg, params, slots=2, max_len=32, device="cuda")
    ops.reset_launches()
    s = ep.try_claim()
    try:
        ep.prefill_batch({s: np.arange(5, dtype=np.int32)})
    except ValueError as e:
        if "head_dim 8" not in str(e):
            raise
        if any(ops.launches.values()):
            raise RuntimeError(f"llama3 smoke: launched {dict(ops.launches)}")
        log(f"[model] llama3-405b smoke model (head_dim 8) on the card "
            f"raises from the launcher, no plain fallback: {e}")
        return
    raise RuntimeError("llama3-405b smoke model ran on the card at head_dim "
                       "8")


# ---------------------------------------------------------------- TP


class shard_launches:
    """Within the block, count each kernel's launches (``ops.launches``)
    by the shard of a tensor-parallel endpoint whose attention made them:
    ``counts[shard][kernel]``.  The endpoints sharded inside the block
    are registered (by the storage of each shard's ``wq``); attention
    calls of an unsharded endpoint are not counted."""

    def __init__(self):
        from repro_torch.models import transformer
        from repro_torch.serving import sharded
        self.modules = (transformer, sharded)
        self.saved = (transformer.attend, sharded.shard_params)
        self.owner: dict = {}
        self.counts: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        transformer, sharded = self.modules
        attend, shard_params = self.saved

        def registered(*a, **kw):
            shards = shard_params(*a, **kw)
            for s, ps in enumerate(shards):
                self.owner[ps["layers/attn/wq"].untyped_storage()
                           .data_ptr()] = s
            return shards

        def counted(cfg, p, *a, **kw):
            s = self.owner.get(p["attn/wq"].untyped_storage().data_ptr())
            before = dict(ops.launches)
            out = attend(cfg, p, *a, **kw)
            if s is not None:
                per = self.counts.setdefault(s, {})
                for k, n in ops.launches.items():
                    per[k] = per.get(k, 0) + n - before[k]
            return out

        transformer.attend, sharded.shard_params = counted, registered
        return self

    def __exit__(self, *exc):
        transformer, sharded = self.modules
        transformer.attend, sharded.shard_params = self.saved
        return False

    def check(self, tag: str, tp: int, kernels: tuple) -> None:
        """Fail unless each of ``tp`` shards launched each of ``kernels``
        and no shard launched anything else."""
        if sorted(self.counts) != list(range(tp)) or any(
                per.get(k, 0) <= 0 for per in self.counts.values()
                for k in kernels) or any(
                n for per in self.counts.values() for k, n in per.items()
                if k not in kernels):
            raise RuntimeError(f"{tag}: launches by shard {self.counts}")


def smoke_tp_on_card() -> None:
    """Phase 4e: the smoke models of stablelm-1.6b (tp 2 and 4) and
    qwen2.5-14b (tp 2) on sharded endpoints over ``forced_devices(tp)``
    on the card, through phase 4's schedule: the ids must equal the same
    model's unsharded endpoint on the card, every shard must launch K1
    and K2, and nothing else (no plain version) may run.  qwen2.5's smoke
    model at tp 4 (2 kv heads) must raise ``validate_tp``'s ValueError
    before any launch."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import Endpoint
    kernels = ("flash_attention", "decode_attention")
    for arch, tp in (("stablelm-1.6b", 2), ("stablelm-1.6b", 4),
                     ("qwen2.5-14b", 2)):
        cfg = configs.get_smoke_config(arch)
        params = model_zoo.init(cfg,
                                torch.Generator(device="cuda").manual_seed(0))
        prompts = _smoke_prompts(cfg, np.random.default_rng(0))
        want = _smoke_schedule(Endpoint(cfg, params, slots=4, max_len=48),
                               prompts)[2]
        ops.reset_launches()
        with mesh_mod.forced_devices(tp), shard_launches() as per:
            ep = Endpoint(cfg, params, slots=4, max_len=48,
                          mesh=mesh_mod.make_mesh((1, tp), ("data", "model")))
            got = _smoke_schedule(ep, prompts)[2]
        if got != want:
            raise RuntimeError(f"4e {arch} tp {tp}: ids {got} != unsharded "
                               f"{want}")
        per.check(f"4e {arch} tp {tp}", tp, kernels)
        if any(n for k, n in ops.launches.items() if k not in kernels):
            raise RuntimeError(f"4e {arch} tp {tp}: {ops.launches}")
        log(f"[4e] {arch} smoke model at tp {tp} on one card "
            f"(forced_devices({tp})) == unsharded on the card: "
            f"{sum(len(v) for v in got.values())} ids identical; launches "
            f"by shard {per.counts}")
    cfg = configs.get_smoke_config("qwen2.5-14b")
    params = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    ops.reset_launches()
    try:
        with mesh_mod.forced_devices(4):
            Endpoint(cfg, params, slots=4, max_len=48,
                     mesh=mesh_mod.make_mesh((1, 4), ("data", "model")))
    except ValueError as e:
        if "num_kv_heads divisible by tp=4" not in str(e) or any(
                ops.launches.values()):
            raise
        log(f"[4e] qwen2.5-14b smoke model at tp 4 refused before any "
            f"launch: {e}")
        return
    raise RuntimeError("4e: qwen2.5-14b smoke model deployed at tp 4")

# prompt lengths both scans' rule admits (S <= 128 or S % 128 == 0)
SCAN_PROMPTS = (64, 100, 128, 256, 384, 512)
LONG_PROMPT = 1024                  # past hymba's 1024-token window
RECURRENT_MAX_LEN = 2048
# 5d and 5e: 16 requests (40 until the sharded-training phases needed the
# time, 24 until the serve-step phases did)
RECURRENT_ROUNDS = (2, 3, 4, 4, 3)
RECURRENT_LONG_RIDS = (3, 8, 13)                    # 1024-token prompts
PREFILL_KERNELS = ("flash_attention", "rwkv6_scan", "ssd_scan")
KERNEL_TAGS = {"flash_attention": "K1", "decode_attention": "K2",
               "paged_decode_attention": "K3", "rwkv6_scan": "K4",
               "ssd_scan": "K5"}


def _wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` (work that ends in a sync)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _device_ms(fn, n: int):
    """Device time of one call of ``fn`` under ``torch.profiler`` (mean of
    ``n`` calls): (total ms, {kernel name: ms}, the split by category of
    ``repro_torch.launch.profile.breakdown``: attention kernels, the MoE
    helpers' ranges, the rest)."""
    import torch
    from repro_torch.launch import profile
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with profile.moe_spans(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = set(profile.MOE_SPANS.values())
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in spans):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    return sum(by_name.values()), by_name, profile.breakdown(prof, n)


def serve_two_tier(tag: str, cfg, params, shapes: dict, card: str,
                   kernels: tuple, per_round: tuple, prompts: tuple,
                   max_len: int, seed: int, long_rids=(), scan=None,
                   state_keys: tuple = (), summary: dict = None) -> dict:
    """Phases 5d, 5e, 5j (a) and 5k: one model's main path through the
    continuum (edge 2 slots, cloud 16, ``max_len``, policy auto;
    ``per_round`` requests of 32 new tokens a round, prompts drawn from
    ``prompts``, the requests numbered in ``long_rids`` of
    ``LONG_PROMPT``), then one cloud endpoint's 512-token prefill and
    16-row decode step: wall, device time, busy share, the top kernels
    and the device time by category.  Fails unless every request is
    served with 32 tokens, each of ``kernels`` launched and nothing else
    did (no plain version, no other kernel), and ``scan``, given,
    launched once a layer a prefill call.  ``state_keys`` are the cache
    leaves of a recurrent state.  ``summary``, given, receives the cloud
    endpoint's times."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec, Request, TierConfig)
    max_new = 32
    cc = Continuum(edge=TierConfig(slots=2, max_len=max_len),
                   cloud=TierConfig(slots=16, max_len=max_len,
                                    extra_latency_s=0.02),
                   policy="auto", seed=0, device="cuda")
    cc.deploy(FunctionSpec(name=tag, arch=cfg.name,
                           autoscaling=AutoscalingPolicy()), cfg, params)
    rng = np.random.default_rng(seed)
    calls = {"prefill": 0, "decode": 0}
    reqs = []
    ops.reset_launches()
    torch.cuda.synchronize()
    t_serve = time.perf_counter()
    with recording(shapes, calls):
        for rnd, n in enumerate(per_round):
            for _ in range(n):
                L = (LONG_PROMPT if len(reqs) in long_rids
                     else int(rng.choice(prompts)))
                toks = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
                req = Request(rid=len(reqs), tokens=toks, max_new=max_new)
                reqs.append(req)
                if not cc.submit(tag, req):
                    raise RuntimeError(f"{tag} request {req.rid} rejected")
            rec = cc.tick()
            log(f"[{tag}] round={rnd} submitted={n} "
                f"edge={rec['tiers']['edge']} cloud={rec['tiers']['cloud']} "
                f"steps={rec['steps']} R_t={rec['R']:.1f}%")
        drained = cc.drain()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t_serve
    launches = dict(ops.launches)

    served = {t.name: sum(r["tiers"][t.name] for r in cc.log)
              for t in cc.tiers}
    if sum(served.values()) != len(reqs) or any(r.failed for r in reqs):
        raise RuntimeError(f"{tag}: served {served} of {len(reqs)}")
    for r in reqs:
        if (r.output is None or r.output.shape != (max_new,)
                or r.output.min() < 0 or r.output.max() >= cfg.vocab_size):
            raise RuntimeError(f"{tag} request {r.rid}: bad output "
                               f"{r.output}")
    if min(launches[k] for k in kernels) <= 0:
        raise RuntimeError(f"{tag} path skipped a kernel: {launches}")
    if any(n for k, n in launches.items() if k not in kernels):
        raise RuntimeError(f"{tag} path ran a plain version or another "
                           f"kernel: {launches}")
    if scan is not None and launches[scan] != (cfg.num_layers
                                               * calls["prefill"]):
        raise RuntimeError(f"{tag}: {launches[scan]} {KERNEL_TAGS[scan]} "
                           f"launches for {calls['prefill']} prefill calls")
    tokens = len(reqs) * max_new
    log(f"[{tag}] served {len(reqs)}/{len(reqs)} edge={served['edge']} "
        f"cloud={served['cloud']} drain_ticks={drained} tokens={tokens} "
        f"wall={secs:.2f}s tokens_per_s={tokens / secs:.1f} "
        f"final_R_t={cc.log[-1]['R']:.2f}% launches={launches}")
    per = [f"{KERNEL_TAGS[k]} per prefill "
           f"{launches[k] / max(calls['prefill'], 1):g}"
           if k in PREFILL_KERNELS else
           f"{KERNEL_TAGS[k]} per decode step "
           f"{launches[k] / max(calls['decode'], 1):g}" for k in kernels]
    log(f"[{tag}] {calls['prefill']} prefill calls, {calls['decode']} decode "
        f"steps: {', '.join(per)}")
    for k in kernels:
        t = KERNEL_TAGS[k]
        log(f"[{tag}] {t} shapes -> launches: "
            f"{ {str(s): n for s, n in sorted(shapes[t].items())} }")

    # one cloud endpoint, now idle: bytes per row, prefill, decode step
    ep = cc.tiers[-1].endpoints[tag]
    state = sum(ep._row_init[k].numel() * ep._row_init[k].element_size()
                for k in state_keys)
    for L in (512, (LONG_PROMPT if long_rids else 512) + max_new):
        row = ep.cache_nbytes_per_row(L)
        log(f"[{tag}] bytes per row at position {L}: {row:.0f} (KV "
            f"{row - state:.0f}, recurrent state {state})")
    if all(ax is None for ax in ep._len_axes.values()):
        # no leaf grows with the context: every position holds the state
        rows = {ep.cache_nbytes_per_row(L) for L in (0, 1, 512, max_len)}
        if rows != {float(state)}:
            raise RuntimeError(f"{tag}: row bytes {rows} != state {state}")
    probe = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    s0 = ep.try_claim()

    def prefill():
        ep.prefill_batch({s0: probe})

    prefill()                                           # warm-up
    prefill_ms = _wall_ms(prefill, 5)
    prefill_dev = _device_ms(prefill, 3)
    resident = {s0: probe}
    while ep.active < ep.slots:
        resident[ep.try_claim()] = rng.integers(
            0, cfg.vocab_size, int(rng.choice(prompts))).astype(np.int32)
    toks = ep.prefill_batch(resident)

    def step():
        nonlocal toks
        toks = ep.decode_all(toks)

    for _ in range(3):
        step()                                          # warm-up
    decode_ms = _wall_ms(step, 8)
    decode_dev = _device_ms(step, 8)
    for s in list(resident):
        ep.release(s)
    summary = {} if summary is None else summary
    for what, wall, (dev, by_name, split) in (
            ("prefill of one 512-token prompt", prefill_ms, prefill_dev),
            (f"decode step of {ep.slots} rows", decode_ms, decode_dev)):
        log(f"[{tag}] cloud endpoint, {what}: {wall:.3f} ms wall (median), "
            f"device time {dev:.4f} ms (profiler), busy share "
            f"{100 * dev / wall:.1f}% ({card})")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[{tag}]   {ms:8.4f} ms a call  {name[:90]}")
        log(f"[{tag}]   device ms a call by category: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))
        summary[what.split()[0]] = {"wall_ms": wall, "device_ms": dev,
                                    "busy_share": dev / wall,
                                    "by_category_ms": split}
        if what.startswith("prefill") and scan is not None:
            # the scan kernel's own share, in the top eight or not
            own = sum(ms for name, ms in by_name.items()
                      if f"{scan}_kernel" in name)
            if own <= 0:
                raise RuntimeError(f"{tag}: the profiler saw no {scan} "
                                   f"kernel in the prefill")
            log(f"[{tag}]   {KERNEL_TAGS[scan]} {scan} alone: {own:.4f} ms "
                f"a call, {100 * own / dev:.1f}% of the prefill's device "
                f"time")
    log(f"[{tag}] cloud endpoint summary: {json.dumps(summary)}")
    return launches


CHAIN_PROMPTS = (64, 128, 256, 512)
CHAIN_REQ_BYTES = 6.0e6             # matmult's payload: the sim's boundaries


def _chain_topology(max_len: int):
    """Phase 5f's chain, ``Topology.device_edge_cloud``'s links and
    queue depths with the serving tiers of the issue: device 2 dense
    slots (depth 4), edge 8 slots paged in 128 pages of 16 (the KV of two
    dense rows; depth 8), cloud 16 dense slots (unbounded)."""
    from repro_torch.platform import LinkSpec, TierSpec, Topology
    return Topology(
        (TierSpec("device", slots=2, max_len=max_len,
                  queue_depth_per_slot=4),
         TierSpec("edge", slots=8, max_len=max_len, page_size=16,
                  pool_pages=128, queue_depth_per_slot=8),
         TierSpec("cloud", slots=16, max_len=max_len,
                  queue_depth_per_slot=None)),
        (LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6),
         LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6)), waterfall=True)


def _chain_trace(vocab: int):
    """68 requests in two bursts (ticks 8-10 and 26-29), prompts drawn
    from ``CHAIN_PROMPTS``, 32 new tokens each."""
    import numpy as np
    from repro_torch.platform import Trace
    tr = Trace.bursty(base_rps=0.5, burst_rps=8.0, duration_s=30.0,
                      mean_on_s=5.0, mean_off_s=10.0, seed=0)
    tr.prompt_len[:] = np.random.default_rng(0).choice(CHAIN_PROMPTS,
                                                       len(tr))
    tr.max_new[:] = 32
    return tr


def _net_caps(control, arrivals) -> list:
    """Each boundary's net-aware cap for this tick's demand, computed as
    the controller does (float32)."""
    import numpy as np
    from repro_torch.core.offload import link_x100
    caps = []
    for pol, a in zip(control.policies, arrivals):
        rps = control._rps(a)
        denom = np.maximum(rps * np.float32(pol.cfg.req_bytes),
                           np.float32(1e-9))
        caps.append(np.clip(np.float32(link_x100(pol.cfg.link_bytes_per_s))
                            / denom, 0, 100).astype(np.float32))
    return caps


def _step_device(ep, prompts: dict, card: str, tag: str, label: str):
    """One decode step of ``ep`` with ``prompts`` resident: wall (median
    of 8) and device time (profiler, mean of 8) and busy share."""
    toks = ep.prefill_batch(prompts)

    def step():
        nonlocal toks
        toks = ep.decode_all(toks)

    for _ in range(3):
        step()
    wall = _wall_ms(step, 8)
    dev = _device_ms(step, 8)[0]
    for s in list(prompts):
        ep.release(s)
    log(f"[{tag}] {label}: decode step of {len(prompts)} rows {wall:.3f} ms "
        f"wall (median), device time {dev:.4f} ms (profiler), busy share "
        f"{100 * dev / wall:.1f}% ({card})")
    return wall, dev


def serve_chain(cfg, params, shapes: dict, card: str,
                eq1: str = "window", topo=None, tag=None,
                need=("flash_attention", "decode_attention",
                      "paged_decode_attention"), time_tiers=None,
                served_ids: dict = None) -> dict:
    """Phase 5f (``eq1="window"``), 5i (``"sketch"``) or 5m (``topo``
    the cost-priced chain): full-width stablelm-1.6b through a live
    three-tier device -> edge -> cloud chain (waterfall on) under
    ``"auto+net"``, arrivals from a bursty trace; conservation, the
    kernels of ``need`` launched and nothing else, the net-aware cap, sim
    R_t == live R_t on the recorded controller inputs (replayed through
    the simulator's control loop over the same chain), the controller's
    host time, tokens/s and (``eq1="window"``) one decode step per tier
    of ``time_tiers`` (default all), every slot resident.  Returns the
    launches and the summary (with each timed step's device ms);
    ``served_ids``, given, receives every served request's ids by rid."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core.simulator import ContinuumSimulator, SimConfig
    from repro_torch.kernels import ops
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec)
    if tag is None:
        tag = "chain" if eq1 == "window" else "5i"
    max_len, max_new = 1024, 32
    if topo is None:
        topo = _chain_topology(max_len)
    trace = _chain_trace(cfg.vocab_size)
    cc = Continuum.from_topology(topo, policy="auto+net",
                                 req_bytes=CHAIN_REQ_BYTES, trace=trace,
                                 trace_vocab=cfg.vocab_size, seed=0,
                                 device="cuda", eq1=eq1)
    cc.deploy(FunctionSpec(name="stablelm", arch="stablelm-1.6b",
                           autoscaling=AutoscalingPolicy()), cfg, params)
    per_tick = trace.per_tick(1.0)[:, 0]
    log(f"[{tag}] eq1={eq1!r}; {topo}; trace {len(trace)} requests, "
        f"arrivals per tick {per_tick.tolist()}; caps parsed per boundary: "
        f"{[(p.spec, p.cfg.link_bytes_per_s, p.cfg.req_bytes) for p in cc.control.policies]}")

    # record every scrape's controller inputs and outputs, and its host time
    inputs, outputs, upd_ms = [], [], []
    step_name = "step_tiers" if eq1 == "window" else "step_stream"
    step = getattr(cc.control, step_name)

    def recorded(first, *args, queue_ages=None, arrivals=None):
        inputs.append((copy.deepcopy(first), copy.deepcopy(args),
                       copy.deepcopy(queue_ages),
                       [np.array(a) for a in arrivals]))
        R = step(first, *args, queue_ages=queue_ages, arrivals=arrivals)
        outputs.append(np.array(R))
        return R
    setattr(cc.control, step_name, recorded)
    update = cc.controller_update

    def timed_update():
        t0 = time.perf_counter()
        out = update()
        upd_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    cc.controller_update = timed_update

    calls = {"prefill": 0, "decode": 0}
    ops.reset_launches()
    torch.cuda.synchronize()
    t_serve = time.perf_counter()
    with recording(shapes, calls):
        for tick in range(int(math.ceil(trace.duration_s))):
            rec = cc.tick()
            log(f"[{tag}] tick={tick} arrived={int(per_tick[tick])} "
                f"served={rec['tiers']} spilled={rec['spilled']} "
                f"rejected={rec['rejected']} backlog={rec['backlog']} "
                f"R_t={[f'{r:.2f}' for r in outputs[-1][:, 0]]}")
        drained = cc.drain()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t_serve
    launches = dict(ops.launches)

    reqs = cc.trace_requests
    served = {t.name: sum(r["tiers"][t.name] for r in cc.log)
              for t in cc.tiers}
    rejected = sum(r["rejected"] for r in cc.log)
    n_served = sum(served.values())
    if len(reqs) != len(trace) or n_served + rejected != len(reqs):
        raise RuntimeError(f"{tag}: served {served} + rejected {rejected} "
                           f"!= submitted {len(reqs)}")
    if sum(r.failed for r in reqs) != rejected:
        raise RuntimeError(f"{tag}: failed requests != rejections")
    for r in reqs:
        if r.failed:
            continue
        if (r.output is None or r.output.shape != (max_new,)
                or r.output.min() < 0 or r.output.max() >= cfg.vocab_size):
            raise RuntimeError(f"{tag} request {r.rid}: bad output "
                               f"{r.output}")
    if min(launches[k] for k in need) <= 0:
        raise RuntimeError(f"{tag} skipped a kernel: {launches}")
    if any(n for k, n in launches.items() if k not in need):
        raise RuntimeError(f"{tag} ran a plain version or another kernel: "
                           f"{launches}")
    if served_ids is not None:
        served_ids.update({r.rid: r.output for r in reqs if not r.failed})
    link_MB = [sum(r["link_MB"][l] for r in cc.log)
               for l in range(len(topo.links))]
    spilled = sum(r["spilled"] for r in cc.log)

    # sim R_t == live R_t: the simulator's loop over the same chain,
    # parsed against matmult's payload, replays the recorded inputs
    sim = ContinuumSimulator("matmult", "auto+net",
                             SimConfig(window=64, control_interval_s=1.0),
                             topology=topo, eq1=eq1).control
    sim_step = getattr(sim, step_name)
    capped = 0
    for i, ((first, args, ages, arrivals), R_live) in enumerate(
            zip(inputs, outputs)):
        R_sim = sim_step(first, *args, queue_ages=ages, arrivals=arrivals)
        if not np.array_equal(R_sim, R_live):
            raise RuntimeError(f"{tag}: sim R_t {R_sim.tolist()} != live "
                               f"R_t {R_live.tolist()} at scrape {i}")
        caps = _net_caps(cc.control, arrivals)
        capped += int(any(np.any((R_live[b] == caps[b]) & (caps[b] < 100))
                          for b in range(len(caps))))
    traj = np.stack(outputs)[:, :, 0]
    med = statistics.median(upd_ms)
    p95 = float(np.percentile(upd_ms, 95))
    tokens = n_served * max_new
    summary = dict(served=served, rejected=rejected,
                   final_R=[round(float(x), 4) for x in traj[-1]],
                   tokens_per_s=round(tokens / secs, 1),
                   update_ms_median=round(med, 4), update_ms_p95=round(p95, 4))
    log(f"[{tag}] submitted {len(reqs)} served {served} rejected {rejected} "
        f"spilled {spilled} link_MB {[round(m, 4) for m in link_MB]} "
        f"drain_ticks={drained} tokens={tokens} wall={secs:.2f}s "
        f"tokens_per_s={tokens / secs:.1f} launches={launches}")
    log(f"[{tag}] R_t per boundary per scrape: "
        f"{ {b: [round(float(x), 4) for x in traj[:, b]] for b in range(traj.shape[1])} }")
    log(f"[{tag}] sim R_t == live R_t (np.array_equal) on all "
        f"{len(outputs)} scrapes; the net-aware cap bound on {capped} of "
        f"them")
    log(f"[{tag}] controller_update host time over {len(upd_ms)} ticks: "
        f"median {med:.4f} ms, p95 {p95:.4f} ms, max {max(upd_ms):.4f} ms")
    log(f"[{tag}] {calls['prefill']} prefill calls, {calls['decode']} decode "
        f"steps; K1 {launches['flash_attention']}, K2 "
        f"{launches['decode_attention']}, K3 "
        f"{launches['paged_decode_attention']} launches")
    for t in [KERNEL_TAGS[k] for k in need]:
        log(f"[{tag}] {t} shapes -> launches: "
            f"{ {str(k): v for k, v in sorted(shapes.get(t, {}).items())} }")
    if eq1 != "window":
        return launches, summary

    # one decode step per tier, every slot resident (the edge's rows fit
    # its pages: 8 x 10 of 128)
    rng = np.random.default_rng(5)
    summary["step_device_ms"] = {}
    for tier in cc.tiers:
        if time_tiers is not None and tier.name not in time_tiers:
            continue
        ep = tier.endpoints["stablelm"]
        prompts = {}
        while ep.active < ep.slots:
            toks = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
            slot = (ep.try_claim(tokens=toks, max_new=max_new) if ep.paged
                    else ep.try_claim())
            if slot is None:                # pages held by the registry
                break
            prompts[slot] = toks
        summary["step_device_ms"][tier.name] = _step_device(
            ep, prompts, card, tag, f"tier {tier.name}"
            f"{' (paged)' if ep.paged else ''}")[1]
    return launches, summary


def sketch_chain(cfg, params, card: str, window_summary: dict) -> dict:
    """Phase 5i: phase 5f's chain again with ``eq1="sketch"`` (the
    controller reads Eq (1) from decayed histograms fed each scrape's
    fresh samples), held to the same checks, its summary printed beside
    5f's; then the sketch tick alone on the host at F = 1024 and 4096
    (one boundary, window 64), beside the window tick at the same F."""
    launches, summary = serve_chain(cfg, params, {}, card, eq1="sketch")
    log(f"[5i] beside 5f: " + json.dumps({"5f window": window_summary,
                                         "5i sketch": summary}))
    import numpy as np
    from repro_torch.core.policy import ControlLoop
    rng = np.random.default_rng(0)
    for F in (1024, 4096):
        times = {}
        for eq1 in ("sketch", "window"):
            loop = ControlLoop("auto", F, window=64, eq1=eq1)
            ms = []
            for t in range(23):
                ids = rng.integers(0, F, F)
                vals = rng.gamma(2.0, 0.05, F).astype(np.float32)
                if eq1 == "sketch":
                    t0 = time.perf_counter()
                    loop.step_stream([(ids, vals)], arrivals=[np.ones(F)])
                else:
                    lat = rng.gamma(2.0, 0.05, (F, 64)).astype(np.float32)
                    valid = np.ones((F, 64), bool)
                    t0 = time.perf_counter()
                    loop.step(lat, valid, arrivals=np.ones(F))
                if t >= 3:
                    ms.append(1e3 * (time.perf_counter() - t0))
            times[eq1] = (statistics.median(ms),
                          float(np.percentile(ms, 95)))
        log(f"[5i] host tick at F={F}, one boundary, W=64, F samples a "
            f"tick: sketch median {times['sketch'][0]:.3f} ms p95 "
            f"{times['sketch'][1]:.3f} ms; window median "
            f"{times['window'][0]:.3f} ms p95 {times['window'][1]:.3f} ms "
            f"(20 ticks after 3; host clock; {card})")
    return launches


def faas_bodies(card: str) -> None:
    """Phase 5g: the paper's four FaaS bodies on the card, each against
    its CPU run on the same drawn tensors, timed with CUDA events."""
    import torch
    from repro_torch.core import workloads as wl
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    a, b = wl.draw_matmult(256, g, dev)
    img = wl.draw_image(128, g, dev)
    idx = wl.draw_io(1 << 16, g, dev)
    ma, mb = wl.draw_matmult(128, g, dev)
    mimg = wl.draw_image(128, g, dev)
    midx = wl.draw_io(128 * 128, g, dev)
    cases = (("matmult n=256", wl.matmult_body, (a, b)),
             ("image_proc 128", wl.image_proc_body, (img,)),
             ("random_io 2^16", wl.random_io_body, (idx, 1 << 16)),
             ("mixed 128", wl.mixed_body, (ma, mb, mimg, midx)))
    tol = dict(rtol=1e-4, atol=1e-4)
    for name, fn, args in cases:
        got = fn(*args)
        want = fn(*[x.cpu() if torch.is_tensor(x) else x for x in args])
        if not torch.isfinite(got) or not torch.allclose(got.cpu(), want,
                                                         **tol):
            raise RuntimeError(f"FaaS body {name}: card {got.item()} vs "
                               f"CPU {want.item()}")
        for _ in range(3):
            fn(*args)
        times = []
        for _ in range(20):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        log(f"[faas] {name}: card {got.item():.6g} CPU {want.item():.6g} "
            f"(rtol 1e-4, atol 1e-4), {statistics.median(times):.4f} ms a "
            f"call (CUDA events, median of 20; {card})")


def sim_sweep() -> None:
    """The paper's Table 2 row for matmult, on the host."""
    from repro_torch.platform import Continuum
    t0 = time.perf_counter()
    res = Continuum.sweep("matmult", (0.0, 25.0, 50.0, 75.0, 100.0, "auto",
                                      "auto+net"))
    for pol, r in res.items():
        if r.successes + r.failures != r.submitted or r.submitted <= 0:
            raise RuntimeError(f"sweep {pol}: not conserved")
    log(f"[sweep] matmult successes/failures per policy: "
        f"{ {p: (r.successes, r.failures) for p, r in res.items()} } "
        f"({time.perf_counter() - t0:.1f}s on the host)")


# ---------------------------------------------------------------- phase 5h

# the keeper has 9 tokens left when the row migrates (the longest-running
# of the two goes: ceil(2 x 50 %) = 1) and 1 a tick later, too few to
# migrate itself (``migrate_min_remaining`` = 2)
MIG_MAX_NEW, MIG_KEEP_NEW, MIG_STEPS = 32, 18, 8
MIG_LINK = (0.04, 100e6)            # Topology.device_edge_cloud's 2nd link


def _migration_topology(slots: int, max_len: int, paged: dict):
    """Two tiers of one shape (the same slots, ``max_len`` and page
    layout) over the 40 ms / 100 MB/s link: a row decodes at the same
    batch on both sides, so K2/K3 split it alike and cuBLAS picks the same
    GEMMs, and the migrated stream can be held bitwise."""
    from repro_torch.platform import LinkSpec, TierSpec, Topology
    return Topology(
        (TierSpec("edge", slots=slots, max_len=max_len, **paged),
         TierSpec("cloud", slots=slots, max_len=max_len, **paged)),
        (LinkSpec(rtt_s=MIG_LINK[0], bandwidth_Bps=MIG_LINK[1]),),
        waterfall=False)


def _migration_run(tag, cfg, params, topo, prompts, migrate: bool):
    """Serve ``prompts`` (rid -> (tokens, max_new)) on ``topo``'s edge:
    every arrival stays at the ingress while R_t = 50, one tick of
    ``MIG_STEPS`` decode steps, then (``migrate``) the threshold drops to
    50 and the tier ships its longest-running row over the link.  Ticks
    to the end, holding the migration identity after every tick.
    Returns the requests, the continuum and what the row transfer did."""
    import torch
    from repro_torch.platform import (Continuum, FunctionSpec, Request,
                                      StaticSplit)

    class HoldThenMigrate(StaticSplit):
        def __init__(self):
            super().__init__(50.0)
            self.migrate_threshold = None

        def tier_distribution(self, R_all, num_tiers):
            d = super().tier_distribution(R_all, num_tiers)
            d[:] = 0.0
            d[:, 0] = 100.0
            return d

    pol = HoldThenMigrate()
    cc = Continuum.from_topology(topo, policy=pol, seed=0, device="cuda",
                                 max_steps_per_tick=MIG_STEPS)
    cc.deploy(FunctionSpec(name=tag, arch=cfg.name), cfg, params)
    src, dst = (t.endpoints[tag] for t in cc.tiers)
    moved = {}
    extract, insert = src.extract_rows, dst.insert_rows

    def timed_extract(slots):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = extract(slots)
        torch.cuda.synchronize()
        moved.update(extract_ms=1e3 * (time.perf_counter() - t0),
                     t_fire=time.perf_counter(), rows=out)
        return out

    def timed_insert(rows, slots, positions):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert(rows, slots, positions)
        torch.cuda.synchronize()
        moved.update(insert_ms=1e3 * (time.perf_counter() - t0),
                     landed_s=time.perf_counter() - moved["t_fire"])
    src.extract_rows, dst.insert_rows = timed_extract, timed_insert

    reqs = {}
    for rid, (toks, max_new) in prompts.items():
        reqs[rid] = Request(rid=rid, tokens=toks, max_new=max_new)
        if not cc.submit(tag, reqs[rid]):
            raise RuntimeError(f"5h {tag}: request {rid} rejected")
    cc.tick()
    if migrate:
        pol.migrate_threshold = 50.0        # R_t (50) reaches it now
    for _ in range(64):
        rec = cc.tick()
        c = cc.metrics.counter
        if c("migrations_fired") != (c("migrations_completed")
                                     + c("migrations_aborted")
                                     + cc.migrations_open):
            raise RuntimeError(f"5h {tag}: migration identity broken at "
                               f"tick {len(cc.log)}: {rec}")
        if cc.queued == 0 and cc.in_flight == 0:
            break
    else:
        raise RuntimeError(f"5h {tag}: not drained after 64 ticks")
    torch.cuda.synchronize()
    return reqs, cc, moved


def migration_case(tag, label, cfg, params, slots, max_len, paged, card,
                   kernels, cross_tick=True) -> dict:
    """One bitwise case of phase 5h: a ``MIG_MAX_NEW``-token request on a
    512-token prompt served alone and unmigrated, then the same request
    beside a shorter keeper (256-token prompt, ``MIG_KEEP_NEW`` tokens,
    which keeps the source decoding to the step cap, so the transfer
    lands a tick later),
    migrated after ``MIG_STEPS`` decode steps.  Fails unless the ids are
    equal at every step, exactly one migration completed (landing on a
    later tick than it fired, with ``cross_tick``), ``link_bytes`` grew
    by the row's live cache bytes + 4 B a token (whole pages when paged),
    and ``kernels`` launched and nothing else did."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    topo = _migration_topology(slots, max_len, paged)
    rng = np.random.default_rng(21)
    main = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    keeper = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo, _, _ = _migration_run(tag, cfg, params, topo,
                                {0: (main, MIG_MAX_NEW)}, migrate=False)
    reqs, cc, moved = _migration_run(
        tag, cfg, params, topo,
        {0: (main, MIG_MAX_NEW), 1: (keeper, MIG_KEEP_NEW)}, migrate=True)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)

    want, got = solo[0].output, reqs[0].output
    same = int((got == want).sum()) if got is not None else 0
    c = cc.metrics.counter
    if (got is None or got.shape != (MIG_MAX_NEW,)
            or not np.array_equal(got, want)):
        raise RuntimeError(f"5h {label}: migrated ids {got} != unmigrated "
                           f"{want} ({same}/{MIG_MAX_NEW} equal)")
    if (c("migrations_completed"), c("migrations_aborted")) != (1, 0):
        raise RuntimeError(f"5h {label}: {dict(cc.metrics.counters)}")
    if reqs[1].output is None or reqs[1].output.shape != (MIG_KEEP_NEW,):
        raise RuntimeError(f"5h {label}: keeper {reqs[1].output}")
    fired = [i for i, r in enumerate(cc.log) if r["migrations_fired"]]
    landed = [i for i, r in enumerate(cc.log) if r["migrated"]]
    if fired != [1] or not landed or (cross_tick and landed[0] <= 1):
        raise RuntimeError(f"5h {label}: fired at ticks {fired}, landed "
                           f"at {landed}: the landing did not cross a tick")
    ep = cc.tiers[0].endpoints[tag]
    pos = 512 + MIG_STEPS
    tail = 4.0 * (512 + 1 + MIG_STEPS)
    cache = ep.cache_nbytes_per_row(pos)
    if cc.link_bytes[0] != cache + tail:
        raise RuntimeError(f"5h {label}: link_bytes {cc.link_bytes[0]} != "
                           f"{cache} + {tail}")
    [row] = moved["rows"]
    if paged:
        page = ep.page_size
        if (row.n_pages != -(-pos // page) or row.nbytes != cache
                or cache != ep.cache_nbytes_per_row(row.n_pages * page)):
            raise RuntimeError(f"5h {label}: shipped {row.n_pages} pages, "
                               f"{row.nbytes} B for position {pos}")
        shipped = f"{row.n_pages} pages of {page}"
    else:
        shipped = (f"{sum(l.numel() * l.element_size() for l in row.values())}"
                   f" B of cloned leaves ({', '.join(sorted(row))})")
    if min(launches[k] for k in kernels) <= 0 or any(
            n for k, n in launches.items() if k not in kernels):
        raise RuntimeError(f"5h {label}: launches {launches}")
    transfer = cc.topology.links[0].latency_s(cache + tail)
    log(f"[5h] ({label}) ids equal at all {MIG_MAX_NEW} steps "
        f"({same}/{MIG_MAX_NEW}); row at position {pos}: {cache:.0f} B "
        f"cache + {tail:.0f} B tokens = {cache + tail:.0f} B on link 0 "
        f"({shipped}); link time {transfer:.4f} s (40 ms + bytes / 100 "
        f"MB/s), fired tick {fired[0]} landed tick {landed[0]} after "
        f"{moved['landed_s']:.4f} s wall; extract_rows "
        f"{moved['extract_ms']:.3f} ms, insert_rows "
        f"{moved['insert_ms']:.3f} ms (host clock around a synchronize); "
        f"phase wall {wall:.2f} s; launches {launches} ({card})")
    return launches


def live_controls(cfg, params, card: str) -> dict:
    """Phase 5h (d): phase 5f's chain with the edge and the cloud paged,
    under ``"auto+net+hedge+migrate"``, step-capped ticks, 5f's bursty
    trace, a brownout of link 0 (``faults=``) and an edge outage applied
    through ``apply_fault`` at the first tick from 8 on where the edge
    holds residents, lifted three ticks later.  Short latencies recorded
    at the ingress before the burst seed hedges.  Fails unless served +
    failed == submitted, both accounting identities hold after every
    tick, at least two faults applied and one request replayed, and K1,
    K2 and K3 launched (and nothing else)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec, TierSpec, Topology,
                                      edge_brownout, merge_schedules,
                                      tier_outage)
    max_len = 1024
    base = _chain_topology(max_len)
    topo = Topology((base.tiers[0], base.tiers[1],
                     TierSpec("cloud", slots=16, max_len=max_len,
                              page_size=16, queue_depth_per_slot=None)),
                    base.links, waterfall=True)
    trace = _chain_trace(cfg.vocab_size)
    brownout = edge_brownout(4.0, 20.0, link=0)
    cc = Continuum.from_topology(topo, policy="auto+net+hedge+migrate",
                                 req_bytes=CHAIN_REQ_BYTES, trace=trace,
                                 trace_vocab=cfg.vocab_size, seed=0,
                                 device="cuda", max_steps_per_tick=4,
                                 faults=brownout)
    cc.deploy(FunctionSpec(name="stablelm", arch="stablelm-1.6b",
                           autoscaling=AutoscalingPolicy()), cfg, params)
    gates = [cc.tiers[b].endpoints["stablelm"].compatible_with(
        cc.tiers[b + 1].endpoints["stablelm"]) for b in range(2)]
    if gates != [False, True]:
        raise RuntimeError(f"5h chain: compatibility gates {gates}")
    outage, crashed_with = None, 0
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while True:
        if tick == 7:
            # a window of short samples at the ingress: its p99 drops
            # below the age of every request left waiting a tick
            for _ in range(cc.window):
                cc.edge.metrics.record_latency("stablelm", 0.001)
        if outage is None and tick >= 8 and cc.tiers[1].inflight_count(
                "stablelm") > 0:
            crashed_with = cc.tiers[1].inflight_count("stablelm")
            outage = tier_outage(cc._clock, cc._clock + 3.0, tier=1)
        if outage is not None:
            for ev in outage.due(cc._clock):
                cc.apply_fault(ev)
        done = tick >= int(math.ceil(trace.duration_s))
        if done and cc.queued == 0 and cc.in_flight == 0 and (
                outage is None or outage.exhausted):
            break
        rec = cc.tick()
        tick += 1
        c = cc.metrics.counter
        if cc.hedges_open < 0 or c("migrations_fired") != (
                c("migrations_completed") + c("migrations_aborted")
                + cc.migrations_open):
            raise RuntimeError(f"5h chain: an accounting identity broke at "
                               f"tick {tick}: {dict(cc.metrics.counters)}")
        log(f"[5h] chain tick={tick - 1} served={rec['tiers']} "
            f"hedged={rec['hedged']} won={rec['hedges_won']} "
            f"cancelled={rec['hedges_cancelled']} "
            f"migrations_fired={rec['migrations_fired']} "
            f"migrated={rec['migrated']} aborted={rec['migrations_aborted']} "
            f"inflight={rec['inflight']} backlog={rec['backlog']} "
            f"rejected={rec['rejected']} tier_up={cc.tier_up} "
            f"R_t={rec['R']:.2f}")
        if tick > 200:
            raise RuntimeError("5h chain: not drained after 200 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)

    reqs = cc.trace_requests
    c = cc.metrics.counter
    served = {t.name: sum(r["tiers"][t.name] for r in cc.log)
              for t in cc.tiers}
    failed = sum(r.failed for r in reqs)
    if len(reqs) != len(trace) or sum(served.values()) + failed != len(reqs):
        raise RuntimeError(f"5h chain: served {served} + failed {failed} "
                           f"!= submitted {len(reqs)}")
    for r in reqs:
        if not r.failed and (r.output is None or r.output.shape != (32,)):
            raise RuntimeError(f"5h chain: request {r.rid} {r.output}")
    if cc.hedges_open or cc.migrations_open:
        raise RuntimeError(f"5h chain: open after drain: "
                           f"{dict(cc.metrics.counters)}")
    if c("faults_applied") < 2 or c("replayed") < 1:
        raise RuntimeError(f"5h chain: faults {dict(cc.metrics.counters)}")
    need = ("flash_attention", "decode_attention", "paged_decode_attention")
    if min(launches[k] for k in need) <= 0 or any(
            n for k, n in launches.items() if k not in need):
        raise RuntimeError(f"5h chain: launches {launches}")
    script = merge_schedules(brownout, outage)
    log(f"[5h] (d) chain: submitted {len(reqs)} served {served} failed "
        f"{failed}; faults {script} ({int(c('faults_applied'))} applied; "
        f"the edge crashed holding {crashed_with} residents, "
        f"{int(c('replayed'))} replayed); hedges fired "
        f"{int(c('hedges_fired'))} won {int(c('hedges_won'))} cancelled "
        f"{int(c('hedges_cancelled'))}; migrations fired "
        f"{int(c('migrations_fired'))} completed "
        f"{int(c('migrations_completed'))} aborted "
        f"{int(c('migrations_aborted'))} (R_t follows wall-clock "
        f"latencies, so these counts move between runs); link MB "
        f"{[round(b / 1e6, 4) for b in cc.link_bytes]}; {len(cc.log)} "
        f"ticks, phase wall {wall:.2f} s; launches {launches} ({card})")
    return launches


def migration_hymba(cfg, params, card: str) -> dict:
    """Phase 5h (c) on phase 5d's hymba weights: the row carries the
    global layers' KV, the window layers' KV and the SSM h/conv state;
    prefill through K1 and K5, decode through K2.  Its transfer (about
    half a stablelm row's) may land within the tick that fired it."""
    return migration_case("hymba", "c: dense -> dense, hymba", cfg, params,
                          16, RECURRENT_MAX_LEN, {}, card,
                          ("flash_attention", "decode_attention",
                           "ssd_scan"), cross_tick=False)


def migration_rwkv6(cfg, params, card: str) -> dict:
    """Phase 5h (e) on phase 5e's rwkv6 weights: the row is the WKV state
    and two token shifts of 32 layers, 34,078,720 B at every position;
    prefill through K4, decode the O(1) step (no kernel)."""
    return migration_case("rwkv6", "e: dense -> dense, rwkv6", cfg, params,
                          16, RECURRENT_MAX_LEN, {}, card, ("rwkv6_scan",),
                          cross_tick=False)


def migration_phase(cfg, params, card: str) -> dict:
    """Phase 5h on phase 5's stablelm weights: cases (a), (b) and (d)."""
    total: dict = {}
    for part in (
            migration_case("stablelm", "a: dense -> dense, stablelm", cfg,
                           params, 16, 1024, {}, card,
                           ("flash_attention", "decode_attention")),
            migration_case("stablelm", "b: paged -> paged, stablelm", cfg,
                           params, 8, 1024,
                           dict(page_size=16, pool_pages=128), card,
                           ("flash_attention", "paged_decode_attention")),
            live_controls(cfg, params, card)):
        for k, n in part.items():
            total[k] = total.get(k, 0) + n
    return total


def serve_hymba(cfg, params, shapes: dict, card: str) -> dict:
    """Phase 5d: the hymba main path; its K2 must read both cache widths
    (the 1024-wide rolling window and the 2048-wide global layers)."""
    nparams = sum(p.numel() for p in params.values())
    log(f"[hymba] hymba-1.5b full width: {cfg.num_layers} layers "
        f"(global {cfg.global_layers}, window {cfg.sliding_window}), "
        f"d={cfg.d_model}, heads={cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim={cfg.head_dim}, d_ff={cfg.d_ff}, "
        f"ssm I={cfg.ssm_d_inner} N={cfg.ssm_state}, vocab={cfg.vocab_size}, "
        f"{nparams / 1e9:.3f}B params bf16")
    launches = serve_two_tier(
        "hymba", cfg, params, shapes, card,
        ("flash_attention", "decode_attention", "ssd_scan"),
        RECURRENT_ROUNDS, SCAN_PROMPTS, RECURRENT_MAX_LEN, 11,
        RECURRENT_LONG_RIDS, "ssd_scan", ("h", "conv"))
    widths = {k[1][1] for k in shapes["K2"]}
    if widths != {cfg.sliding_window, RECURRENT_MAX_LEN}:
        raise RuntimeError(f"hymba: K2 read caches of widths {widths}")
    return launches


def serve_rwkv6(cfg, params, shapes: dict, card: str) -> dict:
    """Phase 5e: the rwkv6 main path, prefill through K4 alone, decode
    through the O(1) recurrence (no kernel)."""
    nparams = sum(p.numel() for p in params.values())
    log(f"[rwkv6] rwkv6-7b full width: {cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_rwkv_heads} heads of "
        f"{cfg.rwkv_head_dim}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
        f"{nparams / 1e9:.3f}B params bf16")
    return serve_two_tier("rwkv6", cfg, params, shapes, card,
                          ("rwkv6_scan",), RECURRENT_ROUNDS, SCAN_PROMPTS,
                          RECURRENT_MAX_LEN, 13, RECURRENT_LONG_RIDS,
                          "rwkv6_scan", ("tm_x", "tm_s", "cm_x"))


# ---------------------------------------------------------------- 5l, 5m

PAGED_HYMBA_KERNELS = ("flash_attention", "decode_attention",
                       "paged_decode_attention", "ssd_scan")
# 5l (a): 24 prompts of the scan rule's lengths, two of 1024 tokens
PAGED_HYMBA_LENGTHS = (64, 128, 256, 384, 512, 1024, 128, 256, 64, 512,
                       384, 128, 256, 64, 512, 384, 1024, 128, 256, 512,
                       64, 384, 128, 256)


def serve_hymba_paged(cfg, params, card: str, shapes: dict) -> dict:
    """Phase 5l on phase 5d's hymba weights: full-width hymba-1.5b on a
    paged tier, its 3 global layers' KV in the page pool (K3), its 29
    window layers' rolling rows and every layer's SSM state per slot
    (K2).  (a) paged == dense through 5b's schedule at max_len 2048, two
    1024-token prompts wrapping the window rows; (b) 5d's 2-tier
    continuum with both tiers paged and function-prompt traffic (16
    requests, prefix hits); (c) a paged row migrated mid-stream == the
    unmigrated one, the link carrying its ``PagedRow`` bytes + 4 B a
    token.  Returns the launches of all three."""
    from repro_torch.platform import LinkSpec, TierSpec, Topology
    total: dict = {}
    t0 = time.perf_counter()
    parts = [paged_vs_dense(cfg, params, card, shapes, "5l",
                            max_len=RECURRENT_MAX_LEN,
                            lengths=PAGED_HYMBA_LENGTHS,
                            want=PAGED_HYMBA_KERNELS)]
    free_card("5l (a)")
    page = dict(max_len=RECURRENT_MAX_LEN, page_size=16)
    topo = Topology((TierSpec("edge", slots=2, **page),
                     TierSpec("cloud", slots=16, extra_latency_s=0.02,
                              queue_depth_per_slot=None, **page)),
                    (LinkSpec(rtt_s=0.0),), waterfall=False)
    parts.append(serve_paged(cfg, params, shapes, "5l", topo,
                             per_round=(1, 2, 2, 2, 3, 3, 3),
                             fn_lengths=(128, 256, 384, 512),
                             lengths=SCAN_PROMPTS,
                             kernels=PAGED_HYMBA_KERNELS))
    free_card("5l (b)")
    parts.append(migration_case(
        "hymba", "5l c: paged -> paged, hymba", cfg, params, 16,
        RECURRENT_MAX_LEN, dict(page_size=16), card, PAGED_HYMBA_KERNELS,
        cross_tick=False))
    for part in parts:
        for k, n in part.items():
            total[k] = total.get(k, 0) + n
    log(f"[5l] phase wall {time.perf_counter() - t0:.2f} s; launches "
        f"{total} ({card})")
    return total


def serve_costed_chain(cfg, params, card: str, outputs: dict) -> dict:
    """Phase 5m on phase 5's stablelm weights: the cost-priced chain
    ``Topology.device_edge_cloud(cost_model=True, max_len=1024)``,
    resolved on the H100 SXM5 record (stablelm-1.6b on the device,
    qwen2.5-14b on a (1, 2) edge mesh, llama3-405b on a (16, 16) cloud
    mesh), served live by full-width stablelm-1.6b through
    ``Continuum.from_topology`` with 5f's trace, ``"auto+net"`` and links.
    The two meshes deploy unsharded on the one card with the reference's
    warning.  The same checks as 5f (conservation, K1 and K2 launched and
    nothing else, sim R_t == live R_t on every scrape), then the device
    tier's decode step at its priced slot count: its device time beside
    the priced ``decode_step_ms``.  ``outputs`` receives the served ids
    by rid."""
    from repro_torch.launch import tier_cost
    from repro_torch.platform import Topology
    topo = Topology.device_edge_cloud(cost_model=True, max_len=1024)
    for spec in topo.tiers:
        c = tier_cost.tier_cost(spec.model, mesh_shape=spec.mesh_shape,
                                requested_slots=spec.slots,
                                max_len=spec.max_len)
        r = c.roofline
        log(f"[5m] tier {spec.name}: {spec.model} on mesh "
            f"{spec.mesh_shape} ({c.devices} devices): priced slots "
            f"{spec.slots} (KV fit {c.kv_fit_slots}), decode_step_ms "
            f"{spec.decode_step_ms!r}, service_rate_mult "
            f"{spec.service_rate_mult!r}, dominant {r['dominant']} "
            f"(compute {1e3 * r['compute_s']:.6f} ms, memory "
            f"{1e3 * r['memory_s']:.6f} ms, collective "
            f"{1e3 * r['collective_s']:.6f} ms), per device: params "
            f"{c.params_bytes_per_device:.0f} B, KV row "
            f"{c.kv_row_bytes_per_device:.0f} B, HBM traffic "
            f"{r['bytes_per_device']:.0f} B a step")
    launches, summary, _ = _costed_chain(cfg, params, card, topo, "5m", 1,
                                         outputs, time_tiers=("device",))
    dev = topo.tiers[0]
    measured = summary["step_device_ms"]["device"]
    log(f"[5m] device tier decode step of {dev.slots} rows: device time "
        f"{measured:.4f} ms measured, {dev.decode_step_ms:.6f} ms priced "
        f"(roofline on the H100 SXM5 record), measured / priced "
        f"{measured / dev.decode_step_ms:.3f} ({card})")
    return launches


def _costed_chain(cfg, params, card: str, topo, tag: str, forced: int,
                  outputs: dict, time_tiers=()) -> tuple:
    """``serve_chain`` over the costed ``topo`` under
    ``forced_devices(forced)``: the meshes wider than ``forced`` deploy
    unsharded, each with the reference's warning, and the others sharded.
    Returns its launches, summary and the launches by shard (None when
    ``forced`` is 1: nothing is sharded, and the attention stays as
    timed in 5m)."""
    import contextlib
    import warnings
    from repro_torch.launch import mesh as mesh_mod
    counting = shard_launches() if forced > 1 else contextlib.nullcontext()
    with warnings.catch_warnings(record=True) as caught, \
            mesh_mod.forced_devices(forced), counting as per:
        warnings.simplefilter("always")
        launches, summary = serve_chain(
            cfg, params, {}, card, topo=topo, tag=tag,
            need=("flash_attention", "decode_attention"),
            time_tiers=time_tiers, served_ids=outputs)
    meshes = [str(w.message) for w in caught
              if "deploying unsharded" in str(w.message)]
    wide = [s for s in topo.tiers if s.mesh_shape[0] * s.mesh_shape[1] > 1]
    if len(meshes) != sum(s.mesh_shape[0] * s.mesh_shape[1] > forced
                          for s in wide):
        raise RuntimeError(f"{tag}: unsharded-deploy warnings {meshes}")
    for m in meshes:
        log(f"[{tag}] warning: {m}")
    return launches, summary, per


def serve_costed_chain_tp(cfg, params, card: str, outputs_5m: dict) -> dict:
    """Phase 5n (b): 5m's chain again under ``forced_devices(2)``: the
    edge's (1, 2) mesh deploys as two shards on the one card, the cloud's
    (16, 16) unsharded with the warning.  5m's checks (conservation, K1
    and K2 alone, sim R_t == live R_t on every scrape), and both edge
    shards must launch K1 and K2; prints the share of requests whose ids
    equal 5m's."""
    from repro_torch.platform import Topology
    topo = Topology.device_edge_cloud(cost_model=True, max_len=1024)
    outputs: dict = {}
    launches, summary, per = _costed_chain(cfg, params, card, topo, "5n",
                                           2, outputs)
    import numpy as np
    per.check("5n (b) edge", 2, ("flash_attention", "decode_attention"))
    both = sorted(set(outputs) & set(outputs_5m))
    same = sum(np.array_equal(outputs[r], outputs_5m[r]) for r in both)
    log(f"[5n] (b) the edge's shards launched {per.counts}; served "
        f"{summary['served']}, rejected {summary['rejected']}; ids equal to "
        f"5m's for {same} of the {len(both)} requests both served "
        f"({100 * same / max(len(both), 1):.1f}%)")
    return launches


# ---------------------------------------------------------------- 5j, 5k

# the prompt lengths of phases 5j and 5k
MOE_PROMPTS = (64, 128, 256, 384, 512)
# 5j's 24 requests: phase 6 times K3 at its paged step's 16 rows over
# the live slots of its cloud's 16-row decode batch, which fewer
# requests do not fill
MOE_ROUNDS = (2, 3, 4, 5, 5, 5)


def _describe(tag: str, cfg, params) -> None:
    nparams = sum(p.numel() for p in params.values())
    moe = (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
           f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared "
           f"({cfg.shared_d_ff}), {cfg.active_param_count() / 1e9:.3f}B "
           f"active a token" if cfg.family == "moe" else "")
    log(f"[{tag}] {cfg.name} full width: {cfg.num_layers} layers, "
        f"d={cfg.d_model}, heads={cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim={cfg.head_dim}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}"
        f"{moe}, {nparams:,} params bf16 ({2 * nparams / 1e9:.2f} GB)")


def serve_moe(cfg, params, card: str) -> tuple:
    """Phase 5j: full-width qwen2-moe-a2.7b.  (a) the 2-tier continuum
    (edge 2 slots, cloud 16, max_len 1024, auto), 24 requests of 32 new
    tokens, prompts from ``MOE_PROMPTS``, K1 and K2 alone; (c) its cloud
    endpoint's 512-token prefill and 16-row decode step, device time by
    category (attention kernels, routed expert products, shared experts,
    routing / dispatch / combine glue, the rest); (b) paged == dense ids
    at every step over one fixed schedule.  Returns (the shapes of K1,
    K2 from (a) and K3 from (b), their launches)."""
    _describe("qwen2-moe", cfg, params)
    shapes: dict = {}
    launches = serve_two_tier(
        "qwen2-moe", cfg, params, shapes, card,
        ("flash_attention", "decode_attention"), MOE_ROUNDS,
        MOE_PROMPTS, 1024, 17)
    paged_shapes: dict = {}
    paged = paged_vs_dense(cfg, params, card, paged_shapes, "qwen2-moe")
    shapes["K3"] = paged_shapes["K3"]
    launches["paged_decode_attention"] = paged["paged_decode_attention"]
    return shapes, launches


def serve_qwen25(cfg, params, card: str, shapes: dict,
                 summary: dict) -> dict:
    """Phase 5k: full-width qwen2.5-14b (40 query heads over 8 kv heads at
    head_dim 128), 16 requests through 5j's 2-tier continuum, the same
    checks and the same cloud endpoint times (into ``summary``)."""
    _describe("qwen2.5", cfg, params)
    return serve_two_tier(
        "qwen2.5", cfg, params, shapes, card,
        ("flash_attention", "decode_attention"), (1, 1, 2, 2, 2, 2, 3, 3),
        MOE_PROMPTS, 1024, 19, summary=summary)


#: phase 5n (a)'s bf16 tolerance: the relative L2 error of a row's layer
#: update and of its layer-forced logits
TP_LOGIT_TOL = 2e-2
#: phase 5n (a)'s token-forced logits may drift at most this multiple of
#: the control's largest drift (the unsharded endpoint through K2's plain
#: version over the same steps): TP reorders K2's split and every column
#: product's sums, the control K2's alone
TP_CONTROL_MULT = 2.0


def _capture_logits(ep, sink: list) -> tuple:
    """Wrap ``ep``'s model functions so that every prefill and decode call
    appends its logits (float32, on the host) to ``sink``; returns the
    unwrapped pair."""
    prefill, decode = ep._prefill_fn, ep._decode_fn

    def p(params, tokens, lengths, cache):
        logits, cache = prefill(params, tokens, lengths, cache)
        sink.append(logits.float().cpu())
        return logits, cache

    def d(params, cache, tokens, t, active=None, **kw):
        logits, cache = decode(params, cache, tokens, t, active, **kw)
        sink.append(logits.float().cpu())
        return logits, cache

    ep._prefill_fn, ep._decode_fn = p, d
    return prefill, decode


def _step_logits(sink: list, prompts: dict) -> list:
    """The captured calls of one prefill of ``prompts`` (one call a length
    group, in ``Endpoint._prefill_groups``' order) and the decode steps
    after it, as one (slots, vocab) tensor a step."""
    by_len: dict = {}
    for slot, toks in prompts.items():
        by_len.setdefault(len(toks), []).append(slot)
    groups = [by_len[L] for L in sorted(by_len)]
    first = sink[0].new_empty((len(prompts), sink[0].shape[1]))
    for call, slots in zip(sink, groups):
        first[slots] = call[:len(slots)]
    return [first] + sink[len(groups):]


def _flips(run: list, ref_logits: list) -> torch.Tensor:
    """(step, row): where ``run``'s argmax differs from the reference's."""
    import torch
    return torch.stack([a.argmax(-1) != b.argmax(-1)
                        for a, b in zip(run, ref_logits)])


def _tp_stream(ep, prompts: dict, steps: int, forced=None) -> dict:
    """Prefill ``prompts`` into claimed slots, then ``steps`` decode steps
    fed the endpoint's own ids or, with ``forced`` (slot -> ids), the
    forced ids (teacher forcing).  Returns its ids by slot; the slots stay
    resident."""
    for _ in prompts:
        ep.try_claim()
    cur = ep.prefill_batch(prompts)
    ids = {s: [t] for s, t in cur.items()}
    for k in range(steps):
        if forced is not None:
            cur = {s: forced[s][k] for s in cur}
        cur = ep.decode_all(cur)
        for s, t in cur.items():
            ids[s].append(t)
    return ids


def _step_times(ep, card: str, label: str) -> dict:
    """One decode step of ``ep`` with every resident row stepping: wall
    (median of 8, after 3) and device time (profiler, mean of 8); the
    rows are released after."""
    toks = {s: 0 for s in range(ep.slots) if not ep.slot_free[s]}

    def step():
        nonlocal toks
        toks = ep.decode_all(toks)

    for _ in range(3):
        step()
    wall = _wall_ms(step, 8)
    dev = _device_ms(step, 8)[0]
    for s in list(toks):
        ep.release(s)
    log(f"[5n] {label}: decode step of {len(toks)} rows {wall:.3f} ms wall "
        f"(median), device time {dev:.4f} ms (profiler), busy share "
        f"{100 * dev / wall:.1f}% ({card})")
    return {"wall_ms": wall, "device_ms": dev}


def serve_qwen25_tp(cfg, params, card: str, shapes: dict,
                    k_summary: dict) -> dict:
    """Phase 5n (a), on 5k's weights: full-width qwen2.5-14b at tp 2 on
    the one card (two shards over ``forced_devices(2)``).  16 slots,
    max_len 1024, 16 prompts of 64-512 tokens, 32 new tokens.

    The unsharded endpoint runs greedily first: its ids, every step's
    logits and every decode step's residual stream layer by layer are
    kept.  The control runs the same endpoint again over the same
    prompts, fed those ids at every decode step (teacher forcing), with
    K2's plain version in K2's place: how far a reordering of one
    kernel's sums moves these logits over these steps.  Its step is
    timed.  Then the sharded endpoint, fed the same prompts and ids, runs
    three times: (1) token-forced, each step's logits against the
    unsharded ones (near ties and changed argmax printed); (2) also
    forced layer by layer (each decode layer reads the unsharded stream);
    (3) free-running (agreement of the greedy streams).  The phase fails
    unless every row's residual update at every decode layer and every
    row's layer-forced logits lie within ``TP_LOGIT_TOL`` relative L2 of
    the unsharded ones, and the token-forced logits within
    ``TP_CONTROL_MULT`` times the control's largest error.  Every shard
    must launch K1 and K2, and nothing else may run.  Prints the bytes
    gathered a step and both decode steps beside 5k's.  Returns the
    sharded runs' launches (``shapes`` gets their K1, K2 shapes)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model_zoo
    from repro_torch.serving import sharded
    from repro_torch.serving.engine import Endpoint
    slots, max_len, max_new = 16, 1024, 32
    rng = np.random.default_rng(29)
    prompts = {s: rng.integers(0, cfg.vocab_size, int(rng.choice(
        MOE_PROMPTS))).astype(np.int32) for s in range(slots)}
    log(f"[5n] (a) qwen2.5-14b tp 2 on one card: {slots} slots, max_len "
        f"{max_len}, prompt lengths {[len(p) for p in prompts.values()]}")

    def rel(a, b):
        return ((a.float() - b.float()).norm(dim=-1)
                / b.float().norm(dim=-1))

    # the unsharded endpoint, greedy, its decode streams layer by layer
    family = model_zoo._FAMILIES["dense"]
    streams: list = []                      # step -> [(x_in, x_out)]

    def recorded(cfg_, p, x, positions, cache, mode, rows, rope, paging,
                 layer_idx):
        out = family.layer_fn(cfg_, p, x, positions, cache, mode, rows,
                              rope, paging, layer_idx)
        if mode == "decode":
            if layer_idx == 0:
                streams.append([])
            streams[-1].append((x, out))
        return out

    ep = Endpoint(cfg, params, slots=slots, max_len=max_len)
    sink: list = []
    plain = _capture_logits(ep, sink)
    model_zoo._FAMILIES["dense"] = family._replace(layer_fn=recorded)
    try:
        want = _tp_stream(ep, prompts, max_new - 1)
    finally:
        model_zoo._FAMILIES["dense"] = family
    ep._prefill_fn, ep._decode_fn = plain
    ref_logits = _step_logits(sink, prompts)
    forced_ids = {s: v[:-1] for s, v in want.items()}
    # the control: the same steps token-forced through K2's plain version
    for s in range(slots):
        ep.release(s)
    sink = []
    plain = _capture_logits(ep, sink)
    k2 = ops.decode_attention
    ops.decode_attention = ref.decode_attention
    try:
        _tp_stream(ep, prompts, max_new - 1, forced=forced_ids)
    finally:
        ops.decode_attention = k2
        ep._prefill_fn, ep._decode_fn = plain
    control = torch.stack([rel(a, b) for a, b in
                           zip(_step_logits(sink, prompts), ref_logits)])
    if control.shape != (max_new, slots):
        raise RuntimeError("5n (a): the control took other steps")
    times = {"unsharded": _step_times(ep, card, "unsharded endpoint")}
    del ep, sink
    free_card("5n (a) unsharded endpoint")

    # the sharded endpoint: token-forced, layer-forced, free-running
    forcing = {"on": False, "step": -1}
    layer_errs: list = []
    tp_layer = sharded._tp_layer

    def forced(devices, cfg_, p, x, positions, cache, mode, rows=None,
               rope=None, paging=None, layer_idx=None):
        if not (forcing["on"] and mode == "decode"):
            return tp_layer(devices, cfg_, p, x, positions, cache, mode,
                            rows, rope, paging, layer_idx)
        if layer_idx == 0:
            forcing["step"] += 1
        x_in, x_out = streams[forcing["step"]][layer_idx]
        out = tp_layer(devices, cfg_, p, x_in, positions, cache, mode, rows,
                       rope, paging, layer_idx)
        layer_errs.append(rel((out - x_in).flatten(1),
                              (x_out - x_in).flatten(1)))     # per row
        return x_out

    gathered = []
    gather = sharded._gather

    def counted_gather(pieces, dim, device):
        out = gather(pieces, dim, device)
        gathered.append((dim, out.numel() * out.element_size()))
        return out

    ops.reset_launches()
    sharded._tp_layer = forced
    try:
        with mesh_mod.forced_devices(2), shard_launches() as per, \
                recording(shapes):
            ep = Endpoint(cfg, params, slots=slots, max_len=max_len,
                          mesh=mesh_mod.make_mesh((1, 2), ("data", "model")))
            log(f"[mem] 5n (a) sharded endpoint built: "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
            sinks = ([], [])
            for sink, on in zip(sinks, (False, True)):
                plain = _capture_logits(ep, sink)
                forcing["on"] = on
                try:
                    tf = _tp_stream(ep, prompts, max_new - 1,
                                    forced=forced_ids)
                finally:
                    forcing["on"] = False
                    ep._prefill_fn, ep._decode_fn = plain
                if not on:
                    sharded._gather = counted_gather   # one more step
                    try:
                        ep.decode_all({s: 0 for s in range(slots)})
                    finally:
                        sharded._gather = gather
                for s in range(slots):
                    ep.release(s)
            free = _tp_stream(ep, prompts, max_new - 1)
            launches = dict(ops.launches)
            per.check("5n (a)", 2, ("flash_attention", "decode_attention"))
    finally:
        sharded._tp_layer = tp_layer
    if any(n for k, n in launches.items()
           if k not in ("flash_attention", "decode_attention")):
        raise RuntimeError(f"5n (a) ran a plain version: {launches}")
    token, layer = (_step_logits(sink, prompts) for sink in sinks)
    if len(token) != len(ref_logits) or len(layer) != len(ref_logits) or \
            len(layer_errs) != cfg.num_layers * (max_new - 1) or any(
                len(v) != max_new for v in (*tf.values(), *free.values())):
        raise RuntimeError("5n (a): the runs took different steps")
    top2 = torch.stack([b.topk(2, dim=-1).values for b in ref_logits])
    near = (top2[..., 0] - top2[..., 1]) < TP_LOGIT_TOL * top2[..., 0].abs()
    errs = {}
    for label, run in (("token-forced", token),
                       ("token- and layer-forced", layer),
                       ("control (unsharded, K2's plain version)", None)):
        e = control if run is None else torch.stack(
            [rel(a, b) for a, b in zip(run, ref_logits)])
        errs[label] = e
        flips = ("" if run is None else
                 f"; argmax changed at "
                 f"{int((_flips(run, ref_logits) & near).sum())} of the "
                 f"{int(near.sum())} near ties (unsharded top-2 gap < "
                 f"{TP_LOGIT_TOL} x the row's largest logit) and "
                 f"{int((_flips(run, ref_logits) & ~near).sum())} elsewhere")
        log(f"[5n] (a) {label} logits, relative L2 error per (row, step) "
            f"over {e.numel()}: max {e.max().item():.4e} (row "
            f"{int(e.max(0).values.argmax())}, step "
            f"{int(e.max(1).values.argmax())}), median "
            f"{e.median().item():.4e}, step 0 (prefill) max "
            f"{e[0].max().item():.4e}{flips}")
    lerr = torch.stack(layer_errs)                # (step x layer, row)
    log(f"[5n] (a) layer-forced: each row's residual update at each decode "
        f"layer, relative L2 over {lerr.numel()} (step, layer, row): max "
        f"{lerr.max().item():.4e}, median {lerr.median().item():.4e}; "
        f"tolerance {TP_LOGIT_TOL}")
    agree = np.mean([a == b for s in want for a, b in zip(want[s], free[s])])
    log(f"[5n] (a) free-running greedy streams: {100 * agree:.2f}% of "
        f"{slots * max_new} ids equal, "
        f"{sum(want[s] == free[s] for s in want)} of {slots} rows equal "
        f"throughout")
    log(f"[5n] (a) gathered a step (the embeddings, o, act, logits and "
        f"the row-parallel weights): "
        f"{sum(n for _, n in gathered)} B, of which weights "
        f"{sum(n for dim, n in gathered if dim == 0)} B ({cfg.num_layers} "
        f"layers x attn/wo + mlp/wo)")
    log(f"[5n] (a) launches by shard {per.counts}; K1 shapes "
        f"{ {str(k): v for k, v in sorted(shapes['K1'].items())} }, K2 "
        f"shapes { {str(k): v for k, v in sorted(shapes['K2'].items())} }")
    layered = max(errs["token- and layer-forced"].max().item(),
                  lerr.max().item())
    if not layered <= TP_LOGIT_TOL:
        raise RuntimeError(f"5n (a): a row's layer update or layer-forced "
                           f"logits off by {layered:.4e} in relative L2")
    drift, bound = (errs["token-forced"].max().item(),
                    TP_CONTROL_MULT * control.max().item())
    log(f"[5n] (a) token-forced logits max {drift:.4e} against "
        f"{TP_CONTROL_MULT} x the control's max = {bound:.4e}")
    if not drift <= bound:
        raise RuntimeError(f"5n (a): token-forced logits off by {drift:.4e}"
                           f", over {TP_CONTROL_MULT} x the control's max")
    times["sharded"] = _step_times(ep, card, "sharded endpoint (tp 2)")
    times["5k cloud endpoint"] = {"wall_ms": k_summary["decode"]["wall_ms"],
                                  "device_ms": k_summary["decode"][
                                      "device_ms"]}
    log(f"[5n] (a) decode step of 16 rows, beside 5k's: "
        f"{json.dumps(times)} ({card})")
    return launches


# ------------------------------------------------------- phases 4f and 5o

# phase 4f: the reference smoke test's optimizer (tests/test_archs.py:47-48)
TRAIN_SMOKE_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_SMOKE_STEPS = 3
# 4f's state gate, the CPU parity test's (tests/test_torch_train_loop.py):
# every element of params, mu, nu and err within 2 x peak lr x steps (a
# near-zero gradient rounded to the other sign, or across an int8 step of
# the compression, moves Adam's update by up to lr), 99.9 % within 1e-6
STATE_MAX = 2 * TRAIN_SMOKE_OPT["peak_lr"] * TRAIN_SMOKE_STEPS
STATE_TOL, STATE_SHARE = 1e-6, 0.999
# 5o's control: grad_norm of step 1 with K1 against the plain attention,
# relative; 5x the 3.8e-4 read on an H100 at 700 W.  The loss gate (2e-2)
# is a sanity check, not a kernel check: at random init the loss is about
# ln V whatever attention computes
CONTROL_GRAD_RTOL, CONTROL_LOSS_RTOL = 2e-3, 2e-2
# phase 5o's command line: full-width stablelm-1.6b, 4 x 2048-token
# microbatches (finding: the plain attention VJP's (B, Hq, S, T) float32
# transient decides the sequence length)
TRAIN_FULL_ARGS = ["--arch", "stablelm-1.6b", "--batch", "8", "--seq",
                   "2048", "--accum", "2", "--warmup", "2", "--steps", "6"]
TRAIN_SPANS = {"attention_vjp": "train.attention_vjp",
               "ce": "train.ce", "optimizer": "train.optimizer",
               "gather": "train.gather"}
_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)


def _train_kernels(cfg) -> dict:
    """The counted kernels a train step of ``cfg`` launches, and the
    layers that launch each: K1 in every attention layer, K4 in every
    rwkv6 layer, K5 in every hymba layer."""
    per = {"dense": ("flash_attention",), "moe": ("flash_attention",),
           "rwkv6": ("rwkv6_scan",),
           "hymba": ("flash_attention", "ssd_scan")}[cfg.family]
    return {k: cfg.num_layers for k in per}


class train_spy:
    """Within the block, every train step that ``make_train_step`` builds
    records its loss, ``grad_norm`` and the kernel launches it made
    (``steps``), and, given ``spans``, the attention VJP, the CE chunks,
    the optimizer (one-device or block by block) and the sharded step's
    weight gathers run under ``torch.profiler.record_function`` ranges
    (:data:`TRAIN_SPANS`; the package carries no profiling hooks)."""

    def __init__(self, spans: bool = False):
        from repro_torch import placement
        from repro_torch.kernels import ops
        from repro_torch.models import common
        from repro_torch.training import optimizer, train_loop
        self.steps: list = []
        self.targets = [(train_loop, "make_train_step", self._spy)]
        if spans:
            vjp = ops._FlashAttention.backward
            self.targets += [
                (ops._FlashAttention, "backward", staticmethod(
                    self._span(vjp, TRAIN_SPANS["attention_vjp"]))),
                (common, "_chunk_xent",
                 self._span(common._chunk_xent, TRAIN_SPANS["ce"])),
                (optimizer, "apply_updates",
                 self._span(optimizer.apply_updates,
                            TRAIN_SPANS["optimizer"])),
                (optimizer, "update_leaf",
                 self._span(optimizer.update_leaf,
                            TRAIN_SPANS["optimizer"])),
                (placement, "join",
                 self._span(placement.join, TRAIN_SPANS["gather"]))]
        self.saved = [m.__dict__[n] for m, n, _ in self.targets]
        self.make = train_loop.make_train_step

    @staticmethod
    def _span(fn, label):
        import torch

        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run

    def _spy(self, *a, **kw):
        from repro_torch.kernels import ops
        step = self.make(*a, **kw)

        def run(state, batch):
            before = dict(ops.launches)
            state, metrics = step(state, batch)
            self.steps.append({
                "loss": metrics["loss"].item(),
                "grad_norm": metrics["grad_norm"].item(),
                "launches": {k: n - before[k]
                             for k, n in ops.launches.items()}})
            return state, metrics
        run.__dict__.update(step.__dict__)     # the sharded step's traffic
        return run

    def __enter__(self):
        for m, name, fn in self.targets:
            setattr(m, name, fn)
        return self

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.targets, self.saved):
            setattr(m, name, fn)
        return False


def _check_step_launches(tag: str, cfg, tcfg, launches: dict) -> None:
    """Fail unless each counted kernel of ``cfg``'s train step launched
    layers x microbatches x (1 + remat) times and nothing else ran."""
    want = {k: n * tcfg.accum_steps * (1 + cfg.remat)
            for k, n in _train_kernels(cfg).items()}
    got = {k: n for k, n in launches.items() if n}
    if got != want:
        raise RuntimeError(f"{tag}: launches {got}, expected {want}")


def _state_parts(state) -> dict:
    return {"params": state.params, "mu": state.opt.mu,
            "nu": state.opt.nu, "err": state.err or {}}


def _state_gap(card, cpu) -> dict:
    """For each part of two train states (params, mu, nu, err), over all
    its elements: the largest |card - cpu| and the share within
    :data:`STATE_TOL`."""
    out = {}
    a, b = _state_parts(card), _state_parts(cpu)
    for part, leaves in a.items():
        worst, near, n = 0.0, 0, 0
        for k, v in leaves.items():
            d = (v.float() - b[part][k].to(v.device).float()).abs()
            worst = max(worst, d.max().item())
            near += int((d <= STATE_TOL).sum().item())
            n += d.numel()
        if n:
            out[part] = {"max": worst, "share": near / n}
    return out


def _copy_state(src, dst) -> None:
    """Overwrite train state ``dst`` in place with ``src``'s values."""
    into = _state_parts(dst)
    for part, leaves in _state_parts(src).items():
        for k, v in leaves.items():
            into[part][k].copy_(v)
    dst.opt.step.copy_(src.opt.step)


def train_smoke_on_card(card: str) -> dict:
    """Phase 4f: every smoke config but llama3-405b's (head_dim 8, which
    no kernel takes: its train step must raise on the card) trains 3
    steps on the card and on the CPU from the same parameters and
    batches (accum 2, int8 error-feedback compression), each step from
    the card's state on both: each step's loss and grad_norm within
    2e-5 abs / 2e-4 rel, the updated params, moments and error buffer
    within :data:`STATE_MAX` with :data:`STATE_SHARE` of each within
    :data:`STATE_TOL`, each counted kernel
    launched layers x microbatches x 2 (remat) times a step and no plain
    version.  Then the reference's resume test on the card (smoke
    stablelm): 12 steps, against a run preempted at step 7 and resumed
    from its step-5 checkpoint, every resumed loss within rtol 1e-6.
    Returns the launches of the card's runs."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.training import compression, data, optimizer
    from repro_torch.training import train_loop as tl
    t0 = time.perf_counter()
    tcfg = tl.TrainConfig(opt=optimizer.OptimizerConfig(**TRAIN_SMOKE_OPT),
                          accum_steps=2,
                          compression=compression.CompressionConfig(
                              enabled=True))
    total: dict = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke_config(arch)
        cpu = tl.init_state(torch.Generator().manual_seed(0), cfg, tcfg)
        to_card = lambda d: {k: v.cuda() for k, v in d.items()}  # noqa
        card_state = tl.TrainState(
            to_card(cpu.params), optimizer.OptState(
                cpu.opt.step.clone(), to_card(cpu.opt.mu),
                to_card(cpu.opt.nu)), to_card(cpu.err))
        dcfg = data.DataConfig(batch=4, seq_len=32, seed=0)
        batches = [data.make_batch(cfg, dcfg, i)
                   for i in range(TRAIN_SMOKE_STEPS)]
        if arch == "llama3-405b":
            ops.reset_launches()
            try:
                tl.make_train_step(cfg, tcfg, "cuda")(card_state, batches[0])
            except ValueError as e:
                if "head_dim 8" not in str(e) or any(ops.launches.values()):
                    raise
                log(f"[4f] llama3-405b smoke train step (head_dim 8) raises "
                    f"from the launcher on the card: {e}")
                continue
            raise RuntimeError("llama3-405b smoke model trained on the card "
                               "at head_dim 8")
        # each step starts both devices from the card's state: Adam's
        # normalized first steps turn a last-bit difference of a
        # near-zero gradient into lr, which would compound over steps
        states = {"cpu": cpu, "cuda": card_state}
        steps, runs, gaps = {}, {}, {}
        for dev in states:
            with train_spy() as spy:
                steps[dev] = tl.make_train_step(cfg, tcfg, dev)
            runs[dev] = spy.steps            # each step's record
        for i, b in enumerate(batches):
            for dev in states:
                states[dev], _ = steps[dev](states[dev], b)
            c, g = runs["cpu"][-1], runs["cuda"][-1]
            for k in ("loss", "grad_norm"):
                if not math.isclose(g[k], c[k], rel_tol=2e-4,
                                    abs_tol=2e-5):
                    raise RuntimeError(f"4f {arch} step {i}: {k} card "
                                       f"{g[k]!r} cpu {c[k]!r}")
            _check_step_launches(f"4f {arch} step {i}", cfg, tcfg,
                                 g["launches"])
            for k, n in g["launches"].items():
                total[k] = total.get(k, 0) + n
            for part, gap in _state_gap(states["cuda"],
                                        states["cpu"]).items():
                if gap["max"] > STATE_MAX or gap["share"] < STATE_SHARE:
                    raise RuntimeError(f"4f {arch} step {i}: {part} card vs "
                                       f"cpu {gap}")
                was = gaps.get(part, {"max": 0.0, "share": 1.0})
                gaps[part] = {"max": max(was["max"], gap["max"]),
                              "share": min(was["share"], gap["share"])}
            _copy_state(states["cuda"], states["cpu"])
        worst = max(abs(g[k] - c[k]) / abs(c[k]) for c, g in zip(
            runs["cpu"], runs["cuda"]) for k in ("loss", "grad_norm"))
        log(f"[4f] {arch} smoke: {TRAIN_SMOKE_STEPS} train steps on cuda == "
            f"cpu (largest relative difference {worst:.2e}); updated state "
            f"card vs cpu, worst step, largest |d| and share within "
            f"{STATE_TOL:g}: {gaps} (<= {STATE_MAX:g}, >= {STATE_SHARE}); "
            f"losses "
            f"{[s['loss'] for s in runs['cuda']]}, grad_norm "
            f"{[s['grad_norm'] for s in runs['cuda']]}; launches a step "
            f"{ {k: n for k, n in runs['cuda'][0]['launches'].items() if n} }")

    # the reference's resume test (tests/test_fault_tolerance.py:71-95)
    cfg = configs.get_smoke_config("stablelm-1.6b")
    dcfg = data.DataConfig(batch=4, seq_len=32, seed=0)

    def trainer(d, hook=None):
        rcfg = tl.TrainConfig(opt=optimizer.OptimizerConfig(
            peak_lr=1e-3, warmup_steps=4, total_steps=12))
        return tl.Trainer(cfg, rcfg, tl.LoopConfig(
            total_steps=12, ckpt_dir=d, ckpt_every=5),
            lambda s: data.stream(cfg, dcfg, s), fault_hook=hook,
            device="cuda")

    def hook(step):
        if step == 7 and not getattr(hook, "fired", False):
            hook.fired = True
            raise tl.PreemptionError("simulated node loss")

    with tempfile.TemporaryDirectory() as tmp:
        full = trainer(f"{tmp}/a").run()["history"]
        try:
            trainer(f"{tmp}/b", hook).run()
        except tl.PreemptionError:
            pass
        else:
            raise RuntimeError("4f: the fault hook did not fire")
        again = trainer(f"{tmp}/b")
        if again.start_step != 5:
            raise RuntimeError(f"4f: resumed at {again.start_step}, not 5")
        resumed = again.run()["history"]
    tail = [h for h in full if h["step"] > 5]
    if [h["step"] for h in resumed] != [h["step"] for h in tail] or any(
            not math.isclose(a["loss"], b["loss"], rel_tol=1e-6, abs_tol=0)
            for a, b in zip(resumed, tail)):
        raise RuntimeError(f"4f resume: {resumed} vs {tail}")
    worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(resumed, tail))
    log(f"[4f] resume on the card: preempted at step 7, resumed from step "
        f"5, steps 6-12 losses within rtol {worst:.2e} of the uninterrupted "
        f"run (<= 1e-6); phase wall {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return total


def _train_breakdown(prof, n: int) -> dict:
    """Device ms a step (``n`` profiled) by category: ``K1`` (the
    kernel, wherever launched), ``attention_vjp``, ``ce``, ``optimizer``
    and ``gather`` (the kernels launched under their :data:`TRAIN_SPANS`
    range, and for ``ce`` also by the backward nodes of the ops run
    there, matched by sequence number), ``gemm`` (the other matrix
    products, by kernel name) and ``rest``."""
    import torch
    CUDA = torch.autograd.DeviceType.CUDA
    spans = {v: k for k, v in TRAIN_SPANS.items()}
    events = prof.events()
    total = k1 = 0.0
    for e in events:
        if e.device_type == CUDA and e.name not in spans and not getattr(
                e, "is_user_annotation", False):
            total += e.time_range.elapsed_us()
            if "flash_fwd" in e.name:
                k1 += e.time_range.elapsed_us()

    def span_of(e):
        while e is not None:
            if e.name in spans:
                return spans[e.name]
            e = e.cpu_parent
        return None

    # (forward thread, sequence nr) of the ops run in a span -> the span;
    # their backward nodes carry the same pair
    seq_span = {}
    for e in events:
        if e.device_type != CUDA and e.sequence_nr >= 0 and \
                "Backward" not in e.name:
            s = span_of(e)
            if s is not None:
                seq_span.setdefault((e.thread, e.sequence_nr), s)
    out = dict.fromkeys(("K1", *TRAIN_SPANS, "gemm", "rest"), 0.0)
    out["K1"] = k1
    for e in events:
        if e.device_type == CUDA or not e.kernels:
            continue
        s = span_of(e)
        if s is None:                 # a backward node of a spanned op?
            p = e
            while p is not None and s is None:
                if "Backward" in p.name:
                    s = seq_span.get((p.fwd_thread, p.sequence_nr))
                p = p.cpu_parent
        for kern in e.kernels:
            if "flash_fwd" in kern.name:
                continue
            us = kern.duration
            out[s or ("gemm" if _GEMM.search(kern.name) else "rest")] += us
    attributed = sum(out.values())
    out["rest"] += total - attributed          # kernels no op claimed
    out = {k: v / 1e3 / n for k, v in out.items()}
    out["total"] = total / 1e3 / n
    return out


def train_full_on_card(card: str) -> dict:
    """Phase 5o: full-width stablelm-1.6b (bf16, seeded on the card)
    trains 6 steps through ``launch/train.py``'s ``main`` (batch 8 of
    2048 tokens, accum 2, as ``train_preset`` gives; no checkpoints).
    Fails unless every loss is finite, the first in (1, 20) and the last
    below the first, K1 launched 24 x 2 x 2 = 96 times a step and no
    plain version ran, and a control passes: the first step's grad_norm
    recomputed from the same initial state and batch with every
    attention forward through the plain version agrees within
    :data:`CONTROL_GRAD_RTOL` relative (its loss within
    :data:`CONTROL_LOSS_RTOL`, a sanity check, not a kernel check).  Prints the step wall and device time, the device time by
    category (one more step under the profiler), tokens/s, the peak
    memory beside the reckoning, and 6 N tokens / step time as a share
    of the dense-bf16 peak.  Returns K1's launches over the 6 steps."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import presets, roofline, train
    from repro_torch.training import data
    from repro_torch.training import train_loop as tl
    t0 = time.perf_counter()
    cfg = configs.get_config("stablelm-1.6b")
    preset = presets.train_preset(cfg, 8)
    if preset.accum_steps != 2 or preset.opt.moment_dtype != torch.float32:
        raise RuntimeError(f"5o: train_preset(stablelm, 8) is {preset}, not "
                           f"accum 2 with float32 moments")
    n_params = cfg.param_count()
    gb = 1e9
    reckon = {"params": 2 * n_params / gb, "grads": 2 * n_params / gb,
              "moments": 8 * n_params / gb, "accumulator": 4 * n_params / gb}
    B, S, accum = 8, 2048, 2
    vjp_gb = 6 * (B // accum) * cfg.num_heads * S * S * 4 / gb
    log(f"[5o] stablelm-1.6b full width: {n_params / 1e9:.3f} B params bf16, "
        f"train {' '.join(TRAIN_FULL_ARGS)}; reckoned GB {reckon}, "
        f"attention-VJP transient ~{vjp_gb:.1f} GB (six (B,H,S,T) float32 "
        f"tensors)")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with train_spy() as spy:
        trainer = train.main(TRAIN_FULL_ARGS)
    peak = torch.cuda.max_memory_allocated() / gb
    steps = spy.steps
    losses = [s["loss"] for s in steps]
    if len(steps) != 6 or not all(math.isfinite(x) for x in losses) or not (
            1.0 < losses[0] < 20.0) or not losses[-1] < losses[0]:
        raise RuntimeError(f"5o: losses {losses}")
    for i, s in enumerate(steps):
        _check_step_launches(f"5o step {i + 1}", cfg, trainer.tcfg,
                             s["launches"])
    k1 = sum(s["launches"]["flash_attention"] for s in steps)
    walls = trainer.step_times
    med = statistics.median(walls[1:])
    tokens = B * S
    flops = 6.0 * n_params * tokens
    mfu = flops / med / roofline.H100_SXM5.peak_flops
    log(f"[5o] losses {losses}; grad_norm "
        f"{[s['grad_norm'] for s in steps]}; K1 launches a step "
        f"{[s['launches']['flash_attention'] for s in steps]}, plain 0")
    log(f"[5o] step walls s {walls}; median of steps 2-6 {med:.4f} s; "
        f"tokens/s {tokens / med:.1f}; 6 N tokens / step {flops / med / 1e12:.1f}"
        f" TFLOP/s = {100 * mfu:.2f}% of the dense-bf16 peak "
        f"({roofline.H100_SXM5.name}); peak memory "
        f"{peak:.2f} GB (max_memory_allocated) beside the reckoned "
        f"{sum(reckon.values()):.2f} GB of state + ~{vjp_gb:.1f} GB VJP "
        f"transient ({card})")

    # one more step under the profiler, its device time by category
    dcfg = data.DataConfig(seed=0, batch=B, seq_len=S)
    batch = data.make_batch(cfg, dcfg, 6)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with train_spy(spans=True) as spy_p:
        step = tl.make_train_step(cfg, trainer.tcfg, "cuda")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            trainer.state, _ = step(trainer.state, batch)
            torch.cuda.synchronize()
    split = _train_breakdown(prof, 1)
    if split["total"] <= 0:
        raise RuntimeError("5o: the profiler recorded no device activity")
    log(f"[5o] device ms of one step by category: " + json.dumps(
        {k: round(v, 3) for k, v in split.items()}) + f"; device busy "
        f"{100 * split['total'] / 1e3 / med:.1f}% of the median step wall")

    # the control: step 1 again from the same initial state and batch,
    # every attention forward through the plain version
    tcfg = trainer.tcfg
    del trainer, step, spy_p
    gc.collect()
    torch.cuda.empty_cache()
    state = tl.init_state(torch.Generator(device="cuda").manual_seed(0),
                          cfg, tcfg)
    kernel_forward = ops._flash_forward

    def plain(q, k, v, q_pos, kv_pos, causal, window, softcap):
        return ref.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softcap=softcap)

    ops._flash_forward = plain
    try:
        with train_spy() as spy_c:
            tl.make_train_step(cfg, tcfg, "cuda")(
                state, data.make_batch(cfg, dcfg, 0))
    finally:
        ops._flash_forward = kernel_forward
    ctl = spy_c.steps[0]
    rel = {k: abs(steps[0][k] - ctl[k]) / abs(ctl[k])
           for k in ("loss", "grad_norm")}
    if rel["grad_norm"] > CONTROL_GRAD_RTOL or rel["loss"] > \
            CONTROL_LOSS_RTOL or any(ctl["launches"].values()):
        raise RuntimeError(f"5o control: kernel step 1 {steps[0]}, plain "
                           f"attention {ctl}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[5o] control: step 1 with every attention forward through the "
        f"plain version: loss {ctl['loss']!r} grad_norm "
        f"{ctl['grad_norm']!r}; relative differences from the kernel's "
        f"run {rel} (grad_norm <= {CONTROL_GRAD_RTOL:g}, the kernel check; "
        f"loss <= {CONTROL_LOSS_RTOL:g}, a sanity check); phase wall "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return {"launches": k1, "steps": len(steps), "step_wall_s": med,
            "device_ms": split}


# ------------------------------------------------------- phases 4g and 5p

# phase 4g: the sharded step at smoke width, (2, 2) on the one card
SHARDED_SMOKE_ARCHS = ("stablelm-1.6b", "hymba-1.5b", "qwen2-moe-a2.7b")
SHARDED_STEPS = 2
# phase 5p: full-width stablelm-1.6b, 5o's batches and optimizer, sharded
# over (2, 2) against the unsharded step; loss and grad_norm relative
SHARDED_FULL_RTOL = 2e-3


def _sharded_launches(cfg, tcfg, replicas: int) -> dict:
    """The counted kernels a sharded step launches: each data replica
    runs every layer of every microbatch, twice with remat."""
    return {k: n * tcfg.accum_steps * replicas * (1 + cfg.remat)
            for k, n in _train_kernels(cfg).items()}


def _placed_batch(batch: dict, mesh) -> dict:
    from repro_torch import placement
    from repro_torch.launch import sharding as shd
    specs = shd.batch_shardings(batch, mesh)
    return {k: placement.place(v, specs[k], mesh) for k, v in batch.items()}


def _same(a, b) -> bool:
    """Bit for bit: the same dtype and values, compared on the host."""
    import torch
    return a.dtype == b.dtype and bool(torch.equal(a.cpu(), b.cpu()))


def train_sharded_smoke_on_card(card: str) -> dict:
    """Phase 4g: (a) ``ring_allreduce_int8`` and ``allreduce_compressed``
    over 4 members on the card, bit for bit the CPU's results, the ring
    the int32 sum; (b) the sharded train step (``make_train_step(...,
    mesh=)``, a (2, 2) mesh over ``forced_devices(4)``) of the smoke
    stablelm, hymba and qwen2-moe (its load balance over the global
    batch) configs, 2 steps each on the card and on the CPU from the same
    state and batches (accum 2, int8 compression, 4f's optimizer), each
    step from the card's state: loss and grad_norm within 2e-5 abs / 2e-4
    rel, the joined params, moments and error buffer within 4f's state
    gate, each counted kernel launched layers x microbatches x 2 data
    replicas x 2 (remat) times a step and nothing else; (c) stablelm's
    sharded state saved and restored onto a (4, 1) mesh, bit for bit.
    Returns the card's launches."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as shd
    from repro_torch.training import checkpoint, compression, data, optimizer
    from repro_torch.training import train_loop as tl
    t0 = time.perf_counter()

    # (a) the collectives
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randint(-127, 128, (4096, 64), generator=gen).to(torch.int8)
          for _ in range(4)]
    wire: dict = {}
    cpu_sum = compression.ring_allreduce_int8(xs)
    card_sum = compression.ring_allreduce_int8([x.cuda() for x in xs], wire)
    want = sum(x.to(torch.int32) for x in xs)
    if not all(_same(c, w) and _same(g, w)
               for c, g, w in zip(cpu_sum, card_sum, [want] * 4)):
        raise RuntimeError("4g: the ring's sum differs between the card, "
                           "the CPU and the int32 sum")
    grads = [{"w": torch.randn(2048, 64, generator=gen) * s,
              "b": torch.randn(333, generator=gen)} for s in (1, 3, .5, 2)]
    errs = [{k: torch.randn(v.shape, generator=gen) * 0.01
             for k, v in g.items()} for g in grads]
    ccfg = compression.CompressionConfig(enabled=True)
    cuda = lambda d: {k: v.cuda() for k, v in d.items()}  # noqa: E731
    mc, ec = compression.allreduce_compressed(grads, errs, ccfg)
    mg, eg = compression.allreduce_compressed(
        [cuda(g) for g in grads], [cuda(e) for e in errs], ccfg)
    if not all(_same(a[k], b[k]) for x, y in ((mc, mg), (ec, eg))
               for a, b in zip(x, y) for k in a):
        raise RuntimeError("4g: allreduce_compressed differs between the "
                           "card and the CPU")
    log(f"[4g] ring_allreduce_int8 over 4 members of (4096, 64) int8: card "
        f"== cpu == the int32 sum, bitwise; its hops copied "
        f"{wire['wire_bytes']} bytes, {wire['wire_bytes'] // 4} a member "
        f"(2 x 3 int32 chunks; the reference's docstring counts "
        f"{2 * 3 * 4096 // 4 * 64} int8 bytes a member); "
        f"allreduce_compressed means and errors card == cpu, bitwise")

    # (b) the sharded step, card against CPU
    tcfg = tl.TrainConfig(opt=optimizer.OptimizerConfig(**TRAIN_SMOKE_OPT),
                          accum_steps=2,
                          compression=compression.CompressionConfig(
                              enabled=True))
    with mesh_mod.forced_devices(4):
        meshes = {"cuda": mesh_mod.make_mesh((2, 2), ("data", "model")),
                  "cpu": mesh_mod.make_mesh((2, 2), ("data", "model"),
                                            mesh_mod.host_devices("cpu"))}
        mesh41 = mesh_mod.make_mesh((4, 1), ("data", "model"))
    total: dict = {}
    keep = None
    for arch in SHARDED_SMOKE_ARCHS:
        cfg = configs.get_smoke_config(arch)
        sh = shd.train_state_shardings(cfg, meshes["cuda"], compression=True)
        init = tl.init_state(torch.Generator().manual_seed(0), cfg, tcfg)
        states = {d: tl.place_state(init, sh, m) for d, m in meshes.items()}
        steps, runs, gaps = {}, {}, {}
        for d, m in meshes.items():
            with train_spy() as spy:
                steps[d] = tl.make_train_step(cfg, tcfg, mesh=m)
            runs[d] = spy.steps
        dcfg = data.DataConfig(batch=4, seq_len=32, seed=0)
        want = _sharded_launches(cfg, tcfg, 2)
        for i in range(SHARDED_STEPS):
            b = data.make_batch(cfg, dcfg, i)
            for d, m in meshes.items():
                states[d], _ = steps[d](states[d], _placed_batch(b, m))
            c, g = runs["cpu"][-1], runs["cuda"][-1]
            for k in ("loss", "grad_norm"):
                if not math.isclose(g[k], c[k], rel_tol=2e-4,
                                    abs_tol=2e-5):
                    raise RuntimeError(f"4g {arch} step {i}: {k} card "
                                       f"{g[k]!r} cpu {c[k]!r}")
            got = {k: n for k, n in g["launches"].items() if n}
            if got != want:
                raise RuntimeError(f"4g {arch} step {i}: launches {got}, "
                                   f"expected {want}")
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
            joined = tl.join_state(states["cuda"])
            for part, gap in _state_gap(
                    joined, tl.join_state(states["cpu"], "cpu")).items():
                if gap["max"] > STATE_MAX or gap["share"] < STATE_SHARE:
                    raise RuntimeError(f"4g {arch} step {i}: {part} card vs "
                                       f"cpu {gap}")
                was = gaps.get(part, {"max": 0.0, "share": 1.0})
                gaps[part] = {"max": max(was["max"], gap["max"]),
                              "share": min(was["share"], gap["share"])}
            states["cpu"] = tl.place_state(tl.join_state(states["cuda"],
                                                         "cpu"), sh,
                                           meshes["cpu"])
        if keep is None:
            keep = (cfg, states["cuda"])
        log(f"[4g] {arch} smoke, sharded over (2, 2) on the card: "
            f"{SHARDED_STEPS} steps card == cpu (loss "
            f"{[r['loss'] for r in runs['cuda']]}, grad_norm "
            f"{[r['grad_norm'] for r in runs['cuda']]}); joined state card "
            f"vs cpu, worst step: {gaps} (<= {STATE_MAX:g}, >= "
            f"{STATE_SHARE}); launches a step {want}; traffic of the card's "
            f"run {steps['cuda'].traffic}")

    # (c) a sharded checkpoint restored onto a (4, 1) mesh, bitwise
    cfg, state = keep
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save(tmp, SHARDED_STEPS, state)
        back, _ = checkpoint.restore(
            tmp, SHARDED_STEPS, tl.abstract_state(cfg, tcfg),
            shardings=shd.train_state_shardings(cfg, mesh41,
                                                compression=True),
            mesh=mesh41)
    a, b = _state_parts(tl.join_state(state)), _state_parts(
        tl.join_state(back))
    if not all(_same(v, b[part][k]) for part, leaves in a.items()
               for k, v in leaves.items()):
        raise RuntimeError("4g: the (4, 1) restore of the (2, 2) checkpoint "
                           "differs")
    log(f"[4g] stablelm smoke: the (2, 2) sharded state saved and restored "
        f"onto a (4, 1) mesh on the card, every leaf bitwise; phase wall "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return total


def _to_host(state):
    """A train state's tensors copied to the host."""
    from repro_torch.training import optimizer
    from repro_torch.training import train_loop as tl

    def tree(d):
        return None if d is None else {k: v.to("cpu", copy=True)
                                       for k, v in d.items()}
    return tl.TrainState(tree(state.params), optimizer.OptState(
        state.opt.step.clone(), tree(state.opt.mu), tree(state.opt.nu)),
        tree(state.err))


def _unsharded_run(cfg, tcfg, batches):
    """The unsharded step's records and final state (on the host) over
    ``batches`` from the seed-0 state on the card; also that initial
    state, on the host."""
    import gc

    import torch
    from repro_torch.training import train_loop as tl
    state = tl.init_state(torch.Generator(device="cuda").manual_seed(0),
                          cfg, tcfg)
    init = _to_host(state)
    with train_spy() as spy:
        step = tl.make_train_step(cfg, tcfg, "cuda")
    for b in batches:
        state, _ = step(state, b)
    out = _to_host(state)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return spy.steps, init, out


def train_sharded_full_on_card(card: str) -> dict:
    """Phase 5p: full-width stablelm-1.6b (bf16, seeded on the card), 2
    steps of 5o's batches (8 x 2048 tokens, accum 2, remat, 5o's
    optimizer) through the unsharded step, its losses, grad norms and
    final state kept on the host; a control, the unsharded step at accum
    4, which sums bf16 gradients of two rows at a time as the sharded
    step's two replicas do; then, the card freed, the sharded step over
    a (2, 2) mesh on the one card from the same initial state.  Fails
    unless each step's loss and grad_norm agree within
    :data:`SHARDED_FULL_RTOL` relative, the joined mu and nu (float32)
    are within 4f's state gate of the unsharded ones (each part's
    largest |d| <= :data:`STATE_MAX`, :data:`STATE_SHARE` of its
    elements within :data:`STATE_TOL`; the worst leaf printed), the
    bf16 params' largest |d| is within :data:`STATE_MAX` and no more of
    them differ by more than :data:`STATE_TOL` than twice the control's
    (a bf16 parameter within 1e-6 of another is the same value: once two
    runs round a gradient differently, Adam's second step moves a share
    of them by an ulp), and K1 launched 24 layers x 2 microbatches x 2
    replicas x 2 (remat) = 192 times a step and nothing else.  Prints
    both steps' walls, the first step's device time by category (it runs
    under the profiler, the second without), the bytes the gathers and
    reductions would move on a real mesh, and the peak memory.  Returns
    K1's launches and the measurements."""
    import dataclasses
    import gc

    import torch
    from repro_torch import configs, placement
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as shd
    from repro_torch.training import data, optimizer
    from repro_torch.training import train_loop as tl
    t0 = time.perf_counter()
    cfg = configs.get_config("stablelm-1.6b")
    tcfg = tl.TrainConfig(opt=optimizer.OptimizerConfig(
        peak_lr=3e-4, warmup_steps=2, total_steps=6), accum_steps=2)
    dcfg = data.DataConfig(seed=0, batch=8, seq_len=2048)
    batches = [data.make_batch(cfg, dcfg, i) for i in range(2)]
    ref, host0, host1 = _unsharded_run(cfg, tcfg, batches)
    ctl, _, ctl_state = _unsharded_run(
        cfg, dataclasses.replace(tcfg, accum_steps=4), batches)
    ctl_params = ctl_state.params
    del ctl_state

    with mesh_mod.forced_devices(4):
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    state = tl.place_state(host0, shd.train_state_shardings(cfg, mesh),
                           mesh)
    del host0
    with train_spy(spans=True) as spy:
        step = tl.make_train_step(cfg, tcfg, mesh=mesh)
        walls, prof = [], None
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for i, b in enumerate(batches):
            pb = _placed_batch(b, mesh)
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            if i == 1:
                state, _ = step(state, pb)
                torch.cuda.synchronize()
            else:
                with torch.profiler.profile(activities=acts) as prof:
                    state, _ = step(state, pb)
                    torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    runs = spy.steps
    want = _sharded_launches(cfg, tcfg, 2)
    rels = []
    for i, (r, g) in enumerate(zip(ref, runs)):
        rel = {k: abs(g[k] - r[k]) / abs(r[k]) for k in ("loss",
                                                          "grad_norm")}
        rels.append(rel)
        if max(rel.values()) > SHARDED_FULL_RTOL:
            raise RuntimeError(f"5p step {i + 1}: sharded {g}, unsharded "
                               f"{r} (relative {rel})")
        got = {k: n for k, n in g["launches"].items() if n}
        if got != want:
            raise RuntimeError(f"5p step {i + 1}: launches {got}, expected "
                               f"{want}")

    def gap(a: dict, b: dict) -> tuple:
        """(largest |d|, share within STATE_TOL, worst leaf's share and
        name) of two dicts of leaves (placed ones joined), on the card."""
        mx, near, n, leaf = 0.0, 0, 0, (2.0, "")
        for k, v in a.items():
            v = placement.join(v) if isinstance(v, placement.Placed) \
                else v.cuda()
            d = (v.float() - b[k].cuda().float()).abs()
            mx = max(mx, d.max().item())
            ok = int((d <= STATE_TOL).sum().item())
            near, n = near + ok, n + d.numel()
            leaf = min(leaf, (ok / d.numel(), k))
            del d
        return mx, near / n, leaf

    gaps = {}
    for part, placed, whole in (("mu", state.opt.mu, host1.opt.mu),
                                ("nu", state.opt.nu, host1.opt.nu)):
        gaps[part] = gap(placed, whole)
        if gaps[part][0] > STATE_MAX or gaps[part][1] < STATE_SHARE:
            raise RuntimeError(f"5p: {part} sharded vs unsharded "
                               f"{gaps[part]}")
    gaps["params"] = gap(state.params, host1.params)
    gaps["params, control"] = gap(ctl_params, host1.params)
    gaps["params, sharded vs control"] = gap(state.params, ctl_params)
    moved, moved_ctl = (1 - gaps["params"][1],
                        1 - gaps["params, control"][1])
    if gaps["params"][0] > STATE_MAX or moved > 2 * moved_ctl:
        raise RuntimeError(f"5p: params sharded vs unsharded "
                           f"{gaps['params']}, control "
                           f"{gaps['params, control']}")
    split = _train_breakdown(prof, 1)
    if split["total"] <= 0:
        raise RuntimeError("5p: the profiler recorded no device activity")
    traffic = step.traffic
    log(f"[5p] stablelm-1.6b full width sharded over (2, 2) on the card "
        f"(forced_devices(4)): losses {[r['loss'] for r in runs]} vs "
        f"unsharded {[r['loss'] for r in ref]} (accum-4 control "
        f"{[r['loss'] for r in ctl]}); grad_norm "
        f"{[r['grad_norm'] for r in runs]} vs "
        f"{[r['grad_norm'] for r in ref]} (control "
        f"{[r['grad_norm'] for r in ctl]}); relative {rels} (<= "
        f"{SHARDED_FULL_RTOL:g}); K1 launches a step "
        f"{[r['launches']['flash_attention'] for r in runs]}, plain 0")
    log(f"[5p] state vs unsharded, (largest |d|, share within "
        f"{STATE_TOL:g}, worst leaf): {gaps}; mu, nu <= {STATE_MAX:g} and "
        f">= {STATE_SHARE}; params moved by more than {STATE_TOL:g}: "
        f"{moved:.6f} of the elements, control {moved_ctl:.6f} (<= 2x)")
    log(f"[5p] step walls s {walls} (the first under the profiler); "
        f"device ms of step 1 by category: " + json.dumps(
            {k: round(v, 3) for k, v in split.items()})
        + f"; bytes a real (2, 2) mesh would move a step: gathers "
        f"{traffic['gather_bytes'] / 2 / 1e9:.4f} GB, reductions "
        f"{traffic['reduce_bytes'] / 2 / 1e9:.4f} GB; peak memory "
        f"{peak:.2f} GB (max_memory_allocated); phase wall "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    del state, step, host1, ctl_params, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": sum(r["launches"]["flash_attention"] for r in runs),
            "walls": walls, "device_ms": split, "peak_gb": peak,
            "traffic": traffic}


# ------------------------------------------------------- phases 4h and 5q

# phase 4h: the serve step over a (2, 2) mesh at smoke width
SERVE_SMOKE_ARCHS = {"stablelm-1.6b": ("flash_attention", "decode_attention"),
                     "hymba-1.5b": ("flash_attention", "decode_attention",
                                    "ssd_scan"),
                     "rwkv6-7b": ("rwkv6_scan",),
                     "qwen2-moe-a2.7b": ("flash_attention",
                                         "decode_attention")}
SERVE_SMOKE = dict(batch=4, prompt=64, max_len=128, steps=8)
# phase 5q: full-width stablelm-1.6b, a prefill of 4 x 2048 tokens, then 8
# decode steps of 16 rows over a 2048-position cache filled with 2040
# tokens
SERVE_FULL = dict(batch=4, prompt=2048, rows=16, fill=2040, steps=8)


def _serve_mesh(kind: str):
    """A (2, 2) ("data", "model") mesh over four forced devices of
    ``kind``."""
    from repro_torch.launch import mesh as mesh_mod
    with mesh_mod.forced_devices(4):
        return mesh_mod.make_mesh((2, 2), ("data", "model"),
                                  mesh_mod.host_devices(kind))


def _serve_stream(cfg, params, toks, dev: str, mesh=None, feed=None):
    """Phase 4h's run of one step kind: a prefill of ``toks`` into a
    ``max_len`` cache, then ``steps`` greedy decode steps (fed ``feed``'s
    ids instead when given).  Returns every step's float32 logits on the
    host."""
    import torch
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine
    B, S = toks.shape
    kw = {"mesh": mesh} if mesh is not None else {}
    pre = engine.make_serve_step(cfg, "prefill", dev, **kw)
    dec = engine.make_serve_step(cfg, "decode", dev, **kw)
    cache = model_zoo.init_cache(cfg, B, SERVE_SMOKE["max_len"], dev)
    batch = {"tokens": toks.to(dev)}
    if mesh is not None:
        params, cache, batch = engine.serve_placement(cfg, mesh, params,
                                                      cache, batch)
    logits, cache = pre(params, batch, cache)
    out = [logits.float().cpu()]
    for i in range(SERVE_SMOKE["steps"]):
        nxt = out[-1].argmax(-1) if feed is None else feed[i]
        x = {"tokens": nxt.to(torch.int32).to(dev),
             "t": torch.full((B,), S + i, dtype=torch.int32, device=dev)}
        if mesh is not None:
            x = engine.serve_placement(cfg, mesh, {}, {}, x)[2]
        logits, cache = dec(params, cache, x["tokens"], x["t"])
        out.append(logits.float().cpu())
    return out


def serve_sharded_smoke_on_card(card: str) -> dict:
    """Phase 4h: the serve step (``make_serve_step(..., mesh=)``) over a
    (2, 2) mesh of ``forced_devices(4)`` on the card, for the smoke
    stablelm, hymba, rwkv6 and qwen2-moe configs: a prefill of 4 prompts
    of 64 tokens into a 128-position cache, then 8 greedy decode steps.
    Held against the same step over a (2, 2) CPU mesh and against the
    unsharded step on the card: the ids equal, the logits within the
    bf16 tolerance (2e-2); the mesh run launches each of the family's
    kernels (K1, K2, K4, K5) twice as often as the unsharded one (once a
    data replica) and no plain version.  Returns the mesh runs'
    launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    t0 = time.perf_counter()
    meshes = {"cuda": _serve_mesh("cuda"), "cpu": _serve_mesh("cpu")}
    total: dict = {}
    for arch, kernels in SERVE_SMOKE_ARCHS.items():
        cfg = configs.get_smoke_config(arch)
        params = model_zoo.init(cfg, torch.Generator().manual_seed(0))
        card_params = {k: v.cuda() for k, v in params.items()}
        rng = np.random.default_rng(4)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SERVE_SMOKE["batch"], SERVE_SMOKE["prompt"])
        ).astype(np.int32))
        runs, launched = {}, {}
        for name, dev, mesh in (("card", "cuda", None),
                                ("card mesh", "cuda", meshes["cuda"])):
            ops.reset_launches()
            runs[name] = _serve_stream(cfg, card_params, toks, dev, mesh)
            torch.cuda.synchronize()
            launched[name] = dict(ops.launches)
        runs["cpu mesh"] = _serve_stream(cfg, params, toks, "cpu",
                                         meshes["cpu"])
        for other in ("card", "cpu mesh"):
            for i, (a, b) in enumerate(zip(runs["card mesh"], runs[other])):
                if not torch.equal(a.argmax(-1), b.argmax(-1)):
                    raise RuntimeError(f"4h {arch} step {i}: ids of the "
                                       f"card mesh differ from the {other}")
                if not torch.allclose(a, b, **TOL["bfloat16"]):
                    raise RuntimeError(
                        f"4h {arch} step {i}: logits of the card mesh vs "
                        f"the {other}: max |d| "
                        f"{(a - b).abs().max().item():.3e}")
        one, two = launched["card"], launched["card mesh"]
        got = {k: n for k, n in two.items() if n}
        want = {k: 2 * one[k] for k in kernels}
        if got != want or not all(want.values()):
            raise RuntimeError(f"4h {arch}: mesh launches {got}, expected "
                               f"twice the unsharded {one}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        gap = max((a - b).abs().max().item() for a, b in
                  zip(runs["card mesh"], runs["card"]))
        log(f"[4h] {arch} smoke, serve step over (2, 2) on the card: "
            f"prefill + {SERVE_SMOKE['steps']} decode steps, ids == the "
            f"(2, 2) cpu mesh == the unsharded card step; logits vs "
            f"unsharded max |d| {gap:.3e} (<= 2e-2); launches {got}")
    log(f"[4h] phase wall {time.perf_counter() - t0:.1f} s ({card})")
    return total


def _rel_l2(a, b):
    """Per-row relative L2 of ``a`` against ``b`` (float32)."""
    return ((a.float() - b.float()).norm(dim=-1)
            / b.float().norm(dim=-1).clamp_min(1e-30))


def serve_sharded_full_on_card(cfg, params, card: str) -> dict:
    """Phase 5q: full-width stablelm-1.6b (phase 5's weights) through the
    serve step over a (2, 2) mesh of ``forced_devices(4)`` on the card:
    (a) a prefill of 4 x 2048 tokens; (b) 8 decode steps of 16 rows over a
    2048-position cache (6.4 GB) that the unsharded step filled with
    2040-token prompts, fed the unsharded step's ids.  Two references:
    the unsharded step over the whole batch, and a control, the unsharded
    step run on each data replica's rows alone (the shapes each replica
    computes at).  Fails unless the logits and the cache entries equal
    the control's bit for bit (so the joins and write-backs lose
    nothing), the ids equal the whole batch's but at near ties (the
    batch's shape alone reorders bf16 sums: a flipped row's top-2 gap
    under twice its largest |d|), the bytes each mesh step joined
    and wrote back equal ``serve_step_counts``' collective bytes for the
    same shape term by term, and K1 launched 24 layers x 2 replicas and
    K2 24 x 2 x 8 times and no plain version.  Prints the logits'
    relative L2 to the whole batch's (the rows-alone control's drift from
    it, batch shape alone, is the same number when the gate holds), each
    step's wall, a prefill's and a decode step's device time both ways,
    the launches and the peak memory."""
    import torch
    from repro_torch import configs, placement
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_cost
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = _serve_mesh("cuda")
    shape2 = {"data": 2, "model": 2}
    gen = torch.Generator(device="cuda").manual_seed(17)
    B, S = SERVE_FULL["batch"], SERVE_FULL["prompt"]
    R, F = SERVE_FULL["rows"], SERVE_FULL["fill"]
    pre_u = engine.make_serve_step(cfg, "prefill", "cuda")
    pre_m = engine.make_serve_step(cfg, "prefill", mesh=mesh)
    dec_u = engine.make_serve_step(cfg, "decode", "cuda")
    dec_m = engine.make_serve_step(cfg, "decode", mesh=mesh)

    def synced(fn):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - w0

    def halves(n):
        return [slice(0, n // 2), slice(n // 2, n)]

    def same(a, b) -> bool:
        return a.dtype == b.dtype and bool(torch.equal(a, b))

    def near_ties(what: str, got, whole) -> int:
        """The rows whose id differs from the whole batch's; raises
        unless each is a near tie there (top-2 gap under twice the row's
        largest |d| between the two)."""
        flip = got.argmax(-1) != whole.argmax(-1)
        top = whole.topk(2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        drift = (got - whole).abs().max(dim=-1).values
        if bool((flip & (gap >= 2 * drift)).any()):
            raise RuntimeError(f"5q {what}: ids differ from the unsharded "
                               f"step beyond a near tie (gaps "
                               f"{gap[flip].tolist()}, drifts "
                               f"{drift[flip].tolist()})")
        return int(flip.sum())

    # (a) the prefill
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache_u = model_zoo.init_cache(cfg, B, S, "cuda")
    (lg_u, cache_u), wall_pre_u = synced(
        lambda: pre_u(params, {"tokens": toks}, cache_u))
    ctl = [pre_u(params, {"tokens": toks[h]},
                 model_zoo.init_cache(cfg, B // 2, S, "cuda"))
           for h in halves(B)]
    p, c, x = engine.serve_placement(
        cfg, mesh, params, model_zoo.init_cache(cfg, B, S, "cuda"),
        {"tokens": toks})
    ops.reset_launches()
    (lg_m, c), wall_pre_m = synced(lambda: pre_m(p, x, c))
    launched = dict(ops.launches)
    pre_counts = serve_cost.serve_step_counts(
        cfg, shape2, configs.ShapeSpec("5q prefill", "prefill", S, B))
    if pre_m.traffic != pre_counts["collective"]:
        raise RuntimeError(f"5q prefill: the step moved {pre_m.traffic}, "
                           f"the closed form counts "
                           f"{pre_counts['collective']}")
    flips = near_ties("prefill", lg_m, lg_u)
    joined = {k: placement.join(v) for k, v in c.items()}
    for h, (lg_h, cache_h) in zip(halves(B), ctl):
        if not (same(lg_m[h], lg_h) and all(
                same(joined[k][:, h], v) for k, v in cache_h.items())):
            raise RuntimeError(f"5q prefill rows {h}: the mesh step's "
                               f"logits or cache differ from the unsharded "
                               f"step on those rows alone")
    rel_pre = _rel_l2(lg_m, lg_u).max().item()
    pre_bitwise = same(lg_m, lg_u)
    pre_traffic = dict(pre_m.traffic)
    dev_pre_m = _device_ms(lambda: pre_m(p, x, c), 1)[0]
    dev_pre_u = _device_ms(
        lambda: pre_u(params, {"tokens": toks}, cache_u), 1)[0]
    del c, x, cache_u, lg_u, lg_m, ctl, joined

    # (b) 8 decode steps of 16 rows over a 2048-position cache
    fill = torch.randint(0, cfg.vocab_size, (R, F), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache16 = model_zoo.init_cache(cfg, R, S, "cuda")
    lg, cache16 = pre_u(params, {"tokens": fill}, cache16)
    _, c16, _ = engine.serve_placement(cfg, mesh, {}, cache16, {})
    cache_h = [{k: v[:, h].clone() for k, v in cache16.items()}
               for h in halves(R)]
    ref, ctl, walls_u, ins = [], [], [], []
    nxt = lg.argmax(-1).to(torch.int32)
    for i in range(SERVE_FULL["steps"]):
        t = torch.full((R,), F + i, dtype=torch.int32, device="cuda")
        ins.append((nxt, t))
        (lg, cache16), w = synced(lambda: dec_u(params, cache16, nxt, t))
        ctl.append(torch.cat([dec_u(params, ch, nxt[h], t[h])[0]
                              for h, ch in zip(halves(R), cache_h)]))
        ref.append(lg)
        walls_u.append(w)
        nxt = lg.argmax(-1).to(torch.int32)
    rels, rels_ctl, walls_m, steps_traffic = [], [], [], []
    ops.reset_launches()
    for i, ((tok, t), want_lg) in enumerate(zip(ins, ref)):
        xi = engine.serve_placement(cfg, mesh, {}, {},
                                    {"tokens": tok, "t": t})[2]
        before = dict(dec_m.traffic)
        (lg, c16), w = synced(lambda: dec_m(p, c16, xi["tokens"],
                                            xi["t"]))
        walls_m.append(w)
        moved = {k: dec_m.traffic[k] - before[k] for k in before}
        want = serve_cost.serve_step_counts(
            cfg, shape2, configs.ShapeSpec("5q decode", "decode", S, R),
            position=F + i)
        if moved != want["collective"]:
            raise RuntimeError(f"5q decode step {i}: the step moved {moved}, "
                               f"the closed form counts "
                               f"{want['collective']}")
        steps_traffic.append(moved)
        if not same(lg, ctl[i]):
            raise RuntimeError(
                f"5q decode step {i}: the mesh step's logits differ from "
                f"the unsharded step on each replica's rows alone "
                f"(relative L2 {_rel_l2(lg, ctl[i]).max().item():.3e})")
        flips += near_ties(f"decode step {i}", lg, want_lg)
        rels.append(_rel_l2(lg, want_lg).max().item())
        rels_ctl.append(_rel_l2(ctl[i], want_lg).max().item())
    joined = {k: placement.join(v) for k, v in c16.items()}
    if not all(same(joined[k][:, h], ch[k]) for h, ch in
               zip(halves(R), cache_h) for k in ch):
        raise RuntimeError("5q decode: the mesh's cache differs from the "
                           "rows-alone control's after 8 steps")
    del joined
    launched = {k: launched.get(k, 0) + n for k, n in ops.launches.items()}
    got = {k: n for k, n in launched.items() if n}
    want_launch = {"flash_attention": cfg.num_layers * 2,
                   "decode_attention": cfg.num_layers * 2
                   * SERVE_FULL["steps"]}
    if got != want_launch:
        raise RuntimeError(f"5q: launches {got}, expected {want_launch}")
    tok, t = ins[-1]
    xi = engine.serve_placement(cfg, mesh, {}, {}, {"tokens": tok, "t": t})[2]
    dev_dec_m = _device_ms(lambda: dec_m(p, c16, xi["tokens"], xi["t"]),
                           1)[0]
    dev_dec_u = _device_ms(lambda: dec_u(params, cache16, tok, t), 1)[0]
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = serve_cost.serve_step_counts(
        cfg, shape2, configs.ShapeSpec("5q decode", "decode", S, R),
        position=F + SERVE_FULL["steps"] - 1)
    log(f"[5q] stablelm-1.6b full width, serve step over (2, 2) on the card "
        f"(forced_devices(4)): prefill {B} x {S} and "
        f"{SERVE_FULL['steps']} decode steps of {R} rows over {S} positions "
        f"({F} filled): logits, ids and cache entries == the unsharded "
        f"step on each replica's rows alone, bitwise; vs the unsharded "
        f"step on the whole batch: {flips} of {B + R * SERVE_FULL['steps']}"
        f" ids differ, each at a near tie; prefill relative L2 {rel_pre:.3e} "
        f"(bitwise {pre_bitwise}), decode {[float(f'{r:.4e}') for r in rels]}"
        f" (the rows-alone control's {[float(f'{r:.4e}') for r in rels_ctl]}"
        f"; all within 2e-2: {max(rels + [rel_pre]) <= 2e-2})")
    log(f"[5q] bytes joined and written back: prefill {pre_traffic} == "
        f"serve_step_counts {pre_counts['collective']}; decode steps "
        f"{steps_traffic[0]} .. {steps_traffic[-1]} == serve_step_counts "
        f"{counts['collective']} (each step equal)")
    log(f"[5q] walls s: prefill mesh {wall_pre_m:.4f} unsharded "
        f"{wall_pre_u:.4f}; decode mesh {[round(w, 5) for w in walls_m]} "
        f"unsharded {[round(w, 5) for w in walls_u]}; device ms: prefill "
        f"mesh {dev_pre_m:.3f} unsharded {dev_pre_u:.3f}, decode step mesh "
        f"{dev_dec_m:.3f} unsharded {dev_dec_u:.3f}; launches {got}; peak "
        f"memory {peak:.2f} GB (max_memory_allocated); phase wall "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    del p, c16, cache16, cache_h, ref, ctl
    return {"launches": got, "walls_decode": walls_m,
            "device_ms": {"prefill": dev_pre_m, "prefill_unsharded":
                          dev_pre_u, "decode": dev_dec_m,
                          "decode_unsharded": dev_dec_u},
            "peak_gb": peak}


# ---------------------------------------------------------------- phase 6


def _time_ms(fn, flush, reps: int = 30, warmup: int = 5,
             isolate: bool = False) -> float:
    """Median ms between CUDA events around one call of ``fn``, L2 flushed
    before each.  Where a launch's host side outlasts the flush, the
    events take it in too; with ``isolate`` the card is kept busy while
    the host enqueues the call, so they time the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()                      # evict the inputs from L2
        if isolate:
            torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median ms the host takes to enqueue one call of ``fn`` (checks,
    allocation, launch), while the card is busy with an earlier sleep."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)         # tens of ms of queued work
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def _split_times(fn, flush, lib=None) -> dict:
    """The kernel's device time alone and host time, and the library
    call's device time alone, beside the rows' event times."""
    return {"device_ms": _time_ms(fn, flush, isolate=True),
            "host_ms": _host_ms(fn),
            "library_device_ms": (None if lib is None else
                                  _time_ms(lib, flush, isolate=True))}


def _k1_row(key, launches, gen, flush, window=None) -> dict:
    """K1 timed at one (q, k) shape of a prefill (plain causal, with the
    window given), beside its bound, plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (B, S, Hq, D), (_, T, Hkv, _) = key
    q, k, v, qp, kp = prefill_inputs(B, S, T, Hq, Hkv, D, torch.bfloat16, gen)
    got = ops.flash_attention(q, k, v, qp, kp, window=window)
    want = ref.flash_attention(q, k, v, qp, kp, window=window)
    err = check_close("K1 timing inputs", got, want, "bfloat16")
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    d = qp[:, :, None] - kp[:, None, :]
    ok = (d >= 0) & (kp[:, None, :] >= 0)         # allowed (q, kv) pairs
    if window is not None:
        ok &= d < window
    def kern():
        return ops.flash_attention(q, k, v, qp, kp, window=window)

    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    mask = (dict(is_causal=True) if window is None or S <= window
            else dict(attn_mask=ok[:, None]))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, **mask, **gqa)

    ms = _time_ms(kern, flush)
    plain = _time_ms(lambda: ref.flash_attention(q, k, v, qp, kp,
                                                 window=window), flush)
    lib = _time_ms(sdpa, flush)
    flops = 4.0 * int(ok.sum().item()) * Hq * D    # QK^T and P.V
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * 2 \
        + (qp.numel() + kp.numel()) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, **_split_times(kern, flush, sdpa),
        "shape": f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16"
                 + ("" if window is None else f" window={window}")}


def _k2_row(key, launches, gen, flush, prompts, window=None):
    """K2 timed at one (q, k) shape of a decode step, row b's cache
    filled with a prompt drawn from ``prompts`` plus 1..32 new tokens, as
    on the main path.  Returns (row, the fill)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (B, Hq, D), (_, T, Hkv, _) = key
    cpu = torch.Generator().manual_seed(2)
    fill = (prompts(B, cpu)                               # prompt + new
            + torch.randint(1, 33, (B,), generator=cpu)).clamp(max=T).tolist()
    q, k, v, qp, kp = decode_inputs(B, T, Hq, Hkv, D, torch.bfloat16, gen,
                                    fill=fill)
    got = ops.decode_attention(q, k, v, qp, kp, window=window)
    C = _launched_split("decode_attention")[0]
    want = ref.decode_attention(q, k, v, qp, kp, window=window)
    err = check_close("K2 timing inputs", got, want, "bfloat16")
    qh = q[:, :, None].contiguous()                       # (B,H,1,D)
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
    ok = (kp >= 0) & (kp <= qp[:, None])
    if window is not None:
        ok &= qp[:, None] - kp < window
    mask = ok[:, None, None, :]
    def kern():
        return ops.decode_attention(q, k, v, qp, kp, window=window)

    gqa = {"enable_gqa": True} if Hq != Hkv else {}

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              **gqa)

    ms = _time_ms(kern, flush)
    plain = _time_ms(lambda: ref.decode_attention(q, k, v, qp, kp,
                                                  window=window), flush)
    lib = _time_ms(sdpa, flush)
    valid = int(ok.sum().item())
    nbytes = (q.numel() + got.numel()) * 2 + valid * Hkv * D * 2 * 2 \
        + (qp.numel() + kp.numel()) * 4            # only live slots are read
    flops = 4.0 * valid * Hq * D
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:189",
        "launches": launches["decode_attention"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, **_split_times(kern, flush, sdpa), "cluster": C,
        "shape": f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 "
                 f"live_slots={valid}"
                 + ("" if window is None else f" window={window}")}, fill


def _k3_row(key, launches, gen, flush, fill) -> dict:
    """K3 timed at one (q, pool, tables) shape of a paged decode step,
    row b holding ``fill[b]`` tokens over shuffled pages of a pool with
    spare pages, bitwise against K2 on the gathered view, beside its
    bound, plain version and two page gathers + SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (qs, ks, ts) = key
    B, Hq, D = qs
    page, Hkv, ppr = ks[1], ks[2], ts[1]
    q, kpg, vpg, tab, qp, kvp = paged_inputs(B, ppr, page, Hq, Hkv, D,
                                             torch.bfloat16, gen, fill=fill)
    got = ops.paged_decode_attention(q, kpg, vpg, tab, qp, kvp)
    C = _launched_split("paged_decode_attention")[0]
    want = ref.paged_decode_attention(q, kpg, vpg, tab, qp, kvp)
    err = check_close("K3 timing inputs", got, want, "bfloat16")
    kd, vd, kpd = gathered(kpg, vpg, tab, kvp)
    if not torch.equal(got, ops.decode_attention(q, kd.contiguous(),
                                                 vd.contiguous(), qp,
                                                 kpd.contiguous())):
        raise RuntimeError("K3 timing inputs: not bitwise equal to K2")
    flat = tab.reshape(-1).long()
    mask = ((kpd >= 0) & (kpd <= qp[:, None]))[:, None, None, :]
    qh = q[:, :, None].contiguous()

    def gather_sdpa():
        # two page gathers and one SDPA: no single PyTorch call computes
        # attention through a page table
        kg = kpg.index_select(0, flat).view(B, ppr * page, Hkv, D)
        vg = vpg.index_select(0, flat).view(B, ppr * page, Hkv, D)
        return F.scaled_dot_product_attention(
            qh, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask,
            **({"enable_gqa": True} if Hq != Hkv else {}))

    lib_out = gather_sdpa()[:, :, 0]
    check_close("K3 yardstick", lib_out, want, "bfloat16")
    def kern():
        return ops.paged_decode_attention(q, kpg, vpg, tab, qp, kvp)

    ms = _time_ms(kern, flush)
    plain = _time_ms(lambda: ref.paged_decode_attention(q, kpg, vpg, tab,
                                                        qp, kvp), flush)
    lib = _time_ms(gather_sdpa, flush)
    valid = int(((kpd >= 0) & (kpd <= qp[:, None])).sum().item())
    nbytes = (q.numel() + got.numel()) * 2 + valid * Hkv * D * 2 * 2 \
        + (qp.numel() + kpd.numel() + tab.numel()) * 4
    flops = 4.0 * valid * Hq * D
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:132",
        "launches": launches["paged_decode_attention"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, **_split_times(kern, flush, gather_sdpa),
        "library": "2x index_select + scaled_dot_product_attention",
        "cluster": C,
        "shape": f"B={B} ppr={ppr} page={page} Hq={Hq} Hkv={Hkv} D={D} "
                 f"bf16 live_slots={valid} pool_pages={kpg.shape[0]}"}


def _k5_row(key, launches, gen, flush) -> dict:
    """K5 timed at one (a, b) shape of a prefill, beside its bound and
    its plain version; no single PyTorch call computes the recurrence."""
    import torch
    from repro_torch.kernels import ops, ref
    (B, S, I, N), _ = key
    a, b, h0 = ssd_inputs(B, S, I, N, gen)
    hs, hf = ops.ssd_scan(a, b, h0)
    want_hs, want_hf = ref.ssd_scan(a, b, h0)
    torch.testing.assert_close(hs, want_hs, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hf, want_hf, atol=1e-4, rtol=1e-4)
    err = max((hs - want_hs).abs().max().item(),
              (hf - want_hf).abs().max().item())
    def kern():
        return ops.ssd_scan(a, b, h0)

    ms = _time_ms(kern, flush)
    plain = _time_ms(lambda: ref.ssd_scan(a, b, h0), flush, reps=10,
                     warmup=2)
    nbytes = (a.numel() + b.numel() + hs.numel()
              + h0.numel() + hf.numel()) * 4     # read a, b, h0; write hs, h
    flops = 2.0 * a.numel()                      # a*h + b per element
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:58",
        "launches": launches["ssd_scan"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, **_split_times(kern, flush),
        "library": "none (no PyTorch call computes the recurrence)",
        "shape": f"B={B} S={S} I={I} N={N} float32"}


def _k4_row(key, launches, gen, flush, shape_launches=None) -> dict:
    """K4 timed at one (r,) shape of a prefill, beside its bound and its
    plain version; no single PyTorch call computes the recurrence.  The
    row carries, given, the launches the main path made at this shape."""
    import torch
    from repro_torch.kernels import ops, ref
    ((B, S, H, D),) = key
    xs = rwkv_inputs(B, S, H, D, gen)
    got = ops.rwkv6_scan(*xs)
    err = _rwkv_close("timing inputs", got, ref.rwkv6_scan(*xs), "float32")
    def kern():
        return ops.rwkv6_scan(*xs)

    ms = _time_ms(kern, flush)
    plain = _time_ms(lambda: ref.rwkv6_scan(*xs), flush, reps=10, warmup=2)
    y, s_final = got
    # read r, k, v, lw, u, s0 once; write y and s_final once
    nbytes = (5 * y.numel() + 2 * s_final.numel() + xs[4].numel()) * 4
    flops = 5.0 * B * S * H * D * D     # a product and two fmas per (t,i,j)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:87",
        "launches": launches["rwkv6_scan"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, **_split_times(kern, flush),
        "library": "none: no PyTorch call computes the WKV6 recurrence",
        **({} if shape_launches is None else
           {"shape_launches": shape_launches}),
        "shape": f"B={B} S={S} H={H} D={D} float32"}


def timing_train(launches_5o: int) -> dict:
    """Phase 6's K1 row at stablelm-1.6b's training microbatch (B = 4,
    S = T = 2048, 32/32 heads, D = 64, bf16), with its launches in 5o."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    key = ((4, 2048, 32, 64), (4, 2048, 32, 64))
    return {**_k1_row(key, {"flash_attention": launches_5o}, gen, flush),
            "case": "stablelm-1.6b training microbatch (5o)"}


def _stablelm_prompts(n, gen):
    import torch
    return torch.randint(64, 513, (n,), generator=gen)


def _moe_prompts(n, gen):
    import torch
    lens = torch.tensor(MOE_PROMPTS)
    return lens[torch.randint(0, len(lens), (n,), generator=gen)]


def _scan_prompts(n, gen):
    import torch
    lens = torch.tensor(SCAN_PROMPTS)
    return lens[torch.randint(0, len(lens), (n,), generator=gen)]


def timing(shapes: dict, launches: dict, hy_shapes: dict,
           hy_launches: dict, window: int, rw_shapes: dict,
           rw_launches: dict, moe_shapes: dict, moe_launches: dict,
           qw_shapes: dict, qw_launches: dict, hp_shapes: dict,
           hp_launches: dict, tp_shapes: dict, tp_launches: dict) -> tuple:
    """Phase 6.  Returns (the kernels' rows: K1, K2 at stablelm's main
    path, K3 at the paged tier's, K4 at rwkv6's, K5 at hymba's, K3 at
    hymba's paged global layers (5l), K1 and K2 at a qwen2.5-14b tp-2
    shard's (5n (a)); K1, K2
    and K5 at hymba's shapes; K4 at one 512-token prompt; K1 at the
    smaller prefill buckets and K2 at the edge's B = 2; K1, K2 and K3 at
    qwen2-moe-a2.7b's shapes, K2 at its edge's B = 2 too, and K1 and K2
    at qwen2.5-14b's cloud shapes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []

    # K1 at the main path's largest prefill bucket
    rows.append(_k1_row(max(shapes["K1"], key=lambda s: (
        s[0][1], shapes["K1"][s])), launches, gen, flush))
    # K2 at the cloud tier's decode batch, cache filled as on the main path
    row, fill = _k2_row(max(shapes["K2"], key=lambda s: (
        s[0][0], shapes["K2"][s])), launches, gen, flush, _stablelm_prompts)
    rows.append(row)

    # K3 at the paged cloud tier's decode batch: the same live slots as
    # K2's row (same fill), pages shuffled over a pool with spare pages
    rows.append(_k3_row(max(shapes["K3"], key=lambda s: (
        s[0][0], shapes["K3"][s])), launches, gen, flush, fill))
    # K4 at the shape the rwkv6 main path launched it at most
    k4_key = max(rw_shapes["K4"], key=lambda s: (rw_shapes["K4"][s],
                                                 s[0][1]))
    rows.append(_k4_row(k4_key, rw_launches, gen, flush))
    # K5 at the shape the hymba main path launched it at most
    k5_key = max(hy_shapes["K5"], key=lambda s: (hy_shapes["K5"][s],
                                                 s[0][1]))
    rows.append(_k5_row(k5_key, hy_launches, gen, flush))
    # K3 at hymba's global layers on the paged cloud's decode batch
    # (phase 5l): 128 pages a row, rows filled as on its path
    k3h = max(hp_shapes["K3"], key=lambda s: (s[0][0], hp_shapes["K3"][s]))
    cpu = torch.Generator().manual_seed(4)
    B = k3h[0][0]
    fill = (_scan_prompts(B, cpu)
            + torch.randint(1, 33, (B,), generator=cpu)).tolist()
    rows.append({**_k3_row(k3h, hp_launches, gen, flush, fill),
                 "case": "hymba-1.5b global layers (5l)"})
    # K1 and K2 at a shard's shapes of qwen2.5-14b at tp 2 (phase 5n (a):
    # 20 query heads over 4 kv heads at head_dim 128): its largest
    # prefill, and the 16-row decode step, with 5n (a)'s launches
    k1 = max(tp_shapes["K1"], key=lambda s: (s[0][1], tp_shapes["K1"][s]))
    rows.append({**_k1_row(k1, tp_launches, gen, flush),
                 "case": "qwen2.5-14b tp-2 shard (5n a)"})
    k2 = max(tp_shapes["K2"], key=lambda s: (s[0][0], tp_shapes["K2"][s]))
    rows.append({**_k2_row(k2, tp_launches, gen, flush, _moe_prompts)[0],
                 "case": "qwen2.5-14b tp-2 shard (5n a)"})

    # K1 and K2 at hymba's shapes: the longest prefill through a window
    # layer, and the cloud tier's decode batch on the rolling and the
    # global caches
    hy_rows = [_k1_row(max(hy_shapes["K1"], key=lambda s: (
        s[0][1], hy_shapes["K1"][s])), hy_launches, gen, flush, window)]
    for w in (window, None):
        width = w or max(s[1][1] for s in hy_shapes["K2"])
        key = max((s for s in hy_shapes["K2"] if s[1][1] == width),
                  key=lambda s: (s[0][0], hy_shapes["K2"][s]))
        hy_rows.append(_k2_row(key, hy_launches, gen, flush, _scan_prompts,
                               w)[0])
    # and K5 at one 512-token prompt, whatever the path launched most
    (_, _, I, N), _ = k5_key
    hy_rows.append(_k5_row(((1, 512, I, N), None), hy_launches, gen, flush))
    # K4 at every shape the rwkv6 main path launched it at, each with its
    # launches there; their sum weighted by device time is K4's share of
    # phase 5e
    rw_rows = [_k4_row(key, rw_launches, gen, flush, n)
               for key, n in sorted(rw_shapes["K4"].items(),
                                    key=lambda kv: kv[0][0][:2])]
    dev = sum(r["shape_launches"] * r["device_ms"] for r in rw_rows)
    bound = sum(r["shape_launches"] * r["bound_ms"] for r in rw_rows)
    log(f"[time-rwkv6] K4 over phase 5e: {sum(rw_shapes['K4'].values())} "
        f"launches at {len(rw_rows)} shapes, sum of launches x device time "
        f"{dev:.3f} ms (bound {bound:.3f} ms)")
    MAIN_PATH_K4.parent.mkdir(parents=True, exist_ok=True)
    MAIN_PATH_K4.write_text(json.dumps(
        [[list(k[0]), n] for k, n in sorted(rw_shapes["K4"].items())]))
    # K1 at every smaller prefill bucket phase 5 launched, and K2 at the
    # edge tier's B = 2 (stablelm, and hymba's rolling cache)
    more = [_k1_row(max((s for s in shapes["K1"] if s[0][1] == S),
                        key=lambda s: shapes["K1"][s]), launches, gen, flush)
            for S in sorted({s[0][1] for s in shapes["K1"]})[:-1]]
    more.append(_k2_row(min(shapes["K2"], key=lambda s: (
        s[0][0], -shapes["K2"][s])), launches, gen, flush,
        _stablelm_prompts)[0])
    more.append(_k2_row(min((s for s in hy_shapes["K2"]
                             if s[1][1] == window), key=lambda s: (
        s[0][0], -hy_shapes["K2"][s])), hy_launches, gen, flush,
        _scan_prompts, window)[0])
    # K1, K2 and K3 at qwen2-moe-a2.7b's shapes (phase 5j): the largest
    # prefill bucket, the cloud's decode batch, the paged cloud's step
    # over the same live slots, and the edge's decode batch
    moe_rows = [_k1_row(max(moe_shapes["K1"], key=lambda s: (
        s[0][1], moe_shapes["K1"][s])), moe_launches, gen, flush)]
    row, fill = _k2_row(max(moe_shapes["K2"], key=lambda s: (
        s[0][0], moe_shapes["K2"][s])), moe_launches, gen, flush,
        _moe_prompts)
    moe_rows += [row, _k3_row(max(moe_shapes["K3"], key=lambda s: (
        s[0][0], moe_shapes["K3"][s])), moe_launches, gen, flush, fill)]
    moe_rows.append(_k2_row(min(moe_shapes["K2"], key=lambda s: (
        s[0][0], -moe_shapes["K2"][s])), moe_launches, gen, flush,
        _moe_prompts)[0])
    # and K1, K2 at qwen2.5-14b's (phase 5k: 40 query heads over 8, G = 5):
    # its largest prefill, and the cloud endpoint's 16-row step that 5k
    # times (the continuum may have routed no request to the cloud)
    k1 = max(qw_shapes["K1"], key=lambda s: (s[0][1], qw_shapes["K1"][s]))
    moe_rows.append(_k1_row(k1, qw_launches, gen, flush))
    (_, _, Hq, D), (_, _, Hkv, _) = k1
    moe_rows.append(_k2_row(((16, Hq, D), (16, 1024, Hkv, D)), qw_launches,
                            gen, flush, _moe_prompts)[0])
    for tag, rs in (("time", rows), ("time-hymba", hy_rows),
                    ("time-rwkv6", rw_rows), ("time-more", more),
                    ("time-moe", moe_rows)):
        for r in rs:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            cl = f", cluster {r['cluster']}" if "cluster" in r else ""
            if "shape_launches" in r:
                cl += f", launches at this shape {r['shape_launches']}"
            log(f"[{tag}] {r['name']} {r['shape']}: kernel {r['ms']:.4f} "
                f"ms (device alone {r['device_ms']:.4f} ms, host "
                f"{r['host_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
                f"{lib}, launches {r['launches']}{cl}")
    return rows, hy_rows, rw_rows, more, moe_rows


# ------------------------------------------------------- --baseline DIR


def baseline_ab(base: Path) -> list:
    """Phase-6-style timing of this checkout's kernels against an earlier
    revision's sources in ``base``, in this one process on this one card:
    K1, K2 and K3 when ``base`` holds ``flash_attention.cu`` and
    ``decode_attention.cu``, K4 when it holds ``rwkv6_scan.cu``."""
    rows = []
    if all((base / f"{n}.cu").is_file()
           for n in ("flash_attention", "decode_attention")):
        rows += _ab_attention(base)
    if (base / "rwkv6_scan.cu").is_file():
        rows += _ab_rwkv(base)
    if not rows:
        raise RuntimeError(f"{base}: no kernel source to compare against")
    return rows


class _Clocks:
    """``nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit`` sampled
    every 50 ms while the block runs; ``summary`` gives each as [min,
    median, max] over the samples (MHz, W, W) and their count."""

    KEYS = ("clocks.sm", "power.draw", "power.limit")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.KEYS)}",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        samples = []
        for line in out.splitlines():
            try:
                samples.append([float(x) for x in line.split(",")])
            except ValueError:
                continue                   # a line cut short, or [N/A]
        self.summary = {"samples": len(samples)}
        for key, col in zip(self.KEYS, zip(*samples)):
            self.summary[key] = [min(col), statistics.median(col), max(col)]
        return False


def _ab_rwkv(base: Path) -> list:
    """K4 of this checkout against ``base/rwkv6_scan.cu``, at B = 1 and
    every prompt length of the rwkv6 main path (rwkv6-7b: H = D = 64) and
    at every (B, S) phase 6 last recorded for it (``MAIN_PATH_K4``).
    Both are checked against the plain version (and whether they are
    bitwise equal is printed), then timed baseline, new, new, baseline
    three ways, as for K1/K2, with the card's SM clock and power sampled
    beside.  The new kernel goes through the port's launcher, the
    baseline straight through ctypes (the entry points take the same
    arguments); both libraries' host side is timed through the same
    ctypes path."""
    import ctypes
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rwkv6_scan as k4
    P, I = ctypes.c_void_p, ctypes.c_int

    def direct(csrc: Path) -> tuple:
        lib = ctypes.CDLL(str(_build.build(["rwkv6_scan"],
                                           csrc=csrc)["rwkv6_scan"]))
        lib.repro_cuda_error_string.argtypes = [I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        fn = lib.repro_rwkv6_scan
        fn.argtypes = [P] * 8 + [I] * 4 + [P]
        fn.restype = I

        def call(xs):
            y, sf = torch.empty_like(xs[0]), torch.empty_like(xs[5])
            err = fn(*(t.data_ptr() for t in xs), y.data_ptr(),
                     sf.data_ptr(), *xs[0].shape,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(
                    f"{csrc}: K4 failed: "
                    f"{lib.repro_cuda_error_string(err).decode()}")
            return y, sf
        return call

    new_direct, old_direct = direct(_build.CSRC), direct(base)

    shapes = {(1, S, 64, 64) for S in SCAN_PROMPTS + (LONG_PROMPT,)}
    main = {}
    if MAIN_PATH_K4.is_file():
        main = {tuple(k): n for k, n in json.loads(MAIN_PATH_K4.read_text())}
        shapes |= set(main)
        written = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(
            MAIN_PATH_K4.stat().st_mtime))
        log(f"[ab] K4 main-path shapes and launches from {MAIN_PATH_K4} "
            f"(written {written} by an earlier phase 6 in this checkout)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for shape in sorted(shapes):
        label = f"K4 B={shape[0]} S={shape[1]}"
        xs = rwkv_inputs(*shape, gen)

        def new_fn():
            return k4.rwkv6_scan(*xs)

        def old_fn_():
            return old_direct(xs)

        def direct_fn():
            return new_direct(xs)

        got_new = new_fn()
        got_old, got_direct = old_fn_(), direct_fn()
        torch.cuda.synchronize()
        want = ref.rwkv6_scan(*xs)
        err_new = _rwkv_close(f"{label} (new)", got_new, want, "float32")
        err_old = _rwkv_close(f"{label} (baseline)", got_old, want,
                              "float32")
        if not all(torch.equal(a, b) for a, b in zip(got_new, got_direct)):
            raise RuntimeError(f"{label}: the launcher and a direct call "
                               f"disagree")
        same = [torch.equal(a, b) for a, b in zip(got_new, got_old)]
        row = {"label": label, "shape": list(shape),
               "max_abs_err": err_new, "baseline_max_abs_err": err_old,
               "bitwise_equal_y": same[0], "bitwise_equal_s_final": same[1]}
        log(f"[ab] {label}: max_abs_err new {err_new:.3e} baseline {err_old:.3e}, bitwise equal to "
            f"the baseline: y {same[0]}, s_final {same[1]}")
        with _Clocks() as clocks:
            for key, timer, new in (
                    ("ms", lambda f: _time_ms(f, flush), new_fn),
                    ("device_ms", lambda f: _time_ms(f, flush, isolate=True),
                     new_fn),
                    ("host_ms", _host_ms, direct_fn)):
                t = [timer(fn) for fn in (old_fn_, new, new, old_fn_)]
                row[f"baseline_{key}"], row[f"new_{key}"] = ([t[0], t[3]],
                                                             t[1:3])
                log(f"[ab] {label} {key}: baseline {t[0]:.5f} / "
                    f"{t[3]:.5f}, new {t[1]:.5f} / {t[2]:.5f}, ratio "
                    f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x")
        row["clocks"] = clocks.summary
        log(f"[ab] {label} nvidia-smi [min, median, max]: {clocks.summary}")
        rows.append(row)
    if main:
        by_shape = {tuple(r["shape"]): r for r in rows}
        tot = {side: sum(n * statistics.mean(by_shape[sh][f"{side}_device_ms"])
                         for sh, n in main.items())
               for side in ("baseline", "new")}
        log(f"[ab] K4 over the phase 5e of {written} "
            f"({sum(main.values())} launches at {len(main)} shapes): sum of "
            f"launches x device time, baseline {tot['baseline']:.3f} ms, new "
            f"{tot['new']:.3f} ms")
    return rows


def _ab_attention(base: Path) -> list:
    """K1, K2 and K3 of this checkout against the same kernels built from
    ``base/flash_attention.cu`` and ``base/decode_attention.cu`` (an
    earlier revision's sources), in this one process on this one card.
    Each shape is timed baseline, new, new, baseline, three ways (events
    around the call, the device alone, the host's enqueue; L2 flushed)
    after both are checked against the plain version.  The float32 K1
    and the C = 1 K2/K3 launches must be bitwise equal to the
    baseline's.  A baseline ``decode_attention.cu`` whose entry points
    take no ``cluster``/``span`` arguments is called without them."""
    import ctypes
    import torch
    from repro_torch.kernels import _build, ops, ref
    names = ("flash_attention", "decode_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def direct(csrc: Path) -> tuple:
        """K1, K2 and K3 of the libraries built from ``csrc``, called
        straight through ctypes: one host path for both revisions."""
        lib = {n: ctypes.CDLL(str(p))
               for n, p in _build.build(names, csrc=csrc).items()}
        split_abi = "int cluster" in (csrc / "decode_attention.cu").read_text()
        extra = [I, I] if split_abi else []
        fa = lib["flash_attention"].repro_flash_attention
        fa.argtypes, fa.restype = [P] * 6 + [I] * 9 + [F, F, P], I
        dec = lib["decode_attention"].repro_decode_attention
        dec.argtypes = [P] * 6 + [I] * 7 + [F, F] + extra + [P]
        pdec = lib["decode_attention"].repro_paged_decode_attention
        pdec.argtypes = [P] * 7 + [I] * 8 + [F, F] + extra + [P]
        dec.restype = pdec.restype = I

        def call(fn, tensors, ints, D, window, name, out):
            # a split entry point gets the (C, span) the port's launcher
            # last ran with: ``ab`` launches it first
            stream = torch.cuda.current_stream().cuda_stream
            win = -1 if window is None else window
            more = [_launched_split(name)] if split_abi else []
            err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), *ints,
                     win, 0.0, D ** -0.5, *(x for cs in more for x in cs),
                     stream)
            if err:
                raise RuntimeError(f"{csrc}: launch failed: CUDA error {err}")
            return out

        def k1(q, k, v, qp, kp, window=None):
            B, S, Hq, D = q.shape
            T, Hkv = k.shape[1:3]
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            err = fa(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                     kp.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
                     int(q.dtype == torch.bfloat16), 1,
                     -1 if window is None else window, 0.0, D ** -0.5,
                     stream)
            if err:
                raise RuntimeError(f"{csrc}: K1 failed: CUDA error {err}")
            return out

        def k2(q, k, v, qp, kp, window=None):
            B, Hq, D = q.shape
            T, Hkv = k.shape[1:3]
            return call(dec, (q, k, v, qp, kp),
                        (B, T, Hq, Hkv, D, int(q.dtype == torch.bfloat16)),
                        D, window, "decode_attention", torch.empty_like(q))

        def k3(q, kpg, vpg, tab, qp, kvp, window=None):
            B, Hq, D = q.shape
            page, Hkv = kpg.shape[1:3]
            ppr = tab.shape[1]
            return call(pdec, (q, kpg, vpg, tab, qp, kvp),
                        (B, ppr, page, Hq, Hkv, D,
                         int(q.dtype == torch.bfloat16)), D, window,
                        "paged_decode_attention", torch.empty_like(q))

        return k1, k2, k3

    new_k1, new_k2, new_k3 = direct(_build.CSRC)
    old_k1, old_k2, old_k3 = direct(base)

    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cpu = torch.Generator().manual_seed(2)
    rows = []

    def ab(label, new_fn, old_fn, direct_fn, want, dname="bfloat16",
           bitwise=False):
        """``new_fn`` goes through the port's launcher, ``old_fn`` and
        ``direct_fn`` (the new library) straight through ctypes.  Times
        ms and device_ms of old vs new_fn, host_ms of old vs direct_fn
        (the libraries' own host side) and, once, of new_fn (the port's
        launcher as a whole)."""
        got_new, got_old, got_direct = new_fn(), old_fn(), direct_fn()
        torch.cuda.synchronize()
        check_close(f"{label} (new)", got_new, want, dname)
        check_close(f"{label} (baseline)", got_old, want, dname)
        if not torch.equal(got_new, got_direct):
            raise RuntimeError(f"{label}: the launcher and a direct call "
                               f"disagree")
        if bitwise and not torch.equal(got_new, got_old):
            raise RuntimeError(f"{label}: not bitwise equal to the baseline")
        row = {"label": label, "bitwise_equal": bitwise or None}
        for key, timer, new in (
                ("ms", lambda f: _time_ms(f, flush), new_fn),
                ("device_ms", lambda f: _time_ms(f, flush, isolate=True),
                 new_fn),
                ("host_ms", _host_ms, direct_fn)):
            t = [timer(fn) for fn in (old_fn, new, new, old_fn)]
            row[f"baseline_{key}"], row[f"new_{key}"] = [t[0], t[3]], t[1:3]
            log(f"[ab] {label} {key}: baseline {t[0]:.5f} / {t[3]:.5f}, "
                f"new {t[1]:.5f} / {t[2]:.5f}, ratio "
                f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
                + (", bitwise equal" if bitwise else ""))
        row["launcher_host_ms"] = _host_ms(new_fn)
        log(f"[ab] {label} launcher_host_ms: {row['launcher_host_ms']:.5f}")
        rows.append(row)

    # K1: stablelm's prefill buckets, hymba's longest window prefill; and
    # float32 (the CUDA-core body) bitwise equal to the baseline's
    for label, B, S, Hq, Hkv, window, dt in (
            ("K1 stablelm S=512", 1, 512, 32, 32, None, torch.bfloat16),
            ("K1 stablelm S=256", 1, 256, 32, 32, None, torch.bfloat16),
            ("K1 stablelm S=128", 1, 128, 32, 32, None, torch.bfloat16),
            ("K1 hymba S=1024", 1, 1024, 25, 5, 1024, torch.bfloat16),
            ("K1 float32 S=512", 1, 512, 32, 32, None, torch.float32),
            ("K1 float32 ragged window", 2, 200, 8, 2, 64, torch.float32)):
        q, k, v, qp, kp = prefill_inputs(B, S, S, Hq, Hkv, 64, dt, gen)
        f32 = dt == torch.float32
        ab(label,
           lambda: ops.flash_attention(q, k, v, qp, kp, window=window),
           lambda: old_k1(q, k, v, qp, kp, window),
           lambda: new_k1(q, k, v, qp, kp, window),
           ref.flash_attention(q, k, v, qp, kp, window=window),
           "float32" if f32 else "bfloat16", bitwise=f32)

    # K2: stablelm's cloud (C = 1, bitwise) and edge steps, hymba's cloud
    # steps on both cache widths and its edge step; K3 at stablelm's
    # paged cloud step (C = 1, bitwise)
    for label, B, T, Hq, Hkv, window, prompts, dt in (
            ("K2 stablelm B=16", 16, 1024, 32, 32, None, _stablelm_prompts,
             torch.bfloat16),
            ("K2 stablelm B=16 float32", 16, 1024, 32, 32, None,
             _stablelm_prompts, torch.float32),
            ("K2 stablelm edge B=2", 2, 1024, 32, 32, None,
             _stablelm_prompts, torch.bfloat16),
            ("K2 hymba rolling B=16", 16, 1024, 25, 5, 1024, _scan_prompts,
             torch.bfloat16),
            ("K2 hymba global B=16", 16, 2048, 25, 5, None, _scan_prompts,
             torch.bfloat16),
            ("K2 hymba edge B=2", 2, 1024, 25, 5, 1024, _scan_prompts,
             torch.bfloat16)):
        fill = (prompts(B, cpu) + torch.randint(1, 33, (B,), generator=cpu)
                ).clamp(max=T).tolist()
        q, k, v, qp, kp = decode_inputs(B, T, Hq, Hkv, 64, dt, gen,
                                        fill=fill)
        ops.decode_attention(q, k, v, qp, kp, window=window)
        c = _launched_split("decode_attention")[0]
        f32 = dt == torch.float32
        ab(f"{label} C={c}",
           lambda: ops.decode_attention(q, k, v, qp, kp, window=window),
           lambda: old_k2(q, k, v, qp, kp, window),
           lambda: new_k2(q, k, v, qp, kp, window),
           ref.decode_attention(q, k, v, qp, kp, window=window),
           "float32" if f32 else "bfloat16", bitwise=c == 1)
        if label == "K2 stablelm B=16":
            q, kpg, vpg, tab, qp, kvp = paged_inputs(
                B, T // 16, 16, Hq, Hkv, 64, dt, gen, fill=fill)
            ab(f"K3 stablelm B=16 C={c}",
               lambda: ops.paged_decode_attention(q, kpg, vpg, tab, qp, kvp),
               lambda: old_k3(q, kpg, vpg, tab, qp, kvp),
               lambda: new_k3(q, kpg, vpg, tab, qp, kvp),
               ref.paged_decode_attention(q, kpg, vpg, tab, qp, kvp),
               bitwise=c == 1)
    return rows


# ---------------------------------------------------------------- main


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if len(sys.argv) == 3 and sys.argv[1] == "--baseline":
        rows = baseline_ab(Path(sys.argv[2]).resolve())
        log(f"[ab] {json.dumps({'card': card, 'rows': rows})}")
        log(f"[done] {time.perf_counter() - t_start:.1f}s")
        return 0
    log(f"[build] kernels built in {build_kernels():.1f}s")
    parity()
    parity_paged()
    parity_ssd()
    parity_rwkv()
    smoke_model_vs_cpu("stablelm-1.6b")
    smoke_model_vs_cpu("hymba-1.5b", ("flash_attention", "decode_attention",
                                      "ssd_scan"))
    smoke_model_vs_cpu("hymba-1.5b", PAGED_HYMBA_KERNELS, paged=True,
                       hit=True)
    smoke_model_vs_cpu("nemotron-4-340b", ("flash_attention",
                                           "paged_decode_attention"),
                       paged=True, hit=True)
    smoke_model_vs_cpu("rwkv6-7b", ("rwkv6_scan",))
    for arch in NEW_SMOKE_ARCHS:                       # phase 4d
        smoke_model_vs_cpu(arch)
    llama3_smoke_refuses_the_card()
    smoke_model_vs_cpu("qwen2-moe-a2.7b", ("flash_attention",
                                           "paged_decode_attention"),
                       paged=True)
    smoke_tp_on_card()                                 # phase 4e
    train_smoke_launches = train_smoke_on_card(card)   # phase 4f
    sharded_smoke_launches = train_sharded_smoke_on_card(card)  # phase 4g
    serve_smoke_launches = serve_sharded_smoke_on_card(card)    # phase 4h
    cfg, params = full_model("stablelm-1.6b")
    shapes: dict = {}
    launches = serve_full(cfg, params, shapes)
    paged_vs_dense(cfg, params, card, {}, "5b")
    paged_shapes: dict = {}
    launches.update({k: v for k, v in serve_paged(cfg, params,
                                                  paged_shapes).items()
                     if k.startswith("paged_")})
    shapes["K3"] = paged_shapes["K3"]
    chain_launches, chain_summary = serve_chain(cfg, params, {}, card)
    sketch_launches = sketch_chain(cfg, params, card, chain_summary)
    mig_launches = migration_phase(cfg, params, card)
    free_card("5h")
    outputs_5m: dict = {}
    costed_launches = serve_costed_chain(cfg, params, card, outputs_5m)
    free_card("5m")
    tp_chain_launches = serve_costed_chain_tp(cfg, params, card, outputs_5m)
    free_card("5n (b)")
    faas_bodies(card)
    sim_sweep()
    serve_5q = serve_sharded_full_on_card(cfg, params, card)   # phase 5q
    del params
    free_card("stablelm-1.6b")
    hcfg, hparams = full_model("hymba-1.5b")
    hy_shapes: dict = {}
    hy_launches = serve_hymba(hcfg, hparams, hy_shapes, card)
    for k, n in migration_hymba(hcfg, hparams, card).items():
        mig_launches[k] = mig_launches.get(k, 0) + n
    free_card("5d and 5h (c)")
    hp_shapes: dict = {}
    hp_launches = serve_hymba_paged(hcfg, hparams, card, hp_shapes)
    del hparams
    free_card("hymba-1.5b")
    rcfg, rparams = full_model("rwkv6-7b")
    rw_shapes: dict = {}
    rw_launches = serve_rwkv6(rcfg, rparams, rw_shapes, card)
    for k, n in migration_rwkv6(rcfg, rparams, card).items():
        mig_launches[k] = mig_launches.get(k, 0) + n
    del rparams
    free_card("rwkv6-7b")
    mcfg, mparams = full_model("qwen2-moe-a2.7b")
    moe_shapes, moe_launches = serve_moe(mcfg, mparams, card)
    del mparams
    free_card("qwen2-moe-a2.7b")
    qcfg, qparams = full_model("qwen2.5-14b")
    qw_shapes: dict = {}
    qw_summary: dict = {}
    qwen_launches = serve_qwen25(qcfg, qparams, card, qw_shapes, qw_summary)
    free_card("5k")
    tp_shapes: dict = {}
    tp_launches = serve_qwen25_tp(qcfg, qparams, card, tp_shapes, qw_summary)
    del qparams
    free_card("qwen2.5-14b")
    train_5o = train_full_on_card(card)                # phase 5o
    free_card("5o")
    train_5p = train_sharded_full_on_card(card)        # phase 5p
    free_card("5p")
    rows, hy_rows, rw_rows, more, moe_rows = timing(
        shapes, launches, hy_shapes, hy_launches, hcfg.sliding_window,
        rw_shapes, rw_launches, moe_shapes, moe_launches, qw_shapes,
        qwen_launches, hp_shapes, hp_launches, tp_shapes, tp_launches)
    for row in rows:
        if row["name"] in ("flash_attention", "decode_attention",
                           "paged_decode_attention"):
            row["launches_5f"] = chain_launches[row["name"]]
            row["launches_5i"] = sketch_launches[row["name"]]
            row["launches_5j"] = moe_launches[row["name"]]
            row["launches_5k"] = qwen_launches.get(row["name"], 0)
            row["launches_5m"] = costed_launches[row["name"]]
            row["launches_5n_b"] = tp_chain_launches[row["name"]]
        row["launches_5h"] = mig_launches.get(row["name"], 0)
        row["launches_5l"] = hp_launches.get(row["name"], 0)
        row["launches_4f"] = train_smoke_launches.get(row["name"], 0)
    rows.append(timing_train(train_5o["launches"]))
    for row in rows:
        row["launches_4g"] = sharded_smoke_launches.get(row["name"], 0)
        row["launches_4h"] = serve_smoke_launches.get(row["name"], 0)
        row["launches_5q"] = serve_5q["launches"].get(row["name"], 0)
        row["launches_5p"] = (train_5p["launches"]
                              if row["name"] == "flash_attention" else 0)
    log(f"[time-hymba] {json.dumps({'kernels_at_hymba_shapes': hy_rows})}")
    log(f"[time-rwkv6] {json.dumps({'k4_rwkv6': rw_rows})}")
    log(f"[time-more] {json.dumps({'buckets_and_edge': more})}")
    log(f"[time-moe] {json.dumps({'kernels_at_5j_5k_shapes': moe_rows})}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
