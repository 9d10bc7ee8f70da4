#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``replicatinggpt_tpu_torch`` (never the JAX package) in phases,
and fails (non-zero exit) on the first phase that fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``replicatinggpt_tpu_torch/csrc/`` (with
   ``-Xptxas -v``: registers, shared memory and spills a kernel); name the
   flash kernels' two bodies (bf16 on the tensor cores, f32 on the CUDA
   cores) and, where the toolkit has ``cuobjdump``, count the HMMA/HGMMA
   instructions of each bf16 flash kernel (evidence, gating nothing);
3. kernel phase: ``paged_window_attention`` against its plain PyTorch
   version at the serving path's shapes (GPT-2 124M: C=768, H=12,
   page 16, 64 pages per slot, 512 pages, 8 slots), W in {1, 4, 5} (5:
   the speculative verify window at k = 4, two passes of 4 rows), bf16
   (atol = rtol = 2e-2: bf16 output rounding and another summation
   order) and f32 (1e-4); then, at W=1 and at W=5 (the split sized from
   the longest pos, as the engine's verify sizes it), CUDA-event timings
   of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` over the same K/V gathered dense
   with the same mask (the library yardstick, used nowhere in the port;
   after half a second of launches to settle the clocks, the kernel and
   the library timed in turns and each averaged over its two turns),
   the kernel's rate (the bound's bytes over its time) and its split
   (CTAs of a cluster, grid, tile rows, passes); row #1's ``w5_*``
   fields;
4. flash kernel phase: ``flash_packed_fwd`` / ``flash_packed_bwd``
   against their plain versions at the training path's shapes (char-GPT:
   B=64, T=256, C=384, H=6), bf16 and f32 (``FLASH_TOL``: one bf16 ulp,
   else 1e-4; every flash check feeds bf16 inputs on the exact grid of
   ``on_grid``), attention dropout off and at 0.2 with one seed (o, lse,
   d(qkv)); then timings of
   both kernels, their plain versions and ``scaled_dot_product_attention``
   on split heads (its forward, and its backward), at the path's dropout;
5. serving parity phase: one greedy request set through the engine at
   f32, 2 layers of full width, on the kernel route and on the gather
   route; the token streams must be identical;
6. serving slice (a main path): ``serve-replay`` of GPT-2 124M at random
   init through the port's CLI with the kernel route, greedy and then
   sampled; every request completes, every token is in the vocabulary,
   the prefix cache hits, and the kernel ran 12 times per decode step;
7. training parity phase: char-GPT width, 2 layers, f32, 10 steps through
   the kernels and 10 through the packed plain version with the same
   seeds and batches, dropout off and on; per-step losses within 1e-4
   relative;
8. decode kernel phase: ``fused_decode_layers`` against its plain
   version at the generation path's shapes (char-GPT: L=6, C=384, H=6,
   S=256) and at GPT-2 124M B=1 (L=12, C=768, H=12, S=1024), both cache
   layouts, and ``packed_decode_attention`` at GPT-2 124M (B=8, S=1024,
   C=768, H=12); bf16 (2e-2) and f32 (1e-4), pos at 0, inside and at
   S-1 (packed: also one pos for each rank count of its split, 1 to 8,
   and the split printed), NaN in every cache row >= pos; then timings
   of the kernels, their
   plain versions and (packed attention) ``scaled_dot_product_attention``
   over the split-heads cache after the write; the fused kernel's rate,
   its split (grid, each product's column tiles x input slices) and the
   cost of one of its grid barriers (a cooperative kernel on the same
   grid that crosses 1000 barriers and does nothing else);
9. generation parity phase: f32 greedy streams through ``generate()`` on
   the kernel routes and the plain route must be identical: char-GPT
   width, 2 layers, B=1, 300 tokens (one window refresh; fused kernel);
   GPT-2 width, 2 layers, packed cache, B=4, 64 tokens (packed kernel);
10. training slice (a main path): ``train --preset char-gpt
   --sample-after --sample-tokens 1000`` through the port's CLI for 300
   steps; every loss finite, the final val loss under 3.0 and under the
   step-0 estimate, the forward kernel launched 6 times per train step
   and per eval batch, the backward 6 times per step; the sample is 1000
   characters of the corpus's vocabulary and ran the fused decode kernel
   exactly 1030 times (256 first-segment steps + 6 x 129 refresh steps);
11. generation slice (a main path): five more 1000-token char-GPT
   samples through ``generate()`` (p50 tokens/s, the BASELINE config 5
   metric; random weights, as speed does not depend on them), then GPT-2
   124M, packed cache, bf16, B=8, 64-token random prompts, 256 new
   tokens: the packed kernel runs exactly 12 x 256 = 3072 times;
12. paged fused kernel phase: ``fused_paged_decode_layers`` against its
   plain version at the char-GPT serving path's shapes (L=6, C=384, H=6,
   pages of 16, 16 pages per slot, 8 slots at ragged positions, one of
   them inactive at 0), f32 (1e-4) then bf16 (2e-2), in every pool (none,
   int8 and fp8, page and head scales), NaN in every pool row (quantized:
   every scale) at or past a slot's position, with the history split
   sized from the longest position (the engine's call) and from the
   whole table; then the plan (grid, splits, ring) and timings of the
   kernel and its plain version in every pool (bf16), against the bound. No
   single PyTorch call computes every layer of a step: no library time;
13. quantized paged kernel phase: ``paged_window_attention`` with int8
   and fp8 pages, page and head scales, at the GPT-2 124M serving shapes
   (B=8, W=1), bf16 and f32, against its plain version, with timings
   and rates (the kernel line's ``int8_ms`` and ``fp8_ms``: page scales);
14. fused serving parity phase: f32 greedy streams through the engine at
   char-GPT width, 2 layers, on the fused route and on the gather route,
   with unquantized (fused route forced: the JAX envelope keeps f32
   char-GPT layers off it), int8 and fp8 pools; identical streams;
15. serving slice, char-GPT (a main path): ``serve-replay --preset
   char-gpt`` (bf16, random init, fused route) with 24 shared-prefix
   requests of prompts up to 128 and 64 new tokens: one fused launch per
   decode step exactly; then a 4-layer ``gpt2-small --kv-quant int8``
   replay on the per-layer route (its kernel 4 times per step);
16. flash kernel phase at GPT-2 124M (TPU rows #7-#12, which the JAX
   package's head-group families compute): B=32, T=1024, C=768, H=12,
   bf16 and f32 (``FLASH_TOL``), attention dropout 0 and 0.1, then B=1,
   T=8192 in f32 and bf16, q/k/v at the path's scale; o, lse and d(qkv)
   against the plain versions, then timings (dropout 0, the path's) of the
   kernels, the plain versions and ``scaled_dot_product_attention``;
17. GPT-2 training parity phase: 124M width, 2 layers, T=1024, B=2, f32,
   5 steps through the kernels and through the plain version; per-step
   losses within 1e-4 relative;
18. GPT-2 training slice (a main path): ``train --preset gpt2-small``
   through the port's CLI, 200 steps at B=32, T=1024, evals at 0, 100 and
   200 over 20 batches of each split, the byte-level BPE trained at first
   use; every loss finite, the last val loss under ln(1024) (a uniform
   guess over the BPE's tokens) and under step 0's, the forward kernel
   launched 12 times per train step and eval batch, the backward 12 times
   per step;
19. ``train --preset gpt2-shakespeare`` (the reference's GPT-2.py run):
   50 steps, a ``Step {i}, Loss: ...`` line each, 6 + 6 launches a step;
20. heads flash kernel phase (TPU rows #13-#20, ``pallas_flash_attention``
   on (B, H, T, D)): ``flash_heads_fwd`` / ``flash_heads_bwd`` against
   their plain versions at GPT-2 XL's attention shapes (B=16, the slice's
   micro-batch, H=25, T=1024, D=64), bf16 and f32 (``FLASH_TOL``),
   dropout 0 and 0.1, causal; ``causal=False`` at B=2, H=4, T=512; D=256
   at B=2, H=4, T=2048 (the f32 backward on 32-row tiles, the bf16 one
   on 64-row tiles over column chunks of D), bf16 and f32; then
   timings at the path's setting (bf16, dropout 0) of the kernels, their
   plain versions and ``scaled_dot_product_attention(is_causal=True)``
   beside the bound, and of both routes at those shapes: the packed
   kernel on the equivalent (B, T, 3C) input against the heads kernel
   with its split and merge transposes;
21. GPT-2 XL parity phase: C=1600, H=25, T=1024, 2 layers, B=2, f32: 5
   steps through the split-heads kernel route and through the plain
   route (split heads, plain core), per-step losses within 1e-4
   relative; then one step's loss and every gradient with remat on and
   off, identical (deterministic algorithms on);
22. GPT-2 XL training slice (a main path): ``train --preset gpt2-xl``
   through the CLI at the published widths (V=50257, T=1024, L=48, H=25,
   C=1600, remat full) and the JAX preset's optimizer (lr 2e-4,
   constant, no clip, random windows, global batch 64 as 4 accumulated
   micro-batches of 16), cut to ``XL_STEPS`` steps and ``XL_EVAL_ITERS``
   eval batches a split at steps 0 and the end; every loss finite, the
   last val loss under step 0's, the heads kernel's forward launched 48
   x (2 x steps x 4 + eval batches) times (full remat runs each block's
   forward twice a micro-batch), its backward 48 x steps x 4, the packed
   kernel never; the peak of ``torch.cuda.max_memory_allocated()``
   under the card's 80 GB;
23. chunk flash kernel phase (TPU rows #21-#24, ``pallas_flash_chunk``:
   the ring hop): ``flash_chunk_fwd`` / ``flash_chunk_bwd`` against their
   plain versions at the ``--sp 4`` hop of GPT-2 XL (B=16, H=25,
   Tq=Tk=256, D=64), bf16 and f32 (``CHUNK_TOL``: one bf16 ulp; f32
   1e-5), dropout 0 and 0.1, on a fully visible hop, a diagonal one,
   partly masked hops on a tile boundary (q - k = 128) and off it (96), a
   fully masked one (o = 0, lse = NEG_INF, gradients exactly 0) and one
   with Tk = 2 Tq; the backward fed a nonzero lse cotangent. At offsets 0
   the chunk kernel's results and dropout mask equal the heads kernel's
   bit for bit. Then timings of both kernels at the fully visible and the
   diagonal hops (bf16, dropout 0) beside the bound, the plain versions
   and ``scaled_dot_product_attention`` with the hop's boolean mask;
24. ring parity phase: GPT-2 XL width (C=1600, H=25), 2 layers, T=1024,
   B=2, f32, dropout 0: 5 steps through the ring over 4 shards in one
   process (``LocalSeqGroup``; chunk kernel hops) against the same steps
   through the dense heads kernel route, losses within 1e-4 relative; and
   the ring's output and gradients against the heads kernel's at B=2,
   H=25, T=1024;
25. sequence-parallel GPT-2 XL slice (a main path): ``train --preset
   gpt2-xl --sp 4`` through the CLI in one process, as the XL slice
   (4 x 16 micro-batches, ``XL_STEPS`` steps, ``XL_EVAL_ITERS`` eval
   batches at 0 and the end): 'auto' resolves to the ring (25 heads do
   not divide by 4) and the run logs it; every loss finite, the last val
   loss under step 0's, the chunk kernel's forward launched 48 x 10 x
   (2 x steps x 4 + eval batches) times (10 hops a layer: shard i runs
   i + 1; remat runs each forward twice) and its backward 48 x 10 x
   steps x 4, the heads and packed kernels never; the peak memory under
   80 GB.

26. partials kernel phase (row #1's ``fold=False`` over owned pages, the
   sharded serving path's kernel): one model shard of the GPT-2 124M
   serving shapes (H_loc=6, C_loc=384, B=8, W=1, pos ``POS``), its pool in
   2 data blocks whose pages interleave in each slot's table and one slot
   that owns nothing in block 0; bf16, f32, int8 and fp8 pools; each
   block's raw (acc, m, l) against the plain twin (``PARTIALS_TOL``: the
   partials are f32), and both blocks merged and folded against the
   unsharded fold mode (``MERGE_TOL``); then one block's time beside its
   bound (its owned rows' bytes at 3.35 TB/s) and the twin's;
27. mesh serving parity phase: f32 greedy streams of the 2x2 engine
   (``LocalServeGroup``) on the kernel route, the 1x1 kernel route and
   the gather route, 124M widths, 2 layers: identical;
28. mesh serving slice (a main path): ``serve-replay --preset gpt2-small
   --decode-cache-layout packed --paged-kernel --mesh-shape 2x2`` in one
   process, bf16, full width and depth, 16 greedy requests: every request
   completes, the partials kernel runs 12 layers x 4 shards = 48 times a
   decode step and the fold mode never;
29. wide window phase (run right after phase 6): ``paged_window_attention``
   at W in {2, 5, 8, 64} (64: the mixed window's width at 124M, its
   prefill chunk) at the 124M serving shapes, every pool, bf16 and f32
   (``TOL``), slot 0 at pos 0 holding the longest slot's table, the
   split sized from the longest pos; then at W=64, bf16: the kernel's
   time, the plain version's, SDPA with the same mask, the bound and the
   rate (row #1's ``w64_*`` fields);
30. window parity phase: f32 greedy streams of the windowed engine at
   k = 8 and auto-tuned up to 8 equal k = 1's at 124M width (2 layers) on
   the kernel and gather routes, then at char-gpt width on the fused
   route (row #2 in the decode windows, row #1 at W=64 in the mixed
   ones), through arrivals while windows fly, an eos inside a window and
   a cancel; every window step's host bound on the positions at or above
   the card's; row #1 launched 2 times (2 layers) a step of each window
   kind, row #2 once a decode window step; no window break;
31. window sync phase: one steady decode window's launch and one mixed
   window's after an admission (124M width, 2 layers, bf16, sampled
   slots) under ``torch.cuda.set_sync_debug_mode("error")``;
32. windowed serving slice (this slice's main path): ``serve-replay
   --preset gpt2-small --decode-cache-layout packed --paged-kernel
   --decode-window 8 --decode-window-auto`` at full width and depth, the
   k = 1 slice's 16 greedy requests: every request completes, row #1
   runs 12 times a step at W=1 in the decode windows and at W=64 in the
   mixed ones, no window break; tokens/s, TTFT, step p50, dispatches and
   host ms a token beside the k = 1 slice's (row #1's ``launches`` and
   ``launches_by_window`` are this run's; ``launches_k1`` phase 6's);
33. idle phase: the device's idle share at k = 1 and k = 8 (124M, bf16,
   8 decoding slots, ``tools/torch_port_profile.py``'s measure);
34. checkpoint slice (a main path, run after phase 19; its directories
   in a temporary one, removed at the end): ``train()`` of GPT-2 124M
   (the preset's bf16, T=1024, B=32) for 6 steps with a checkpoint every
   3, uninterrupted and then stopped at step 3 (SIGTERM through the
   ``train/step`` seam to a handler that sets the stop event) and resumed
   into a fresh state and model: the losses of steps 3-5, the weights,
   AdamW's moments and count and both dropout streams equal the
   uninterrupted run's bit for bit (PyTorch's default algorithms: no
   step of either model differs between two runs); the same for char-gpt
   with dropout 0.2 (each block's seed, hence its residual masks and rows
   #5-#6's hashed mask, comes from the restored ``seeds`` stream);
   save and restore seconds, bytes and GB/s, the crc32 pass alone; a copy
   of the newest step with 8 bytes flipped raises
   ``CorruptCheckpointError`` naming it and ``restore_latest`` falls back
   to step 3; then from the 124M checkpoint ``eval --checkpoint-dir``
   (losses finite, below ln 50257), ``serve-replay --checkpoint-dir
   --paged-kernel`` (row #1 12 times a step; every engine's weights the
   checkpoint's cast to the compute dtype, bit for bit), ``generate
   --checkpoint-dir --decode-cache-layout packed`` (row #4, 12 a token;
   it samples the corpus BPE's 1024 ids of the 50257 rows and decodes
   them) and ``export-torch`` (every tensor the checkpoint's weight,
   f32); ``generate --checkpoint-dir`` from the char-gpt checkpoint
   (row #3 once a character, 256). The kernels line's
   ``launches_checkpoint`` fields are this slice's.
35. speculative parity phase (run after phase 33): f32 greedy streams of
   GPT-2 124M width cut to 2 layers, repeat-mode prompts, k = 4: the
   engine with the n-gram drafter and with a model drafter of the
   target's weights, on the kernel route and on the gather route, equals
   the plain engine on the kernel route; on the kernel route row #1 runs
   at W = 5 only, 2 launches a verify step; the model drafter's accept
   rate >= 0.99 (printed);
36. speculative serving slice (this slice's main path): ``serve-replay
   --preset gpt2-small --decode-cache-layout packed --paged-kernel
   --spec ngram --spec-k 4 --prompt-mode repeat --greedy`` (16 requests),
   the same trace without ``--spec`` and ``--spec model --draft-model
   char-gpt --spec-k 4`` (8 sampled requests), full width and depth,
   bf16, row #1's counts set to 0 before each and read after: every
   request completes, every token is in the vocabulary, row #1 runs 12
   times a verify step at W = 5 and at no other W; accept rate, tokens
   a slot-step, draft overhead p50, tokens/s and TTFT p50 beside the
   plain run's tokens/s (row #1's ``launches_spec``);
37. speculative resilience phase: the ``spec/draft`` collapse fault on
   the card (124M width, 2 layers, f32, model drafter of the target's
   weights): one disable, one re-probe, speculation active again at the
   end, the greedy streams the plain engine's.

38. DP parity phase (run after phase 34): ``LocalDataGroup(2)`` at GPT-2
   124M width (2 layers, T=1024, f32, sequential windows), 3 steps of 2
   accumulated micro-batches of 4 rows with clip 1.0, FSDP off and on,
   against the plain step (losses to 1e-5 relative, weights and both
   moments to 1e-5; 12 + 12 packed flash launches a step at B=2); then
   with attention dropout 0.1 through the kernels against two one-shard
   runs fed each shard's rows and streams, bit for bit (with FSDP, whose
   clip sums the shards' squares in another order, to 1e-5);
39. rank flash phase: rows #7-#12's packed kernels at the DP slice's rank
   shapes (B=8, T=1024, C=768, H=12, bf16), checked at dropout 0 and
   0.1 and timed beside their plain versions, SDPA and the bound (the
   gpt2-small flash rows' ``rank_shape``);
40. DP slice (this slice's main path): ``train --preset gpt2-small --dp 4
   --batch-size 32`` through the CLI in one process (4 shards of 8 rows),
   20 steps, evals at 0 and 20: losses finite, exactly 4 x 12 forward and
   4 x 12 backward packed flash launches a step (and 4 x 12 forward an
   eval batch), tokens/s and step p50 beside phase 19's unsharded slice
   (the gpt2-small flash rows' ``launches_dp``);
41. FSDP slice: ``train --preset gpt2-medium --dp 4 --fsdp`` (350M, B=64
   as 4 shards of 16, remat full), 3 steps in one process, and the same
   without FSDP: flash launches (4 x 24 x 2 forward a step with the
   recompute), peak memory allocated and step p50 of each.
42. fleet parity phase (run after phase 37): GPT-2 124M width cut to 2
   layers, f32, 20 requests over 2 shared prefixes (16 greedy, 4 sampled
   with fixed rng_seeds): a ``Router`` of 2 replicas on the kernel route
   with journals gives one gather-route ``Engine``'s streams; so does it
   after ``replica_kill`` of replica 0 at router step 4 (every request
   finishes, requeued from the journal) and through ``replica_wedge`` of
   replica 0 (0.2 s stalls against a 0.1 s budget: quarantined, its work
   re-routed with ``cancel(migrated=True)``, rejoined); in every run each
   id's delivered tokens (``take_new_tokens``) are its final tokens, and
   no id is active on two live replicas at any step;
43. front-door slice (this slice's main path): ``ServeApp`` over a
   ``Router`` of 2 GPT-2 124M replicas (bf16, full width and depth, 8
   slots, page 16, packed cache, the kernel route) on 127.0.0.1 at an
   ephemeral port, its clients in a process of their own: ``/readyz`` 503
   until both replicas are warm, 200 after; 24 sessions of 3 turns over 4
   system prefixes of 256 tokens (16-48 user tokens and 32 new tokens a
   turn) from 8 concurrent clients of ``/v1/generate``; row #1 runs
   exactly 12 x the replicas' decode steps; fleet tokens/s, client TTFT
   p50 and p99, each replica's step p50, the prefix-hit rate beside the
   same sessions on 1 replica and without affinity, the ``/metrics``
   fleet counters; the wedge probe (1 s budget) never trips; then with
   ``replica_kill`` of replica 1 in turn 2: every session finishes and
   every SSE stream carries each token of its result once; then a
   char-gpt fleet (fused route): row #2 once a decode step (row #1's
   ``launches_front_door``, row #2's);
44. serve CLI phase: ``python -m replicatinggpt_tpu_torch serve --preset
   gpt2-small --decode-cache-layout packed --paged-kernel --replicas 2
   --port 0 --journal-dir D`` as a subprocess: ``/readyz`` 200 once it
   prints ``serving on``, one ``/v1/generate`` round trip, SIGINT: exit
   0, the journals closed with no unfinished request.
45. multiproc parity phase: two ``serve-worker`` processes on the card
   (GPT-2 124M width cut to 2 layers, f32, the kernel route, phase 42's
   weights) behind the router and the process supervisor, one fleet
   through five runs of phase 42's 20 requests (4 sampled), each fault on
   the worker that holds the run's requests: clean, after ``proc_kill``
   (a real SIGKILL, a supervised restart, its journal replayed), through
   ``proc_hang`` (SIGSTOP past the 0.5 s step RPC budget, the wedge, the
   ``migrated`` re-route, SIGCONT, the rejoin), after ``host_loss`` (its
   directory deleted, the router's ledger recovering the work) and
   through a rolling restart
   (no drop, ``/readyz`` never 503): every run's streams equal one
   gather-route engine's, each id's delivered tokens are its final
   tokens, no id is active on two answering workers at any step, row #1
   runs 2 x each worker's decode steps, and every worker process is gone
   after;
46. multiproc front door (this slice's main path): ``python -m
   replicatinggpt_tpu_torch serve --preset gpt2-small --decode-cache-layout
   packed --paged-kernel --replicas 2 --multiproc --journal-dir D --port
   0`` as a subprocess (bf16, full width and depth), phase 43's sessions
   from its clients' process, beside phase 43's in-process fleet: fleet
   tokens/s, client TTFT p50 and p99, each worker's step p50 as the router
   times it, the RPC's share of a step, the step frame bytes (p50, max),
   the prefix-hit rate, each worker's peak memory, seconds from spawn to
   registration; then the same sessions with a real SIGKILL in turn 2 of
   worker 1, or of worker 0 where it holds all the work: every SSE stream
   carries each token of its result once, the
   seconds from kill to rejoin, the requeued count and latency; row #1
   runs exactly 12 x each worker's decode steps, counted in the worker
   and read from its ``summary`` at exit (row #1's
   ``launches_multiproc``); SIGINT: exit 0, no worker left, the journals
   and the router's ledger closed with no unfinished request.

Every flash row of the ``{"kernels": [...]}`` line also carries the
achieved rate (``tflops``: the bound's operation count over the kernel's
time) and ``vs_library`` (kernel time over the library call's). Prints
that line, the card's name and power limit and, last, the
``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import signal
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

from replicatinggpt_tpu_torch import cli, faults
from replicatinggpt_tpu_torch.config import config_from_args, get_config
from replicatinggpt_tpu_torch.data.loader import (RandomBatcher,
                                                  SequentialBatcher)
from replicatinggpt_tpu_torch.models import gpt
from replicatinggpt_tpu_torch.models.gpt import (BLOCK_SHAPES,
                                                compute_params, decode_step,
                                                init_kv_cache, init_params)
from replicatinggpt_tpu_torch.ops import _build
from replicatinggpt_tpu_torch.ops import decode as dec
from replicatinggpt_tpu_torch.ops import flash_chunk as fc
from replicatinggpt_tpu_torch.ops import flash_heads as fh
from replicatinggpt_tpu_torch.ops import flash_packed as fp
from replicatinggpt_tpu_torch.ops import paged_attention as pa
from replicatinggpt_tpu_torch.ops.attention import full_causal_attention
from replicatinggpt_tpu_torch.ops.flash_attention import packed_qkv_attention
from replicatinggpt_tpu_torch.parallel import (LocalDataGroup,
                                               LocalSeqGroup,
                                               make_ring_attention_fn,
                                               ring_attention)
from replicatinggpt_tpu_torch.parallel.sharded_flash import (
    shard_dropout_rng)
from replicatinggpt_tpu_torch.parallel.serve_group import LocalServeGroup
from replicatinggpt_tpu_torch.quant.kv import fake_quantize_rows, quantize_rows
from replicatinggpt_tpu_torch.serve import engine as engine_mod
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig,
                                            ModelDrafter, NGramDrafter,
                                            ReplayConfig, Request,
                                            RequestJournal, Router,
                                            RouterConfig, SamplingParams,
                                            SessionLoadConfig, make_sessions,
                                            make_trace, session_request)
from replicatinggpt_tpu_torch.faults.fleet import (FLEET_STEP,
                                                   KIND_HOST_LOSS,
                                                   KIND_PROC_HANG,
                                                   KIND_PROC_KILL,
                                                   KIND_REPLICA_KILL,
                                                   KIND_REPLICA_WEDGE)
from replicatinggpt_tpu_torch.serve.http import ServeApp
from replicatinggpt_tpu_torch.sample.generate import (GenerateConfig,
                                                     generate)
from replicatinggpt_tpu_torch.tokenizers import CharTokenizer
from replicatinggpt_tpu_torch.train.runner import train
from replicatinggpt_tpu_torch.train.state import create_train_state
from replicatinggpt_tpu_torch.train.steps import loss_fn, make_train_step
from replicatinggpt_tpu_torch.utils.logging import StepLogger

KERNEL_SOURCE = "replicatinggpt_tpu_torch/csrc/paged_window_attention.cu"
KERNEL_REPLACES = "replicatinggpt_tpu/ops/paged_pallas.py:202"
FLASH_SOURCE = "replicatinggpt_tpu_torch/csrc/flash_packed.cu"
FLASH_REPLACES = {"fwd": "replicatinggpt_tpu/ops/flash_pallas.py:1846",
                  "bwd": "replicatinggpt_tpu/ops/flash_pallas.py:1913"}
# the head-group kernels the JAX package runs at GPT-2 124M (T=1024), and
# their streamed and triangular variants (long T), which compute the
# same function (TPU rows #7-#12)
GROUP_REPLACES = {"fwd": "replicatinggpt_tpu/ops/flash_pallas.py:2092",
                  "bwd": "replicatinggpt_tpu/ops/flash_pallas.py:2181"}
GROUP_ALSO_REPLACES = {
    "fwd": ["replicatinggpt_tpu/ops/flash_pallas.py:2341",
            "replicatinggpt_tpu/ops/flash_pallas.py:2574"],
    "bwd": ["replicatinggpt_tpu/ops/flash_pallas.py:2432",
            "replicatinggpt_tpu/ops/flash_pallas.py:2470",
            "replicatinggpt_tpu/ops/flash_pallas.py:2661",
            "replicatinggpt_tpu/ops/flash_pallas.py:2690"]}
# the (B, H, T, D) family that the JAX package runs at gpt2-xl (TPU rows
# #13-#20): the resident forward and the kv-major fused backward, and the
# rows that compute the same function
HEADS_REPLACES = {"fwd": "replicatinggpt_tpu/ops/flash_pallas.py:259",
                  "bwd": "replicatinggpt_tpu/ops/flash_pallas.py:413"}
HEADS_ALSO_REPLACES = {
    "fwd": ["replicatinggpt_tpu/ops/flash_pallas.py:608",
            "replicatinggpt_tpu/ops/flash_pallas.py:838"],
    "bwd": ["replicatinggpt_tpu/ops/flash_pallas.py:449",
            "replicatinggpt_tpu/ops/flash_pallas.py:386",
            "replicatinggpt_tpu/ops/flash_pallas.py:712",
            "replicatinggpt_tpu/ops/flash_pallas.py:933"]}
# GPT-2 XL: the slice's micro-batch (4 of them make the preset's global
# batch of 64), heads, width; the slice's steps and eval batches a split
XB, XACC, XH, XC = 16, 4, 25, 1600
XL_STEPS, XL_EVAL_ITERS = 8, 4
# the chunk family JAX runs at a ring hop of gpt2-xl (TPU rows #21-#24):
# the resident forward and the kv-major fused backward (Tq * D * 4 under
# its scratch bound), and the rows that compute the same function
CHUNK_REPLACES = {"fwd": "replicatinggpt_tpu/ops/flash_pallas.py:1187",
                  "bwd": "replicatinggpt_tpu/ops/flash_pallas.py:1592"}
CHUNK_ALSO_REPLACES = {
    "fwd": ["replicatinggpt_tpu/ops/flash_pallas.py:1310"],
    "bwd": ["replicatinggpt_tpu/ops/flash_pallas.py:1225",
            "replicatinggpt_tpu/ops/flash_pallas.py:1254",
            "replicatinggpt_tpu/ops/flash_pallas.py:1357",
            "replicatinggpt_tpu/ops/flash_pallas.py:1393"]}
# the sequence-parallel slice: 4 shards of 256 tokens; a ring call runs
# 1 + 2 + 3 + 4 hops with all shards in one process
SP, XTL = 4, 256
RING_HOPS = SP * (SP + 1) // 2
# (name, Tq, Tk, q_offset, k_offset) at the slice's hop shapes
CHUNK_HOPS = (("visible", XTL, XTL, XTL, 0),
              ("diagonal", XTL, XTL, 3 * XTL, 3 * XTL),
              ("aligned", XTL, XTL, XTL + 128, XTL),
              ("unaligned", XTL, XTL, XTL + 96, XTL),
              ("masked", XTL, XTL, -XTL, 0),
              ("tk_2tq", XTL, 2 * XTL, 3 * XTL // 2, 0))
# the chunk kernels against their plain versions: bf16 o and gradients to
# one bf16 ulp (FLASH_TOL), lse (f32 on both sides) to 1e-4; f32 to 1e-5
CHUNK_TOL = {torch.bfloat16: (1e-4, 1e-2), torch.float32: (1e-5, 1e-5)}
# GPT-2 124M training shapes (the gpt2-small preset), and the long-T case
GB, GT, GC, GH, LT = 32, 1024, 768, 12, 8192
# q, k and v as the path feeds the kernel: unit-variance layernorm output
# through 0.02-std weights at C=768
QKV_SCALE = 0.5
GROUP_RATE = 0.1
DECODE_SOURCE = {
    "fused": "replicatinggpt_tpu_torch/csrc/fused_decode_layers.cu",
    "packed": "replicatinggpt_tpu_torch/csrc/packed_decode_attention.cu"}
DECODE_REPLACES = {"fused": "replicatinggpt_tpu/ops/decode_pallas.py:194",
                   "packed": "replicatinggpt_tpu/ops/decode_pallas.py:102"}
FUSED_PAGED_SOURCE = ("replicatinggpt_tpu_torch/csrc/"
                      "fused_paged_decode_layers.cu")
FUSED_PAGED_REPLACES = "replicatinggpt_tpu/ops/decode_pallas.py:394"
POOLS = (("none", "page"), ("int8", "page"), ("int8", "head"),
         ("fp8", "page"), ("fp8", "head"))
# bf16 through an fp8 pool: the kernel and the plain version round k/v
# to bf16 after products summed in different orders, and a one-ulp bf16
# difference that crosses an e4m3 rounding boundary of the fake-quantized
# fresh column moves that element by one fp8 ulp (2^-3 relative), which
# six layers carry on; int8's grid (amax / 127) is as fine as bf16's
FP8_BF16_TOL = 5e-2
CORPUS = "datasets/shakespeare.txt"
BPE_CACHE = "datasets/bpe_1024.json"      # get_tokenizer('bpe')'s cache
# char-GPT training shapes (the char-gpt preset)
FB, FT, FC, FH = 64, 256, 384, 6
ATTN_RATE = 0.2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
C, H, PSZ, MP, N, B = 768, 12, 16, 64, 512, 8
POS = [0, 1, 15, 16, 17, 333, 777, 1000]
SPEC_K = 4                # the speculative slice's drafts a step
SPEC_W = SPEC_K + 1       # its verify window: row #1's W
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the flash kernels and their plain versions sum in f32 in different
# orders and round once to the output's type: bf16 o and d(qkv) agree to
# one bf16 ulp (at most 2^-7 of the value, under rtol) plus an f32
# difference far under atol; lse is f32 on both sides whatever the input
# type. (atol, rtol) by output dtype
FLASH_TOL = {torch.bfloat16: (1e-4, 1e-2), torch.float32: (1e-4, 1e-4)}


def on_grid(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as the flash checks feed it in ``dtype``: bf16 on a grid of 1/32
    within [-4, 4], where every product of two inputs is a multiple of
    2^-10 below 16 and a sum of D <= 256 of them is exact in f32 in any
    order. The bf16 kernels and their plain versions round p z and ds to
    bf16 at the same points; from equal scores they round equally, so
    ``FLASH_TOL`` holds elementwise. Off the grid, f32 summation order
    alone moves a few in a million of those roundings by one bf16 ulp."""
    if dtype == torch.bfloat16:
        x = (x * 32).round().clamp(-128, 128) / 32
    return x.to(dtype)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def paged_inputs(W: int, dtype: torch.dtype, seed: int = 0):
    """The kernel's inputs at the path's shapes; table entries past each
    slot's live frontier hold ids past the pool, which neither side may
    read."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    perm = torch.randperm(N, generator=g, device=dev)[:B * MP]
    tables = perm.reshape(B, MP).to(torch.int32)
    pos = torch.tensor(POS, dtype=torch.int32, device=dev)
    live = (pos + PSZ - 1) // PSZ
    past = torch.arange(MP, device=dev)[None, :] >= live[:, None]
    tables = torch.where(past, torch.full_like(tables, N + 7), tables)
    return (rnd(B, W, C), rnd(B, W, C), rnd(B, W, C), rnd(N, PSZ, C),
            rnd(N, PSZ, C), tables.contiguous(), pos)


# cycles of a device spin enqueued before each timed run (~0.5 ms): the
# card waits on it, not on the host's launch work, so the events bracket
# the device time of ``fn`` alone
HOST_PAD_CYCLES = 1_000_000


def time_ms(fn, flush: torch.Tensor, n: int = 30, warm: int = 5) -> float:
    """Median device time of ``fn`` over ``n`` runs, each after an L2
    flush (the serving path reads a layer's pages cold) and a device spin
    that outlasts the host's work to launch ``fn``."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(HOST_PAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def paged_bytes(args, W: int, scale_floats: int = 0) -> int:
    """Bytes one call must move on this run's data: window rows in and
    out, the live K/V pages (and ``scale_floats`` f32 scales a row, a
    quantized pool), the live table prefix and pos."""
    q, *_, kp, _, _, pos = args
    live = ((pos.long() + PSZ - 1) // PSZ).sum().item()
    return (4 * B * W * C * q.element_size()
            + 2 * live * PSZ * (C * kp.element_size() + 4 * scale_floats)
            + live * 4 + B * 4)


def settle(*fns, seconds: float = 0.5) -> None:
    """Launch ``fns`` in turns for about ``seconds`` of device time, so
    that an idle card's clocks come up before a timing."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for fn in fns:
            fn()
        torch.cuda.synchronize()


def bound_ms(args, W: int) -> tuple:
    """Least time for the work of one call on this run's data: bytes
    (``paged_bytes``) over the memory rate vs operations over the peak
    rate of the input type."""
    q, *_, pos = args
    flops = 4 * C * W * (pos.long().sum().item() + B * W)
    return _bound(paged_bytes(args, W), flops, q.dtype)


def gbps(nbytes: float, ms: float) -> float:
    """The bound's bytes over a measured time, GB/s."""
    return nbytes / (ms * 1e-3) / 1e9


def sdpa_inputs(args, W: int):
    """The same K/V gathered dense with the fresh rows appended, and the
    same mask, for the library yardstick."""
    q, kn, vn, kp, vp, tables, pos = args
    S = MP * PSZ
    live = (pos.long() + PSZ - 1) // PSZ
    owned = torch.arange(MP, device="cuda")[None, :] < live[:, None]
    tab = torch.where(owned, tables.long(), torch.zeros_like(tables.long()))

    def heads(x, T):
        return x.reshape(B, T, H, C // H).transpose(1, 2).contiguous()

    k = heads(torch.cat([kp[tab].reshape(B, S, C), kn], 1), S + W)
    v = heads(torch.cat([vp[tab].reshape(B, S, C), vn], 1), S + W)
    kpos = torch.arange(S + W, device="cuda")
    hist = (kpos[None, None] < pos.long()[:, None, None]) & (kpos < S)
    fresh = ((kpos[None] - S) <= torch.arange(W, device="cuda")[:, None]) \
        & (kpos >= S)
    mask = (hist | fresh[None])[:, None]                   # (B, 1, W, S+W)
    return heads(q, W), k, v, mask


def time_row1(W: int, flush: torch.Tensor, max_pos=None) -> dict:
    """Row #1 at width W, bf16: CUDA-event times of the kernel and of
    ``F.scaled_dot_product_attention`` over the same K/V gathered dense
    with the same mask (after half a second of launches to settle the
    clocks, timed in turns and each averaged over its two turns), the
    plain version's, the bound, the rate and the split. ``max_pos``: the
    engine's bound on the positions (the split's span), None for the
    whole table."""
    args = paged_inputs(W, torch.bfloat16)
    sq, sk, sv, mask = sdpa_inputs(args, W)

    def kernel():
        return pa.paged_window_attention(*args, n_head=H, max_pos=max_pos)

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)

    settle(kernel, sdpa)
    ms_a, lib_a, lib_b, ms_b = (time_ms(f, flush)
                                for f in (kernel, sdpa, sdpa, kernel))
    ms, library_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
    plain_ms = time_ms(
        lambda: pa.paged_window_attention_ref(*args, n_head=H), flush)
    b_ms, b_by = bound_ms(args, W)
    rate = gbps(paged_bytes(args, W), ms)
    ranks = pa.cluster_ranks(W, C // H, MP, PSZ, 2, False, max_pos)
    split = {"cluster_ranks": ranks, "tile_rows": pa.tile_rows(W, C // H, MP,
                                                                2),
             "grid": [ranks, H, B], "passes": -(-W // (1 if W == 1 else 4))}
    print(f"kernel timing (bf16, W={W}, B={B}, pos {POS}, span "
          f"{max_pos or MP * PSZ}): kernel {ms * 1e3:.1f} us "
          f"({ms_a * 1e3:.1f} / {ms_b * 1e3:.1f}; {rate:.0f} GB/s of the "
          f"bound's bytes), plain {plain_ms * 1e3:.1f} us, sdpa "
          f"{library_ms * 1e3:.1f} us ({lib_a * 1e3:.1f} / "
          f"{lib_b * 1e3:.1f}), bound {b_ms * 1e3:.2f} us ({b_by}); kernel "
          f"/ sdpa {ms / library_ms:.2f}; split: clusters of "
          f"{split['cluster_ranks']} CTAs, grid {split['grid']}, "
          f"{split['tile_rows']}-row tiles, {split['passes']} pass(es)")
    if ms >= library_ms:
        print(f"kernel note: the kernel at W={W} ({ms * 1e3:.1f} us) is not "
              f"below sdpa ({library_ms * 1e3:.1f} us) in this call")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "gbps": rate,
            "split": split}


def kernel_phase() -> dict:
    """Row #1 against its plain version at W in {1, 4, 5} (5 = k+1 of the
    speculative verify at the default k = 4, the first W that takes two
    passes of 4 rows), bf16 and f32; then its times at W=1 (the decode
    step) and W=5 (the verify step, split sized from the longest pos as
    the engine sizes it)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for W in (1, 4, SPEC_W):
            args = paged_inputs(W, dtype)
            got = pa.paged_window_attention(*args, n_head=H)
            torch.cuda.synchronize()
            ref = pa.paged_window_attention_ref(*args, n_head=H)
            err = (got.float() - ref.float()).abs().max().item()
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                       rtol=tol)
            errs[(dtype, W)] = err
            print(f"kernel check: {str(dtype)[6:]} W={W} max_abs_err "
                  f"{err:.3e} (atol=rtol={tol})")
    t1 = time_row1(1, flush)
    t5 = time_row1(SPEC_W, flush, max_pos=max(POS))
    print(f"kernel timing: W={SPEC_W} / W=1 {t5['ms'] / t1['ms']:.2f}")
    return {"name": "paged_window_attention", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "max_abs_err": errs[(torch.bfloat16, 1)], "ms": t1["ms"],
            "kernel_ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": t1["library_ms"], "gbps": t1["gbps"],
            "split": t1["split"],
            "w5_max_abs_err": {str(dt)[6:]: errs[(dt, SPEC_W)]
                               for dt in (torch.bfloat16, torch.float32)},
            **{f"w5_{k}": v for k, v in t5.items()},
            "w5_vs_w1": t5["ms"] / t1["ms"]}


def flash_inputs(dtype: torch.dtype, seed: int = 0, shape=(FB, FT, FC),
                 scale: float = 1.0):
    """qkv (B, T, 3C) at ``scale`` and a unit-scale upstream gradient
    (B, T, C): d(qkv) is linear in it, so unit scale keeps the absolute
    tolerance a real test of the backward."""
    B, T, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, T, 3 * C), generator=g, device="cuda") * scale
    do = torch.randn((B, T, C), generator=g, device="cuda")
    return on_grid(qkv, dtype), on_grid(do, dtype)


def flash_bound_ms(qkv: torch.Tensor, n_head: int, which: str) -> tuple:
    """Least time of one call: its inputs read once and outputs written
    once over the memory rate, vs its causal products (2 matrix products
    forward, 5 backward, over the T(T+1)/2 unmasked pairs) over the peak
    rate of the input type; (ms, what bounds it, the products' FLOP)."""
    B, T, C3 = qkv.shape
    C, isz = C3 // 3, qkv.element_size()
    rows, D = B * T, C // n_head
    pairs = B * n_head * T * (T + 1) // 2
    if which == "fwd":   # qkv in; o and lse out
        nbytes = rows * 3 * C * isz + rows * C * isz + rows * n_head * 4
        flops = 2 * 2 * pairs * D
    else:                # qkv, do, lse, delta in; d(qkv) out
        nbytes = (2 * rows * 3 * C * isz + rows * C * isz
                  + 2 * rows * n_head * 4)
        flops = 5 * 2 * pairs * D
    return (*_bound(nbytes, flops, qkv.dtype), flops)


def rates(ms: float, flops: float, library_ms: float) -> dict:
    """A flash row's achieved rate (the bound's operation count over the
    kernel's time) and its time over the library call's."""
    return {"tflops": flops / ms / 1e9, "vs_library": ms / library_ms}


def rates_text(r: dict) -> str:
    return f"{r['tflops']:.1f} TFLOP/s, {r['vs_library']:.2f}x sdpa"


def flash_tol_text(dtype: torch.dtype) -> str:
    atol, rtol = FLASH_TOL[dtype]
    return (f"o, d(qkv) atol {atol:g} rtol {rtol:g}; lse atol/rtol "
            f"{FLASH_TOL[torch.float32][0]:g}")


def check_flash(qkv, do, n_head: int, seed: int, rate: float) -> dict:
    """Forward (o, lse) and backward (d(qkv)) of the kernels against the
    plain versions on the same inputs, at ``FLASH_TOL``; the max abs
    errors."""
    o, lse = fp.flash_packed_fwd(qkv, n_head, seed=seed, rate=rate)
    delta = fp.packed_delta(do, o, n_head)
    dqkv = fp.flash_packed_bwd(qkv, do, lse, delta, n_head, seed=seed,
                               rate=rate)
    torch.cuda.synchronize()
    ro, rlse = fp.flash_packed_fwd_ref(qkv, n_head, seed=seed, rate=rate)
    rd = fp.flash_packed_bwd_ref(qkv, do, lse, delta, n_head, seed=seed,
                                 rate=rate)
    err = {}
    for name, got, ref in (("o", o, ro), ("lse", lse, rlse),
                           ("dqkv", dqkv, rd)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash: non-finite {name}")
        err[name] = (got.float() - ref.float()).abs().max().item()
        atol, rtol = FLASH_TOL[got.dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    return err


def time_flash(qkv, do, n_head: int, seed: int, rate: float,
               flush: torch.Tensor, n: int = 30) -> tuple:
    """CUDA-event times (ms) of both kernels, their plain versions and
    ``scaled_dot_product_attention`` on split heads with the same causal
    mask and dropout rate (its forward, and its backward), and the SDPA
    backend PyTorch picks."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    D = C // n_head
    o, lse = fp.flash_packed_fwd(qkv, n_head, seed=seed, rate=rate)
    delta = fp.packed_delta(do, o, n_head)
    fwd = functools.partial(fp.flash_packed_fwd, qkv, n_head, seed=seed,
                            rate=rate)
    fwd_ref = functools.partial(fp.flash_packed_fwd_ref, qkv, n_head,
                                seed=seed, rate=rate)
    bwd = functools.partial(fp.flash_packed_bwd, qkv, do, lse, delta,
                            n_head, seed=seed, rate=rate)
    bwd_ref = functools.partial(fp.flash_packed_bwd_ref, qkv, do, lse, delta,
                                n_head, seed=seed, rate=rate)

    def heads(x):
        return x.reshape(B, T, n_head, D).transpose(1, 2).contiguous()

    sq, sk, sv = (heads(t).requires_grad_(True) for t in qkv.split(C, -1))
    choice = torch._fused_sdp_choice(sq, sk, sv, None, rate, True)
    backend = SDPBackend(choice).name

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, dropout_p=rate,
                                              is_causal=True)

    out, go = sdpa(), heads(do)
    plain_n = max(3, n // 3)
    ms = {"fwd": time_ms(fwd, flush, n), "bwd": time_ms(bwd, flush, n)}
    plain = {"fwd": time_ms(fwd_ref, flush, plain_n, 2),
             "bwd": time_ms(bwd_ref, flush, plain_n, 2)}
    library = {"fwd": time_ms(sdpa, flush, n),
               "bwd": time_ms(lambda: torch.autograd.grad(
                   out, (sq, sk, sv), go, retain_graph=True), flush, n)}
    return ms, plain, library, backend


def flash_kernel_phase() -> list:
    seed = 1_234_567
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, ATTN_RATE):
            qkv, do = flash_inputs(dtype)
            err = errs[(dtype, rate)] = check_flash(qkv, do, FH, seed, rate)
            print(f"flash check: {str(dtype)[6:]} rate {rate} max_abs_err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" ({flash_tol_text(dtype)})")
    # timings at the training path's setting: bf16, attention dropout 0.2
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    qkv, do = flash_inputs(torch.bfloat16)
    ms, plain, library, backend = time_flash(qkv, do, FH, seed, ATTN_RATE,
                                             flush)
    rows = []
    for which, err in (("fwd", "o"), ("bwd", "dqkv")):
        b_ms, b_by, b_ops = flash_bound_ms(qkv, FH, which)
        r = rates(ms[which], b_ops, library[which])
        print(f"flash {which} timing (bf16, B={FB}, T={FT}, C={FC}, H={FH}, "
              f"attention dropout {ATTN_RATE}): kernel "
              f"{ms[which] * 1e3:.1f} us, plain {plain[which] * 1e3:.1f} us, "
              f"sdpa ({backend}) {library[which] * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}); {rates_text(r)}")
        rows.append({**r,
            "name": f"flash_packed_{which}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[which],
            "max_abs_err": errs[(torch.bfloat16, ATTN_RATE)][err],
            "ms": ms[which], "kernel_ms": ms[which],
            "plain_ms": plain[which], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library[which], "library": f"sdpa {backend}"})
    return rows


def parity_phase() -> None:
    base = get_config("gpt2-small").model
    mcfg = dataclasses.replace(base, n_layer=2, dtype="float32",
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=8, seed=1, prompt_len_max=300, prompt_mode="shared_prefix",
        max_new_tokens=24, greedy=True))
    streams = {}
    for kernel in (True, False):
        eng = Engine(model, mcfg, EngineConfig(pool_size=8, page_size=16,
                                               paged_kernel=kernel),
                     device="cuda")
        assert eng.kernel_route.decode == ("kernel" if kernel else "gather")
        for _, req in trace:
            assert eng.submit(req) is None
        streams[kernel] = {r.id: r.tokens for r in eng.drain()}
    a, b = streams[True], streams[False]
    for rid in sorted(b):
        if a[rid] != b[rid]:
            i = next(j for j, (x, y) in enumerate(zip(a[rid], b[rid]))
                     if x != y)
            raise AssertionError(f"parity: {rid} differs at token {i}: "
                                 f"kernel {a[rid][i]} vs gather {b[rid][i]}")
    n = sum(len(s) for s in a.values())
    print(f"parity: {len(a)} greedy streams, {n} tokens identical on the "
          f"kernel and gather routes (f32, 2 layers, C=768)")


MIXED_W = 64        # the 124M (and char-gpt) prefill chunk: the mixed W


def replay(extra, n_layer: int = 0, shards: int = 1) -> dict:
    argv = ["serve-replay", "--preset", "gpt2-small",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--rate", "1000", "--pool-size", "8", "--page-size", "16",
            "--prompt-mode", "shared_prefix", "--prompt-len-max", "512",
            "--request-max-new-tokens", "64", "--json", *extra]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines[:-1]))
    s = json.loads(lines[-1])
    n_layer = n_layer or get_config("gpt2-small").model.n_layer
    V = get_config("gpt2-small").model.vocab_size
    assert s["n_completed"] == s["n_requests"], s["n_completed"]
    assert s["kernel_route"]["decode"] == "kernel", s["kernel_route"]
    assert s["kernel_route"]["sharded"] == (shards > 1), s["kernel_route"]
    # one launch a layer, or on a mesh one partials launch a layer and
    # data shard of each model shard; a windowed run launches a layer's
    # kernel at W=1 in every step of its decode windows and at W=chunk
    # in every step of its mixed windows
    launched = s["partials_launches" if shards > 1 else "kernel_launches"]
    dp = s["dispatch"]
    if dp["window_k_max"] > 1:
        by_w = s["kernel_launches_by_window"]
        assert by_w == {k: v for k, v in (
            ("1", n_layer * dp["decode_window_steps"]),
            (str(MIXED_W), n_layer * dp["mixed_window_steps"])) if v}, (
            by_w, dp)
        assert not any(s["window_breaks"].values()), s["window_breaks"]
    else:
        assert launched == shards * n_layer * s["n_steps"], (
            launched, s["n_steps"])
    assert s["pages"]["prefix_hits"] > 0, s["pages"]
    toks = [t for st in s["streams"].values() for t in st]
    assert toks and all(0 <= t < V for t in toks)
    return s


def slice_phase(card: str) -> int:
    pa.paged_window_attention.launches = 0
    s = replay(["--n-requests", "16", "--greedy"])
    launches = pa.paged_window_attention.launches
    assert launches > 0
    h = s["histograms"]
    print(f"slice (greedy, 16 requests) on {card}: "
          f"{s['aggregate_tokens_per_s']} tok/s, TTFT p50 "
          f"{h['ttft_s']['p50'] * 1e3:.2f} ms / p99 "
          f"{h['ttft_s']['p99'] * 1e3:.2f} ms, step p50 "
          f"{s['step_latency']['p50_s'] * 1e3:.3f} ms over {s['n_steps']} "
          f"steps, {s['kernel_launches']} kernel launches")
    s2 = replay(["--n-requests", "8", "--top-k", "50", "--temperature",
                 "0.8"])
    print(f"slice (sampled, 8 requests) on {card}: "
          f"{s2['aggregate_tokens_per_s']} tok/s over {s2['n_steps']} "
          f"steps")
    return launches, s


# the mesh's phases: one model shard of GPT-2 124M on a 2x2 mesh (its 6 of
# 12 heads, 384 of 768 channels), its pool's pages in 2 data blocks
MESH_HL, MESH_CL = H // 2, C // 2
PARTIALS_REPLACES = "replicatinggpt_tpu/ops/paged_pallas.py:277"
PARTIALS_POOLS = ((torch.float32, "none"), (torch.bfloat16, "none"),
                  (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"))
# the partials are f32 whatever the input type: f32's tolerance. The two
# blocks merged and folded against the unsharded fold mode: the merge's
# f32 order, then one rounding to the output type on each side
PARTIALS_TOL = 1e-4
MERGE_TOL = TOL


def partials_inputs(dtype: torch.dtype, kv: str, seed: int = 0):
    """Rows (q, k_new, v_new) of one model shard at the serving path's
    shapes (B=8, W=1, pos ``POS``), in ``dtype`` (the fresh rows
    fake-quantized for a quantized pool, page scales), and its pool of N
    pages (C_loc channels) in 2 data blocks of N/2. Each live page of a
    slot is drawn from a random block, so a slot's pages interleave the
    blocks; slot 3's all come from block 1 (it owns nothing in block 0).
    Table entries past each live frontier hold ids past the pool."""
    rng = np.random.default_rng(seed)
    half = N // 2
    free = [list(rng.permutation(half)), list(rng.permutation(half) + half)]
    tables = np.full((B, MP), N + 7, np.int32)
    for b, p in enumerate(POS):
        for j in range(-(-p // PSZ)):
            tables[b, j] = free[1 if b == 3 else int(rng.integers(2))].pop()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q, kn, vn = (rnd(B, 1, MESH_CL) for _ in range(3))
    kp, vp = rnd(N, PSZ, MESH_CL), rnd(N, PSZ, MESH_CL)
    if kv == "none":
        pool = {"k": kp.to(dtype), "v": vp.to(dtype)}
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv, MESH_HL, "page")
                              for t in (kp, vp))
        pool = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        kn, vn = (fake_quantize_rows(t, kv, MESH_HL, "page")
                  for t in (kn, vn))
    return ((q.to(dtype), kn.to(dtype), vn.to(dtype)), pool,
            torch.from_numpy(tables).cuda(),
            torch.tensor(POS, dtype=torch.int32, device="cuda"), tables)


def owned_rows(tables: np.ndarray, lo: int, block: int) -> np.ndarray:
    """(B,) history rows each slot owns in the block [lo, lo + block)."""
    pos = np.asarray(POS)[:, None]
    j = np.arange(MP)[None, :]
    rows = np.clip(pos - j * PSZ, 0, PSZ)
    live = j < -(-pos // PSZ)
    return (rows * (live & (tables >= lo) & (tables < lo + block))).sum(1)


def partials_bound_ms(rows: int, isz: int, dtype: torch.dtype) -> tuple:
    """Least time of one partials call on this block: its owned K+V rows
    (and their scale pairs, a quantized pool), the query rows, the table
    and owned mask and pos read once, acc, m and l written once, over
    the memory rate; 4 C_loc operations an owned row (q.k and p.v) over
    the input type's peak."""
    nbytes = (2 * rows * (MESH_CL * isz + (4 if isz == 1 else 0))
              + B * MESH_CL * (2 if dtype == torch.bfloat16 else 4)
              + 2 * B * MP * 4 + B * 4
              + B * MESH_CL * 4 + 2 * B * MESH_HL * 4)
    return (*_bound(nbytes, 4 * MESH_CL * rows, dtype), nbytes)


def partials_kernel_phase(flush: torch.Tensor) -> dict:
    """Row #1's partials mode (``owned=``, ``fold=False``) at one model
    shard of the 124M serving path's shapes: each data block's raw (acc,
    m, l) against the plain twin in every pool, the slot that owns
    nothing in block 0 giving m = -1e30, l = acc = 0, and both blocks
    merged and folded (``sharded_paged_window_attention`` over
    ``LocalServeGroup(2, 1)``) against the unsharded fold mode; then the
    time of one block's call (bf16, the split sized from its owned rows'
    bound, as the engine's step sizes it) beside its bound and the
    twin's. No single PyTorch call returns raw partials: no library
    time."""
    group = LocalServeGroup(2, 1)
    half = N // 2
    errs = {}
    for dtype, kv in PARTIALS_POOLS:
        rows, pool, tables, pos, tab_np = partials_inputs(dtype, kv)
        blocks = [{k: t[d * half:(d + 1) * half] for k, t in pool.items()}
                  for d in (0, 1)]
        local = pa.localize_tables(tables, pos, PSZ, half, (0, 1))
        err = 0.0
        for d, blk in enumerate(blocks):
            sc = ({"k_scales": blk["ks"], "v_scales": blk["vs"]}
                  if kv != "none" else {})
            args = (*rows, blk["k"], blk["v"], local[d][0], pos)
            kw = dict(n_head=MESH_HL, owned=local[d][1], **sc)
            span = int(owned_rows(tab_np, d * half, half).max())
            got = pa.paged_window_attention(*args, fold=False, max_pos=span,
                                            **kw)
            torch.cuda.synchronize()
            ref = pa.paged_window_attention_ref(*args, fold=False, **kw)
            for a, r in zip(got, ref):
                torch.testing.assert_close(a, r, atol=PARTIALS_TOL,
                                           rtol=PARTIALS_TOL)
                err = max(err, (a - r).abs().max().item())
            if d == 0:
                assert (got[1][3] == pa.NEG_INF).all() \
                    and not got[2][3].any() and not got[0][3].any()
        sc = ({"k_scales": [b["ks"] for b in blocks],
               "v_scales": [b["vs"] for b in blocks]} if kv != "none" else {})
        merged = pa.sharded_paged_window_attention(
            *rows, [b["k"] for b in blocks], [b["v"] for b in blocks],
            tables, pos, group, n_head=MESH_HL, **sc)
        whole_sc = ({"k_scales": pool["ks"], "v_scales": pool["vs"]}
                    if kv != "none" else {})
        whole = pa.paged_window_attention(*rows, pool["k"], pool["v"],
                                          tables, pos, n_head=MESH_HL,
                                          **whole_sc)
        torch.cuda.synchronize()
        tol = MERGE_TOL[dtype]
        torch.testing.assert_close(merged.float(), whole.float(), atol=tol,
                                   rtol=tol)
        merge_err = (merged.float() - whole.float()).abs().max().item()
        errs[(dtype, kv)] = err
        print(f"partials check: {str(dtype)[6:]} {kv} pool, 2 data blocks "
              f"of {half} pages (B={B}, W=1, H_loc={MESH_HL}, "
              f"C_loc={MESH_CL}, pos {POS}): max_abs_err {err:.3e} "
              f"(atol=rtol={PARTIALS_TOL}); merged and folded vs the "
              f"unsharded kernel {merge_err:.3e} (atol=rtol={tol})")
    rows, pool, tables, pos, tab_np = partials_inputs(torch.bfloat16, "none")
    blk = {k: t[:half] for k, t in pool.items()}
    loc, own = pa.localize_tables(tables, pos, PSZ, half, (0,))[0]
    owned = owned_rows(tab_np, 0, half)
    args = (*rows, blk["k"], blk["v"], loc, pos)
    kw = dict(n_head=MESH_HL, owned=own, fold=False)

    def kernel():
        return pa.paged_window_attention(*args, max_pos=int(owned.max()),
                                         **kw)

    settle(kernel)
    ms = time_ms(kernel, flush)
    plain_ms = time_ms(lambda: pa.paged_window_attention_ref(*args, **kw),
                       flush)
    b_ms, b_by, nbytes = partials_bound_ms(int(owned.sum()), 2,
                                           torch.bfloat16)
    ranks = pa.cluster_ranks(1, MESH_CL // MESH_HL, MP, PSZ, 2, False,
                             int(owned.max()))
    print(f"partials timing (bf16, block 0 of 2: {int(owned.sum())} owned "
          f"rows, at most {int(owned.max())} a slot): kernel "
          f"{ms * 1e3:.1f} us ({gbps(nbytes, ms):.0f} GB/s of the bound's "
          f"bytes), plain {plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} "
          f"us ({b_by}); split: clusters of {ranks} CTAs, grid "
          f"[{ranks}, {MESH_HL}, {B}]; library: none (no PyTorch call "
          f"returns raw partials)")
    return {"name": "paged_window_attention_partials", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": PARTIALS_REPLACES,
            "max_abs_err": errs[(torch.bfloat16, "none")], "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "gbps": gbps(nbytes, ms)}


def mesh_parity_phase() -> None:
    """f32 greedy streams of the 2x2 engine (``LocalServeGroup``: 2 data
    blocks of pages, 2 model shards of heads) on the kernel route equal
    the 1x1 kernel route's and the gather route's, at 124M widths cut to
    2 layers."""
    base = get_config("gpt2-small").model
    mcfg = dataclasses.replace(base, n_layer=2, dtype="float32",
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=8, seed=1, prompt_len_max=300, prompt_mode="shared_prefix",
        max_new_tokens=24, greedy=True))
    streams = {}
    for name, kw in (("2x2 kernel", dict(paged_kernel=True, mesh_data=2,
                                         mesh_model=2)),
                     ("1x1 kernel", dict(paged_kernel=True)),
                     ("gather", dict(paged_kernel=False))):
        eng = Engine(model, mcfg, EngineConfig(pool_size=8, page_size=16,
                                               **kw), device="cuda")
        route = eng.kernel_route.summary()
        assert route["decode"] == name.split()[-1], route
        assert route["sharded"] == (name == "2x2 kernel"), route
        before = pa.paged_window_attention.partials_launches
        for _, req in trace:
            assert eng.submit(dataclasses.replace(req)) is None
        streams[name] = {r.id: r.tokens for r in eng.drain()}
        launched = pa.paged_window_attention.partials_launches - before
        assert launched == (2 * 4 * eng.n_steps if route["sharded"]
                            else 0), (name, launched, eng.n_steps)
    a = streams["2x2 kernel"]
    for name in ("1x1 kernel", "gather"):
        b = streams[name]
        for rid in sorted(b):
            if a[rid] != b[rid]:
                i = next(j for j, (x, y) in enumerate(zip(a[rid], b[rid]))
                         if x != y)
                raise AssertionError(f"mesh parity: {rid} differs at token "
                                     f"{i}: 2x2 kernel {a[rid][i]} vs "
                                     f"{name} {b[rid][i]}")
    n = sum(len(s) for s in a.values())
    print(f"mesh parity: {len(a)} greedy streams, {n} tokens identical on "
          f"the 2x2 kernel route (partials, merged over 2 data shards), "
          f"the 1x1 kernel route and the gather route (f32, 2 layers, "
          f"C=768)")


def mesh_slice_phase(card: str) -> int:
    """``serve-replay --mesh-shape 2x2`` at GPT-2 124M's full width and
    depth, bf16, in one process: 4 shards, each layer's attention the
    partials kernel per (data, model) shard, 48 launches a step."""
    pa.paged_window_attention.launches = 0
    pa.paged_window_attention.partials_launches = 0
    s = replay(["--n-requests", "16", "--greedy", "--mesh-shape", "2x2"],
               shards=4)
    launches = pa.paged_window_attention.partials_launches
    assert launches > 0 and s["kernel_launches"] == 0
    assert s["pages"]["effective_mesh_shape"] == [2, 2], s["pages"]
    h = s["histograms"]
    print(f"mesh slice (2x2, greedy, 16 requests) on {card}: "
          f"{s['aggregate_tokens_per_s']} tok/s, TTFT p50 "
          f"{h['ttft_s']['p50'] * 1e3:.2f} ms / p99 "
          f"{h['ttft_s']['p99'] * 1e3:.2f} ms, step p50 "
          f"{s['step_latency']['p50_s'] * 1e3:.3f} ms over {s['n_steps']} "
          f"steps, {s['partials_launches']} partials kernel launches "
          f"({s['partials_launches'] // s['n_steps']} a step)")
    return launches


def train_parity_phase(tokens: np.ndarray) -> None:
    """10 steps of char-GPT width at 2 layers, f32, through the kernels
    and through the packed plain version, from the same seeds."""
    base = get_config("char-gpt")

    def plain_core(qkv, n_head, *, seed, rate):
        return fp.flash_packed_fwd_ref(qkv, n_head, seed=seed, rate=rate)[0]

    plain = functools.partial(packed_qkv_attention, core=plain_core)
    tcfg = dataclasses.replace(base.train, max_iters=10)
    for rate in (0.0, ATTN_RATE):
        mcfg = dataclasses.replace(base.model, n_layer=2, dtype="float32",
                                   dropout=rate, attn_dropout=rate)
        curves = []
        for attention_fn in (None, plain):
            state = create_train_state(mcfg, tcfg, "cuda")
            step = make_train_step(mcfg, tcfg, attention_fn)
            batcher = RandomBatcher(tokens, tcfg.batch_size, mcfg.block_size,
                                    seed=tcfg.seed)
            losses = []
            for _ in range(tcfg.max_iters):
                batch = (torch.from_numpy(a).cuda()
                         for a in batcher.next_batch())
                losses.append(step(state, tuple(batch)))
            curves.append([float(x) for x in losses])
        rel = max(abs(a - b) / abs(b) for a, b in zip(*curves))
        if not rel <= 1e-4:
            raise AssertionError(f"train parity (dropout {rate}): kernel "
                                 f"{curves[0]} vs plain {curves[1]}")
        print(f"train parity (f32, 2 layers, C={FC}, dropout {rate}): 10 "
              f"losses {curves[0][0]:.6f} -> {curves[0][-1]:.6f}, max "
              f"relative difference kernel vs plain {rel:.2e} (limit 1e-4)")


def train_slice_phase(card: str, vocab: set) -> tuple:
    """The training main path through the port's CLI, in process, ending
    in a 1000-token sample of the trained weights."""
    n_layer = get_config("char-gpt").model.n_layer
    steps, eval_iters, n_evals = 300, 20, 4   # evals at 0, 100, 200, end
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "train.jsonl")
        fp.flash_packed_fwd.launches = fp.flash_packed_bwd.launches = 0
        dec.fused_decode_layers.launches = 0
        with contextlib.redirect_stdout(out):
            assert cli.main(["train", "--preset", "char-gpt", "--max-iters",
                             str(steps), "--eval-interval", "100",
                             "--eval-iters", str(eval_iters), "--log-jsonl",
                             log, "--sample-after", "--sample-tokens",
                             "1000"]) == 0
        fwd, bwd = fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches
        fused = dec.fused_decode_layers.launches
        with open(log) as f:
            events = [json.loads(line) for line in f]
    print(out.getvalue(), end="")
    text = out.getvalue()
    sample = text[-1001:-1]
    assert text.endswith("\n") and len(sample) == 1000 \
        and set(sample) <= vocab, sample
    assert fused == 1030, fused
    evals = [e for e in events if e["event"] == "eval"]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    losses += [e[k] for e in evals for k in ("train_loss", "val_loss")]
    assert losses and all(math.isfinite(x) for x in losses), losses
    assert [e["step"] for e in evals] == [0, 100, 200, steps], evals
    first, last = evals[0]["val_loss"], evals[-1]["val_loss"]
    assert last < 3.0 and last < first, (first, last)
    assert fwd == n_layer * (steps + n_evals * 2 * eval_iters), fwd
    assert bwd == n_layer * steps, bwd
    info = {k: v for e in events if e["event"] == "info" for k, v in e.items()}
    print(f"train slice (char-gpt, {steps} steps, B=64, T=256) on {card}: "
          f"{info['tokens_per_sec']:.0f} tok/s, train step p50 "
          f"{info['p50_ms']:.3f} ms (mean {info['mean_ms']:.3f}), val loss "
          f"{last:.4f} at step {steps} (step 0: {first:.4f}), {fwd} forward / "
          f"{bwd} backward kernel launches; the 1000-character sample ran "
          f"the fused decode kernel {fused} times")
    return fwd, bwd, fused


def _bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple:
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nan_past(cache: torch.Tensor, pos: int, seq_axis: int) -> torch.Tensor:
    idx = [slice(None)] * cache.dim()
    idx[seq_axis] = slice(pos, None)
    cache[tuple(idx)] = float("nan")
    return cache


def fused_inputs(mcfg, dtype: torch.dtype, pos: int, seed: int = 0):
    """The fused kernel's inputs at one model's widths, at the scales of
    the path: weights drawn as ``init_params`` draws them (residual
    projections at 0.02 / sqrt(2L)) with layernorm parameters and biases
    perturbed so their casts show; an embedding-sized input row; a warm
    cache of projection-sized K/V rows with NaN in every row >= pos.
    (Unit-scale rows and weights make bf16 rounding flips cascade
    through 12 layers to several ulps of the residual.)"""
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, C = mcfg.n_layer, mcfg.n_embd

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    resid = 0.02 * (2 * L) ** -0.5
    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        if name.endswith("_scale"):
            blocks[name] = 1 + rnd(L, *shape(C), scale=0.1)
        elif name.endswith("_kernel"):
            blocks[name] = rnd(L, *shape(C), scale=resid if name in (
                "attn_out_kernel", "mlp_down_kernel") else 0.02)
        else:
            blocks[name] = rnd(L, *shape(C), scale=0.02)
    blocks = dec.fused_weights(blocks, dtype)
    packed = mcfg.decode_cache_layout == "packed"
    cache = init_kv_cache(mcfg, 1, dtype=dtype, device="cuda")
    for k in ("k", "v"):
        cache[k].copy_(rnd(*cache[k].shape, scale=0.5))
        _nan_past(cache[k], pos, 2 if packed else 3)
    return rnd(1, C, scale=0.03).to(dtype), blocks, cache


def fused_bytes(mcfg, dtype: torch.dtype, pos: int) -> int:
    """Every layer's weights read once, the cache rows < pos read once,
    the row in and the row and fresh K/V out."""
    L, C = mcfg.n_layer, mcfg.n_embd
    isz = torch.empty((), dtype=dtype).element_size()
    return (L * (12 * C * C + 13 * C) + 2 * L * pos * C + C + C
            + 2 * L * C) * isz


def fused_bound_ms(mcfg, dtype: torch.dtype, pos: int) -> tuple:
    """``fused_bytes`` over the memory rate vs ~2 flops per weight and 4
    per cache element read over the peak rate."""
    L, C = mcfg.n_layer, mcfg.n_embd
    weights = L * (12 * C * C + 13 * C)
    return _bound(fused_bytes(mcfg, dtype, pos), 2 * weights + 4 * L * pos
                  * C, dtype)


def grid_sync_us(mcfg, dtype: torch.dtype, n: int = 1000) -> float:
    """One grid barrier on the fused kernel's grid (the same blocks and
    shared memory): a cooperative kernel that crosses n barriers and
    does nothing else, against one that crosses none, CUDA events."""
    lib = _build.load("fused_decode_layers")
    dec._lib("fused_decode_layers")          # sets the probe's argtypes
    stream = torch.cuda.current_stream().cuda_stream
    C, H, S = mcfg.n_embd, mcfg.n_head, mcfg.block_size
    code = 1 if dtype == torch.bfloat16 else 0

    def probe(k):
        err = lib.fused_decode_barrier_probe(k, C, H, S, code, stream)
        if err != 0:
            raise RuntimeError(f"barrier probe failed: CUDA error {err}")

    flush = torch.empty(1, device="cuda")
    return (time_ms(lambda: probe(n), flush, n=10)
            - time_ms(lambda: probe(0), flush, n=10)) * 1e3 / n


def fused_kernel_phase(flush: torch.Tensor) -> dict:
    char = dataclasses.replace(get_config("char-gpt").model)
    small = dataclasses.replace(get_config("gpt2-small").model)
    errs = {}
    for mcfg, label in ((char, "char-gpt"), (small, "gpt2-small B=1")):
        S = mcfg.block_size
        for layout in ("heads", "packed"):
            cfg = dataclasses.replace(mcfg, decode_cache_layout=layout)
            for dtype in (torch.float32, torch.bfloat16):
                pairs = []
                for pos in (0, S // 4, S - 1):
                    x0, blocks, cache = fused_inputs(cfg, dtype, pos)
                    got = dec.fused_decode_layers(x0, blocks, pos, cache, cfg)
                    torch.cuda.synchronize()
                    ref = dec.fused_decode_layers_ref(x0, blocks, pos, cache,
                                                      cfg)
                    pairs += [(pos, a.float(), b.float())
                              for a, b in zip(got, ref)]
                err = max((a - b).abs().max().item() for _, a, b in pairs)
                errs[(label, layout, dtype)] = err
                print(f"fused check: {label} {layout} {str(dtype)[6:]} pos "
                      f"0/{S // 4}/{S - 1} max_abs_err {err:.3e} "
                      f"(atol=rtol={TOL[dtype]})")
                for pos, a, b in pairs:
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"fused: non-finite output at "
                                             f"pos {pos}")
                    torch.testing.assert_close(a, b, atol=TOL[dtype],
                                               rtol=TOL[dtype])
    timings = {}
    for mcfg, label in ((char, "char-gpt"), (small, "gpt2-small B=1")):
        pos = mcfg.block_size - 1
        x0, blocks, cache = fused_inputs(mcfg, torch.bfloat16, pos)
        args = (x0, blocks, pos, cache, mcfg)
        ms = time_ms(lambda: dec.fused_decode_layers(*args), flush)
        plain_ms = time_ms(lambda: dec.fused_decode_layers_ref(*args), flush)
        b_ms, b_by = fused_bound_ms(mcfg, torch.bfloat16, pos)
        timings[label] = (ms, plain_ms, b_ms, b_by)
        plan = dec.fused_decode_plan(mcfg.n_embd, mcfg.n_head,
                                     mcfg.block_size, torch.bfloat16, "cuda")
        print(f"fused timing ({label}, bf16, heads cache, pos {pos}): kernel "
              f"{ms * 1e3:.1f} us ({gbps(fused_bytes(mcfg, torch.bfloat16, pos), ms):.0f} "
              f"GB/s of the bound's bytes), plain {plain_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.2f} us ({b_by}); split: {plan}")
    sync_us = grid_sync_us(char, torch.bfloat16)
    plan = dec.fused_decode_plan(char.n_embd, char.n_head, char.block_size,
                                 torch.bfloat16, "cuda")
    print(f"fused barrier: one grid.sync() on {plan['grid']} blocks costs "
          f"{sync_us:.3f} us; a char-gpt token crosses "
          f"{4 * char.n_layer} ({4 * char.n_layer * sync_us:.1f} us)")
    # the routing note: the step the route rule picks at 124M B=1 (plain)
    model = init_params(small, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    cp = compute_params(model, "cuda")
    cache = init_kv_cache(small, 1, device="cuda")
    tok = torch.zeros(1, dtype=torch.int32, device="cuda")
    step_ms = time_ms(lambda: decode_step(cp, tok, 511, cache, small), flush)
    print(f"route note (gpt2-small B=1, bf16, pos 511): the rule's plain "
          f"decode_step {step_ms * 1e3:.1f} us of device time (events) vs "
          f"the fused kernel {timings['gpt2-small B=1'][0] * 1e3:.1f} us "
          f"at pos 1023")
    ms, plain_ms, b_ms, b_by = timings["char-gpt"]
    if ms > 0.15:
        print(f"fused note: {ms * 1e3:.1f} us at char-gpt pos 255 misses "
              f"the 150 us target in this call")
    return {"name": "fused_decode_layers", "route": "cuda",
            "source": DECODE_SOURCE["fused"],
            "replaces": DECODE_REPLACES["fused"],
            "max_abs_err": errs[("char-gpt", "heads", torch.bfloat16)],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "gbps": gbps(fused_bytes(char, torch.bfloat16,
                                     char.block_size - 1), ms),
            "split": {"grid": plan["grid"], **{
                f"{p}_tiles_x_splits": [plan[f"{p}_tiles"],
                                        plan[f"{p}_splits"]]
                for p in ("qkv", "proj", "up", "down")},
                "grid_syncs_per_token": 4 * char.n_layer},
            "grid_sync_us": sync_us,
            "library": "none: no single PyTorch call computes every layer "
                       "of a decode step",
            "gpt2_small_b1": {"ms": timings["gpt2-small B=1"][0],
                              "plain_ms": timings["gpt2-small B=1"][1],
                              "bound_ms": timings["gpt2-small B=1"][2],
                              "plain_route_step_ms": step_ms}}


PB, PS = 8, 1024        # GPT-2 124M generate slice: batch, cache length


def packed_inputs(dtype: torch.dtype, pos: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    qkv = rnd(PB, 3 * C)            # the fused projection's row slices
    q, kn, vn = qkv.split(C, dim=-1)
    return (q, kn, vn, _nan_past(rnd(PB, PS, C), pos, 1),
            _nan_past(rnd(PB, PS, C), pos, 1), pos)


# one pos a rank count of the packed kernel's split (1 to 8 ranks at
# S=1024), besides the slice's positions
PACKED_POS = (0, 64, 318, PS - 1, 129, 257, 385, 513, 641, 769, 897)


def packed_kernel_phase(flush: torch.Tensor) -> dict:
    errs = {}
    D = C // H
    for dtype in (torch.bfloat16, torch.float32):
        err, ranks = 0.0, set()
        for pos in PACKED_POS:
            args = packed_inputs(dtype, pos)
            got = dec.packed_decode_attention(*args, n_head=H)
            torch.cuda.synchronize()
            ref = dec.packed_decode_attention_ref(*args, n_head=H)
            if not torch.isfinite(got).all():
                raise AssertionError(f"packed: non-finite output at {pos}")
            torch.testing.assert_close(got.float(), ref.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            err = max(err, (got.float() - ref.float()).abs().max().item())
            ranks.add(dec.packed_decode_split(D, dtype.itemsize,
                                              pos)["ranks"])
        if ranks != set(range(1, 9)):
            raise AssertionError(f"packed: rank counts {sorted(ranks)}")
        errs[dtype] = err
        print(f"packed check: {str(dtype)[6:]} B={PB} S={PS} pos "
              f"{'/'.join(map(str, PACKED_POS))} (1 to 8 ranks) max_abs_err "
              f"{err:.3e} (atol=rtol={TOL[dtype]})")
    pos = 318                       # the slice's last step: 63 + 255
    split = dec.packed_decode_split(D, 2, pos)
    print(f"packed split (bf16, pos {pos}): {split['ranks']} ranks of "
          f"{split['rows']} rows, {split['held']} held, {split['smem']} "
          f"bytes of shared memory, grid ({split['ranks'] * PB}, {H})")
    args = packed_inputs(torch.bfloat16, pos)
    q, kn, vn, kc, vc, _ = args
    D = C // H

    def heads(x):                   # (B, T, C) -> (B, H, T, D)
        return x.reshape(PB, -1, H, D).transpose(1, 2).contiguous()

    kw, vw = kc.clone(), vc.clone()
    kw[:, pos], vw[:, pos] = kn, vn
    kw[:, pos + 1:] = vw[:, pos + 1:] = 0
    sq, sk, sv = heads(q[:, None]), heads(kw), heads(vw)
    mask = (torch.arange(PS, device="cuda") <= pos)[None, None, None]
    ms = time_ms(lambda: dec.packed_decode_attention(*args, n_head=H), flush)
    plain_ms = time_ms(lambda: dec.packed_decode_attention_ref(
        *args, n_head=H), flush)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush)
    isz = 2
    b_ms, b_by = _bound(2 * PB * pos * C * isz + 4 * PB * C * isz,
                        4 * PB * (pos + 1) * C, torch.bfloat16)
    print(f"packed timing (bf16, B={PB}, S={PS}, pos {pos}): kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, sdpa "
          f"{library_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by})")
    if not ms < library_ms:
        print(f"packed note: the kernel ({ms * 1e3:.1f} us) is not below "
              f"sdpa ({library_ms * 1e3:.1f} us) in this call")
    return {"name": "packed_decode_attention", "route": "cuda",
            "source": DECODE_SOURCE["packed"],
            "replaces": DECODE_REPLACES["packed"],
            "max_abs_err": errs[torch.bfloat16], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library": "sdpa, split-heads cache",
            "split": split}


@contextlib.contextmanager
def forced_route(route: str):
    """decode_step takes ``route`` wherever kernels are allowed: the JAX
    envelopes keep char-GPT's f32 weights (7 MB a layer) off the fused
    route, and the parity phase needs f32 to ask for identical streams."""
    rule = gpt.decode_route
    gpt.decode_route = lambda cfg, b, dt, s, allow=True: (route if allow
                                                          else "plain")
    try:
        yield
    finally:
        gpt.decode_route = rule


def generate_parity_phase() -> None:
    """f32 greedy streams on the kernel routes and the plain route."""
    char = dataclasses.replace(get_config("char-gpt").model, n_layer=2,
                               dtype="float32")
    small = dataclasses.replace(get_config("gpt2-small").model, n_layer=2,
                                dtype="float32", decode_cache_layout="packed")
    prompts = np.random.default_rng(3).integers(0, small.vocab_size, (4, 16))
    for mcfg, prompt, n, counter, route in (
            (char, [[0]], 300, dec.fused_decode_layers, "fused"),
            (small, prompts, 64, dec.packed_decode_attention, "packed")):
        model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        gcfg = GenerateConfig(max_new_tokens=n, greedy=True)
        counter.launches = 0
        with forced_route(route):
            got = generate(model, prompt, mcfg, gcfg).cpu()
        launched = counter.launches
        want = generate(model, prompt, mcfg, gcfg, allow_kernels=False).cpu()
        if launched == 0 or counter.launches != launched:
            raise AssertionError(f"parity: kernel launches {launched} / "
                                 f"{counter.launches}")
        if not torch.equal(got, want):
            b, i = (got != want).nonzero()[0].tolist()
            raise AssertionError(f"generate parity: row {b} differs at "
                                 f"token {i}: kernel {got[b, i]} vs plain "
                                 f"{want[b, i]}")
        print(f"generate parity: {mcfg.n_embd}C {mcfg.decode_cache_layout} "
              f"B={got.shape[0]}, {n} greedy tokens identical on the kernel "
              f"route ({launched} {counter.__name__} launches) and the "
              f"plain route (f32, 2 layers)")


def generate_slice_phase(card: str) -> tuple:
    """The generation main path through generate(): char-GPT B=1 samples
    (p50 tokens/s) and GPT-2 124M packed B=8."""
    char = get_config("char-gpt").model
    model = init_params(char, torch.Generator(device="cuda").manual_seed(1337),
                        device="cuda")
    walls = []
    dec.fused_decode_layers.launches = 0
    for i in range(5):
        gen = torch.Generator(device="cuda").manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, [[0]], char,
                        GenerateConfig(max_new_tokens=1000), gen).cpu()
        walls.append(time.perf_counter() - t0)
        assert toks.shape == (1, 1000) and 0 <= toks.min() \
            and toks.max() < char.vocab_size
    fused = dec.fused_decode_layers.launches
    assert fused == 5 * 1030, fused
    tps = sorted(1000 / w for w in walls)
    print(f"generate slice (char-gpt, B=1, 1000 tokens, bf16, 5 samples) on "
          f"{card}: p50 {statistics.median(tps):.1f} tok/s (min {tps[0]:.1f}, "
          f"max {tps[-1]:.1f}), {fused} fused kernel launches")
    small = dataclasses.replace(get_config("gpt2-small").model,
                                decode_cache_layout="packed")
    model = init_params(small, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    prompts = np.random.default_rng(0).integers(0, small.vocab_size, (PB, 64))
    gcfg = GenerateConfig(max_new_tokens=256, top_k=50, temperature=0.8)
    generate(model, prompts[:, :8], small,
             GenerateConfig(max_new_tokens=4))          # warm the allocator
    dec.packed_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, prompts, small, gcfg).cpu()
    wall = time.perf_counter() - t0
    packed = dec.packed_decode_attention.launches
    assert packed == small.n_layer * 256, packed
    assert toks.shape == (PB, 256) and 0 <= toks.min() \
        and toks.max() < small.vocab_size
    print(f"generate slice (gpt2-small, packed, B={PB}, 64-token prompts, "
          f"256 new, bf16, top-k 50) on {card}: {PB * 256 / wall:.1f} tok/s "
          f"aggregate, {wall / 256 * 1e3:.3f} ms per step (host clock, "
          f"prefill included), {packed} packed kernel launches")
    return fused, packed


# char-GPT serving: 8 slots (one inactive), pages of 16, 16 pages a slot
FPB, FPSZ, FPMP = 8, 16, 16
FPOS = [0, 1, 64, 100, 129, 170, 230, 255]


def pool_label(kv: str, gran: str) -> str:
    return "none" if kv == "none" else f"{kv}-{gran}"


def fused_paged_inputs(dtype: torch.dtype, kv: str, gran: str,
                       seed: int = 0):
    """The paged fused kernel's inputs at the char-GPT serving path's
    shapes: init-sized weights (layernorm parameters and biases
    perturbed so their casts show), embedding-sized rows, projection-
    sized pool rows on a permuted table whose entries past each live
    frontier point past the pool, and NaN in every pool row (quantized:
    every scale) at or past a slot's position."""
    mcfg = dataclasses.replace(get_config("char-gpt").model, dtype={
        torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype],
        decode_cache_layout="packed")
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, C, H = mcfg.n_layer, mcfg.n_embd, mcfg.n_head
    N = FPB * FPMP

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    resid = 0.02 * (2 * L) ** -0.5
    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        if name.endswith("_scale"):
            blocks[name] = 1 + rnd(L, *shape(C), scale=0.1)
        elif name.endswith("_kernel"):
            blocks[name] = rnd(L, *shape(C), scale=resid if name in (
                "attn_out_kernel", "mlp_down_kernel") else 0.02)
        else:
            blocks[name] = rnd(L, *shape(C), scale=0.02)
    blocks = dec.fused_weights(blocks, dtype)
    kv_rows = [rnd(L, N, FPSZ, C, scale=0.5) for _ in range(2)]
    if kv == "none":
        cache = {"k": kv_rows[0].to(dtype), "v": kv_rows[1].to(dtype)}
        dirty = ("k", "v")
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv, H, gran) for t in kv_rows)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        dirty = ("ks", "vs")
    perm = torch.randperm(N, generator=g, device="cuda")
    tables = perm.reshape(FPB, FPMP).to(torch.int32)
    pos = torch.tensor(FPOS, dtype=torch.int32, device="cuda")
    for b, p in enumerate(FPOS):
        live = (p + FPSZ - 1) // FPSZ
        for r in range(p, live * FPSZ):
            for n in dirty:
                cache[n][:, int(tables[b, r // FPSZ]), r % FPSZ] = float("nan")
        tables[b, live:] = N + 9
    x0 = rnd(FPB, C, scale=0.03).to(dtype)
    return (x0, blocks, pos, tables.contiguous(), cache, mcfg)


def fused_paged_bound_ms(args) -> tuple:
    """Every layer's weights read once for all slots, each slot's live
    K/V rows (and scales) read once, the rows in and the rows and fresh
    K/V out; ~2 flops per weight element and slot, 4 per history element
    (scores and values)."""
    x0, _, pos, tables, cache, mcfg = args
    L, C, H = mcfg.n_layer, mcfg.n_embd, mcfg.n_head
    isz = x0.element_size()
    hist = int(pos.long().sum())
    sw = (0 if "ks" not in cache else cache["ks"].shape[-1]
          if cache["ks"].dim() == 4 else 1)
    weights = L * (12 * C * C + 13 * C)
    nbytes = (weights * isz + 2 * L * hist * (C * cache["k"].element_size()
                                              + 4 * sw)
              + FPB * C * isz * (2 + 2 * L) + tables.numel() * 4 + FPB * 4)
    return _bound(nbytes, 2 * FPB * weights + 4 * L * hist * C, x0.dtype)


def fused_paged_plan(args) -> dict:
    """The paged fused kernel's plan for these inputs and the history
    split the engine's step gets (max_pos = the longest position)."""
    x0, _, _, tables, cache, mcfg = args
    plan = dec.fused_paged_decode_plan(
        mcfg.n_embd, mcfg.n_head, tables.shape[1] * cache["k"].shape[2],
        x0.dtype, cache["k"].dtype, "cuda")
    return {**plan, "attn_splits": dec.fused_paged_attn_splits(
        max(FPOS), FPB, mcfg.n_head, plan["grid"])}


def fused_paged_kernel_phase(flush: torch.Tensor) -> dict:
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kv, gran in POOLS:
            args = fused_paged_inputs(dtype, kv, gran)
            ref = dec.fused_paged_decode_layers_ref(*args)
            tol = (FP8_BF16_TOL if kv == "fp8" and dtype == torch.bfloat16
                   else TOL[dtype])
            err = 0.0
            # as the engine's step calls it (its longest position), and
            # with the split sized from the whole table
            for max_pos in (max(FPOS), None):
                got = dec.fused_paged_decode_layers(*args, max_pos=max_pos)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"fused paged: non-finite "
                                             f"output ({dtype}, {kv}-{gran})")
                    torch.testing.assert_close(a.float(), b.float(),
                                               atol=tol, rtol=tol)
                    err = max(err, (a.float() - b.float()).abs().max().item())
            errs[(dtype, pool_label(kv, gran))] = err
            print(f"fused paged check: {str(dtype)[6:]} pool "
                  f"{pool_label(kv, gran)} B={FPB} pos {FPOS} max_pos "
                  f"{max(FPOS)} and none, max_abs_err {err:.3e} "
                  f"(atol=rtol={tol})")
    by_pool = {}
    for kv, gran in POOLS:
        args = fused_paged_inputs(torch.bfloat16, kv, gran)
        plan = fused_paged_plan(args)
        print(f"fused paged plan (char-gpt, bf16, pool "
              f"{pool_label(kv, gran)}): {plan}")
        ms = time_ms(lambda: dec.fused_paged_decode_layers(
            *args, max_pos=max(FPOS)), flush)
        plain_ms = time_ms(lambda: dec.fused_paged_decode_layers_ref(*args),
                           flush, n=10, warm=2)
        b_ms, b_by = fused_paged_bound_ms(args)
        by_pool[pool_label(kv, gran)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "plan": plan,
            "max_abs_err": errs[(torch.bfloat16, pool_label(kv, gran))]}
        print(f"fused paged timing (char-gpt, bf16, pool "
              f"{pool_label(kv, gran)}, B={FPB}, pos sum {sum(FPOS)}): "
              f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.2f} us ({b_by})")
    main = by_pool["none"]
    return {"name": "fused_paged_decode_layers", "route": "cuda",
            "source": FUSED_PAGED_SOURCE, "replaces": FUSED_PAGED_REPLACES,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes every layer "
                       "of a paged decode step",
            "split": {k: main["plan"][k] for k in (
                "grid", "attn_splits", "weight_slots", "kv_rows")},
            "by_pool": by_pool}


def quantized_paged_phase(flush: torch.Tensor) -> dict:
    """Row #1's quantized pools at the GPT-2 124M serving shapes (W=1)."""
    out = {}
    for kv, gran in POOLS[1:]:
        label = pool_label(kv, gran)
        err = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, kn, vn, kp, vp, tables, pos = paged_inputs(1, torch.float32)
            kq, ks = quantize_rows(kp, kv, H, gran)
            vq, vs = quantize_rows(vp, kv, H, gran)
            kn, vn = (fake_quantize_rows(t, kv, H, gran) for t in (kn, vn))
            args = (q.to(dtype), kn.to(dtype), vn.to(dtype), kq, vq, tables,
                    pos)
            kw = {"n_head": H, "k_scales": ks, "v_scales": vs}
            got = pa.paged_window_attention(*args, **kw)
            torch.cuda.synchronize()
            ref = pa.paged_window_attention_ref(*args, **kw)
            torch.testing.assert_close(got.float(), ref.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            err[dtype] = (got.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: pa.paged_window_attention(*args, **kw), flush)
        plain_ms = time_ms(lambda: pa.paged_window_attention_ref(*args, **kw),
                           flush)
        nbytes = paged_bytes(args, 1, H if gran == "head" else 1)
        b_ms, b_by = _bound(nbytes, 4 * C * (int(pos.long().sum()) + B),
                            torch.bfloat16)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err[torch.bfloat16],
                      "gbps": gbps(nbytes, ms)}
        print(f"quantized paged check + timing ({label}, B={B}, W=1): "
              f"max_abs_err f32 {err[torch.float32]:.3e} (1e-4), bf16 "
              f"{err[torch.bfloat16]:.3e} (2e-2); bf16 kernel "
              f"{ms * 1e3:.1f} us ({gbps(nbytes, ms):.0f} GB/s), plain "
              f"{plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
    return out


@contextlib.contextmanager
def forced_fused_route():
    """The engine's route rule takes the fused kernel wherever the
    per-layer kernel is allowed: the JAX envelope keeps char-GPT's f32
    layers (7 MB each) off it unless the pool is quantized."""
    rule = engine_mod.fused_paged_decode_supported
    engine_mod.fused_paged_decode_supported = lambda *a, **kw: True
    try:
        yield
    finally:
        engine_mod.fused_paged_decode_supported = rule


def fused_parity_phase() -> None:
    """f32 greedy streams through the engine on the fused and gather
    routes, at char-GPT width, 2 layers, with each pool."""
    mcfg = dataclasses.replace(get_config("char-gpt").model, n_layer=2,
                               dtype="float32", decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=8, seed=2, prompt_len_max=120, prompt_mode="shared_prefix",
        max_new_tokens=48, greedy=True))
    for kv in ("none", "int8", "fp8"):
        streams = {}
        for fused in (True, False):
            ecfg = EngineConfig(pool_size=8, page_size=16, paged_kernel=fused,
                                kv_quant=kv)
            with forced_fused_route() if fused and kv == "none" \
                    else contextlib.nullcontext():
                eng = Engine(model, mcfg, ecfg, device="cuda")
            assert eng.kernel_route.decode == ("fused" if fused
                                               else "gather")
            dec.fused_paged_decode_layers.launches = 0
            for _, req in trace:
                assert eng.submit(req) is None
            streams[fused] = {r.id: r.tokens for r in eng.drain()}
            launched = dec.fused_paged_decode_layers.launches
            assert (launched == eng.n_steps) if fused else launched == 0
        a, b = streams[True], streams[False]
        for rid in sorted(b):
            if a[rid] != b[rid]:
                i = next(j for j, (x, y) in enumerate(zip(a[rid], b[rid]))
                         if x != y)
                raise AssertionError(f"fused parity ({kv}): {rid} differs at "
                                     f"token {i}: fused {a[rid][i]} vs "
                                     f"gather {b[rid][i]}")
        n = sum(len(s) for s in a.values())
        print(f"fused parity ({kv} pool): {len(a)} greedy streams, {n} "
              f"tokens identical on the fused and gather routes (f32, 2 "
              f"layers, C=384)")


def char_replay(extra) -> dict:
    argv = ["serve-replay", "--preset", "char-gpt", "--decode-cache-layout",
            "packed", "--paged-kernel", "--rate", "1000", "--pool-size", "8",
            "--page-size", "16", "--prompt-mode", "shared_prefix",
            "--prompt-len-max", "128", "--request-max-new-tokens", "64",
            "--json", *extra]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def fused_slice_phase(card: str) -> tuple:
    """The char-GPT serving main path through the port's CLI (fused
    route), then a reduced-depth GPT-2 124M replay on an int8 pool (the
    per-layer route: the fused envelope says no at 124M)."""
    V = get_config("char-gpt").model.vocab_size
    dec.fused_paged_decode_layers.launches = 0
    pa.paged_window_attention.launches = 0
    s = char_replay(["--n-requests", "24", "--greedy"])
    fused = dec.fused_paged_decode_layers.launches
    assert fused > 0 and pa.paged_window_attention.launches == 0
    assert s["n_completed"] == s["n_requests"] == 24, s["n_completed"]
    assert s["kernel_route"]["decode"] == "fused", s["kernel_route"]
    assert s["fused_launches"] == s["n_steps"] > 0, (s["fused_launches"],
                                                     s["n_steps"])
    assert s["kernel_launches"] == 0
    assert s["pages"]["prefix_hits"] > 0, s["pages"]
    toks = [t for st in s["streams"].values() for t in st]
    assert len(toks) == 24 * 64 and all(0 <= t < V for t in toks)
    h = s["histograms"]
    print(f"char slice (fused route, bf16, 24 greedy requests) on {card}: "
          f"{s['aggregate_tokens_per_s']} tok/s, TTFT p50 "
          f"{h['ttft_s']['p50'] * 1e3:.2f} ms / p99 "
          f"{h['ttft_s']['p99'] * 1e3:.2f} ms, step p50 "
          f"{s['step_latency']['p50_s'] * 1e3:.3f} ms over {s['n_steps']} "
          f"steps, {s['fused_launches']} fused launches (one per step)")
    n_layer = 4
    pa.paged_window_attention.launches = 0
    q = replay(["--n-requests", "8", "--greedy", "--n-layer", str(n_layer),
                "--kv-quant", "int8"], n_layer=n_layer)
    qlaunches = pa.paged_window_attention.launches
    assert q["kernel_route"]["kv_quant"] == "int8", q["kernel_route"]
    assert q["pages"]["kv_quant"] == "int8" and q["fused_launches"] == 0
    print(f"gpt2-small int8 slice ({n_layer} layers, kernel route, 8 greedy "
          f"requests) on {card}: {q['aggregate_tokens_per_s']} tok/s, step "
          f"p50 {q['step_latency']['p50_s'] * 1e3:.3f} ms over "
          f"{q['n_steps']} steps, {q['kernel_launches']} kernel launches, "
          f"{q['pages']['bytes_per_page']} bytes/page")
    return fused, qlaunches, s


def group_flash_phase(flush: torch.Tensor) -> list:
    """The flash kernels at the GPT-2 124M training shapes (bf16 and f32,
    attention dropout 0 and 0.1) and at T=8192 (f32 and bf16), against
    their plain versions; then timings at the path's setting (bf16, dropout 0)
    beside the bound and ``scaled_dot_product_attention``."""
    seed = 7_654_321
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, GROUP_RATE):
            qkv, do = flash_inputs(dtype, shape=(GB, GT, GC),
                                   scale=QKV_SCALE)
            err = errs[(dtype, rate)] = check_flash(qkv, do, GH, seed, rate)
            print(f"flash check (gpt2-small, B={GB}, T={GT}, C={GC}, H={GH}):"
                  f" {str(dtype)[6:]} rate {rate} max_abs_err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" ({flash_tol_text(dtype)})")
            del qkv, do
    long_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv, do = flash_inputs(dtype, shape=(1, LT, GC), scale=QKV_SCALE)
        err = long_err[dtype] = check_flash(qkv, do, GH, seed, 0.0)
        print(f"flash check (B=1, T={LT}, C={GC}, H={GH}): {str(dtype)[6:]} "
              f"rate 0.0 max_abs_err " + ", ".join(f"{k} {v:.3e}"
                                                   for k, v in err.items())
              + f" ({flash_tol_text(dtype)})")
    long_t = time_flash(qkv, do, GH, seed, 0.0, flush, n=10)
    long_bound = {w: flash_bound_ms(qkv, GH, w) for w in ("fwd", "bwd")}
    del qkv, do
    qkv, do = flash_inputs(torch.bfloat16, shape=(GB, GT, GC),
                           scale=QKV_SCALE)
    ms, plain, library, backend = time_flash(qkv, do, GH, seed, 0.0, flush,
                                             n=10)
    rows = []
    for which, err in (("fwd", "o"), ("bwd", "dqkv")):
        b_ms, b_by, b_ops = flash_bound_ms(qkv, GH, which)
        lb_ms, lb_by, lb_ops = long_bound[which]
        r = rates(ms[which], b_ops, library[which])
        lr = rates(long_t[0][which], lb_ops, long_t[2][which])
        for label, t, p, lib, bm, bb, rr in (
                (f"B={GB}, T={GT}", ms, plain, library, b_ms, b_by, r),
                (f"B=1, T={LT}", *long_t[:3], lb_ms, lb_by, lr)):
            print(f"flash {which} timing (bf16, {label}, C={GC}, H={GH}, "
                  f"dropout 0): kernel {t[which]:.3f} ms, plain "
                  f"{p[which]:.3f} ms, sdpa ({backend}) {lib[which]:.3f} ms, "
                  f"bound {bm:.4f} ms ({bb}); {rates_text(rr)}")
        rows.append({**r,
            "name": f"flash_packed_{which}@gpt2-small", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": GROUP_REPLACES[which],
            "also_replaces": GROUP_ALSO_REPLACES[which],
            "shapes": f"B={GB}, T={GT}, C={GC}, H={GH}, bf16, dropout 0",
            "max_abs_err": errs[(torch.bfloat16, 0.0)][err],
            "ms": ms[which], "kernel_ms": ms[which],
            "plain_ms": plain[which], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library[which], "library": f"sdpa {backend}",
            "long_t": {"shapes": f"B=1, T={LT}, C={GC}, H={GH}, bf16",
                       "max_abs_err": long_err[torch.bfloat16][err],
                       "ms": long_t[0][which],
                       "plain_ms": long_t[1][which],
                       "library_ms": long_t[2][which],
                       "library": f"sdpa {long_t[3]}", "bound_ms": lb_ms,
                       "bound_by": lb_by, **lr}})
    return rows


def gpt2_parity_phase() -> None:
    """5 steps at GPT-2 124M width (2 layers, T=1024, B=2, f32) through
    the kernels and through the packed plain version, from the same
    seeds and batches (warmup cut to one step so the weights move)."""
    base = get_config("gpt2-small")

    def plain_core(qkv, n_head, *, seed, rate):
        return fp.flash_packed_fwd_ref(qkv, n_head, seed=seed, rate=rate)[0]

    plain = functools.partial(packed_qkv_attention, core=plain_core)
    mcfg = dataclasses.replace(base.model, n_layer=2, dtype="float32")
    tcfg = dataclasses.replace(base.train, batch_size=2, max_iters=5,
                               warmup_iters=1)
    tokens = np.random.default_rng(5).integers(0, 1024, 64 * GT)
    curves = []
    for attention_fn in (None, plain):
        fp.flash_packed_fwd.launches = 0
        state = create_train_state(mcfg, tcfg, "cuda")
        step = make_train_step(mcfg, tcfg, attention_fn)
        batcher = RandomBatcher(tokens, tcfg.batch_size, GT, seed=tcfg.seed)
        losses = [step(state, tuple(torch.from_numpy(a).cuda()
                                    for a in batcher.next_batch()))
                  for _ in range(tcfg.max_iters)]
        curves.append([float(x) for x in losses])
        if (fp.flash_packed_fwd.launches > 0) != (attention_fn is None):
            raise AssertionError(f"gpt2 parity: {fp.flash_packed_fwd.launches}"
                                 f" kernel launches")
    rel = max(abs(a - b) / abs(b) for a, b in zip(*curves))
    if not rel <= 1e-4:
        raise AssertionError(f"gpt2 parity: kernel {curves[0]} vs plain "
                             f"{curves[1]}")
    print(f"gpt2 parity (f32, 2 layers, C={GC}, H={GH}, T={GT}, B=2): 5 "
          f"losses {curves[0][0]:.6f} -> {curves[0][-1]:.6f}, max relative "
          f"difference kernel vs plain {rel:.2e} (limit 1e-4)")


FLASH_WRAPPERS = (fc.flash_chunk_fwd, fc.flash_chunk_bwd,
                  fp.flash_packed_fwd, fp.flash_packed_bwd,
                  fh.flash_heads_fwd, fh.flash_heads_bwd)


def run_train_cli(argv) -> tuple:
    """``train`` through the port's CLI, in process: (stdout, JSONL
    events, forward and backward packed flash launches, the heads
    kernel's forward and backward launches, and the chunk kernel's),
    every count set to 0 just before the run."""
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "train.jsonl")
        for w in FLASH_WRAPPERS:
            w.launches = 0
        with contextlib.redirect_stdout(out):
            assert cli.main(["train", *argv, "--log-jsonl", log]) == 0
        cf, cb, pf, pb, hf, hb = (w.launches for w in FLASH_WRAPPERS)
        with open(log) as f:
            events = [json.loads(line) for line in f]
    return out.getvalue(), events, (pf, pb), (hf, hb), (cf, cb)


def gpt2_slice_phase(card: str) -> tuple:
    """The GPT-2 124M training main path: ``train --preset gpt2-small``
    through the CLI for 200 steps (B=32, T=1024), evals at 0, 100 and 200
    over 20 batches each of train and val, the BPE trained at first use."""
    L = get_config("gpt2-small").model.n_layer
    steps, eval_iters, n_evals = 200, 20, 3
    had_bpe = os.path.exists(BPE_CACHE)
    text, events, (fwd, bwd), _, _ = run_train_cli(
        ["--preset", "gpt2-small", "--max-iters", str(steps),
         "--eval-interval", "100", "--eval-iters", str(eval_iters)])
    print(text, end="")
    assert os.path.exists(BPE_CACHE)
    evals = [e for e in events if e["event"] == "eval"]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    losses += [e[k] for e in evals for k in ("train_loss", "val_loss")]
    assert losses and all(math.isfinite(x) for x in losses), losses
    assert [e["step"] for e in evals] == [0, 100, steps], evals
    first, last = evals[0]["val_loss"], evals[-1]["val_loss"]
    if not (last < math.log(1024) and last < first):
        raise AssertionError(f"gpt2 slice: val loss {first} at step 0, {last}"
                             f" at step {steps} (limit ln 1024 = "
                             f"{math.log(1024):.4f})")
    assert fwd == L * (steps + n_evals * 2 * eval_iters), fwd
    assert bwd == L * steps, bwd
    info = {k: v for e in events if e["event"] == "info" for k, v in e.items()}
    print(f"gpt2 slice (gpt2-small, {steps} steps, B={GB}, T={GT}, bf16, BPE "
          f"{'loaded' if had_bpe else 'trained at first use'}) on {card}: "
          f"{info['tokens_per_sec']:.0f} tok/s, train step p50 "
          f"{info['p50_ms']:.3f} ms (mean {info['mean_ms']:.3f}), val loss "
          f"{last:.4f} at step {steps} (step 0: {first:.4f}), {fwd} forward / "
          f"{bwd} backward kernel launches ({L} per step and eval batch)")
    return fwd, bwd, info


def gpt2_shakespeare_phase(card: str) -> None:
    """The reference's GPT-2.py run: ``train --preset gpt2-shakespeare``,
    50 steps with a ``Step {i}, Loss: ...`` line each."""
    cfg = get_config("gpt2-shakespeare")
    L, steps = cfg.model.n_layer, cfg.train.max_iters
    text, events, (fwd, bwd), _, _ = run_train_cli(
        ["--preset", "gpt2-shakespeare"])
    print(text, end="")
    lines = re.findall(r"^Step (\d+), Loss: (\S+) \|", text, re.M)
    assert [int(i) for i, _ in lines] == list(range(steps)), lines
    assert all(math.isfinite(float(x)) for _, x in lines)
    assert fwd == L * (steps + 2 * cfg.train.eval_iters), fwd
    assert bwd == L * steps, bwd
    print(f"gpt2-shakespeare (the reference's GPT-2.py run) on {card}: "
          f"{steps} steps, loss {lines[0][1]} -> {lines[-1][1]}, {fwd} "
          f"forward / {bwd} backward kernel launches")


# q, k and v as gpt2-xl's path feeds the kernel: unit-variance layernorm
# output through 0.02-std weights at C=1600
XQKV_SCALE = 0.8


def heads_inputs(dtype: torch.dtype, shape, seed: int = 0,
                 scale: float = XQKV_SCALE) -> tuple:
    """q, k, v (B, H, T, D) at ``scale`` and a unit-scale upstream
    gradient (the gradients are linear in it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") * scale
               for _ in range(3))
    do = torch.randn(shape, generator=g, device="cuda")
    return tuple(on_grid(t, dtype) for t in (q, k, v, do))


def heads_bound_ms(q: torch.Tensor, which: str, causal: bool = True) -> tuple:
    """Least time of one call: q, k, v (and dO, lse, delta) read once,
    o and lse (dq, dk, dv) written once, over the memory rate, vs the
    products over the unmasked pairs (2 forward, 5 backward) over the peak
    rate of the input type; (ms, what bounds it, the products' FLOP)."""
    B, H, T, D = q.shape
    n = B * H * T * D * q.element_size()
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    if which == "fwd":
        nbytes, flops = 4 * n + B * H * T * 4, 2 * 2 * pairs * D
    else:
        nbytes, flops = 7 * n + 2 * B * H * T * 4, 5 * 2 * pairs * D
    return (*_bound(nbytes, flops, q.dtype), flops)


def check_heads(q, k, v, do, seed: int, rate: float,
                causal: bool = True) -> dict:
    """Forward (o, lse) and backward (dq, dk, dv) of the heads kernels
    against the plain versions on the same inputs, at ``FLASH_TOL``; the
    max abs errors (``d``: the largest of the three gradients')."""
    kw = dict(causal=causal, seed=seed, rate=rate)
    o, lse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, o)
    grads = fh.flash_heads_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(("o", "lse"), (o, lse),
                     fh.flash_heads_fwd_ref(q, k, v, **kw)))
    pairs += zip(("dq", "dk", "dv"), grads,
                 fh.flash_heads_bwd_ref(q, k, v, do, lse, delta, **kw))
    err = {}
    for name, got, ref in pairs:
        if not torch.isfinite(got).all():
            raise AssertionError(f"heads flash: non-finite {name}")
        err[name] = (got.float() - ref.float()).abs().max().item()
        atol, rtol = FLASH_TOL[got.dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")
    err["d"] = max(err["dq"], err["dk"], err["dv"])
    return err


def time_heads(q, k, v, do, flush: torch.Tensor, n: int = 10) -> tuple:
    """CUDA-event times (ms) of both heads kernels, their plain versions,
    ``scaled_dot_product_attention(is_causal=True)`` (its forward and its
    backward) at dropout 0, and the SDPA backend PyTorch picks."""
    o, lse = fh.flash_heads_fwd(q, k, v)
    delta = fh.heads_delta(do, o)
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    backend = SDPBackend(torch._fused_sdp_choice(sq, sk, sv, None, 0.0,
                                                 True)).name

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)

    out = sdpa()
    plain_n = max(3, n // 3)
    ms = {"fwd": time_ms(lambda: fh.flash_heads_fwd(q, k, v), flush, n),
          "bwd": time_ms(lambda: fh.flash_heads_bwd(q, k, v, do, lse, delta),
                         flush, n)}
    plain = {"fwd": time_ms(lambda: fh.flash_heads_fwd_ref(q, k, v), flush,
                            plain_n, 2),
             "bwd": time_ms(lambda: fh.flash_heads_bwd_ref(
                 q, k, v, do, lse, delta), flush, plain_n, 2)}
    library = {"fwd": time_ms(sdpa, flush, n),
               "bwd": time_ms(lambda: torch.autograd.grad(
                   out, (sq, sk, sv), do, retain_graph=True), flush, n)}
    return ms, plain, library, backend


def time_routes(q, k, v, do, flush: torch.Tensor, n: int = 10) -> dict:
    """The two attention routes at the same shapes (bf16, dropout 0), as
    the block runs them: the packed kernel on the (B, T, 3C) projection
    output, and the heads kernel with the split transposes of q, k, v
    (forward) or dO (backward) and the merge of o (forward) or dq, dk, dv
    (backward); each with its delta. CUDA-event ms."""
    B, H, T, D = q.shape
    C = H * D
    qkv = torch.cat([gpt._merge_heads(t) for t in (q, k, v)], -1)
    dom = gpt._merge_heads(do).contiguous()
    po, plse = fp.flash_packed_fwd(qkv, H)
    ho, hlse = fh.flash_heads_fwd(q, k, v)

    def heads_fwd():
        parts = (gpt._split_heads(t, H).contiguous()
                 for t in qkv.split(C, -1))
        return gpt._merge_heads(fh.flash_heads_fwd(*parts)[0])

    def heads_bwd():
        g = gpt._split_heads(dom, H).contiguous()
        grads = fh.flash_heads_bwd(q, k, v, g, hlse, fh.heads_delta(g, ho))
        return torch.cat([gpt._merge_heads(t) for t in grads], -1)

    return {"packed_fwd": time_ms(lambda: fp.flash_packed_fwd(qkv, H), flush,
                                  n),
            "heads_fwd": time_ms(heads_fwd, flush, n),
            "packed_bwd": time_ms(lambda: fp.flash_packed_bwd(
                qkv, dom, plse, fp.packed_delta(dom, po, H), H), flush, n),
            "heads_bwd": time_ms(heads_bwd, flush, n)}


def heads_flash_phase(flush: torch.Tensor) -> list:
    """The (B, H, T, D) kernels at gpt2-xl's attention shapes, causal=False
    and D=256 against their plain versions; timings beside the bound,
    the plain versions, SDPA and the packed route."""
    seed = 2_468_013
    shape = (XB, XH, GT, XC // XH)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, GROUP_RATE):
            err = errs[(dtype, rate)] = check_heads(
                *heads_inputs(dtype, shape), seed, rate)
            print(f"heads flash check (gpt2-xl, B={XB}, H={XH}, T={GT}, "
                  f"D={shape[-1]}): {str(dtype)[6:]} rate {rate} max_abs_err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" ({flash_tol_text(dtype)}; d(q, k, v) as o)")
    for label, shp, causal, cases in (
            ("causal=False", (2, 4, 512, 64), False,
             ((torch.float32, GROUP_RATE), (torch.bfloat16, GROUP_RATE))),
            ("D=256", (2, 4, 2048, 256), True,
             ((torch.float32, GROUP_RATE), (torch.bfloat16, 0.0)))):
        for dtype, rate in cases:
            err = check_heads(*heads_inputs(dtype, shp, seed=1, scale=0.5),
                              seed, rate, causal=causal)
            print(f"heads flash check ({label}, B, H, T, D = {shp}): "
                  f"{str(dtype)[6:]} rate {rate} max_abs_err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    q, k, v, do = heads_inputs(torch.bfloat16, shape)
    ms, plain, library, backend = time_heads(q, k, v, do, flush)
    routes = time_routes(q, k, v, do, flush)
    print(f"route timing (gpt2-xl attention, bf16, B={XB}, T={GT}, dropout "
          f"0): packed kernel on (B, T, 3C) fwd {routes['packed_fwd']:.3f} "
          f"ms / bwd {routes['packed_bwd']:.3f} ms; heads kernel with its "
          f"split and merge transposes fwd {routes['heads_fwd']:.3f} ms / "
          f"bwd {routes['heads_bwd']:.3f} ms")
    rows = []
    for which, err in (("fwd", "o"), ("bwd", "d")):
        b_ms, b_by, b_ops = heads_bound_ms(q, which)
        r = rates(ms[which], b_ops, library[which])
        print(f"heads flash {which} timing (bf16, B={XB}, H={XH}, T={GT}, "
              f"D={shape[-1]}, dropout 0): kernel {ms[which]:.3f} ms, plain "
              f"{plain[which]:.3f} ms, sdpa ({backend}) "
              f"{library[which]:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{rates_text(r)}")
        rows.append({**r,
            "name": f"flash_heads_{which}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": HEADS_REPLACES[which],
            "also_replaces": HEADS_ALSO_REPLACES[which],
            "shapes": f"B={XB}, H={XH}, T={GT}, D={shape[-1]}, bf16, "
                      f"dropout 0",
            "max_abs_err": errs[(torch.bfloat16, 0.0)][err],
            "ms": ms[which], "kernel_ms": ms[which],
            "plain_ms": plain[which], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library[which], "library": f"sdpa {backend}",
            "routes_ms": {"packed": routes[f"packed_{which}"],
                          "heads": routes[f"heads_{which}"]}})
    return rows


def xl_plain_route(qkv, cfg, rng, train):
    """The split-heads route on the plain core (no kernel)."""
    q, k, v = (gpt._split_heads(t, cfg.n_head)
               for t in qkv.split(cfg.n_embd, dim=-1))
    return gpt._merge_heads(full_causal_attention(q, k, v))


def xl_parity_phase() -> None:
    """5 f32 steps at GPT-2 XL width (2 layers, T=1024, B=2, remat on)
    through the heads kernel and through the plain route, from the same
    seeds and batches; then one step's loss and gradients with remat on
    and off, identical."""
    base = get_config("gpt2-xl")
    mcfg = dataclasses.replace(base.model, n_layer=2, dtype="float32")
    tcfg = dataclasses.replace(base.train, batch_size=2, max_iters=5)
    tokens = np.random.default_rng(6).integers(0, 1024, 64 * GT)
    curves = []
    for attention_fn in (None, xl_plain_route):
        fh.flash_heads_fwd.launches = 0
        state = create_train_state(mcfg, tcfg, "cuda")
        step = make_train_step(mcfg, tcfg, attention_fn)
        batcher = RandomBatcher(tokens, tcfg.batch_size, GT, seed=tcfg.seed)
        losses = [step(state, tuple(torch.from_numpy(a).cuda()
                                    for a in batcher.next_batch()))
                  for _ in range(tcfg.max_iters)]
        curves.append([float(x) for x in losses])
        if (fh.flash_heads_fwd.launches > 0) != (attention_fn is None):
            raise AssertionError(f"xl parity: {fh.flash_heads_fwd.launches} "
                                 f"kernel launches")
        del state, step
    rel = max(abs(a - b) / abs(b) for a, b in zip(*curves))
    if not rel <= 1e-4:
        raise AssertionError(f"xl parity: kernel {curves[0]} vs plain "
                             f"{curves[1]}")
    print(f"xl parity (f32, 2 layers, C={XC}, H={XH}, T={GT}, B=2, remat "
          f"full): 5 losses {curves[0][0]:.6f} -> {curves[0][-1]:.6f}, max "
          f"relative difference kernel vs plain {rel:.2e} (limit 1e-4)")
    x, y = (torch.from_numpy(a).cuda()
            for a in RandomBatcher(tokens, 2, GT, seed=1).next_batch())
    results = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (True, False):
            cfg = dataclasses.replace(mcfg, remat=remat)
            model = init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
            _, loss = gpt.forward(model.tree(), x, cfg, targets=y)
            loss.backward()
            results.append((loss.detach(), {n: p.grad for n, p in
                                             model.named_parameters()}))
    finally:
        torch.use_deterministic_algorithms(False)
    (l1, g1), (l0, g0) = results
    diff = {n: (g1[n] - g0[n]).abs().max().item() for n in g0}
    if not torch.equal(l1, l0) or any(diff.values()):
        raise AssertionError(f"xl remat: loss {l1.item()} vs {l0.item()}, "
                             f"gradient max differences {diff}")
    print(f"xl remat (f32, 2 layers, C={XC}): loss {l1.item():.6f} and all "
          f"{len(g0)} gradients identical with remat full and without")


def gpt2_xl_slice_phase(card: str) -> tuple:
    """The GPT-2 XL training main path: ``train --preset gpt2-xl`` through
    the CLI at the published widths, remat full, the preset's global
    batch of 64 as 4 accumulated micro-batches of 16, ``XL_STEPS`` steps,
    evals at 0 and the end over ``XL_EVAL_ITERS`` batches a split."""
    mcfg = get_config("gpt2-xl").model
    L, steps, eval_iters, n_evals = (mcfg.n_layer, XL_STEPS, XL_EVAL_ITERS,
                                     2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    text, events, packed, (fwd, bwd), chunk = run_train_cli(
        ["--preset", "gpt2-xl", "--batch-size", str(XB),
         "--grad-accum-steps", str(XACC), "--max-iters", str(steps),
         "--eval-interval", str(steps), "--eval-iters", str(eval_iters),
         "--log-interval", "1"])
    peak = torch.cuda.max_memory_allocated()
    print(text, end="")
    evals = [e for e in events if e["event"] == "eval"]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    losses += [e[k] for e in evals for k in ("train_loss", "val_loss")]
    assert len(losses) == steps + 2 * n_evals, losses
    assert all(math.isfinite(x) for x in losses), losses
    assert [e["step"] for e in evals] == [0, steps], evals
    first, last = evals[0]["val_loss"], evals[-1]["val_loss"]
    if not last < first:
        raise AssertionError(f"xl slice: val loss {first} at step 0, {last} "
                             f"at step {steps}")
    want_fwd = L * (2 * steps * XACC + n_evals * 2 * eval_iters)
    if (fwd, bwd, *packed, *chunk) != (want_fwd, L * steps * XACC, 0, 0, 0,
                                       0):
        raise AssertionError(f"xl slice launches: heads {fwd} / {bwd} "
                             f"(want {want_fwd} / {L * steps * XACC}), "
                             f"packed {packed}, chunk {chunk} (want 0)")
    if not peak < 80e9:
        raise AssertionError(f"xl slice: peak memory {peak} bytes")
    info = {k: v for e in events if e["event"] == "info" for k, v in e.items()}
    print(f"gpt2-xl slice ({steps} steps, {XACC} x B={XB}, T={GT}, bf16, "
          f"remat full) on {card}: {info['tokens_per_sec']:.0f} tok/s, train "
          f"step p50 {info['p50_ms']:.3f} ms (mean {info['mean_ms']:.3f}), "
          f"val loss {last:.4f} at step {steps} (step 0: {first:.4f}), peak "
          f"memory allocated {peak / 1e9:.3f} GB, {fwd} forward / {bwd} "
          f"backward heads kernel launches ({L} x (2 x {steps} x {XACC} + "
          f"{n_evals * 2 * eval_iters}) and {L} x {steps} x {XACC}), packed "
          f"kernel launches {packed[0]} / {packed[1]}")
    return fwd, bwd


def chunk_inputs(dtype: torch.dtype, Tq: int, Tk: int, seed: int = 0,
                 scale: float = XQKV_SCALE) -> tuple:
    """q (B, H, Tq, D), k and v (B, H, Tk, D) at the XL path's scale,
    dO at unit scale, and a unit-scale f32 lse cotangent (B, H, Tq)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = XC // XH

    def mk(T, s):
        return on_grid(torch.randn((XB, XH, T, D), generator=g,
                                   device="cuda") * s, dtype)

    return (mk(Tq, scale), mk(Tk, scale), mk(Tk, scale), mk(Tq, 1.0),
            torch.randn((XB, XH, Tq), generator=g, device="cuda"))


def visible_pairs(hop) -> int:
    """(q, k) pairs of one (batch, head) that a causal hop computes."""
    _, Tq, Tk, q_off, k_off = hop
    return sum(min(max(q_off + r - k_off + 1, 0), Tk) for r in range(Tq))


def chunk_bound_ms(q: torch.Tensor, k: torch.Tensor, hop,
                   which: str) -> tuple:
    """Least time of one chunk call: q, k, v (and dO, lse, delta') read
    once, o and lse (dq, dk, dv) written once, over the memory rate, vs
    the products over the hop's visible pairs (2 forward, 5 backward) over
    the peak rate of the input type; (ms, what bounds it, the products'
    FLOP)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    row = B * H * D * q.element_size()
    pairs = B * H * visible_pairs(hop)
    if which == "fwd":
        nbytes, flops = ((2 * Tq + 2 * Tk) * row + B * H * Tq * 4,
                         2 * 2 * pairs * D)
    else:
        nbytes, flops = ((3 * Tq + 4 * Tk) * row + 2 * B * H * Tq * 4,
                         5 * 2 * pairs * D)
    return (*_bound(nbytes, flops, q.dtype), flops)


def check_chunk(hop, dtype: torch.dtype, seed: int, rate: float) -> dict:
    """Forward (o, lse) and backward (dq, dk, dv, from the clamped lse and
    delta' with a nonzero lse cotangent) of the chunk kernels against the
    plain versions on the same inputs, at ``CHUNK_TOL``; the max abs
    errors (``d``: the largest gradient's). A fully masked hop must give
    o = 0, lse = NEG_INF and gradients exactly 0."""
    name, Tq, Tk, q_off, k_off = hop
    q, k, v, do, dlse = chunk_inputs(dtype, Tq, Tk, seed=Tq + Tk + q_off)
    kw = dict(q_offset=q_off, k_offset=k_off, seed=seed, rate=rate)
    o, lse = fc.flash_chunk_fwd(q, k, v, **kw)
    do, lse_c, deltap = fc.chunk_bwd_inputs(o, lse, do, dlse)
    grads = fc.flash_chunk_bwd(q, k, v, do, lse_c, deltap, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(("o", "lse"), (o, lse),
                     fc.flash_chunk_fwd_ref(q, k, v, **kw)))
    pairs += zip(("dq", "dk", "dv"), grads,
                 fc.flash_chunk_bwd_ref(q, k, v, do, lse_c, deltap, **kw))
    err = {}
    for nm, got, ref in pairs:
        if not torch.isfinite(got).all():
            raise AssertionError(f"chunk flash {name}: non-finite {nm}")
        err[nm] = (got.float() - ref.float()).abs().max().item()
        atol, rtol = CHUNK_TOL[got.dtype]
        if nm == "lse" and dtype == torch.bfloat16:
            atol = rtol = 1e-4
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol,
                                   msg=lambda m: f"chunk {name} {nm}: {m}")
    if name == "masked" and (o.any() or (lse != fc.NEG_INF).any()
                             or any(g.any() for g in grads)):
        raise AssertionError("chunk flash: a fully masked hop must give o "
                             "= 0, lse = NEG_INF and zero gradients")
    err["d"] = max(err["dq"], err["dk"], err["dv"])
    return err


def time_chunk(hop, flush: torch.Tensor, n: int = 20) -> dict:
    """CUDA-event times (ms) of both chunk kernels at ``hop`` (bf16,
    dropout 0), their plain versions, ``scaled_dot_product_attention``
    with the hop's boolean mask (its forward and its backward), the SDPA
    backend PyTorch picks, and the bounds."""
    _, Tq, Tk, q_off, k_off = hop
    q, k, v, do, dlse = chunk_inputs(torch.bfloat16, Tq, Tk)
    kw = dict(q_offset=q_off, k_offset=k_off)
    o, lse = fc.flash_chunk_fwd(q, k, v, **kw)
    do, lse_c, deltap = fc.chunk_bwd_inputs(o, lse, do, dlse)
    mask = fp.visible(Tq, Tk, q_off, k_off, "cuda")
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    backend = SDPBackend(torch._fused_sdp_choice(sq, sk, sv, mask, 0.0,
                                                 False)).name

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)

    out = sdpa()
    plain_n = max(3, n // 4)
    t = {"fwd": time_ms(lambda: fc.flash_chunk_fwd(q, k, v, **kw), flush, n),
         "bwd": time_ms(lambda: fc.flash_chunk_bwd(q, k, v, do, lse_c,
                                                   deltap, **kw), flush, n),
         "plain_fwd": time_ms(lambda: fc.flash_chunk_fwd_ref(q, k, v, **kw),
                              flush, plain_n, 2),
         "plain_bwd": time_ms(lambda: fc.flash_chunk_bwd_ref(
             q, k, v, do, lse_c, deltap, **kw), flush, plain_n, 2),
         "library_fwd": time_ms(sdpa, flush, n),
         "library_bwd": time_ms(lambda: torch.autograd.grad(
             out, (sq, sk, sv), do, retain_graph=True), flush, n),
         "backend": backend}
    for which in ("fwd", "bwd"):
        (t[f"bound_{which}"], t[f"bound_by_{which}"],
         t[f"ops_{which}"]) = chunk_bound_ms(q, k, hop, which)
    return t


def chunk_flash_phase(flush: torch.Tensor) -> list:
    """The chunk kernels at the ``--sp 4`` XL hop shapes against their
    plain versions on every kind of hop; the offset-0 chunk against the
    heads kernel; timings at the fully visible and diagonal hops."""
    seed = 3_141_592
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, GROUP_RATE):
            for hop in CHUNK_HOPS:
                err = errs[(dtype, rate, hop[0])] = check_chunk(
                    hop, dtype, seed, rate)
                print(f"chunk flash check ({hop[0]}: B={XB}, H={XH}, "
                      f"Tq={hop[1]}, Tk={hop[2]}, q_offset={hop[3]}, "
                      f"k_offset={hop[4]}): {str(dtype)[6:]} rate {rate} "
                      f"max_abs_err "
                      + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    q, k, v, do, _ = chunk_inputs(torch.bfloat16, XTL, XTL, seed=1)
    kw = dict(seed=seed, rate=GROUP_RATE)
    o, lse = fc.flash_chunk_fwd(q, k, v, **kw)
    ho, hlse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, ho)
    same = [torch.equal(a, b) for a, b in zip(
        (o, lse, *fc.flash_chunk_bwd(q, k, v, do, lse, delta, **kw)),
        (ho, hlse, *fh.flash_heads_bwd(q, k, v, do, hlse, delta, **kw)))]
    if not all(same):
        raise AssertionError(f"chunk at offsets 0 vs heads kernel: equal "
                             f"o, lse, dq, dk, dv {same}")
    print(f"chunk flash at offsets 0 (bf16, rate {GROUP_RATE}, T={XTL}): o, "
          f"lse, dq, dk, dv bit for bit the heads kernel's (one dropout "
          f"mask)")
    times = {hop[0]: time_chunk(hop, flush) for hop in CHUNK_HOPS[:2]}
    rows = []
    for which, err in (("fwd", "o"), ("bwd", "d")):
        rr = {name: rates(t[which], t["ops_" + which],
                          t["library_" + which])
              for name, t in times.items()}
        for name, t in times.items():
            print(f"chunk flash {which} timing ({name} hop, bf16, B={XB}, "
                  f"H={XH}, Tq=Tk={XTL}, D={XC // XH}, dropout 0): kernel "
                  f"{t[which]:.4f} ms, plain {t['plain_' + which]:.3f} ms, "
                  f"sdpa with the hop's mask ({t['backend']}) "
                  f"{t['library_' + which]:.4f} ms, bound "
                  f"{t['bound_' + which]:.4f} ms "
                  f"({t['bound_by_' + which]}); {rates_text(rr[name])}")
        t, d = times["visible"], times["diagonal"]
        rows.append({**rr["visible"],
            "name": f"flash_chunk_{which}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": CHUNK_REPLACES[which],
            "also_replaces": CHUNK_ALSO_REPLACES[which],
            "shapes": f"B={XB}, H={XH}, Tq=Tk={XTL}, D={XC // XH}, bf16, "
                      f"dropout 0, fully visible hop",
            "max_abs_err": errs[(torch.bfloat16, 0.0, "visible")][err],
            "ms": t[which], "kernel_ms": t[which],
            "plain_ms": t["plain_" + which], "bound_ms": t["bound_" + which],
            "bound_by": t["bound_by_" + which],
            "library_ms": t["library_" + which],
            "library": f"sdpa {t['backend']} (boolean mask)",
            "diagonal_hop": {"ms": d[which], "plain_ms": d["plain_" + which],
                             "library_ms": d["library_" + which],
                             "bound_ms": d["bound_" + which],
                             **rr["diagonal"]}})
    return rows


def ring_parity_phase() -> None:
    """5 f32 steps at GPT-2 XL width (2 layers, T=1024, B=2, remat on)
    through the ring over 4 shards in one process and through the dense
    heads kernel route, from the same seeds and batches; then the ring's
    output and gradients against the heads kernel's."""
    base = get_config("gpt2-xl")
    mcfg = dataclasses.replace(base.model, n_layer=2, dtype="float32")
    tcfg = dataclasses.replace(base.train, batch_size=2, max_iters=5)
    tokens = np.random.default_rng(7).integers(0, 1024, 64 * GT)
    group = LocalSeqGroup(SP)
    curves = []
    for ring in (True, False):
        fc.flash_chunk_fwd.launches = fh.flash_heads_fwd.launches = 0
        state = create_train_state(mcfg, tcfg, "cuda")
        step = make_train_step(mcfg, tcfg,
                               make_ring_attention_fn(group) if ring
                               else None, group if ring else None)
        batcher = RandomBatcher(tokens, tcfg.batch_size, GT, seed=tcfg.seed)
        losses = [step(state, tuple(torch.from_numpy(a).cuda()
                                    for a in batcher.next_batch()))
                  for _ in range(tcfg.max_iters)]
        curves.append([float(x) for x in losses])
        want = (2 * 2 * RING_HOPS * tcfg.max_iters, 0) if ring \
            else (0, 2 * 2 * tcfg.max_iters)
        got = (fc.flash_chunk_fwd.launches, fh.flash_heads_fwd.launches)
        if got != want:
            raise AssertionError(f"ring parity launches (chunk, heads) {got},"
                                 f" want {want}")
        del state, step
    rel = max(abs(a - b) / abs(b) for a, b in zip(*curves))
    if not rel <= 1e-4:
        raise AssertionError(f"ring parity: ring {curves[0]} vs heads "
                             f"{curves[1]}")
    q, k, v, do = heads_inputs(torch.float32, (2, XH, GT, XC // XH), seed=3)
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*x, group=group)
    out.backward(do)
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fh.flash_heads_attention(*y)
    ref.backward(do)
    torch.cuda.synchronize()
    o_err = (out - ref).abs().max().item()
    g_err = max((a.grad - b.grad).abs().max().item() for a, b in zip(x, y))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
    print(f"ring parity (f32, 2 layers, C={XC}, H={XH}, T={GT}, B=2, remat "
          f"full, {SP} shards in one process): 5 losses {curves[0][0]:.6f} "
          f"-> {curves[0][-1]:.6f}, max relative difference ring vs heads "
          f"route {rel:.2e} (limit 1e-4); attention alone (B=2, H={XH}, "
          f"T={GT}): ring vs heads kernel max abs err o {o_err:.3e}, "
          f"d(q, k, v) {g_err:.3e} (limit 1e-4)")


def sp_xl_slice_phase(card: str) -> tuple:
    """The sequence-parallel GPT-2 XL main path: ``train --preset gpt2-xl
    --sp 4`` through the CLI in one process, the XL slice's batches,
    steps and evals; the ring's chunk kernel only."""
    L, steps, eval_iters, n_evals = (get_config("gpt2-xl").model.n_layer,
                                     XL_STEPS, XL_EVAL_ITERS, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    text, events, packed, heads, (fwd, bwd) = run_train_cli(
        ["--preset", "gpt2-xl", "--sp", str(SP), "--batch-size", str(XB),
         "--grad-accum-steps", str(XACC), "--max-iters", str(steps),
         "--eval-interval", str(steps), "--eval-iters", str(eval_iters),
         "--log-interval", "1"])
    peak = torch.cuda.max_memory_allocated()
    print(text, end="")
    want_line = (f"sequence parallelism: seq axis {SP}, impl 'ring' "
                 f"(configured 'auto'), one process holding all {SP} shards")
    if want_line not in text:
        raise AssertionError(f"sp slice: no line {want_line!r}")
    evals = [e for e in events if e["event"] == "eval"]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    losses += [e[k] for e in evals for k in ("train_loss", "val_loss")]
    assert len(losses) == steps + 2 * n_evals, losses
    assert all(math.isfinite(x) for x in losses), losses
    assert [e["step"] for e in evals] == [0, steps], evals
    first, last = evals[0]["val_loss"], evals[-1]["val_loss"]
    if not last < first:
        raise AssertionError(f"sp slice: val loss {first} at step 0, {last} "
                             f"at step {steps}")
    want = (L * RING_HOPS * (2 * steps * XACC + n_evals * 2 * eval_iters),
            L * RING_HOPS * steps * XACC)
    if (fwd, bwd, *packed, *heads) != (*want, 0, 0, 0, 0):
        raise AssertionError(f"sp slice launches: chunk {fwd} / {bwd} (want "
                             f"{want[0]} / {want[1]}), packed {packed}, "
                             f"heads {heads} (want 0)")
    if not peak < 80e9:
        raise AssertionError(f"sp slice: peak memory {peak} bytes")
    info = {k: v for e in events if e["event"] == "info" for k, v in e.items()}
    print(f"gpt2-xl --sp {SP} slice ({steps} steps, {XACC} x B={XB}, T={GT} "
          f"in {SP} shards of {XTL}, bf16, remat full, one process) on "
          f"{card}: {info['tokens_per_sec']:.0f} tok/s, train step p50 "
          f"{info['p50_ms']:.3f} ms (mean {info['mean_ms']:.3f}), val loss "
          f"{last:.4f} at step {steps} (step 0: {first:.4f}), peak memory "
          f"allocated {peak / 1e9:.3f} GB, {fwd} forward / {bwd} backward "
          f"chunk kernel launches ({L} x {RING_HOPS} x (2 x {steps} x {XACC} "
          f"+ {n_evals * 2 * eval_iters}) and {L} x {RING_HOPS} x {steps} x "
          f"{XACC}), heads and packed kernel launches 0")
    return fwd, bwd


# --------------------------------------------------------------------------
# decode windows and mixed prefill+decode windows (the windowed serving
# slice): row #1 at the mixed window's widths, then the engine
# --------------------------------------------------------------------------

WIDE_W = (2, 5, 8, MIXED_W)


def wide_inputs(W: int, dtype: torch.dtype, kv: str, gran: str):
    """``paged_inputs`` at width W with slot 0 (pos 0, inactive in the
    engine's terms) holding the longest slot's table: pages another slot
    owns, which it must not read. A quantized pool's pages come from the
    f32 draw, its fresh rows fake-quantized. Returns (args, kw)."""
    q, kn, vn, kp, vp, tables, pos = paged_inputs(W, torch.float32)
    tables = tables.clone()
    tables[0] = tables[-1]
    kw = {"n_head": H}
    if kv == "none":
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        (kp, ks), (vp, vs) = (quantize_rows(t, kv, H, gran)
                              for t in (kp, vp))
        kn, vn = (fake_quantize_rows(t, kv, H, gran) for t in (kn, vn))
        kw.update(k_scales=ks, v_scales=vs)
    return (q.to(dtype), kn.to(dtype), vn.to(dtype), kp, vp, tables,
            pos), kw


def wide_window_phase(flush: torch.Tensor) -> dict:
    """Row #1 at W in {2, 5, 8, 64} (64: the mixed window of the 124M
    slice, 16 passes of 4 rows over each history) against its plain
    version, every pool, bf16 and f32, the split sized from the longest
    pos (the engine's bound); then at W=64, bf16: the kernel's time, the
    plain version's, SDPA over the same K/V gathered dense with the same
    mask, the bound and the rate."""
    errs = {}
    for W in WIDE_W:
        for kv, gran in POOLS:
            for dtype in (torch.float32, torch.bfloat16):
                args, kw = wide_inputs(W, dtype, kv, gran)
                got = pa.paged_window_attention(*args, **kw,
                                                max_pos=max(POS))
                again = pa.paged_window_attention(*args, **kw,
                                                  max_pos=max(POS))
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                ref = pa.paged_window_attention_ref(*args, **kw)
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=TOL[dtype], rtol=TOL[dtype])
                errs[f"{W}/{pool_label(kv, gran)}/{str(dtype)[6:]}"] = (
                    got.float() - ref.float()).abs().max().item()
        worst = {dt: max(v for k, v in errs.items()
                         if k.startswith(f"{W}/") and k.endswith(dt))
                 for dt in ("bfloat16", "float32")}
        print(f"wide window check: W={W}, {len(POOLS)} pools x bf16/f32, "
              f"max_abs_err bf16 {worst['bfloat16']:.3e} (2e-2), f32 "
              f"{worst['float32']:.3e} (1e-4)")
    args, kw = wide_inputs(MIXED_W, torch.bfloat16, "none", "page")
    sq, sk, sv, mask = sdpa_inputs(args, MIXED_W)

    def kernel():
        return pa.paged_window_attention(*args, **kw, max_pos=max(POS))

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)

    settle(kernel, sdpa)
    ms_a, lib_a, lib_b, ms_b = (time_ms(f, flush)
                                for f in (kernel, sdpa, sdpa, kernel))
    ms, library_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
    plain_ms = time_ms(lambda: pa.paged_window_attention_ref(*args, **kw),
                       flush)
    b_ms, b_by = bound_ms(args, MIXED_W)
    rate = gbps(paged_bytes(args, MIXED_W), ms)
    ranks = pa.cluster_ranks(MIXED_W, C // H, MP, PSZ, 2, False, max(POS))
    print(f"wide window timing (bf16, W={MIXED_W}, B={B}, pos {POS}): "
          f"kernel {ms * 1e3:.1f} us ({ms_a * 1e3:.1f} / {ms_b * 1e3:.1f}; "
          f"{rate:.0f} GB/s of the bound's bytes), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us "
          f"({lib_a * 1e3:.1f} / {lib_b * 1e3:.1f}), bound "
          f"{b_ms * 1e3:.2f} us ({b_by}); kernel / sdpa "
          f"{ms / library_ms:.2f}; split: clusters of {ranks} CTAs, "
          f"{pa.tile_rows(MIXED_W, C // H, MP, 2)}-row tiles, "
          f"{-(-MIXED_W // 4)} passes")
    return {"w64_ms": ms, "w64_plain_ms": plain_ms, "w64_bound_ms": b_ms,
            "w64_bound_by": b_by, "w64_library_ms": library_ms,
            "w64_gbps": rate, "w64_vs_library": ms / library_ms,
            "wide_max_abs_err": max(v for k, v in errs.items()
                                    if k.endswith("bfloat16"))}


@contextlib.contextmanager
def bounded_windows():
    """Hold every window step's host bound (``max_pos``, which sizes the
    kernels' split) to the card's positions: read them back (a sync, in
    this check only) and fail if a bound is below one."""
    seen = []
    fns = {n: getattr(gpt, n) for n in ("decode_step_paged",
                                        "verify_step_paged")}

    def wrap(fn, at):
        def wrapped(*a, max_pos=None, **kw):
            if max_pos is not None:
                pos = torch.where(a[at], a[2], 0)
                assert max_pos >= int(pos.max()), (max_pos, pos.tolist())
                seen.append(max_pos)
            return fn(*a, max_pos=max_pos, **kw)
        return wrapped
    gpt.decode_step_paged = wrap(fns["decode_step_paged"], 3)
    gpt.verify_step_paged = wrap(fns["verify_step_paged"], 4)
    try:
        yield seen
    finally:
        for n, fn in fns.items():
            setattr(gpt, n, fn)


def window_streams(model, mcfg, ecfg, trace, eos, cancel) -> tuple:
    """Drive an engine over ``trace`` (arrival step, request): submit
    each request at its step, ``eos`` ids by request, cancel request
    ``cancel[1]`` at step ``cancel[0]``. Returns (results by id, the
    engine, its launches of row #1 by W and of row #2)."""
    eng = Engine(model, mcfg, ecfg, device="cuda")
    by_w0 = dict(pa.paged_window_attention.launches_by_window)
    fused0 = dec.fused_paged_decode_layers.launches
    out, step = {}, 0
    while step <= max(a for a, _ in trace) or not eng.idle:
        for at, req in trace:
            if at == step:
                assert eng.submit(dataclasses.replace(
                    req, eos_token_id=eos.get(req.id))) is None
        if step == cancel[0]:
            assert eng.cancel(cancel[1])
        out.update({r.id: r for r in eng.step()})
        step += 1
    by_w = {w: n - by_w0.get(w, 0) for w, n in
            pa.paged_window_attention.launches_by_window.items()
            if n > by_w0.get(w, 0)}
    return out, eng, by_w, dec.fused_paged_decode_layers.launches - fused0


def window_parity_phase() -> None:
    """f32 greedy streams through the windowed engine (k = 8, and
    auto-tuned up to 8) equal the blocked engine's (k = 1), on the
    kernel route and the gather route at GPT-2 124M width cut to 2
    layers, then on char-gpt's fused route (row #2 in the decode
    windows, row #1 at W=64 in the mixed ones): requests arriving while
    windows fly, one request whose eos lands inside a window, one cancel
    (its stream a prefix of the blocked one's); every window step's
    bound at or above the card's positions; no window break."""
    for preset, routes in (("gpt2-small", ("kernel", "gather")),
                           ("char-gpt", ("fused",))):
        mcfg = dataclasses.replace(get_config(preset).model, n_layer=2,
                                   dtype="float32",
                                   decode_cache_layout="packed")
        model = init_params(mcfg, torch.Generator(device="cuda")
                            .manual_seed(0), device="cuda")
        trace = make_trace(mcfg, ReplayConfig(
            n_requests=10, seed=1, prompt_len_max=200,
            prompt_mode="shared_prefix", max_new_tokens=40, greedy=True))
        arrive = [(0 if i < 4 else 2 if i < 7 else 5, r)
                  for i, (_, r) in enumerate(trace)]
        for route in routes:
            def ecfg(k, auto=False):
                return EngineConfig(pool_size=8, page_size=16,
                                    paged_kernel=route != "gather",
                                    decode_window=k, decode_window_auto=auto)
            with forced_fused_route() if route == "fused" \
                    else contextlib.nullcontext():
                base, eng, _, _ = window_streams(model, mcfg, ecfg(1),
                                                 arrive, {}, (-1, None))
                assert eng.kernel_route.decode == route, eng.kernel_route
                # an eos for the first request (not the cancelled one)
                # whose greedy stream has a token first seen at 2..39
                eos_id, eos_i = next(
                    (rid, i) for rid in sorted(base) if rid != "r0002"
                    for i in range(2, len(base[rid].tokens))
                    if base[rid].tokens[i] not in base[rid].tokens[:i])
                eos = {eos_id: base[eos_id].tokens[eos_i]}
                runs = {}
                with bounded_windows() as seen:
                    for k, auto in ((8, False), (8, True)):
                        runs[(k, auto)] = window_streams(
                            model, mcfg, ecfg(k, auto), arrive, eos,
                            (4, "r0002"))
                assert seen
            for (k, auto), (res, eng, by_w, fused) in runs.items():
                for rid, r in res.items():
                    want = base[rid].tokens
                    if rid == eos_id:
                        assert r.finish_reason == "eos", r.finish_reason
                        want = want[:eos_i + 1]
                    if rid == "r0002":
                        assert r.finish_reason == "cancelled"
                        assert r.tokens == want[:len(r.tokens)]
                        continue
                    assert r.tokens == want, (route, k, auto, rid)
                s = eng.metrics_summary()
                dp = s["dispatch"]
                assert not any(s["window_breaks"].values())
                assert dp["mixed_windows"] > 0 and dp["decode_windows"] > 0
                if route == "gather":
                    assert not by_w and not fused
                else:
                    assert by_w.get(MIXED_W) == 2 * dp["mixed_window_steps"]
                    dec_w = (fused if route == "fused"
                             else by_w.get(1, 0) // 2)
                    assert dec_w == dp["decode_window_steps"], (by_w, dp)
                n = sum(len(r.tokens) for r in res.values())
                print(f"window parity ({preset} width, 2 layers, f32, "
                      f"{route} route, k={k}{' auto' if auto else ''}): "
                      f"{len(res)} streams, {n} tokens equal k=1 (eos at "
                      f"token {eos_i} of {eos_id}, r0002 cancelled after "
                      f"{len(res['r0002'].tokens)}), "
                      f"{dp['decode_windows']} decode + "
                      f"{dp['mixed_windows']} mixed windows, row #1 "
                      f"launches by W {by_w}, row #2 {fused}")


def window_sync_phase() -> None:
    """A windowed engine's launch reads nothing back: one steady decode
    window and one mixed window after an admission, each under
    ``torch.cuda.set_sync_debug_mode("error")`` (GPT-2 124M width, 2
    layers, bf16, kernel route, one sampled slot)."""
    mcfg = dataclasses.replace(get_config("gpt2-small").model, n_layer=2,
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    eng = Engine(model, mcfg, EngineConfig(pool_size=8, page_size=16,
                                           paged_kernel=True,
                                           decode_window=8), device="cuda")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=3, seed=3, prompt_len_max=200, max_new_tokens=64,
        top_k=50, temperature=0.8))
    for _, req in trace[:2]:
        assert eng.submit(dataclasses.replace(
            req, sampling=dataclasses.replace(req.sampling, greedy=False))
        ) is None
    for _ in range(3):
        eng.step()
    assert eng._inflight is not None and not eng._pf_left.any()
    kinds = []
    for admit in (False, True):
        if admit:
            assert eng.submit(trace[2][1]) is None
            eng._admit_queue(eng.clock(), [], eng._admit_windowed)
            assert eng._pf_left.any()
        mixed0 = eng.metrics.counters.get("mixed_windows", 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w = eng._launch(eng._window_cur)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        kinds.append("mixed" if eng.metrics.counters.get(
            "mixed_windows", 0) > mixed0 else "decode")
        eng._drain_pending()
        eng._inflight = w
    res = eng.drain()
    assert kinds == ["decode", "mixed"] and len(res) == 3
    print("window sync check: a steady decode window and a mixed window "
          "after an admission launched under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")


def window_slice_phase(card: str, k1: dict) -> tuple:
    """The windowed serving slice (this slice's main path): ``serve-replay
    --preset gpt2-small --decode-cache-layout packed --paged-kernel
    --decode-window 8 --decode-window-auto`` through the CLI at full
    width and depth, bf16, the k = 1 slice's 16 greedy requests; its
    numbers beside the k = 1 slice's. Returns (row #1 launches by W, the
    summary)."""
    pa.paged_window_attention.launches = 0
    pa.paged_window_attention.launches_by_window = {}
    s = replay(["--n-requests", "16", "--greedy", "--decode-window", "8",
                "--decode-window-auto"])
    by_w = dict(pa.paged_window_attention.launches_by_window)
    assert by_w.get(1) and by_w.get(MIXED_W), by_w
    for name, x in (("k=1", k1), ("k=8 auto", s)):
        h, dp = x["histograms"], x["dispatch"]
        per_tok = (x["step_latency"]["p50_s"] * 1e3
                   / max(dp["window_k"], 1))
        print(f"serving slice {name} on {card}: "
              f"{x['aggregate_tokens_per_s']} tok/s, TTFT p50 "
              f"{h['ttft_s']['p50'] * 1e3:.2f} ms / p99 "
              f"{h['ttft_s']['p99'] * 1e3:.2f} ms, step p50 "
              f"{x['step_latency']['p50_s'] * 1e3:.3f} ms (~{per_tok:.3f} "
              f"ms a token step; window k={dp['window_k']}), "
              f"{dp['dispatches']} dispatches, host "
              f"{dp['host_dispatch_ms_per_token']:.4f} ms/token, window "
              f"breaks {sum(x['window_breaks'].values())}, row #1 "
              f"launches by W {x['kernel_launches_by_window']}")
    return by_w, s


def window_idle_phase(card: str) -> None:
    """The device's idle share at k = 1 and k = 8: GPT-2 124M, bf16,
    kernel route, 8 slots all decoding (``tools/torch_port_profile.py``'s
    filled engine and measure: the union of kernel intervals in a
    ``torch.profiler`` trace over the traced wall), 16 engine steps of
    each, k = 1 first and last."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_profile", "tools/torch_port_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    mcfg = dataclasses.replace(get_config("gpt2-small").model,
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    engines = {k: prof.filled_engine(model, mcfg, True, "none", window=k)
               for k in (1, 8)}
    for eng in engines.values():
        eng.step()
    for k in (1, 8, 1):
        m = prof.measure(engines[k], 16, card)
        print(f"idle share (k={k}): step wall {m['step_wall_ms']} ms "
              f"({m['step_wall_ms_per_token_step']} ms a token step), "
              f"traced {m['traced_step_wall_ms']} ms, device busy "
              f"{m['device_busy_ms_per_step']} ms a step, idle share "
              f"{m['device_idle_share']}, {m['kernels_per_step']} kernels "
              f"a step")


# ------------------------------------------------------------ speculative


def spec_streams(model, mcfg, ecfg, trace, drafter=None, rcfg=None,
                 plan=None) -> tuple:
    """Drain ``trace`` (submitted at once) through an engine with
    ``drafter`` and ``rcfg``, under the fault ``plan`` if one is given.
    Returns (results by id, the engine, row #1's launches by W)."""
    eng = Engine(model, mcfg, ecfg, device="cuda", drafter=drafter,
                 rcfg=rcfg)
    by_w0 = dict(pa.paged_window_attention.launches_by_window)
    for _, req in trace:
        assert eng.submit(req) is None
    with faults.installed(plan) if plan else contextlib.nullcontext():
        res = {r.id: r for r in eng.drain()}
    by_w = {w: n - by_w0.get(w, 0) for w, n in
            pa.paged_window_attention.launches_by_window.items()
            if n > by_w0.get(w, 0)}
    return res, eng, by_w


def first_difference(a: dict, b: dict, what: str) -> None:
    for rid in sorted(b):
        if a[rid] != b[rid]:
            i = next((j for j, (x, y) in enumerate(zip(a[rid], b[rid]))
                      if x != y), min(len(a[rid]), len(b[rid])))
            raise AssertionError(f"{what}: {rid} differs at token {i}")


def spec_model(n_layer: int, dtype: str):
    mcfg = dataclasses.replace(get_config("gpt2-small").model,
                               n_layer=n_layer, dtype=dtype,
                               decode_cache_layout="packed")
    return mcfg, init_params(mcfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")


def spec_parity_phase() -> None:
    """f32 greedy streams of GPT-2 124M width cut to 2 layers, repeat-mode
    prompts: the speculative engine (n-gram drafter, and a model drafter
    with the target's weights; k = 4) on the kernel route and on the
    gather route equals the plain engine on the kernel route, token for
    token; on the kernel route row #1 runs at W = 5, 2 launches (layers)
    a verify step and nothing else; the model drafter accepts >= 0.99 of
    its drafts."""
    mcfg, model = spec_model(2, "float32")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=8, seed=2, prompt_len_max=200, prompt_mode="repeat",
        max_new_tokens=40, greedy=True))

    def ecfg(kernel):
        return EngineConfig(pool_size=8, page_size=16, paged_kernel=kernel)

    base, eng, _ = spec_streams(model, mcfg, ecfg(True), trace)
    assert eng.kernel_route.decode == "kernel", eng.kernel_route
    want = {rid: r.tokens for rid, r in base.items()}
    for kind in ("ngram", "model"):
        for kernel in (True, False):
            drafter = (NGramDrafter(SPEC_K) if kind == "ngram" else
                       ModelDrafter(model, mcfg, SPEC_K, 8, device="cuda"))
            res, eng, by_w = spec_streams(model, mcfg, ecfg(kernel), trace,
                                          drafter)
            route = "kernel" if kernel else "gather"
            assert eng.kernel_route.verify == route, eng.kernel_route
            first_difference({rid: r.tokens for rid, r in res.items()},
                             want, f"spec parity ({kind}, {route})")
            sp = eng.metrics_summary()["speculative"]
            assert by_w == ({SPEC_W: 2 * sp["verify_steps"]} if kernel
                            else {}), (by_w, sp["verify_steps"])
            if kind == "model":
                assert sp["accept_rate"] >= 0.99, sp
            n = sum(len(r.tokens) for r in res.values())
            print(f"spec parity ({kind} drafter, k={SPEC_K}, {route} route, "
                  f"GPT-2 width, 2 layers, f32): {len(res)} greedy streams, "
                  f"{n} tokens equal the plain kernel route's; accept rate "
                  f"{sp['accept_rate']}, {sp['mean_tokens_per_step']} "
                  f"tokens/slot-step over {sp['verify_steps']} verify "
                  f"steps, row #1 launches by W {by_w}")


def spec_replay(extra) -> tuple:
    """``serve-replay --preset gpt2-small --decode-cache-layout packed
    --paged-kernel`` with ``extra`` at full width and depth, bf16, with
    row #1's counts set to 0 just before it and read just after. Every
    request completes with tokens in the vocabulary; with a drafter, row
    #1 runs 12 times a verify step of the replay at W = 5 and at no other
    W, and the warm-up adds one verify step (W = 5) and one plain decode
    step (W = 1; ``run_replay`` warms the path an auto-disable would
    take). Returns (the summary, row #1's launches by W)."""
    argv = ["serve-replay", "--preset", "gpt2-small",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--rate", "1000", "--pool-size", "8", "--page-size", "16",
            "--prompt-mode", "repeat", "--prompt-len-max", "256",
            "--request-max-new-tokens", "64", "--json", *extra]
    pa.paged_window_attention.launches = 0
    pa.paged_window_attention.launches_by_window = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    by_w = dict(pa.paged_window_attention.launches_by_window)
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines[:-1]))
    s = json.loads(lines[-1])
    mcfg = get_config("gpt2-small").model
    assert s["n_completed"] == s["n_requests"], s["n_completed"]
    toks = [t for st in s["streams"].values() for t in st]
    assert toks and all(0 <= t < mcfg.vocab_size for t in toks)
    sp = s.get("speculative")
    if sp:
        L = mcfg.n_layer
        assert s["kernel_route"]["verify"] == "kernel", s["kernel_route"]
        assert sp["verify_steps"] == s["n_steps"] > 0
        assert s["kernel_launches_by_window"] == {
            str(SPEC_W): L * sp["verify_steps"]}, (
            s["kernel_launches_by_window"], sp["verify_steps"])
        assert by_w == {SPEC_W: L * (sp["verify_steps"] + 1), 1: L}, (
            by_w, sp["verify_steps"])
    return s, by_w


def spec_line(name: str, s: dict, card: str) -> None:
    h, sp = s["histograms"], s.get("speculative")
    spec = (f"accept rate {sp['accept_rate']}, "
            f"{sp['mean_tokens_per_step']} tokens/slot-step, draft "
            f"overhead p50 {sp['draft_overhead_s']['p50'] * 1e3:.3f} ms, "
            if sp else "")
    print(f"spec slice {name} on {card}: {spec}"
          f"{s['aggregate_tokens_per_s']} tok/s, TTFT p50 "
          f"{h['ttft_s']['p50'] * 1e3:.2f} ms, step p50 "
          f"{s['step_latency']['p50_s'] * 1e3:.3f} ms over {s['n_steps']} "
          f"steps, row #1 launches by W {s['kernel_launches_by_window']}")


def spec_slice_phase(card: str) -> dict:
    """The speculative serving slice (this slice's main path): GPT-2 124M
    at full width and depth, bf16, random init, the kernel route:
    ``--spec ngram --spec-k 4 --prompt-mode repeat --greedy`` (16
    requests), the same trace without a drafter (the same call's plain
    tokens/s), and ``--spec model --draft-model char-gpt --spec-k 4``
    (8 sampled requests). Returns row #1's launches by W of each
    speculative run."""
    ngram, by_ngram = spec_replay(["--n-requests", "16", "--greedy",
                                   "--spec", "ngram", "--spec-k",
                                   str(SPEC_K)])
    plain, _ = spec_replay(["--n-requests", "16", "--greedy"])
    model, by_model = spec_replay(["--n-requests", "8", "--spec", "model",
                                   "--draft-model", "char-gpt", "--spec-k",
                                   str(SPEC_K), "--top-k", "50",
                                   "--temperature", "0.8"])
    for name, s in (("ngram greedy", ngram), ("plain greedy", plain),
                    ("model sampled", model)):
        spec_line(name, s, card)
    ratio = (ngram["aggregate_tokens_per_s"]
             / plain["aggregate_tokens_per_s"])
    print(f"spec slice: ngram / plain tokens/s on the same trace "
          f"{ratio:.3f}")
    return {"ngram": {str(w): n for w, n in by_ngram.items()},
            "model": {str(w): n for w, n in by_model.items()}}


def spec_resilience_phase(card: str) -> None:
    """The accept-collapse fault on the card (GPT-2 124M width, 2 layers,
    f32, a model drafter with the target's weights, k = 4): the
    ``spec/draft`` seam garbles the first 3 drafts, the engine disables
    speculation once, re-probes once and finds the drafter healthy, and
    the greedy streams equal the plain engine's."""
    mcfg, model = spec_model(2, "float32")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=4, seed=3, prompt_len_max=120, prompt_mode="repeat",
        max_new_tokens=48, greedy=True))
    ecfg = EngineConfig(pool_size=8, page_size=16, paged_kernel=True)
    base, _, _ = spec_streams(model, mcfg, ecfg, trace)
    rcfg = faults.ResilienceConfig(spec_disable_threshold=0.4, spec_window=3,
                                   spec_reprobe_after=4)
    plan = faults.FaultPlan(faults.Fault(site="spec/draft", kind="collapse",
                                         times=3))
    res, eng, by_w = spec_streams(
        model, mcfg, ecfg, trace,
        ModelDrafter(model, mcfg, SPEC_K, 8, device="cuda"), rcfg, plan)
    rec = eng.metrics_summary()["recovery"]
    first_difference({rid: r.tokens for rid, r in res.items()},
                     {rid: r.tokens for rid, r in base.items()},
                     "spec resilience")
    assert (rec["spec_disables"], rec["spec_reprobes"]) == (1, 1), rec
    assert eng.spec_active and by_w.get(1) and by_w.get(SPEC_W), by_w
    print(f"spec resilience on {card}: collapse fault -> "
          f"{rec['spec_disables']} disable, {rec['spec_reprobes']} "
          f"re-probe, speculation active again; streams equal the plain "
          f"engine's; row #1 launches by W {by_w} (W=1: the degraded "
          f"decode steps); events {rec['events']}")


# the checkpoint slice: GPT-2 124M (the preset's bf16, T=1024, B=32) and
# char-gpt (dropout 0.2) trained 6 steps with a checkpoint every 3, and a
# run stopped at step 3 and resumed into a fresh state
CKPT_STEPS, CKPT_EVERY, CKPT_STOP = 6, 3, 3


def ckpt_config(preset: str):
    cfg = get_config(preset)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_iters=CKPT_STEPS, eval_interval=0, eval_iters=1,
        log_interval=1, checkpoint_every=CKPT_EVERY))


def ckpt_train(cfg, ck=None, stop_at=None, resume=False) -> tuple:
    """``train()`` on the card: (result, {step: loss}, its log). With
    ``stop_at``, a SIGTERM raised through the ``train/step`` seam at that
    step reaches a handler that sets the stop event, as the CLI's does."""
    import signal
    import threading
    from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, installed
    from replicatinggpt_tpu_torch.train.runner import train
    from replicatinggpt_tpu_torch.utils.logging import StepLogger
    out = io.StringIO()
    stop = threading.Event()
    plan = FaultPlan(*([] if stop_at is None else
                       [Fault(site="train/step", kind="sigterm",
                              at=stop_at)]))
    prev = signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    try:
        with installed(plan):
            res = train(cfg, device="cuda", logger=StepLogger(stream=out),
                        checkpoint_manager=ck, resume=resume,
                        stop_event=stop)
    finally:
        signal.signal(signal.SIGTERM, prev)
    losses = {int(i): float(x) for i, x in re.findall(
        r"^Step (\d+), Loss: (\S+) \|", out.getvalue(), re.M)}
    assert losses and all(math.isfinite(x) for x in losses.values())
    return res, losses, out.getvalue()


def io_line(what: str, t: dict, card: str) -> None:
    gb = t["bytes"] / 1e9
    move = {k: v for k, v in t.items() if k not in ("bytes", "total_s")}
    print(f"checkpoint {what} ({gb:.3f} GB) on {card}: {t['total_s']:.3f} s, "
          f"{gb / t['total_s']:.3f} GB/s with the crc32 pass; crc32 alone "
          f"{t['crc_s']:.3f} s ({gb / t['crc_s']:.3f} GB/s); by phase "
          + ", ".join(f"{k} {v:.3f}" for k, v in move.items()))


def resume_phase(preset: str, root: str, card: str) -> dict:
    """Train ``preset`` 6 steps uninterrupted, then stopped at step 3 and
    resumed into a fresh state and model from its checkpoint: the losses
    of steps 3-5, the weights, AdamW's moments and count and both dropout
    streams equal bit for bit. Returns the flash launches (forward,
    backward) of the three runs, the checkpoint directory and timings."""
    from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
    from replicatinggpt_tpu_torch.train.state import weights_state
    cfg = ckpt_config(preset)
    ck_dir = os.path.join(root, preset)
    fp.flash_packed_fwd.launches = fp.flash_packed_bwd.launches = 0
    full, want, _ = ckpt_train(cfg)
    ck = CheckpointManager(ck_dir)
    stopped, head, log = ckpt_train(cfg, ck, stop_at=CKPT_STOP)
    assert f"stop requested at step {CKPT_STOP}" in log, log
    assert stopped.state.step == CKPT_STOP and ck.all_steps() == [CKPT_STOP]
    save = dict(ck.timings["save"])
    del stopped
    ck = CheckpointManager(ck_dir)
    resumed, tail, log = ckpt_train(cfg, ck, resume=True)
    launches = (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches)
    assert f"resumed from step {CKPT_STOP}" in log, log
    restore = dict(ck.timings["restore"])
    assert head == {i: want[i] for i in range(CKPT_STOP)}, (head, want)
    assert tail == {i: want[i] for i in range(CKPT_STOP, CKPT_STEPS)}, (
        tail, want)
    a, b = full.state.state_dict(), resumed.state.state_dict()
    assert sorted(a) == sorted(b)
    bad = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    assert not bad, bad
    assert ck.all_steps() == [CKPT_STOP, CKPT_STEPS]
    n_opt = sum(1 for k in a if k.startswith("opt/"))
    mcfg = resumed.state.model.cfg
    L = mcfg.n_layer
    # 6 + 3 + 3 steps, and each run's final estimate: one batch a split
    assert launches == (L * (2 * CKPT_STEPS + 6), L * 2 * CKPT_STEPS), (
        launches)
    # the step-3 manifest verifies (a weights-only restore reads the whole
    # payload and checks every crc32 on the way)
    ck.restore(CKPT_STOP, weights_state(mcfg, 0, "cuda"))
    print(f"resume ({preset}: {mcfg.n_layer}L/{mcfg.n_head}H/"
          f"{mcfg.n_embd}C, T={mcfg.block_size}, B={cfg.train.batch_size}, "
          f"{mcfg.dtype}, dropout {mcfg.dropout}, {CKPT_STEPS} steps, "
          f"checkpoint every {CKPT_EVERY}, stopped at {CKPT_STOP}) on "
          f"{card}: losses of steps {CKPT_STOP}-{CKPT_STEPS - 1} "
          f"{[tail[i] for i in sorted(tail)]} equal the uninterrupted run's "
          f"bit for bit, and so do {len(a)} state arrays ({n_opt} of AdamW, "
          f"count {resumed.state.optimizer.count}); step {CKPT_STOP}'s "
          f"manifest verifies; {launches[0]} forward / {launches[1]} "
          f"backward flash launches over the three runs")
    io_line(f"save ({preset}, step {CKPT_STOP})", save, card)
    io_line(f"restore ({preset}, step {CKPT_STOP} onto the card)", restore,
            card)
    del full, resumed
    torch.cuda.empty_cache()
    return {"dir": ck_dir, "launches": launches, "save": save,
            "restore": restore}


def corruption_phase(ck_dir: str, root: str) -> None:
    """Flip bytes in a copy of the newest step (its older step linked
    beside it): restoring it raises CorruptCheckpointError naming it, and
    restore_latest falls back to step 3."""
    import shutil
    from replicatinggpt_tpu_torch.faults.inject import corrupt_step_dir
    from replicatinggpt_tpu_torch.train.checkpoint import (
        CheckpointManager, CorruptCheckpointError)
    from replicatinggpt_tpu_torch.train.state import weights_state
    bad_dir = os.path.join(root, "corrupted")
    os.makedirs(bad_dir)
    for name in os.listdir(ck_dir):
        src = os.path.join(ck_dir, name)
        if name == str(CKPT_STEPS):
            shutil.copytree(src, os.path.join(bad_dir, name))
        elif os.path.isdir(src):
            shutil.copytree(src, os.path.join(bad_dir, name),
                            copy_function=os.link)
        else:
            shutil.copy(src, os.path.join(bad_dir, name))
    hit = corrupt_step_dir(bad_dir, CKPT_STEPS, "corrupt",
                           np.random.default_rng(0))
    ck = CheckpointManager(bad_dir)
    mcfg = get_config("gpt2-small").model
    try:
        ck.restore(CKPT_STEPS, weights_state(mcfg, 0, "cuda"))
        raise AssertionError("a corrupted step restored")
    except CorruptCheckpointError as e:
        named = str(e)
    assert f"step {CKPT_STEPS} is corrupt" in named, named
    state = weights_state(mcfg, 0, "cuda")
    assert ck.restore_latest(state) is state and state.step == CKPT_STOP
    assert ck.recovery["ckpt_fallbacks"] == 1, ck.recovery
    print(f"corruption: 8 bytes flipped in {os.path.relpath(hit, root)}; "
          f"restore raised \"{named}\"; restore_latest fell back to step "
          f"{state.step} (ckpt_fallbacks 1)")
    shutil.rmtree(bad_dir)


def from_checkpoint_phase(ck_dir: str, char_dir: str, root: str,
                          card: str) -> dict:
    """The CLI entry points on the card from the 124M checkpoint (newest
    step 6): eval, serve-replay with the per-layer kernel, generate
    (row #4), export-torch; generate from the char-gpt checkpoint (row
    #3). Returns each path's launches."""
    from replicatinggpt_tpu_torch.serve import replay as replay_mod
    arrays = torch.load(os.path.join(ck_dir, str(CKPT_STEPS), "state.pt"),
                        map_location="cpu", weights_only=True)
    small = get_config("gpt2-small")
    V, L = small.model.vocab_size, small.model.n_layer
    out = {}
    # eval
    fp.flash_packed_fwd.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main(["eval", "--preset", "gpt2-small", "--eval-iters",
                         "2", "--checkpoint-dir", ck_dir]) == 0
    tr, va = map(float, re.fullmatch(
        r"train loss (\S+), val loss = (\S+)\n", text.getvalue()).groups())
    out["eval"] = fp.flash_packed_fwd.launches
    assert all(math.isfinite(x) and x < math.log(V) for x in (tr, va)), (
        tr, va)
    assert out["eval"] == L * 2 * 2, out["eval"]
    print(f"eval --checkpoint-dir (gpt2-small, step {CKPT_STEPS}) on "
          f"{card}: {text.getvalue().strip()} (ln {V} = "
          f"{math.log(V):.4f}), {out['eval']} forward flash launches")
    # serve-replay: the engine's weights are the checkpoint's
    made = []

    class Recording(replay_mod.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    replay_mod.Engine = Recording
    pa.paged_window_attention.launches = 0
    try:
        s = replay(["--n-requests", "8", "--greedy", "--checkpoint-dir",
                    ck_dir])
    finally:
        replay_mod.Engine = Recording.__mro__[1]
    # the replay's warm-up engine launches too: whole steps of L each
    out["serve"] = pa.paged_window_attention.launches
    assert out["serve"] >= s["kernel_launches"] == L * s["n_steps"] > 0 \
        and out["serve"] % L == 0, (out["serve"], s["n_steps"])
    cd = small.model.compute_dtype
    leaves = [k[len("params/"):] for k in arrays if k.startswith("params/")]
    for eng in made:
        tree = eng.params
        assert len(tree) - 1 + len(tree["blocks"]) == len(leaves)
        for k in leaves:
            got = (tree["blocks"][k[len("blocks/"):]]
                   if k.startswith("blocks/") else tree[k])
            want = arrays[f"params/{k}"].to(got.device,
                                            None if "ln" in k else cd)
            assert torch.equal(got, want), k
    print(f"serve-replay --checkpoint-dir (gpt2-small, step {CKPT_STEPS}, "
          f"8 greedy requests) on {card}: {s['aggregate_tokens_per_s']} "
          f"tok/s over {s['n_steps']} steps, {out['serve']} row #1 "
          f"launches; the engines' weights ({len(made)}, the warm-up's "
          f"included) equal the checkpoint's bit for bit")
    # generate through the CLI at 124M: row #4, drawing only the corpus
    # BPE's 1024 ids from the 50257 rows
    dec.packed_decode_attention.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main(["generate", "--preset", "gpt2-small",
                         "--decode-cache-layout", "packed",
                         "--checkpoint-dir", ck_dir, "--sample-tokens", "64",
                         "--top-k", "50"]) == 0
    big_sample = text.getvalue()[:-1]
    out["generate"] = dec.packed_decode_attention.launches
    # one segment of 64 steps from the one-token start
    assert out["generate"] == L * 64, out["generate"]
    assert big_sample, big_sample
    # generate through the CLI from the char-gpt checkpoint: row #3
    dec.fused_decode_layers.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main(["generate", "--preset", "char-gpt",
                         "--checkpoint-dir", char_dir, "--sample-tokens",
                         "256", "--top-k", "20"]) == 0
    sample = text.getvalue()[:-1]
    out["generate_cli"] = dec.fused_decode_layers.launches
    assert len(sample) == 256 and set(sample) <= set(
        open(CORPUS, encoding="utf-8").read()), sample
    # one segment of 256 steps fills the 256-row cache from one token
    assert out["generate_cli"] == 256, out["generate_cli"]
    print(f"generate --checkpoint-dir from the checkpoints on {card}: "
          f"gpt2-small step {CKPT_STEPS} (64 BPE tokens, packed cache, "
          f"{out['generate']} row #4 launches): {big_sample[:60]!r}...; "
          f"char-gpt step {CKPT_STEPS} (256 characters, "
          f"{out['generate_cli']} row #3 launches): {sample[:60]!r}...")
    # export-torch: the file's tensors are the checkpoint's weights as f32
    path = os.path.join(root, "model.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["export-torch", "--preset", "gpt2-small",
                         "--checkpoint-dir", ck_dir, "--out", path]) == 0
    sd = torch.load(path, weights_only=True)
    n = 0
    for name, t in sd.items():
        if name.startswith("blocks."):
            _, i, leaf = name.split(".")
            want = arrays[f"params/blocks/{leaf}"][int(i)]
        else:
            want = arrays[f"params/{name}"]
        assert t.dtype == torch.float32 and torch.equal(t, want), name
        n += t.numel()
    assert n == sum(v.numel() for k, v in arrays.items()
                    if k.startswith("params/"))
    print(f"export-torch --checkpoint-dir (gpt2-small): {len(sd)} tensors, "
          f"{n:,} f32 parameters equal to the checkpoint's")
    os.unlink(path)
    return out


def checkpoint_slice(card: str) -> dict:
    """The checkpoint main path: resume at 124M and at char-gpt with
    dropout, at PyTorch's default algorithms, corruption and fallback,
    then eval, generate, serve and export from the checkpoint. The
    directories live in a temporary one, removed at the end."""
    import shutil
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt-smoke-")
    try:
        big = resume_phase("gpt2-small", root, card)
        char = resume_phase("char-gpt", root, card)
        corruption_phase(big["dir"], root)
        launches = from_checkpoint_phase(big["dir"], char["dir"], root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the replay's engines hold their pools in reference cycles: collect
    # them so the later phases' peak memory is their own
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_124m"], launches["train_char"] = (big["launches"],
                                                      char["launches"])
    print(f"checkpoint slice: {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------------------
# data parallelism and FSDP in training: the one-process group at GPT-2
# widths (each data shard's rows through the kernels at a rank's shapes)
# --------------------------------------------------------------------------

DP = 4                     # the data slices' shards (one process)
DP_STEPS, DP_EVAL_ITERS = 20, 2
FSDP_STEPS = 3


def dp_runs(mcfg, tcfg, tokens, group, steps: int = 3) -> tuple:
    """``steps`` train steps of ``group`` (None: the plain step) on the
    sequential windows of ``tokens``: (losses, the gathered state)."""
    state = create_train_state(mcfg, tcfg, "cuda", group=group)
    step = make_train_step(mcfg, tcfg, None, group)
    batcher = SequentialBatcher(tokens, tcfg.batch_size, GT)
    losses = []
    for _ in range(steps):
        xs, ys = zip(*(batcher.next_batch()
                       for _ in range(tcfg.grad_accum_steps)))
        batch = tuple(torch.from_numpy(np.stack(a)).cuda() for a in (xs, ys))
        losses.append(float(step(state, batch)))
    return losses, state.state_dict()


def two_shard_runs(mcfg, tcfg, tokens, steps: int = 3) -> tuple:
    """What two processes of ``--dp 2`` compute, in one: each shard's
    rows with its own dropout streams (``shard_dropout_rng``) through the
    plain loss and backward, summed over the micro-batches, then the two
    shards' gradients summed in shard order and averaged, the clip and
    AdamW; (losses, the state)."""
    state = create_train_state(mcfg, tcfg, "cuda")
    rngs = [shard_dropout_rng(tcfg.seed + 1, d, 0, "cuda") for d in (0, 1)]
    batcher = SequentialBatcher(tokens, tcfg.batch_size, GT)
    A, b = tcfg.grad_accum_steps, tcfg.batch_size // 2
    params = list(state.model.parameters())
    losses = []
    for _ in range(steps):
        batches = [tuple(torch.from_numpy(a).cuda()
                         for a in batcher.next_batch()) for _ in range(A)]
        state.optimizer.zero_grad()
        shard_grads, shard_losses = [], []
        for d in (0, 1):
            total = None
            for x, y in batches:
                loss = loss_fn(state.model.tree(),
                               (x[d * b:(d + 1) * b], y[d * b:(d + 1) * b]),
                               mcfg, rng=rngs[d], train=True)
                (loss / A).backward()
                total = loss.detach() if total is None else \
                    total + loss.detach()
            shard_losses.append(total / A)
            shard_grads.append([p.grad for p in params])
            state.optimizer.zero_grad()
        for p, g0, g1 in zip(params, *shard_grads):
            p.grad = (g0 + g1) / 2
        state.optimizer.step()
        state.step += 1
        losses.append(float((shard_losses[0] + shard_losses[1]) / 2))
    return losses, state.state_dict()


def dp_parity_phase() -> None:
    """``LocalDataGroup(2)`` at GPT-2 124M width (2 layers, T=1024, f32,
    the kernel route, sequential windows), 3 steps of 2 accumulated
    micro-batches of 4 rows, clip 1.0: with and without FSDP against the
    plain step (losses to 1e-5 relative, weights and both AdamW moments
    to 1e-5); then with attention dropout 0.1 through the kernels, the
    group against two one-shard runs (``two_shard_runs``): losses, weights
    and moments bit for bit (deterministic algorithms on: the embedding's
    index backward is atomic otherwise), and with FSDP to 1e-5."""
    base = get_config("gpt2-small")
    mcfg = dataclasses.replace(base.model, n_layer=2, dtype="float32")
    tcfg = dataclasses.replace(base.train, batch_size=4, grad_accum_steps=2,
                               grad_clip=1.0, warmup_iters=1, max_iters=3)
    tokens = np.random.default_rng(11).integers(0, 1024, 64 * GT)
    names = None
    plain_l, plain = dp_runs(mcfg, tcfg, tokens, None)
    report = []
    for fsdp in (False, True):
        fp.flash_packed_fwd.launches = fp.flash_packed_bwd.launches = 0
        got_l, got = dp_runs(mcfg, tcfg, tokens, LocalDataGroup(2, fsdp=fsdp))
        want = (2 * 2 * 2 * 3, 2 * 2 * 2 * 3)     # layers x shards x A x steps
        launches = (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches)
        if launches != want:
            raise AssertionError(f"dp parity (fsdp {fsdp}): packed flash "
                                 f"launches {launches}, want {want}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got_l, plain_l))
        names = [k for k in plain if k.startswith(("params/", "opt/exp"))]
        err = max((got[k] - plain[k]).abs().max().item() for k in names)
        if not (rel <= 1e-5 and err <= 1e-5):
            raise AssertionError(f"dp parity (fsdp {fsdp}): losses {got_l} "
                                 f"vs {plain_l} (rel {rel:.2e}), weights and "
                                 f"moments max abs diff {err:.3e}")
        report.append(f"FSDP {'on' if fsdp else 'off'}: loss rel {rel:.2e}, "
                      f"weights/moments {err:.2e}")
    drop = dataclasses.replace(mcfg, attn_dropout=0.1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got_l, got = dp_runs(drop, tcfg, tokens, LocalDataGroup(2))
        want_l, want = two_shard_runs(drop, tcfg, tokens)
        fsdp_l, fsdp = dp_runs(drop, tcfg, tokens,
                               LocalDataGroup(2, fsdp=True))
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [k for k in names if not torch.equal(got[k], want[k])]
    if got_l != want_l or differ:
        raise AssertionError(f"dp dropout parity: losses {got_l} vs {want_l}"
                             f", arrays that differ {differ[:5]}")
    # FSDP draws the same masks; its clip sums the shards' squares in
    # another order, so it holds the tolerance, not the bits
    f_rel = max(abs(a - b) / abs(b) for a, b in zip(fsdp_l, got_l))
    f_err = max((fsdp[k] - got[k]).abs().max().item() for k in names)
    if not (f_rel <= 1e-5 and f_err <= 1e-5):
        raise AssertionError(f"dp dropout parity (FSDP): losses {fsdp_l} vs "
                             f"{got_l}, weights/moments {f_err:.3e}")
    print(f"dp parity (LocalDataGroup(2), f32, 2 layers, C={GC}, H={GH}, "
          f"T={GT}, 2 x B=4, clip 1.0, 3 steps, 12 + 12 packed flash "
          f"launches a step) vs the plain step: {'; '.join(report)} (limits "
          f"1e-5); attention dropout 0.1 vs two one-shard runs: 3 losses "
          f"{got_l[0]:.6f} -> {got_l[-1]:.6f} and {len(names)} weight and "
          f"moment arrays bit for bit; with FSDP loss rel {f_rel:.2e}, "
          f"weights/moments {f_err:.2e} (limits 1e-5)")


def rank_flash_phase(flush: torch.Tensor) -> dict:
    """The packed flash kernels at the DP slice's rank shapes (B=8 of the
    global 32, T=1024, C=768, H=12, bf16): checks at dropout 0 and 0.1,
    timings at 0 beside the plain versions, SDPA and the bound."""
    seed = 7_654_321
    qkv, do = flash_inputs(torch.bfloat16, shape=(GB // DP, GT, GC),
                           scale=QKV_SCALE)
    errs = {rate: check_flash(qkv, do, GH, seed, rate)
            for rate in (0.0, GROUP_RATE)}
    ms, plain, library, backend = time_flash(qkv, do, GH, seed, 0.0, flush,
                                             n=10)
    out = {}
    for which, err in (("fwd", "o"), ("bwd", "dqkv")):
        b_ms, b_by, b_ops = flash_bound_ms(qkv, GH, which)
        r = rates(ms[which], b_ops, library[which])
        print(f"flash {which} at a rank's shapes (bf16, B={GB // DP}, T={GT}, "
              f"C={GC}, H={GH}): max_abs_err "
              + ", ".join(f"rate {k} {v[err]:.3e}" for k, v in errs.items())
              + f"; kernel {ms[which]:.3f} ms, plain {plain[which]:.3f} ms, "
              f"sdpa ({backend}) {library[which]:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {rates_text(r)}")
        out[which] = {"shapes": f"B={GB // DP}, T={GT}, C={GC}, H={GH}, bf16",
                      "max_abs_err": errs[0.0][err], "ms": ms[which],
                      "plain_ms": plain[which], "library_ms": library[which],
                      "library": f"sdpa {backend}", "bound_ms": b_ms,
                      "bound_by": b_by, **r}
    return out


def dp_slice_phase(card: str, gpt2_info: dict) -> tuple:
    """The data-parallel GPT-2 124M main path: ``train --preset gpt2-small
    --dp 4 --batch-size 32`` through the CLI in one process, 20 steps,
    evals at 0 and 20 over 2 batches a split; every step 4 shards x 12
    forward and 4 x 12 backward packed flash launches at B=8."""
    L = get_config("gpt2-small").model.n_layer
    text, events, (fwd, bwd), heads, chunk = run_train_cli(
        ["--preset", "gpt2-small", "--dp", str(DP), "--batch-size", str(GB),
         "--max-iters", str(DP_STEPS), "--eval-interval", str(DP_STEPS),
         "--eval-iters", str(DP_EVAL_ITERS)])
    print(text, end="")
    line = (f"data parallelism: data axis {DP}, FSDP off, one process "
            f"holding all {DP} shards")
    if line not in text:
        raise AssertionError(f"dp slice: no line {line!r}")
    evals = [e for e in events if e["event"] == "eval"]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    losses += [e[k] for e in evals for k in ("train_loss", "val_loss")]
    assert losses and all(math.isfinite(x) for x in losses), losses
    assert [e["step"] for e in evals] == [0, DP_STEPS], evals
    want = (L * DP * (DP_STEPS + 2 * 2 * DP_EVAL_ITERS), L * DP * DP_STEPS)
    if (fwd, bwd, *heads, *chunk) != (*want, 0, 0, 0, 0):
        raise AssertionError(f"dp slice launches: packed {fwd} / {bwd} (want "
                             f"{want[0]} / {want[1]}), heads {heads}, chunk "
                             f"{chunk}")
    info = {k: v for e in events if e["event"] == "info" for k, v in e.items()}
    print(f"gpt2-small --dp {DP} slice ({DP_STEPS} steps, B={GB} as {DP} "
          f"shards of {GB // DP}, T={GT}, bf16, one process) on {card}: "
          f"{info['tokens_per_sec']:.0f} tok/s, train step p50 "
          f"{info['p50_ms']:.3f} ms (mean {info['mean_ms']:.3f}) against the "
          f"unsharded slice's {gpt2_info['tokens_per_sec']:.0f} tok/s and "
          f"{gpt2_info['p50_ms']:.3f} ms; val loss {evals[-1]['val_loss']:.4f}"
          f" at step {DP_STEPS}; {fwd} forward / {bwd} backward packed flash "
          f"launches ({L} x {DP} a step and eval batch)")
    return fwd, bwd


def fsdp_slice_phase(card: str) -> None:
    """``train --preset gpt2-medium --dp 4 --fsdp`` (350M, B=64 as 4
    shards of 16, T=1024, bf16, remat full), 3 steps in one process, and
    the same run without FSDP: peak memory and step p50 of each."""
    L = get_config("gpt2-medium").model.n_layer
    argv = ["train", "--preset", "gpt2-medium", "--dp", str(DP),
            "--max-iters", str(FSDP_STEPS), "--eval-interval", "0",
            "--eval-iters", "1", "--log-interval", "1"]
    out = {}
    for fsdp in (True, False):
        args = cli.build_parser().parse_args(
            argv + (["--fsdp"] if fsdp else []))
        cfg = config_from_args(args)
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                                fsdp=fsdp))
        log = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fp.flash_packed_fwd.launches = fp.flash_packed_bwd.launches = 0
        res = train(cfg, device="cuda", logger=StepLogger(stream=log))
        peak = torch.cuda.max_memory_allocated()
        launches = (fp.flash_packed_fwd.launches,
                    fp.flash_packed_bwd.launches)
        want = (L * DP * (2 * FSDP_STEPS + 2), L * DP * FSDP_STEPS)
        if launches != want:
            raise AssertionError(f"fsdp slice ({fsdp}): packed flash launches "
                                 f"{launches}, want {want} (remat recomputes "
                                 f"each forward)\n{log.getvalue()}")
        line = (f"data parallelism: data axis {DP}, FSDP "
                f"{'on' if fsdp else 'off'}, one process holding all {DP} "
                f"shards")
        if line not in log.getvalue():
            raise AssertionError(f"fsdp slice: no line {line!r}\n"
                                 f"{log.getvalue()}")
        if not all(math.isfinite(v) for v in res.final_eval.values()):
            raise AssertionError(f"fsdp slice: eval {res.final_eval}")
        out[fsdp] = (peak, res.step_times["p50_ms"], res.final_eval["val"])
        del res
    print(f"gpt2-medium --dp {DP} slice (350M, B=64 as {DP} shards of 16, "
          f"T={GT}, bf16, remat full, {FSDP_STEPS} steps, one process) on "
          f"{card}: --fsdp peak memory allocated {out[True][0] / 1e9:.3f} GB, "
          f"step p50 {out[True][1]:.3f} ms; without FSDP "
          f"{out[False][0] / 1e9:.3f} GB, {out[False][1]:.3f} ms (one process "
          f"holds every shard, so the sum of the four cards' shares); val "
          f"loss {out[True][2]:.4f} / {out[False][2]:.4f}")


# ------------------------------------------------------------------ fleet

#: phase 43's traffic at 124M: 24 sessions of 3 turns over 4 system
#: prefixes of 256 tokens, 16-48 user tokens and 32 new tokens a turn,
#: 8 concurrent clients; and the char-gpt fleet's, within its 256 block
FLEET_LCFG = dict(n_sessions=24, turns=3, n_prefix_groups=4, prefix_len=256,
                  user_len_min=16, user_len_max=48, max_new_tokens=32,
                  rate=1e6, seed=11)
CHAR_FLEET_LCFG = dict(n_sessions=16, turns=3, n_prefix_groups=2,
                       prefix_len=64, user_len_min=8, user_len_max=16,
                       max_new_tokens=32, rate=1e6, seed=12)
FLEET_CLIENTS = 8
#: client k sends its first request k x this after the first client's,
#: past a router step: a worker's load as the router sees it is its last
#: step reply's, so a burst between two steps would all go to one worker
FLEET_STAGGER_S = 0.1
#: phase 42's wedge: replica 0's router steps 6-7 stall 0.2 s against a
#: 0.1 s budget (a 2-layer step takes milliseconds)
FLEET_WEDGE = dict(at=6, times=2, arg=0.2, arg2=0)


def fleet_requests(mcfg) -> list:
    """Phase 42's traffic: 16 greedy and 4 sampled requests (fixed
    rng_seeds), prompts over 2 shared prefixes of 48 tokens."""
    rng = np.random.default_rng(21)
    prefixes = [rng.integers(0, mcfg.vocab_size, (48,)) for _ in range(2)]
    return [Request(
        id=f"f{i:02d}", prompt=np.concatenate(
            [prefixes[i % 2],
             rng.integers(0, mcfg.vocab_size, (int(rng.integers(4, 40)),))]),
        max_new_tokens=24, rng_seed=1000 + i,
        sampling=SamplingParams(greedy=i < 16, top_k=50, temperature=0.8))
        for i in range(20)]


def fleet_drive(router, reqs) -> dict:
    """Submit ``reqs``, step the fleet to idle reading its delivery ledger
    every step, and close it. Every request must finish by its budget, no
    id may be active on two live replicas at any step, and each id's
    delivered tokens must be its final tokens. Returns the tokens by
    id."""
    for q in reqs:
        assert router.submit(q) is None
    streams, results = {q.id: [] for q in reqs}, {}
    for _ in range(20_000):
        if router.idle:
            break
        results.update({r.id: r for r in router.step()})
        for rid in streams:
            streams[rid].extend(router.take_new_tokens(rid))
        live = [rid for rep in router.replicas if rep.alive
                for rid in rep.engine.in_flight_ids()]
        assert len(live) == len(set(live)), f"an id on two replicas: {live}"
    router.close()
    assert sorted(results) == sorted(streams), "a request never finished"
    bad = {k: r.finish_reason for k, r in results.items() if not r.ok}
    assert not bad, bad
    for rid, r in results.items():
        assert streams[rid] == list(r.tokens), f"{rid}: delivered != final"
    return {rid: list(r.tokens) for rid, r in results.items()}


def fleet_parity_phase(card: str) -> None:
    """Phase 42: GPT-2 124M width cut to 2 layers, f32, 20 requests (4
    sampled): a 2-replica fleet on the kernel route, with journals, gives
    one gather-route engine's streams; so does it after ``replica_kill``
    of replica 0 at router step 4, and through ``replica_wedge`` of
    replica 0 (quarantined, its work re-routed, then rejoined)."""
    mcfg, model = spec_model(2, "float32")
    reqs = fleet_requests(mcfg)
    eng = Engine(model, mcfg, EngineConfig(pool_size=8, page_size=16),
                 device="cuda")
    assert eng.kernel_route.decode == "gather"
    for q in reqs:
        assert eng.submit(q) is None
    plain = {r.id: list(r.tokens) for r in eng.drain()}
    del eng
    ecfg = EngineConfig(pool_size=8, page_size=16, paged_kernel=True)
    runs, counters = {}, {}
    with tempfile.TemporaryDirectory() as root:
        for name, fault, rkw in (
                ("clean", None, {}),
                ("kill", faults.Fault(site=FLEET_STEP,
                                      kind=KIND_REPLICA_KILL, at=4, arg=0),
                 {}),
                ("wedge", faults.Fault(site=FLEET_STEP,
                                       kind=KIND_REPLICA_WEDGE,
                                       **FLEET_WEDGE),
                 dict(wedge_budget_s=0.1, wedge_patience=2,
                      quarantine_steps=5))):
            router = Router(model, mcfg, RouterConfig(
                n_replicas=2, journal_dir=os.path.join(root, name), **rkw),
                ecfg, device="cuda")
            assert all(r.engine.kernel_route.decode == "kernel"
                       for r in router.replicas)
            router.warmup()
            plan = faults.FaultPlan(*([fault] if fault else []))
            with faults.installed(plan):
                runs[name] = fleet_drive(router, reqs)
            counters[name] = dict(router.metrics.counters)
            counters[name]["alive"] = router.n_alive
    first_difference(runs["clean"], plain, "fleet clean vs one engine")
    first_difference(runs["kill"], runs["clean"], "fleet kill vs clean")
    first_difference(runs["wedge"], runs["clean"], "fleet wedge vs clean")
    k, w = counters["kill"], counters["wedge"]
    assert k["fleet_replica_kills"] == 1 and k["alive"] == 1, k
    assert k.get("fleet_requeued_requests", 0) > 0, k
    assert w.get("fleet_replica_wedges", 0) >= 1, w
    assert w.get("fleet_requeued_requests", 0) > 0, w
    assert w.get("fleet_replica_rejoins", 0) >= 1 and w["alive"] == 2, w
    assert not counters["clean"].get("fleet_replica_wedges"), counters
    n = sum(len(t) for t in plain.values())
    print(f"fleet parity on {card}: 20 streams (16 greedy, 4 sampled), {n} "
          f"tokens: one gather-route engine = the 2-replica kernel-route "
          f"fleet clean = after replica 0's kill at step 4 (requeued "
          f"{k['fleet_requeued_requests']}) = through its 0.2 s wedge "
          f"(wedges {w['fleet_replica_wedges']}, re-routed "
          f"{w['fleet_requeued_requests']}, rejoins "
          f"{w['fleet_replica_rejoins']}); f32, 2 layers, C=768")


async def http_call(host: str, port: int, method: str, path: str,
                    body=None) -> tuple:
    """One HTTP exchange: (status, JSON or raw body)."""
    r, w = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    w.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: "
            f"{len(payload)}\r\n\r\n".encode() + payload)
    await w.drain()
    data = await r.read()
    w.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    try:
        return int(head.split(b" ")[1]), json.loads(rest)
    except ValueError:
        return int(head.split(b" ")[1]), rest


async def sse_generate(host: str, port: int, body: dict) -> dict:
    """``POST /v1/generate``, read as its events arrive: the tokens, their
    indices, the done event, the client-side TTFT (request sent to first
    token event) and total (to the done event)."""
    t0 = time.perf_counter()
    r, w = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    w.write(b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
            + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await w.drain()
    head = await r.readuntil(b"\r\n\r\n")
    assert b" 200 " in head.split(b"\r\n", 1)[0], head
    out = {"tokens": [], "i": [], "done": None, "ttft_s": None}
    while True:
        try:
            block = (await r.readuntil(b"\n\n")).decode()
        except asyncio.IncompleteReadError:
            break
        ev = "message"
        for line in block.splitlines():
            if line.startswith("event: "):
                ev = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                if ev == "done":
                    out["done"] = data
                    out["total_s"] = time.perf_counter() - t0
                elif ev == "message":
                    if out["ttft_s"] is None:
                        out["ttft_s"] = time.perf_counter() - t0
                    out["tokens"].append(data["token"])
                    out["i"].append(data["i"])
                else:
                    raise AssertionError(f"SSE {ev}: {data}")
    w.close()
    return out


def fleet_clients(jobs, out, events: tuple) -> None:
    """The clients' process, one for every run of phases 43 and 46: for
    each job ``(host, port, mcfg, lcfg, kill_in_turn[, cold, tag])`` from
    ``jobs`` (None ends it), with ``cold`` (the default) ``/readyz`` must
    answer 503 (then ``cold`` is set) until the server sets ``warm``, 200
    after; without it, 200 at once. Then ``FLEET_CLIENTS`` clients run the
    sessions of ``lcfg`` through ``/v1/generate`` (request ids prefixed
    with ``tag``; client k starts ``k * FLEET_STAGGER_S`` after the
    first), setting ``turn`` when the first request of turn
    ``kill_in_turn`` (0-based) goes out; last ``/metrics``. Puts ("ok",
    (responses by id, wall seconds, metrics text)) or ("error", text) on
    ``out``."""
    cold, warm, turn = events

    async def client(k, lc, queue, got, host, port, kill_in_turn, tag):
        await asyncio.sleep(k * FLEET_STAGGER_S)
        while not queue.empty():
            sess = queue.get_nowait()
            while sess.next_turn < lc.turns:
                req = session_request(sess, lc)
                req.id = tag + req.id
                if sess.next_turn == kill_in_turn:
                    turn.set()
                res = await sse_generate(host, port, {
                    "id": req.id, "prompt": req.prompt.tolist(),
                    "max_new_tokens": req.max_new_tokens, "greedy": True,
                    "rng_seed": req.rng_seed})
                got[req.id] = res
                assert res["done"] is not None, req.id
                assert res["done"]["finish_reason"] == "max_tokens", (
                    req.id, res["done"])
                sess.context = np.concatenate(
                    [sess.context, sess.user_turns[sess.next_turn],
                     np.asarray(res["tokens"], np.int32)])
                sess.next_turn += 1

    async def run(host, port, mcfg, lcfg, kill_in_turn, is_cold=True,
                  tag=""):
        lc = SessionLoadConfig(**lcfg)
        if is_cold:
            st, body = await http_call(host, port, "GET", "/readyz")
            assert st == 503 and body["ready_replicas"] == 0, (st, body)
            cold.set()
            assert await asyncio.get_running_loop().run_in_executor(
                None, warm.wait, 300), "the server never warmed"
        st, body = await http_call(host, port, "GET", "/readyz")
        assert st == 200 and body["ready_replicas"] >= 1, body
        queue: asyncio.Queue = asyncio.Queue()
        for sess in make_sessions(mcfg, lc):
            queue.put_nowait(sess)
        got: dict = {}
        t0 = time.perf_counter()
        await asyncio.gather(*[client(k, lc, queue, got, host, port,
                                      kill_in_turn, tag)
                               for k in range(FLEET_CLIENTS)])
        wall = time.perf_counter() - t0
        st, text = await http_call(host, port, "GET", "/metrics")
        assert st == 200
        return got, wall, text.decode()

    for job in iter(jobs.get, None):
        try:
            out.put(("ok", asyncio.run(run(*job))))
        except BaseException as e:  # noqa: BLE001 — reported to the server
            out.put(("error", f"{type(e).__name__}: {e}"))


def front_door_run(clients: tuple, model, mcfg, ecfg, n_replicas: int,
                   affinity: bool, lcfg: dict, root: str,
                   kill_in_turn: int = -1) -> dict:
    """The session traffic through ``ServeApp`` over ``Router`` on
    127.0.0.1 at an ephemeral port, the clients in a process of their own
    (``fleet_clients``; ``clients`` is (process, jobs, out, events)), as a
    server's clients are: ``/readyz`` is 503 until the replicas are warm,
    200 after. Row #1's and row #2's counts are set to 0 after the
    warm-up, before the clients may start, and read once they are done.
    With ``kill_in_turn`` >= 0, once a request of that turn went out and
    replica 1 has requests in flight, ``replica_kill`` of replica 1 is
    planned for the next router step. Every session must finish every
    turn, every stream must carry each token of its request's result once
    (indices 0..n-1, the result's tokens in order), and the wedge probe,
    at a 1 s budget, must never trip."""
    proc, jobs, out, events = clients
    lc = SessionLoadConfig(**lcfg)
    router = Router(model, mcfg, RouterConfig(
        n_replicas=n_replicas, affinity=affinity, journal_dir=root,
        wedge_budget_s=1.0), ecfg, device="cuda")
    app = ServeApp(router)
    finals = {}
    pop = router.pop_result

    def pop_and_keep(rid):
        res = pop(rid)
        if res is not None:
            finals[rid] = list(res.tokens)
        return res

    router.pop_result = pop_and_keep
    for e in events:
        e.clear()

    async def serve():
        host, port = await app.start(warm=False)
        jobs.put((host, port, mcfg, lcfg, kill_in_turn))
        planned = []
        try:
            while not events[0].is_set():
                assert proc.is_alive(), "the clients' process died"
                if not out.empty():
                    raise AssertionError(out.get())
                await asyncio.sleep(0.01)
            router.warmup()
            pa.paged_window_attention.launches = 0
            dec.fused_paged_decode_layers.launches = 0
            events[1].set()
            while out.empty():
                assert proc.is_alive(), "the clients' process died"
                if (events[2].is_set() and not planned
                        and router.replicas[1].engine.in_flight_ids()):
                    planned.append(router.n_steps)
                    faults.install(faults.FaultPlan(faults.Fault(
                        site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                        at=planned[0], arg=1)))
                await asyncio.sleep(0.002)
            launches = (pa.paged_window_attention.launches,
                        dec.fused_paged_decode_layers.launches)
            status, res = out.get()
            assert status == "ok", res
            return res, launches, router.fleet_summary(), planned
        finally:
            faults.clear()
            await app.stop()

    (got, wall, text), launches, summary, planned = asyncio.run(serve())
    assert len(got) == lc.n_sessions * lc.turns, len(got)
    for rid, res in got.items():
        n = res["done"]["n_tokens"]
        assert res["i"] == list(range(n)), f"{rid}: SSE indices {res['i']}"
        assert res["tokens"] == finals[rid], f"{rid}: SSE != result"
        assert n == lc.max_new_tokens, (rid, n)
    assert not summary["router"].get("fleet_replica_wedges"), summary
    if kill_in_turn >= 0:
        assert planned and summary["router"]["fleet_replica_kills"] == 1
        assert summary["router"].get("fleet_requeued_requests", 0) > 0
    ttft = sorted(res["ttft_s"] for res in got.values())
    # what the client waits outside the router's submit-to-finish
    outside = sorted(res["total_s"] - res["done"]["total_s"]
                     for res in got.values())
    fleet = [ln for ln in text.splitlines()
             if ln.startswith("tpu_gpt_fleet_fleet_")]
    return {"wall_s": wall, "tokens": sum(len(r["tokens"])
                                          for r in got.values()),
            "ttft_p50": ttft[len(ttft) // 2],
            "ttft_p99": ttft[min(int(0.99 * (len(ttft) - 1) + 0.5),
                                 len(ttft) - 1)],
            "outside_p50": outside[len(outside) // 2],
            "launches": launches, "summary": summary, "metrics": fleet,
            "streams": {rid: r["tokens"] for rid, r in got.items()},
            "kill_at": planned[0] if planned else None}


def front_door_line(name: str, r: dict, card: str) -> None:
    s = r["summary"]
    steps = [(b["n_steps"], b["step_latency"]["p50_s"] * 1e3,
              b["step_latency"]["p99_s"] * 1e3) for b in s["replicas"]]
    print(f"front door {name} on {card}: {r['tokens'] / r['wall_s']:.1f} "
          f"tok/s ({r['tokens']} tokens in {r['wall_s']:.2f} s), client "
          f"TTFT p50 {r['ttft_p50'] * 1e3:.2f} ms / p99 "
          f"{r['ttft_p99'] * 1e3:.2f} ms (p50 {r['outside_p50'] * 1e3:.2f} "
          f"ms of a request's client time outside the router's submit to "
          f"finish), replica steps and step p50 / p99 "
          + ", ".join(f"{n} @ {p50:.3f} / {p99:.3f} ms"
                      for n, p50, p99 in steps)
          + f", prefix-hit rate {s['aggregate_prefix_hit_rate']}, fleet "
          f"TTFT p50 {s['fleet_ttft_s']['p50'] * 1e3:.2f} ms, requeued "
          f"{s['router'].get('fleet_requeued_requests', 0)}, requeue "
          f"latency p50 {s['requeue_latency_s']['p50'] * 1e3:.2f} ms")


def front_door_phase(card: str) -> dict:
    """Phase 43 (this slice's main path): GPT-2 124M at full width and
    depth, bf16, random init, 2 replicas of 8 slots, page 16, packed
    cache, the kernel route, behind ``ServeApp``: the session traffic of
    ``FLEET_LCFG``; row #1 runs exactly 12 x the replicas' decode steps.
    The same sessions on 1 replica and with affinity off (their prefix-hit
    rates beside the fleet's), then with ``replica_kill`` of replica 1 in
    turn 2. Then a char-gpt fleet (bf16, the fused route): row #2 runs
    once a decode step. Returns each run's launches, and the 2-replica
    run's numbers under ``"fleet run"`` (phase 46 compares with them)."""
    import multiprocessing as mp
    mcfg = dataclasses.replace(get_config("gpt2-small").model,
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    ecfg = EngineConfig(pool_size=8, page_size=16, paged_kernel=True)
    out = {}
    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    events = (ctx.Event(), ctx.Event(), ctx.Event())
    proc = ctx.Process(target=fleet_clients, args=(jobs, results, events))
    proc.start()
    clients = (proc, jobs, results, events)
    try:
        with tempfile.TemporaryDirectory() as root:
            runs = {}
            for name, n, aff, kill in (("fleet", 2, True, -1),
                                       ("one replica", 1, True, -1),
                                       ("no affinity", 2, False, -1),
                                       ("kill", 2, True, 1)):
                runs[name] = r = front_door_run(
                    clients, model, mcfg, ecfg, n, aff, FLEET_LCFG,
                    os.path.join(root, name.replace(" ", "_")),
                    kill_in_turn=kill)
                steps = sum(b["n_steps"] for b in r["summary"]["replicas"])
                assert r["launches"] == (mcfg.n_layer * steps, 0), (
                    r["launches"], steps)
                front_door_line(name, r, card)
                out[name] = r["launches"][0]
                if name == "fleet":
                    out["fleet run"] = {k: r[k] for k in (
                        "wall_s", "tokens", "ttft_p50", "ttft_p99",
                        "outside_p50")}
                gc.collect()
                torch.cuda.empty_cache()
            k = runs["kill"]["summary"]["router"]
            assert k["fleet_replica_kills"] == 1, k
            same = sum(runs["kill"]["streams"][rid] == t
                       for rid, t in runs["fleet"]["streams"].items())
            print(f"front door kill: replica 1 killed at router step "
                  f"{runs['kill']['kill_at']}, requeued "
                  f"{k.get('fleet_requeued_requests', 0)}; every SSE stream "
                  f"carried its result once; {same} of "
                  f"{len(runs['fleet']['streams'])} streams equal the clean "
                  f"fleet's")
            print("front door /metrics (fleet run): "
                  + "; ".join(runs["fleet"]["metrics"]))
            hits = {n: runs[n]["summary"]["aggregate_prefix_hit_rate"]
                    for n in ("fleet", "one replica", "no affinity")}
            print(f"front door prefix-hit rate on {card}: 2 replicas with "
                  f"affinity {hits['fleet']}, 1 replica "
                  f"{hits['one replica']}, 2 replicas without affinity "
                  f"{hits['no affinity']}")
            del model
            cmcfg = dataclasses.replace(get_config("char-gpt").model,
                                        decode_cache_layout="packed")
            cmodel = init_params(cmcfg, torch.Generator(device="cuda")
                                 .manual_seed(0), device="cuda")
            r = front_door_run(clients, cmodel, cmcfg, ecfg, 2, True,
                               CHAR_FLEET_LCFG, os.path.join(root, "char"))
            routes = {b["kernel_route"]["decode"]
                      for b in r["summary"]["replicas"]}
            assert routes == {"fused"}, routes
            steps = sum(b["n_steps"] for b in r["summary"]["replicas"])
            assert r["launches"][1] == steps > 0, (r["launches"], steps)
            front_door_line("char-gpt", r, card)
            out["char-gpt fused"] = r["launches"][1]
        jobs.put(None)
        proc.join(timeout=60)
        assert proc.exitcode == 0, proc.exitcode
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    return out


def serve_cli_phase(card: str) -> None:
    """Phase 44: ``python -m replicatinggpt_tpu_torch serve --preset
    gpt2-small --decode-cache-layout packed --paged-kernel --replicas 2
    --port 0 --journal-dir D`` as a subprocess: ``/readyz`` 200 once it
    says it serves, one ``/v1/generate`` round trip, SIGINT: exit 0, and
    the journals closed with no unfinished request."""
    with tempfile.TemporaryDirectory() as jdir:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "replicatinggpt_tpu_torch", "serve",
             "--preset", "gpt2-small", "--decode-cache-layout", "packed",
             "--paged-kernel", "--replicas", "2", "--port", "0",
             "--journal-dir", jdir], stderr=subprocess.PIPE, text=True)
        lines: list = []
        reader = threading.Thread(
            target=lambda: lines.extend(iter(proc.stderr.readline, "")),
            daemon=True)
        reader.start()
        try:
            port = None
            while port is None and time.perf_counter() - t0 < 300:
                if proc.poll() is not None:
                    raise AssertionError("serve exited early: "
                                         + "".join(lines))
                m = re.search(r"serving on http://[\d.]+:(\d+)",
                              "".join(lines))
                port = int(m.group(1)) if m else None
                time.sleep(0.1)
            assert port is not None, "no serving banner: " + "".join(lines)
            t_bound = time.perf_counter() - t0

            async def client():
                st, body = await http_call("127.0.0.1", port, "GET",
                                           "/readyz")
                assert st == 200 and body["ready_replicas"] == 2, body
                return await sse_generate("127.0.0.1", port, {
                    "prompt": list(range(1, 40)), "max_new_tokens": 16,
                    "greedy": True})

            res = asyncio.run(client())
            assert res["done"]["finish_reason"] == "max_tokens", res
            assert res["i"] == list(range(16)), res["i"]
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
            assert rc == 0, (rc, "".join(lines))
            reader.join(timeout=10)
            recs, unfinished = 0, 0
            for i in range(2):
                path = os.path.join(jdir, f"replica{i}.jsonl")
                with open(path) as f:
                    text = f.read()
                assert not text or text.endswith("\n"), path
                recs += len(text.splitlines())
                unfinished += len(RequestJournal.unfinished(path))
            assert recs == 2 and unfinished == 0, (recs, unfinished)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"serve CLI on {card}: bound after {t_bound:.1f} s (model init, "
          f"2 replicas warmed), /readyz 200, one /v1/generate of 16 tokens "
          f"(client TTFT {res['ttft_s'] * 1e3:.2f} ms), SIGINT exit 0, "
          f"journals closed with {recs} records and no unfinished request")


# ------------------------------------------------------------ worker fleet

#: phase 45's workers: GPT-2 124M width cut to 2 layers, f32, the kernel
#: route, phase 42's weights (seed 0) and engine
MP_CONFIG_ARGS = ["--preset", "gpt2-small", "--n-layer", "2", "--dtype",
                  "float32", "--decode-cache-layout", "packed", "--seed", "0"]
MP_ENGINE_ARGS = ["--pool-size", "8", "--page-size", "16", "--paged-kernel",
                  "--device", "cuda"]
#: phase 45's router: a worker step's RPC budget 0.5 s, the wedge probe at
#: 0.4 s (a 2-layer step takes milliseconds), and proc_hang's SIGSTOP for
#: 6 supervisor ticks (router steps)
MP_RCFG = dict(step_timeout_s=0.5, wedge_budget_s=0.4, wedge_patience=2,
               quarantine_steps=8)
MP_HANG_TICKS = 6
#: phase 46's model and route (phase 43's)
MP_SERVE_ARGS = ["--preset", "gpt2-small", "--decode-cache-layout", "packed",
                 "--paged-kernel"]


def pids_gone(pids) -> bool:
    """Whether none of ``pids`` is a live process (they were reaped)."""
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


def mp_drive(router, sup, reqs, tag: str, at_step=None,
             busy=lambda: False, budget_s: float = 300.0) -> dict:
    """Phase 45's driver: submit ``reqs`` under ids prefixed ``tag``, step
    the fleet and tick the supervisor until the router is idle and
    ``busy()`` false, reading the delivery ledger every step;
    ``at_step(n)`` runs after the n-th step. Every request must finish by
    its budget, no id may be active on two live workers that answer (not
    wedged) at any step, and each id's delivered tokens must be its final
    tokens. Returns the tokens by (untagged) id."""
    for q in reqs:
        assert router.submit(dataclasses.replace(q, id=tag + q.id)) is None
    streams = {tag + q.id: [] for q in reqs}
    results = {}
    deadline = time.monotonic() + budget_s
    n = 0
    while not router.idle or busy():
        assert time.monotonic() < deadline, (router.events[-8:],
                                             sup.events[-8:])
        results.update({r.id: r for r in router.step()})
        sup.tick()
        n += 1
        if at_step is not None:
            at_step(n)
        for rid in streams:
            streams[rid].extend(router.take_new_tokens(rid))
        live = [rid for rep in router.replicas
                if rep.alive and not rep.wedged for rid in rep._partials]
        assert len(live) == len(set(live)), f"an id on two workers: {live}"
    assert sorted(results) == sorted(streams), "a request never finished"
    bad = {k: r.finish_reason for k, r in results.items() if not r.ok}
    assert not bad, bad
    for rid, r in results.items():
        assert streams[rid] == list(r.tokens), f"{rid}: delivered != final"
    return {rid[len(tag):]: list(r.tokens) for rid, r in results.items()}


def multiproc_parity_phase(card: str) -> dict:
    """Phase 45: two ``serve-worker`` processes on the card (GPT-2 124M
    width cut to 2 layers, f32, the kernel route) behind the router and
    the supervisor, phase 42's 20 requests (4 sampled), each fault on the
    worker holding the run's requests: the streams equal one in-process
    gather-route engine's clean, after ``proc_kill`` (a real SIGKILL, a
    supervised restart, a journal replay), through ``proc_hang`` (SIGSTOP
    past the step RPC's budget, the wedge, the migrated re-route,
    SIGCONT, the rejoin), after ``host_loss`` (its directory deleted; the
    router's ledger recovers the work) and through a rolling restart (no
    drop, /readyz never 503 while a worker serves). Row #1 runs exactly 2
    x each worker's decode steps. Returns the seconds from spawn to
    registration and each fault's worker."""
    from replicatinggpt_tpu_torch.faults.procsup import (
        SupervisorConfig, make_worker_specs, spawn_fleet)
    mcfg, model = spec_model(2, "float32")
    reqs = fleet_requests(mcfg)
    eng = Engine(model, mcfg, EngineConfig(pool_size=8, page_size=16),
                 device="cuda")
    assert eng.kernel_route.decode == "gather"
    for q in reqs:
        assert eng.submit(q) is None
    plain = {r.id: list(r.tokens) for r in eng.drain()}
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="mp45-")
    rcfg = RouterConfig(n_replicas=2, ledger_path=os.path.join(
        root, "router_ledger.jsonl"), **MP_RCFG)
    router = sup = None
    pids, runs, counters, info = set(), {}, {}, {}
    try:
        t0 = time.perf_counter()
        router, sup = spawn_fleet(
            make_worker_specs(2, root, MP_CONFIG_ARGS, MP_ENGINE_ARGS),
            rcfg, SupervisorConfig(backoff_s=0.2, probe_every=0,
                                   ready_timeout_s=300))
        info["spawn_s"] = time.perf_counter() - t0
        assert all(r.alive and r.warmed for r in router.replicas)

        def run(name, kind=None, **kw):
            """One run; with ``kind``, its fault hits the worker that holds
            most of the run's requests (the router's cached gauges send a
            burst of submits to one worker), two steps after the first."""
            before = dict(router.metrics.counters)
            pids.update(sup.pids())
            plan = faults.FaultPlan()

            def plan_fault(n):
                if n == 1 and kind is not None:
                    owners = [fi.replica for fi in router._inflight.values()]
                    victim = max(set(owners), key=owners.count)
                    info[name] = victim
                    plan.faults = (faults.Fault(
                        site=FLEET_STEP, kind=kind, at=router.n_steps + 1,
                        arg=(MP_HANG_TICKS if kind == KIND_PROC_HANG
                             else victim), arg2=victim),)
                if "at_step" in kw:
                    kw["at_step"](n)

            t = time.perf_counter()
            with faults.installed(plan):
                runs[name] = mp_drive(router, sup, reqs, name + "-",
                                      at_step=plan_fault,
                                      busy=kw.get("busy", lambda: False))
            pids.update(sup.pids())
            assert kind is None or plan.fired, (name, plan.fired)
            counters[name] = {k: v - before.get(k, 0) for k, v
                              in router.metrics.counters.items()}
            counters[name]["s"] = time.perf_counter() - t

        run("clean")
        run("kill", KIND_PROC_KILL)
        victim = info["kill"]
        assert sup.handles[victim].crash_restarts == 1
        with open(sup.handles[victim].spec.log_path) as f:
            assert "journal replay:" in f.read(), "no replay after the kill"
        run("hang", KIND_PROC_HANG)
        h = counters["hang"]
        assert h.get("fleet_replica_wedges", 0) >= 1, h
        assert h.get("fleet_requeued_requests", 0) > 0, h
        # the rejoin: the quarantine's end, or the worker's own
        # re-registration after its silence (a re-attach)
        assert (h.get("fleet_replica_rejoins", 0)
                + h.get("fleet_replica_attaches", 0)) >= 1, h
        assert all(r.alive and not r.wedged for r in router.replicas)
        assert sum(hd.crash_restarts for hd in sup.handles) == 1
        run("host_loss", KIND_HOST_LOSS)
        victim = info["host_loss"]
        gen = sup.handles[victim].gen
        attach = [e for e in sup.events if f"worker {victim} registered+"
                  f"attached (gen {gen}" in e]
        assert attach and "kept 0" in attach[-1], sup.events[-6:]
        assert counters["host_loss"].get("fleet_requeued_requests", 0) > 0
        gens = [hd.gen for hd in sup.handles]
        not_ready = []

        def rolling(n):
            if n == 3:
                sup.start_rolling_restart()
            if n >= 3:
                not_ready.append(not router.readyz()["ok"])

        run("rolling", at_step=rolling, busy=lambda: sup.rolling_active)
        assert [hd.gen for hd in sup.handles] == [g + 1 for g in gens]
        assert not any(not_ready), "/readyz 503 while a worker served"
        assert counters["rolling"].get("fleet_drains", 0) == 2
        summary = router.fleet_summary()
        for b in summary["replicas"]:
            w = b["worker"]
            assert w["row1_launches"] == mcfg.n_layer * b["n_steps"], b
        info["ready_s"] = [hd.ready_s for hd in sup.handles]
    finally:
        if sup is not None:
            sup.stop_all()
            pids.update(sup.pids())
        if router is not None:
            router.close()
    assert pids and pids_gone(pids), "a worker process outlived the phase"
    for name, toks in runs.items():
        first_difference(toks, plain, f"multiproc {name} vs one engine")
    n = sum(len(t) for t in plain.values())
    print(f"multiproc parity on {card}: 20 streams (16 greedy, 4 sampled), "
          f"{n} tokens: one gather-route engine = 2 worker processes clean "
          f"= after worker {info['kill']}'s SIGKILL (replayed) = through "
          f"worker {info['hang']}'s SIGSTOP (wedges "
          f"{counters['hang'].get('fleet_replica_wedges')}, "
          f"re-routed {counters['hang'].get('fleet_requeued_requests')}, "
          f"rejoins {counters['hang'].get('fleet_replica_rejoins', 0)}, "
          f"re-attaches {counters['hang'].get('fleet_replica_attaches', 0)}) "
          f"= after "
          f"worker {info['host_loss']}'s host loss (requeued "
          f"{counters['host_loss'].get('fleet_requeued_requests', 0)}) = "
          f"through a rolling restart (migrated "
          f"{counters['rolling'].get('fleet_requeued_requests', 0)}, /readyz "
          f"200 throughout); spawn to registration {info['spawn_s']:.1f} s, "
          f"each run's seconds "
          + ", ".join(f"{k} {v['s']:.1f}" for k, v in counters.items())
          + f"; registrations (s) {info['ready_s']}; f32, 2 layers, C=768")
    return info


def healthz(port: int) -> dict:
    return asyncio.run(http_call("127.0.0.1", port, "GET", "/healthz"))[1]


def multiproc_front_door_phase(card: str, inproc: dict) -> dict:
    """Phase 46 (this slice's main path): ``serve --preset gpt2-small
    --decode-cache-layout packed --paged-kernel --replicas 2 --multiproc``
    as a subprocess (bf16, full width and depth, 8 slots, page 16): phase
    43's sessions from its own clients' process, beside phase 43's
    in-process fleet (``inproc``); then the same sessions again with a
    real SIGKILL of worker 1 in turn 2, once it holds requests. Measures
    fleet tokens/s, client TTFT, each worker's step p50 as the router
    times it, the RPC's share of a step (worker 0's steps over its life,
    as the router timed them less its own), step frame bytes, the
    prefix-hit rate, each worker's peak memory, spawn-to-registration and
    kill-to-rejoin seconds, and checks that both workers took sessions in
    the clean run, that every SSE stream carries each token of its result
    once, that row #1 ran in each worker, exactly 12 x its decode steps
    (counted in the worker), and that SIGINT exits 0 with no worker left
    and the journals closed with no unfinished request. Returns row #1's
    launches by worker."""
    import multiprocessing as mp
    mcfg = dataclasses.replace(get_config("gpt2-small").model,
                               decode_cache_layout="packed")
    jdir = tempfile.mkdtemp(prefix="mp46-")
    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    events = (ctx.Event(), ctx.Event(), ctx.Event())
    clients = ctx.Process(target=fleet_clients, args=(jobs, results, events))
    clients.start()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "replicatinggpt_tpu_torch", "serve",
         *MP_SERVE_ARGS, "--replicas", "2", "--multiproc", "--journal-dir",
         jdir, "--port", "0", "--wedge-budget-s", "1.0"],
        stderr=subprocess.PIPE, text=True)
    lines: list = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stderr.readline, "")),
        daemon=True)
    reader.start()
    pids, out = set(), {}
    try:
        port = None
        while port is None and time.perf_counter() - t0 < 400:
            if proc.poll() is not None:
                raise AssertionError("serve exited early: " + "".join(lines))
            m = re.search(r"serving on http://[\d.]+:(\d+)", "".join(lines))
            port = int(m.group(1)) if m else None
            time.sleep(0.1)
        assert port is not None, "no serving banner: " + "".join(lines)
        t_bound = time.perf_counter() - t0
        h = healthz(port)
        pids.update(r["pid"] for r in h["replicas"])
        runs = {}
        victim = 1
        #: the most slots each worker held at once in the clean run
        held = [0, 0]
        for name, kill in (("clean", -1), ("kill", victim)):
            for e in events:
                e.clear()
            jobs.put(("127.0.0.1", port, mcfg, FLEET_LCFG, kill, False,
                      name[0] + "-"))
            t_kill = t_rejoin = None
            while results.empty():
                assert clients.is_alive(), "the clients' process died"
                assert proc.poll() is None, "serve died: " + "".join(lines)
                reps = healthz(port)["replicas"]
                if kill < 0:
                    held = [max(h, r["slots_active"])
                            for h, r in zip(held, reps)]
                elif (t_kill is None and events[2].is_set()
                        and reps[victim]["slots_active"] > 0):
                    os.kill(reps[victim]["pid"], signal.SIGKILL)
                    t_kill = time.perf_counter()
                elif t_kill is not None and t_rejoin is None:
                    if reps[victim]["alive"] and reps[victim]["gen"] == 1:
                        t_rejoin = time.perf_counter()
                        pids.add(reps[victim]["pid"])
                time.sleep(0.05)
            status, res = results.get()
            assert status == "ok", res
            runs[name] = (res, t_kill, t_rejoin)
            assert min(held) > 0, f"a worker took no session: {held}"
        assert runs["kill"][1] is not None, "worker 1 was never killed"
        if runs["kill"][2] is None:
            rep = healthz(port)["replicas"][victim]
            assert rep["alive"] and rep["gen"] == 1, rep
            runs["kill"] = (*runs["kill"][:2], time.perf_counter())
            pids.add(rep["pid"])
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        assert rc == 0, (rc, "".join(lines))
    finally:
        jobs.put(None)
        clients.join(timeout=60)
        if clients.is_alive():
            clients.kill()
            clients.join()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
    assert pids_gone(pids), "a worker process outlived serve"
    summary = json.loads(next(ln for ln in lines if ln.startswith(
        "fleet summary: "))[len("fleet summary: "):])
    lc = SessionLoadConfig(**FLEET_LCFG)
    stats = {}
    for name, ((got, wall, text), _, _) in runs.items():
        assert len(got) == lc.n_sessions * lc.turns, (name, len(got))
        for rid, r in got.items():
            n = r["done"]["n_tokens"]
            assert r["i"] == list(range(n)), f"{rid}: SSE indices {r['i']}"
            assert n == lc.max_new_tokens, (rid, n)
        ttft = sorted(r["ttft_s"] for r in got.values())
        outside = sorted(r["total_s"] - r["done"]["total_s"]
                         for r in got.values())
        stats[name] = {"wall_s": wall, "outside_p50": outside[len(outside)
                                                              // 2],
                       "tokens": sum(len(r["tokens"]) for r in got.values()),
                       "ttft_p50": ttft[len(ttft) // 2],
                       "ttft_p99": ttft[min(int(0.99 * (len(ttft) - 1) + .5),
                                           len(ttft) - 1)],
                       "metrics": text}
    for rid, r in runs["clean"][0][0].items():
        assert r["done"]["finish_reason"] == "max_tokens", rid
    router = summary["router"]
    assert not router.get("fleet_replica_wedges"), router
    assert router.get("fleet_replica_downs", 0) >= 1, router
    for path in [os.path.join(jdir, f"worker{i}", "journal.jsonl")
                 for i in range(2)] + [os.path.join(jdir,
                                                    "router_ledger.jsonl")]:
        with open(path) as f:
            text = f.read()
        assert not text or text.endswith("\n"), path
        assert RequestJournal.unfinished(path) == [], path
    workers = {}
    for i, b in enumerate(summary["replicas"]):
        w = b["worker"]
        assert w["row1_launches"] > 0, (i, b)
        assert w["row1_launches"] == mcfg.n_layer * b["n_steps"], (i, b)
        workers[f"worker{i}"] = w["row1_launches"]
        out[i] = w

    p50 = '{quantile="0.5"}'

    def metric(text, name, field):
        m = re.search(rf"^tpu_gpt_fleet_{name}{re.escape(field)} (\S+)$",
                      text, re.M)
        return float(m.group(1)) if m else float("nan")

    clean = stats["clean"]
    text = clean["metrics"]
    steps = ", ".join(
        f"worker {i}: router p50 "
        f"{metric(text, f'replica{i}_step_s', p50) * 1e3:.3f} ms, frame "
        f"p50 {metric(text, f'replica{i}_step_frame_bytes', p50):.0f} / max "
        f"{metric(text, f'replica{i}_step_frame_bytes', '_max'):.0f} B"
        for i in range(2))
    # the RPC's share of a step: worker 0 (never killed, busy in both
    # runs) over the same steps, the router's time of each less its own
    live = 1 - victim
    w0, timed = out[live], summary["replicas"][live]["router_timed"]
    assert timed["pid"] == w0["pid"], (timed, w0)
    assert timed["steps"] == w0["step_calls"] > 0, (timed, w0)
    rt, rn = timed["step_s_sum"], timed["steps"]
    share = rt / rn - w0["step_s_sum"] / rn
    print(f"multiproc front door on {card}: bound after {t_bound:.1f} s "
          f"(spawn to registration {summary['workers'][0]['ready_s']} / "
          f"{summary['workers'][1]['ready_s']} s); clean: "
          f"{clean['tokens'] / clean['wall_s']:.1f} tok/s ({clean['tokens']} "
          f"tokens in {clean['wall_s']:.2f} s) against the in-process "
          f"fleet's {inproc['tokens'] / inproc['wall_s']:.1f} (phase 43, "
          f"{(clean['tokens'] / clean['wall_s']) / (inproc['tokens'] / inproc['wall_s']):.3f}x), "
          f"client TTFT p50 {clean['ttft_p50'] * 1e3:.2f} ms / p99 "
          f"{clean['ttft_p99'] * 1e3:.2f} ms (in-process "
          f"{inproc['ttft_p50'] * 1e3:.2f} / {inproc['ttft_p99'] * 1e3:.2f}), "
          f"p50 {clean['outside_p50'] * 1e3:.2f} ms of a request's client "
          f"time outside the router's submit to finish (in-process "
          f"{inproc['outside_p50'] * 1e3:.2f}); "
          f"{steps}; worker {live} over both runs: router step mean "
          f"{rt / rn * 1e3:.3f} ms over {rn} steps, its own step mean "
          f"{w0['step_s_sum'] / rn * 1e3:.3f} ms over the same steps, p50 "
          f"{w0['step_s_p50'] * 1e3:.3f} ms: RPC share {share * 1e3:.3f} ms "
          f"a step; most slots held at once in the clean run {held}; the "
          f"killed worker "
          f"{victim}'s restarted incarnation's own step p50 "
          f"{out[victim]['step_s_p50'] * 1e3:.3f} ms over "
          f"{out[victim]['step_calls']} steps; prefix-hit rate "
          f"{summary['aggregate_prefix_hit_rate']}; peak memory allocated "
          + " / ".join(f"{out[i].get('peak_allocated_bytes', 0) / 1e9:.3f} GB"
                       for i in range(2)))
    k = stats["kill"]
    t_kill, t_rejoin = runs["kill"][1:]
    print(f"multiproc kill on {card}: worker {victim} SIGKILLed in turn 2, "
          f"rejoined after {t_rejoin - t_kill:.1f} s (restart "
          f"{summary['workers'][victim]['ready_s']} s to register), "
          f"{k['tokens'] / k['wall_s']:.1f} tok/s, requeued "
          f"{router.get('fleet_requeued_requests', 0)}, requeue latency p50 "
          f"{summary['requeue_latency_s']['p50'] * 1e3:.2f} ms, replica "
          f"downs {router.get('fleet_replica_downs', 0)}; every SSE stream "
          f"carried each token of its result once; row #1 "
          f"{workers} = 12 x each worker's decode steps; SIGINT exit 0, no "
          f"worker left, journals closed with no unfinished request")
    return workers


def build_kernels() -> None:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    names = ("paged_window_attention", "flash_packed", "fused_decode_layers",
             "packed_decode_attention", "fused_paged_decode_layers")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for f in [ex.submit(_build.build, n, verbose=True) for n in names]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.1f} s")


def flash_design() -> None:
    """Names the flash kernels' two bodies and, where the toolkit has
    ``cuobjdump``, counts the tensor-core instructions (HMMA, HGMMA) in
    the SASS of each bf16 flash kernel: evidence only, it gates
    nothing."""
    print("flash design: bf16 -> the tensor-core body (mma.sync m16n8k16 "
          "bf16 -> f32, ldmatrix, cp.async double-buffered tiles: "
          "fwd_tc_kernel, dkv_tc_kernel, dq_tc_kernel); f32 -> the "
          "CUDA-core body (fwd_kernel, dkv_kernel, dq_kernel)")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        print("flash sass: no cuobjdump beside nvcc")
        return
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path("flash_packed"))],
        capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?((?:fwd|dkv|dq)_tc_kernel)ILi(\d+)E",
                      line)
        if "Function :" in line:
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
            if name:
                counts[name] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    print("flash sass (HMMA/HGMMA instructions a bf16 kernel): "
          + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    build_kernels()
    flash_design()
    row = kernel_phase()
    flash_rows = flash_kernel_phase()
    parity_phase()
    row["launches_k1"], k1 = slice_phase(card)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    row.update(wide_window_phase(flush))
    window_parity_phase()
    window_sync_phase()
    by_w, ws = window_slice_phase(card, k1)
    row["launches"] = sum(by_w.values())
    row["launches_by_window"] = {str(w): n for w, n in sorted(by_w.items())}
    row["launches_per_mixed_step"] = (
        ws["kernel_launches_by_window"][str(MIXED_W)]
        / ws["dispatch"]["mixed_window_steps"])
    window_idle_phase(card)
    spec_parity_phase()
    row["launches_spec"] = spec_slice_phase(card)
    spec_resilience_phase(card)
    fleet_parity_phase(card)
    front = front_door_phase(card)
    row["launches_front_door"] = {k: v for k, v in front.items()
                                  if k not in ("char-gpt fused",
                                               "fleet run")}
    serve_cli_phase(card)
    multiproc_parity_phase(card)
    row["launches_multiproc"] = multiproc_front_door_phase(card,
                                                           front["fleet run"])
    fused_paged_row = fused_paged_kernel_phase(flush)
    row["quantized"] = quantized_paged_phase(flush)
    row["int8_ms"] = row["quantized"]["int8-page"]["ms"]
    row["fp8_ms"] = row["quantized"]["fp8-page"]["ms"]
    del flush
    fused_parity_phase()
    (fused_paged_row["launches"], row["quantized_launches"],
     _) = fused_slice_phase(card)
    fused_paged_row["launches_front_door"] = front["char-gpt fused"]
    text = open(CORPUS, encoding="utf-8").read()
    train_parity_phase(CharTokenizer.from_text(text).encode_np(text))
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fused_row = fused_kernel_phase(flush)
    packed_row = packed_kernel_phase(flush)
    del flush
    generate_parity_phase()
    (flash_rows[0]["launches"], flash_rows[1]["launches"],
     fused_row["launches"]) = train_slice_phase(card, set(text))
    _, packed_row["launches"] = generate_slice_phase(card)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    group_rows = group_flash_phase(flush)
    del flush
    gpt2_parity_phase()
    group_rows[0]["launches"], group_rows[1]["launches"], gpt2_info = \
        gpt2_slice_phase(card)
    gpt2_shakespeare_phase(card)
    ck = checkpoint_slice(card)
    group_rows[0]["launches_checkpoint"] = ck["train_124m"][0] + ck["eval"]
    group_rows[1]["launches_checkpoint"] = ck["train_124m"][1]
    flash_rows[0]["launches_checkpoint"] = ck["train_char"][0]
    flash_rows[1]["launches_checkpoint"] = ck["train_char"][1]
    row["launches_checkpoint"] = ck["serve"]
    packed_row["launches_checkpoint"] = ck["generate"]
    fused_row["launches_checkpoint"] = ck["generate_cli"]
    dp_parity_phase()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rank = rank_flash_phase(flush)
    del flush
    group_rows[0]["rank_shape"], group_rows[1]["rank_shape"] = (
        rank["fwd"], rank["bwd"])
    group_rows[0]["launches_dp"], group_rows[1]["launches_dp"] = \
        dp_slice_phase(card, gpt2_info)
    fsdp_slice_phase(card)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    heads_rows = heads_flash_phase(flush)
    del flush
    xl_parity_phase()
    heads_rows[0]["launches"], heads_rows[1]["launches"] = \
        gpt2_xl_slice_phase(card)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    chunk_rows = chunk_flash_phase(flush)
    del flush
    ring_parity_phase()
    chunk_rows[0]["launches"], chunk_rows[1]["launches"] = \
        sp_xl_slice_phase(card)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    partials_row = partials_kernel_phase(flush)
    del flush
    mesh_parity_phase()
    partials_row["launches"] = mesh_slice_phase(card)
    print(f"smoke: {time.perf_counter() - t0:.1f} s, the builds included")
    print(json.dumps({"kernels": [row, *flash_rows, *group_rows, *heads_rows,
                                  *chunk_rows, fused_row, packed_row,
                                  fused_paged_row, partials_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
