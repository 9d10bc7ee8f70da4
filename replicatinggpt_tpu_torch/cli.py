"""Command-line interface of the PyTorch/CUDA port.

    python -m replicatinggpt_tpu_torch train --preset char-gpt
    python -m replicatinggpt_tpu_torch train --preset gpt2-small
    python -m replicatinggpt_tpu_torch train --preset gpt2-small \
        --checkpoint-dir ck [--resume]
    python -m replicatinggpt_tpu_torch eval --preset gpt2-small \
        --checkpoint-dir ck
    python -m replicatinggpt_tpu_torch export-torch --preset gpt2-small \
        --checkpoint-dir ck --out model.pth
    python -m replicatinggpt_tpu_torch train --preset gpt2-xl --sp 4
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-xl --sp 4
    python -m replicatinggpt_tpu_torch train --preset gpt2-small --dp 4 \\
        --batch-size 128
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-small --dp 4 --batch-size 128
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-medium --dp 4 --fsdp
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-small --dp 2 --sp 2
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-small --dp 4 --checkpoint-dir ck [--resume]
    python -m replicatinggpt_tpu_torch generate --preset char-gpt \\
        --prompt "ROMEO:" --sample-tokens 500 --top-k 20
    python -m replicatinggpt_tpu_torch serve-replay --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --n-requests 16
    python -m replicatinggpt_tpu_torch serve-replay --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --decode-window 8 \\
        --decode-window-auto
    python -m replicatinggpt_tpu_torch serve-replay --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --mesh-shape 2x2
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch serve-replay \\
        --preset gpt2-small --decode-cache-layout packed --paged-kernel \\
        --mesh-shape 2x2
    python -m replicatinggpt_tpu_torch serve-replay --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --spec ngram \\
        --spec-k 4 --prompt-mode repeat --greedy
    python -m replicatinggpt_tpu_torch serve-replay --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --spec model \\
        --draft-model char-gpt --spec-k 4
    python -m replicatinggpt_tpu_torch serve --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --replicas 2 \\
        --journal-dir J [--ledger L] [--port 8000] [--checkpoint-dir D]
    python -m replicatinggpt_tpu_torch serve --preset test-tiny \\
        --device cpu --replicas 2 --port 0
    python -m replicatinggpt_tpu_torch serve --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel --replicas 2 \\
        --multiproc --journal-dir J [--restart-budget 3] \\
        [--step-timeout-s 10] [--autoscale-max N --autoscale-min M]
    python -m replicatinggpt_tpu_torch serve-worker --preset gpt2-small \\
        --decode-cache-layout packed --paged-kernel \\
        --router-addr HOST:PORT --journal P --port 0

Every subcommand runs on the card unless given ``--device cpu``, and takes
the JAX subcommands' flags (the training overrides of JAX's
``add_config_flags`` on every subcommand, parsed and unused where nothing
trains). Those this port does not implement yet are
still accepted by the parser, so that a command written for the JAX
package fails with the ROADMAP item that will bring the feature, instead
of being half-run or silently ignored. ``train --dp N`` is data
parallelism (``--fsdp``: the masters and moments sharded too), ``train
--sp N`` sequence parallelism through the ring: all shards in one
process without a launcher, one shard a process under ``torchrun``
(data x seq processes); ``train --mesh-shape DxM`` is ``--dp D`` with a
model axis M, which must be 1. A preset's own mesh (gpt2-small's 8-way
data axis, the larger presets' 16-way FSDP) runs only where a launch
fills it, and unsharded elsewhere, with a warning. The other mesh axes
(``--tp``, ``--pp``, ``--microbatches``) and ``--attention ulysses`` are
refused with ROADMAP.md queue A item 11. ``serve-replay --mesh-shape DxM``
serves on a (data, model) mesh likewise: all D x M shards in one process,
or one a process under ``torchrun`` (D x M processes), with one step a
token read; ``--decode-window`` > 1 on such a mesh is refused with queue
A item 14, and ``--spec`` on it with queue A item 16. ``serve-replay
--spec ngram|model`` decodes speculatively (``--spec-k`` drafts a slot a
step; ``--spec model`` drafts with the ``--draft-model`` preset's stack,
its vocabulary, block, dtype and cache layout the target's, random init
from the seed + 1); with ``--decode-window`` > 1 the windows run only
while speculation is off. ``train --checkpoint-dir D`` saves the whole
training state (``train/checkpoint.py``; under ``torchrun`` gathered and
written by rank 0) and, with ``--resume``, continues from its newest step
that verifies; a first SIGTERM or SIGINT saves and exits 0 (under
``torchrun`` at the next checkpoint boundary on rank 0's signal, and not
at all without ``checkpoint_every``). ``generate``, ``serve-replay``,
``eval`` and ``export-torch`` take ``--checkpoint-dir D`` to use the
weights of its newest verified step (random init from the seed only when
D holds no step). ``serve`` runs ``--replicas`` engines behind the
prefix-affinity router over HTTP/SSE (serve/http.py), in this process
(warmed before the socket binds) or, with ``--multiproc``, each as a
``serve-worker`` process under the supervisor (faults/procsup.py:
restarts with backoff, quarantine past ``--restart-budget``, the
autoscaler of ``--autoscale-max``), with journals under ``--journal-dir``
(required) and the router's ledger at ``J/router_ledger.jsonl`` by
default; the launcher builds the kernels its workers' route loads before
it spawns them, and binds once every worker registered (``serving on
http://host:port`` on stderr). SIGINT is a clean stop that closes the
journals and stops every worker. ``serve-worker`` is one worker: the
engine ``serve`` would build, its locked journal replayed, registered
with ``--router-addr`` over RPC (serve/worker.py); ``--tier`` other than
``mixed`` is refused with queue A item 9(e). The trace sinks are refused
with item 12, weight quantization with item 8. ``--rng-impl`` is refused
everywhere by the ground rules (torch generators only), and ``train``'s
``--coordinator``, ``--num-processes`` and ``--process-id`` name
``torchrun``; ``--backend`` (JAX's ``jax``) names the JAX package, and
``--tp``, ``--pp``, ``--microbatches`` and ``--steps-per-dispatch`` are
refused on every subcommand as ``train`` refuses them. ``import-hf`` and
``lint`` exit 2 with items 7 and 12.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .config import (add_config_flags, add_train_flags, config_from_args,
                     config_override_args, flag_args)
from .serve.rpc import DISAGG_ITEM

#: the reason the port refuses ``--rng-impl``
RNG_IMPL_REASON = ("ground rules (the TPU 'rbg' generator is TPU "
                   "scaffolding, and jax.random streams cannot be matched: "
                   "the port draws from torch generators)")
#: the reason the port refuses ``--backend`` (the JAX flag takes 'jax')
BACKEND_REASON = ("ground rules (this package is the PyTorch backend; the "
                  "JAX backend is python -m replicatinggpt_tpu)")
#: the ROADMAP.md items unported flags wait for
TELEMETRY_ITEM = "queue A item 12 (telemetry)"
WEIGHT_QUANT_ITEM = "queue A item 8 (weight quantization)"

#: (flag, dest, value that means "off", ROADMAP.md item that brings it):
#: the serve-replay subcommand's (CONFIG_UNPORTED_FLAGS join it below)
UNPORTED_FLAGS = (
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
    ("--weight-quant", "weight_quant", "none", WEIGHT_QUANT_ITEM),
    ("--act-quant", "act_quant", "none", WEIGHT_QUANT_ITEM),
    ("--trace-out", "trace_out", None, TELEMETRY_ITEM),
    ("--metrics-timeline", "metrics_timeline", None, TELEMETRY_ITEM),
    ("--metrics-timeline-interval", "metrics_timeline_interval", None,
     TELEMETRY_ITEM),
    ("--metrics-out", "metrics_out", None, TELEMETRY_ITEM),
    ("--profile-dir", "profile_dir", None, TELEMETRY_ITEM),
    ("--profile-start", "profile_start", None, TELEMETRY_ITEM),
    ("--profile-steps", "profile_steps", None, TELEMETRY_ITEM),
)


#: the train subcommand's unported flags, in the same form
TRAIN_UNPORTED_FLAGS = (
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
    ("--backend", "backend", None, BACKEND_REASON),
    ("--coordinator", "coordinator", None,
     "ground rules (multi-process training runs under torchrun, which "
     "sets the rendezvous: torchrun --nproc-per-node N -m "
     "replicatinggpt_tpu_torch train ...)"),
    ("--num-processes", "num_processes", None,
     "ground rules (torchrun --nproc-per-node N sets the process count)"),
    ("--process-id", "process_id", None,
     "ground rules (torchrun sets each process's rank)"),
    ("--trace-out", "trace_out", None, TELEMETRY_ITEM),
    ("--profile-dir", "profile_dir", None, TELEMETRY_ITEM),
    ("--profile-start", "profile_start", None, TELEMETRY_ITEM),
    ("--profile-steps", "profile_steps", None, TELEMETRY_ITEM),
    ("--profile-port", "profile_port", None, TELEMETRY_ITEM),
    ("--steps-per-dispatch", "steps_per_dispatch", 1,
     "ground rules (the K-step dispatch scan is TPU scaffolding; each "
     "step is one dispatch here)"),
    ("--tp", "tp", 1, "queue A item 11 (tensor parallelism)"),
    ("--pp", "pp", 1, "queue A item 11 (pipeline parallelism)"),
    ("--microbatches", "microbatches", 0,
     "queue A item 11 (pipeline parallelism)"),
)

#: the flags of JAX's add_config_flags that no subcommand of this port
#: implements (``train`` refuses them in its own list)
CONFIG_UNPORTED_FLAGS = tuple(
    f for f in TRAIN_UNPORTED_FLAGS
    if f[0] in ("--backend", "--steps-per-dispatch", "--tp", "--pp",
                "--microbatches"))
UNPORTED_FLAGS += CONFIG_UNPORTED_FLAGS

#: (flag, dest, refused value, ROADMAP.md item): ported flags with a value
#: this port does not implement yet
TRAIN_UNPORTED_VALUES = (
    ("--attention", "attention_impl", "ulysses",
     "queue A item 11 (Ulysses attention)"),
)


def _add_unported_flags(p: argparse.ArgumentParser,
                        flags=UNPORTED_FLAGS) -> None:
    for flag, dest, off, _ in flags:
        if isinstance(off, bool):
            p.add_argument(flag, dest=dest, action="store_true")
        else:
            kind = type(off) if off is not None else str
            p.add_argument(flag, dest=dest, type=kind, default=off,
                           help="not in this port yet (see ROADMAP.md)")


def check_unported(args: argparse.Namespace, flags=UNPORTED_FLAGS,
                   values=()) -> None:
    """Raise for any unported flag set away from its off value, and for
    any flag set to an unported value of ``values``."""
    for flag, dest, off, item in flags:
        if getattr(args, dest) != off:
            raise SystemExit(
                f"{flag} is not implemented in replicatinggpt_tpu_torch "
                f"yet: ROADMAP.md {item}")
    for flag, dest, value, item in values:
        if getattr(args, dest, None) == value:
            raise SystemExit(
                f"{flag} {value} is not implemented in "
                f"replicatinggpt_tpu_torch yet: ROADMAP.md {item}")


def add_engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pool-size", type=int, default=8,
                   help="decode slots of the engine")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission queue bound (backpressure past it)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prompt tokens per prefill chunk "
                        "(0 = min(64, block_size))")
    p.add_argument("--page-size", type=int, default=0,
                   help="tokens per KV page (0 = min(16, block_size))")
    p.add_argument("--max-pages", type=int, default=0,
                   help="logical KV pages per slot (0 = "
                        "ceil(block_size / page_size))")
    p.add_argument("--n-pages", type=int, default=0,
                   help="physical KV pages in the pool (0 = pool_size * "
                        "pages per slot)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable radix prefix reuse (pages only)")
    p.add_argument("--paged-kernel", action="store_true",
                   help="decode through the paged kernels (packed layout; "
                        "CUDA on the card, their plain versions on the "
                        "CPU): all layers in one fused launch where its "
                        "envelope holds, else the per-layer attention "
                        "kernel; the route and any failed gate are "
                        "reported in the summary's kernel_route")
    p.add_argument("--kv-quant", default="none",
                   choices=["none", "int8", "fp8"],
                   help="paged KV page storage: int8 or fp8 e4m3 pages "
                        "with f32 scales (about half the bytes of a bf16 "
                        "page)")
    p.add_argument("--quant-granularity", default="page",
                   choices=["page", "head"],
                   help="KV scales per written row ('page') or per row "
                        "and head ('head')")
    p.add_argument("--mesh-shape", default="1x1",
                   help="serving mesh DATAxMODEL (e.g. 2x2): the KV pool's "
                        "pages split over data, the heads, pool channels "
                        "and weights (Megatron TP) over model; all shards "
                        "in this process, or one a process under torchrun "
                        "(whose world size must be DATA*MODEL). An axis "
                        "that does not divide is replicated (the pages "
                        "over data, the heads over model); a mesh is never "
                        "downgraded to 1x1, since that would run another "
                        "path")
    p.add_argument("--decode-window", type=int, default=1,
                   help="decode steps enqueued as one window, the state "
                        "kept on the device and one token read per "
                        "window; admissions prefill inside the windows "
                        "(mixed prefill+decode), cancels and deadlines "
                        "ride them as masks (1 = one step per read; a 1x1 "
                        "mesh only)")
    p.add_argument("--decode-window-auto", action="store_true",
                   help="auto-tune the window size from the host's share "
                        "of each window's wall: powers of two up to "
                        "--decode-window")


def engine_forward_args(args: argparse.Namespace) -> list:
    """The add_engine_flags arguments of ``args`` and its ``--device``, so
    that a worker builds the engine the launcher parsed, on the device it
    was asked for (a CPU launcher never spawns CUDA workers). The model's
    ``--dtype`` and ``--decode-cache-layout`` ride
    ``config_override_args``."""
    out = flag_args(add_engine_flags, args)
    if getattr(args, "device", None) is not None:
        out += ["--device", str(args.device)]
    return out


def engine_config_from_args(args: argparse.Namespace):
    from .parallel.mesh import parse_mesh_shape
    from .serve.engine import MESH_SPEC_ITEM, MESH_WINDOW_ITEM, EngineConfig
    d, m = parse_mesh_shape(args.mesh_shape)
    if args.decode_window > 1 and d * m > 1:
        raise SystemExit(
            f"--decode-window {args.decode_window} with --mesh-shape "
            f"{args.mesh_shape} is not implemented in "
            f"replicatinggpt_tpu_torch yet: ROADMAP.md {MESH_WINDOW_ITEM}")
    if getattr(args, "spec", "off") != "off" and d * m > 1:
        raise SystemExit(
            f"--spec {args.spec} with --mesh-shape {args.mesh_shape} is not "
            f"implemented in replicatinggpt_tpu_torch yet: ROADMAP.md "
            f"{MESH_SPEC_ITEM}")
    return EngineConfig(pool_size=args.pool_size, max_queue=args.max_queue,
                        prefill_chunk=args.prefill_chunk,
                        page_size=args.page_size, max_pages=args.max_pages,
                        n_pages=args.n_pages,
                        prefix_cache=not args.no_prefix_cache,
                        paged_kernel=args.paged_kernel,
                        kv_quant=args.kv_quant,
                        quant_granularity=args.quant_granularity,
                        mesh_data=d, mesh_model=m,
                        decode_window=args.decode_window,
                        decode_window_auto=args.decode_window_auto)


def add_checkpoint_dir_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint-dir", default=None,
                   help="use the weights of the newest step under this "
                        "directory that verifies (train/checkpoint.py)")


def load_weights(cfg, checkpoint_dir, device, what: str):
    """The model of ``cfg`` on ``device``: the newest verified step under
    ``checkpoint_dir``, or the random init from the seed when no
    directory is given or it holds no step (said on stderr). A directory
    that does not exist, or a step that fails verification, raises."""
    from .train.checkpoint import CheckpointManager
    from .train.state import weights_state
    if checkpoint_dir is not None and not os.path.isdir(checkpoint_dir):
        raise SystemExit(f"--checkpoint-dir {checkpoint_dir}: no such "
                         f"directory")
    state = weights_state(cfg.model, cfg.seed, device)
    if checkpoint_dir is None or CheckpointManager(
            checkpoint_dir).restore_latest(state) is None:
        print(f"no checkpoint found; {what} random init", file=sys.stderr)
    else:
        print(f"restored step {state.step} from {checkpoint_dir}",
              file=sys.stderr)
    return state


def cmd_serve_replay(args) -> int:
    """Replay a synthetic Poisson request trace through the engine and
    print the serving metrics summary (on rank 0 of a launch, whose ranks
    start from its weights): the weights of ``--checkpoint-dir``'s newest
    verified step, else the random init (the token ids are synthetic
    either way)."""
    check_unported(args)
    import torch.distributed as dist

    from .parallel.distributed import setup_serve
    from .serve.replay import ReplayConfig, format_summary, run_replay
    cfg = config_from_args(args)
    ecfg = engine_config_from_args(args)
    dev = setup_serve(ecfg.mesh_shape, args.device)
    model = load_weights(cfg, args.checkpoint_dir, dev, "serving").model
    launched = dist.is_initialized()
    if launched:
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p, 0)
    draft_model = draft_cfg = None
    if args.spec == "model":
        from .models.gpt import init_params
        from .serve.speculative import draft_config_from_preset
        draft_cfg = draft_config_from_preset(cfg.model, args.draft_model)
        draft_model = init_params(
            draft_cfg, torch.Generator(device=dev).manual_seed(cfg.seed + 1),
            device=dev)
        print(f"draft model: {args.draft_model} -> {draft_cfg.n_layer}L/"
              f"{draft_cfg.n_head}H/{draft_cfg.n_embd}C "
              f"({sum(p.numel() for p in draft_model.parameters()):,} "
              f"params, random init)", file=sys.stderr)
    rcfg = ReplayConfig(
        n_requests=args.n_requests, rate=args.rate, seed=args.seed or 0,
        prompt_len_min=args.prompt_len_min,
        prompt_len_max=args.prompt_len_max or cfg.model.block_size // 2,
        max_new_tokens=args.request_max_new_tokens, greedy=args.greedy,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        deadline_s=args.deadline_s, prompt_mode=args.prompt_mode,
        shared_prefix_len=args.shared_prefix_len, spec=args.spec,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = cfg.model
    main = not launched or dist.get_rank() == 0
    procs = f" over {dist.get_world_size()} processes" if launched else ""
    if main:
        print(f"serve-replay: {rcfg.n_requests} requests @ {rcfg.rate}/s, "
              f"pool {ecfg.pool_size}, queue {ecfg.max_queue}, spec "
              f"{rcfg.spec} (k={rcfg.spec_k}), mesh "
              f"{ecfg.mesh_data}x{ecfg.mesh_model}{procs}, model "
              f"{m.n_layer}L/{m.n_head}H/{m.n_embd}C {m.dtype} on {dev} "
              f"({name})", file=sys.stderr)
    summary = run_replay(model, cfg.model, rcfg, ecfg, device=dev,
                         draft_model=draft_model, draft_cfg=draft_cfg)
    if main:
        print(format_summary(summary))
        if args.json:
            print(json.dumps(summary))
    if launched:
        dist.destroy_process_group()
    return 0


def cmd_train(args) -> int:
    """Train a preset on the corpus and print the reference's log lines
    (and, with ``--sample-after``, a sample from the trained weights).
    A first SIGTERM or SIGINT finishes the step in flight, saves (with
    ``--checkpoint-dir``) and exits 0; a second SIGINT raises
    KeyboardInterrupt. Under ``torchrun`` the ranks stop at a checkpoint
    boundary on rank 0's signal (``train`` says when)."""
    check_unported(args, TRAIN_UNPORTED_FLAGS, TRAIN_UNPORTED_VALUES)
    import signal
    import threading

    from .train.checkpoint import CheckpointManager
    from .train.runner import train
    from .utils.logging import StepLogger
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    if args.mesh_shape is not None:
        from .parallel.mesh import parse_mesh_shape
        d, m = parse_mesh_shape(args.mesh_shape)
        if m > 1:
            raise SystemExit(
                f"--mesh-shape {args.mesh_shape}: a model axis in training "
                f"(tensor parallelism) is not implemented in "
                f"replicatinggpt_tpu_torch yet: ROADMAP.md queue A item 11")
        if args.dp is not None and args.dp != d:
            raise SystemExit(f"--mesh-shape {args.mesh_shape} and --dp "
                             f"{args.dp} disagree")
        args.dp = d
    cfg = config_from_args(args)
    ck = (CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir
          else None)
    stop = threading.Event()

    def _on_signal(signum, frame):
        if stop.is_set() and signum == signal.SIGINT:
            # a second Ctrl+C: out now
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        stop.set()

    prev = {sig: signal.signal(sig, _on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    logger = StepLogger(jsonl_path=args.log_jsonl)
    try:
        res = train(cfg, device=args.device, logger=logger,
                    checkpoint_manager=ck, resume=args.resume,
                    stop_event=stop)
    finally:
        logger.close()
        for sig, h in prev.items():
            signal.signal(sig, h)
    if args.sample_after and res.main:
        model = res.state.model
        _sample(model, model.cfg, res.tokenizer, args.sample_tokens,
                device=args.device)
    return 0


#: the generate subcommand's unported flags
GENERATE_UNPORTED_FLAGS = (
    ("--mesh-shape", "mesh_shape", "1x1", "queue A item 11 (meshes)"),
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
) + CONFIG_UNPORTED_FLAGS

#: the eval subcommand's unported flags
EVAL_UNPORTED_FLAGS = (
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
) + CONFIG_UNPORTED_FLAGS

#: the serve subcommand's unported flags: the trace sinks, weight
#: quantization, and the training flags JAX's serve takes (and ignores)
#: that this port does not implement
SERVE_UNPORTED_FLAGS = CONFIG_UNPORTED_FLAGS + (
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
    ("--weight-quant", "weight_quant", "none", WEIGHT_QUANT_ITEM),
    ("--act-quant", "act_quant", "none", WEIGHT_QUANT_ITEM),
    ("--trace-out", "trace_out", None, TELEMETRY_ITEM),
    ("--trace-jsonl", "trace_jsonl", None, TELEMETRY_ITEM),
)

#: the serve-worker subcommand's unported flags: disaggregation's tiers,
#: weight quantization, and the training flags no subcommand implements
SERVE_WORKER_UNPORTED_FLAGS = CONFIG_UNPORTED_FLAGS + (
    ("--rng-impl", "rng_impl", None, RNG_IMPL_REASON),
    ("--weight-quant", "weight_quant", "none", WEIGHT_QUANT_ITEM),
    ("--act-quant", "act_quant", "none", WEIGHT_QUANT_ITEM),
    ("--tier", "tier", "mixed", DISAGG_ITEM),
)

#: the JAX subcommands this port does not implement yet, with their
#: ROADMAP.md items
REFUSED_COMMANDS = {
    "import-hf": ("import HF GPT-2 weights",
                  "queue A item 7 (HF GPT-2 import)"),
    "lint": ("static analysis of the serve layer's protocol",
             "queue A item 12 (tooling and telemetry)"),
}


def _sample(model, mcfg, tokenizer, n_tokens: int, prompt_text=None,
            top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
            device=None) -> None:
    """Print ``n_tokens`` sampled after ``prompt_text`` (default: the
    reference's zero-context start, one 0 token, GPT1.py:235), drawn
    from the tokenizer's ids only: a GPT-2 preset's 50257 rows outnumber
    the corpus BPE's 1024 ids, which are all it can decode."""
    from .sample.generate import GenerateConfig, generate
    ids = tokenizer.encode(prompt_text) if prompt_text else [0]
    toks = generate(model, [ids], mcfg,
                    GenerateConfig(max_new_tokens=n_tokens, top_k=top_k,
                                   top_p=top_p, temperature=temperature,
                                   vocab_limit=tokenizer.vocab_size),
                    device=device)
    print(tokenizer.decode(toks[0].tolist()))


def _tokenized_config(args):
    """(config with the tokenizer's vocabulary, tokenizer, corpus text)."""
    from .data.dataset import load_corpus
    from .tokenizers import get_tokenizer
    from .train.runner import _resolve_vocab
    cfg = config_from_args(args)
    text = load_corpus(cfg.dataset)
    tokenizer = get_tokenizer(cfg.tokenizer, corpus_text=text)
    return _resolve_vocab(cfg, tokenizer), tokenizer, text


def cmd_generate(args) -> int:
    """Sample from the weights of ``--checkpoint-dir``'s newest verified
    step, else from the random init of the preset's seed."""
    check_unported(args, GENERATE_UNPORTED_FLAGS)
    from .device import resolve_device
    dev = resolve_device(args.device)
    cfg, tokenizer, _ = _tokenized_config(args)
    model = load_weights(cfg, args.checkpoint_dir, dev, "sampling from").model
    _sample(model, cfg.model, tokenizer, args.sample_tokens,
            prompt_text=args.prompt, top_k=args.top_k, top_p=args.top_p,
            temperature=args.temperature, device=dev)
    return 0


def cmd_eval(args) -> int:
    """Estimate the train and val loss of ``--checkpoint-dir``'s newest
    verified step (else the random init) over ``--eval-iters`` batches of
    each split, drawn from seeds 1 and 2 as the JAX package draws them."""
    check_unported(args, EVAL_UNPORTED_FLAGS)
    from .data.dataset import TokenDataset
    from .data.loader import make_batcher
    from .device import resolve_device
    from .train.steps import estimate_loss, make_eval_step
    dev = resolve_device(args.device)
    cfg, tokenizer, text = _tokenized_config(args)
    state = load_weights(cfg, args.checkpoint_dir, dev, "evaluating")
    ds = TokenDataset.from_text(text, tokenizer, cfg.train.val_fraction)
    B, T = cfg.train.batch_size, cfg.model.block_size
    batchers = {"train": make_batcher("random", ds.train, B, T, seed=1),
                "val": make_batcher("random", ds.val, B, T, seed=2)}
    out = estimate_loss(state.model.tree(), batchers,
                        make_eval_step(cfg.model), cfg.train.eval_iters, dev)
    print(f"train loss {out['train']:.4f}, val loss = {out['val']:.4f}")
    return 0


def cmd_export_torch(args) -> int:
    """Write the reference's artifact, a ``torch.save``d ``state_dict``
    in ``RefGPT``'s layout (``models.gpt.reference_state_dict``: f32 CPU
    tensors, (in, out) kernels), from ``--checkpoint-dir``'s newest
    verified step (else the random init)."""
    from .models.gpt import reference_state_dict
    check_unported(args, CONFIG_UNPORTED_FLAGS)
    cfg, _, _ = _tokenized_config(args)
    state = load_weights(cfg, args.checkpoint_dir, "cpu", "exporting")
    sd = reference_state_dict(state.model)
    with open(args.out, "wb") as f:
        torch.save(sd, f)
    print(f"exported {sum(t.numel() for t in sd.values()):,} params (step "
          f"{state.step}) to {args.out}")
    return 0


def cmd_serve(args) -> int:
    """The fleet's front door: ``--replicas`` engine replicas behind the
    prefix-affinity router (serve/router.py), over HTTP/SSE
    (serve/http.py), on the weights of ``--checkpoint-dir``'s newest
    verified step, else the random init. In this process the replicas are
    warmed (on the card: the kernels built) before the socket binds; with
    ``--multiproc`` each is a ``serve-worker`` process, and the socket
    binds once all registered. The bound address is printed as ``serving
    on http://host:port``. SIGINT shuts it down, closes the journals and
    stops every worker, after printing the fleet summary as one
    ``fleet summary: {...}`` line on stderr."""
    check_unported(args, SERVE_UNPORTED_FLAGS)
    import asyncio

    from .serve.http import RateLimitConfig, ServeApp
    from .serve.router import RouterConfig
    ledger = args.ledger
    if ledger is None and args.multiproc and args.journal_dir:
        ledger = os.path.join(args.journal_dir, "router_ledger.jsonl")
    rcfg = RouterConfig(n_replicas=args.replicas,
                        journal_dir=args.journal_dir,
                        ledger_path=ledger,
                        ledger_fsync=args.ledger_fsync,
                        affinity=not args.no_affinity,
                        wedge_budget_s=args.wedge_budget_s,
                        wedge_patience=args.wedge_patience,
                        step_timeout_s=args.step_timeout_s)
    cfg = config_from_args(args)
    ecfg = engine_config_from_args(args)
    m = cfg.model
    supervisor = None
    if args.multiproc:
        if not args.journal_dir:
            raise SystemExit("--multiproc requires --journal-dir (the base "
                             "directory of the workers' private journal "
                             "directories and the router's own ledger)")
        router, supervisor = _spawn_workers(args, rcfg, cfg, ecfg)
        where = (f"{args.replicas} worker process(es) of pool "
                 f"{ecfg.pool_size}, registration on "
                 f"{supervisor.router_addr}")
    else:
        from .device import resolve_device
        from .serve.router import Router
        dev = resolve_device(args.device)
        model = load_weights(cfg, args.checkpoint_dir, dev, "serving").model
        router = Router(model, cfg.model, rcfg, ecfg, device=dev)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        where = (f"{rcfg.n_replicas} replica(s) of pool {ecfg.pool_size} "
                 f"on {dev} ({name}); warming the replicas")
    rate_limit = None
    if args.rate_limit_rps > 0:
        rate_limit = RateLimitConfig(rps=args.rate_limit_rps,
                                     burst=args.rate_limit_burst)
    app = ServeApp(router, idle_timeout_s=args.idle_timeout_s,
                   supervisor=supervisor, rate_limit=rate_limit)
    print(f"serve: model {m.n_layer}L/{m.n_head}H/{m.n_embd}C {m.dtype}, "
          f"{where}", file=sys.stderr, flush=True)
    rc = 0
    try:
        asyncio.run(app.serve_forever(args.host, args.port))
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    except asyncio.CancelledError:
        # the stepping task died: ServeApp printed its traceback and
        # closed the server under serve_forever
        rc = 1
    finally:
        try:
            if rc == 0:
                print("fleet summary: " + json.dumps(_fleet_summary(
                    router, supervisor)), file=sys.stderr, flush=True)
        finally:
            if supervisor is not None:
                supervisor.stop_all()
            router.close()
    return rc


def _spawn_workers(args, rcfg, cfg, ecfg):
    """``serve --multiproc``: the workers' specs (this parse's model and
    engine flags, its seed, device and checkpoint), the kernels their
    route loads built here first (with ``nvcc``: the launcher holds no
    CUDA context), and the fleet, every worker registered. The fleet's
    shape hash comes from this process's parse of the same flags."""
    from .faults.procsup import (AutoscaleConfig, SupervisorConfig,
                                 make_worker_specs, spawn_fleet,
                                 worker_spec_factory)
    from .serve.rpc import engine_shape_hash
    config_args = ["--preset", args.preset] + config_override_args(args)
    engine_args = engine_forward_args(args)
    if args.no_fsync:
        engine_args.append("--no-fsync")
    if args.checkpoint_dir:
        engine_args += ["--checkpoint-dir",
                        os.path.abspath(args.checkpoint_dir)]
    if torch.device(args.device or "cuda").type == "cuda":
        from .ops import _build
        from .serve.engine import route_kernels
        for name in route_kernels(cfg.model, ecfg):
            _build.build(name)
    specs = make_worker_specs(args.replicas, args.journal_dir, config_args,
                              engine_args)
    expect = engine_shape_hash(cfg.model, ecfg)
    autoscale = spec_factory = None
    if args.autoscale_max > 0:
        autoscale = AutoscaleConfig(min_workers=args.autoscale_min,
                                    max_workers=args.autoscale_max)
        spec_factory = worker_spec_factory(args.journal_dir, config_args,
                                           engine_args)
    print(f"spawning {args.replicas} worker process(es); waiting for "
          f"warm-up and registration (expect shape {expect})",
          file=sys.stderr, flush=True)
    return spawn_fleet(
        specs, rcfg, SupervisorConfig(restart_budget=args.restart_budget,
                                      expect_shape_hash=expect),
        autoscale=autoscale, spec_factory=spec_factory,
        listen_host=args.listen_host)


def _fleet_summary(router, supervisor) -> dict:
    """The router's fleet summary, and the supervisor's per-worker
    spawn-to-registration seconds, restarts and events."""
    out = router.fleet_summary()
    if supervisor is not None:
        out["workers"] = [{"idx": h.spec.idx, "state": h.state,
                           "gen": h.gen, "restarts": h.restarts,
                           "crash_restarts": h.crash_restarts,
                           "ready_s": h.ready_s} for h in supervisor.handles]
        out["supervisor_events"] = supervisor.events[-32:]
    return out


def cmd_serve_worker(args) -> int:
    """One fleet worker process (serve/worker.py): builds and warms the
    engine, locks and replays its journal, serves the RPC protocol and
    registers with ``--router-addr``, until the router shuts it down or
    something kills it."""
    check_unported(args, SERVE_WORKER_UNPORTED_FLAGS)
    from .serve.worker import run_worker
    return run_worker(args)


class RefusedCommand(SystemExit):
    """A JAX subcommand this port does not implement yet: exits 2, as a
    refused command line does, with the ROADMAP.md item in its
    message."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.code = 2


def cmd_refused(args) -> int:
    what, item = REFUSED_COMMANDS[args.cmd]
    msg = (f"{args.cmd} ({what}) is not implemented in "
           f"replicatinggpt_tpu_torch yet: ROADMAP.md {item}")
    print(msg, file=sys.stderr)
    raise RefusedCommand(msg)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: every subcommand with its flags."""
    p = argparse.ArgumentParser(prog="replicatinggpt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="train a model")
    add_config_flags(pt)
    add_train_flags(pt)
    pt.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    pt.add_argument("--log-jsonl", default=None,
                    help="also append the step/eval/info events here as "
                         "JSON lines")
    pt.add_argument("--sample-after", action="store_true",
                    help="print a sample after training (GPT1.py:235-236)")
    pt.add_argument("--sample-tokens", type=int, default=500)
    pt.add_argument("--checkpoint-dir", default=None,
                    help="save the whole training state here every "
                         "checkpoint_every steps, at the end and on "
                         "SIGTERM/SIGINT")
    pt.add_argument("--resume", action="store_true",
                    help="continue from the newest step under "
                         "--checkpoint-dir that verifies")
    pt.add_argument("--mesh-shape", default=None,
                    help="training mesh DATAxMODEL: --dp DATA; the model "
                         "axis (tensor parallelism) must be 1")
    _add_unported_flags(pt, TRAIN_UNPORTED_FLAGS)
    pt.set_defaults(fn=cmd_train)
    pg = sub.add_parser("generate", help="sample from a model")
    add_config_flags(pg)
    add_train_flags(pg)
    pg.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    pg.add_argument("--prompt", default=None)
    pg.add_argument("--sample-tokens", type=int, default=500)
    pg.add_argument("--top-k", type=int, default=0)
    pg.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass; 0 = off")
    pg.add_argument("--temperature", type=float, default=1.0)
    add_checkpoint_dir_flag(pg)
    _add_unported_flags(pg, GENERATE_UNPORTED_FLAGS)
    pg.set_defaults(fn=cmd_generate)
    pe = sub.add_parser("eval", help="estimate train/val loss "
                                     "(--eval-iters batches of each split)")
    add_config_flags(pe)
    add_train_flags(pe)
    pe.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    add_checkpoint_dir_flag(pe)
    _add_unported_flags(pe, EVAL_UNPORTED_FLAGS)
    pe.set_defaults(fn=cmd_eval)
    px = sub.add_parser("export-torch",
                        help="write a checkpoint's weights as a torch "
                             "state_dict in the reference layout")
    add_config_flags(px)
    add_train_flags(px)
    add_checkpoint_dir_flag(px)
    px.add_argument("--out", default="model.pth")
    _add_unported_flags(px, CONFIG_UNPORTED_FLAGS)
    px.set_defaults(fn=cmd_export_torch)
    ps = sub.add_parser("serve-replay",
                        help="replay a synthetic Poisson request trace "
                             "through the paged serving engine and report "
                             "TTFT/throughput/occupancy")
    add_config_flags(ps)
    add_train_flags(ps)
    ps.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ps.add_argument("--n-requests", type=int, default=64)
    ps.add_argument("--rate", type=float, default=200.0,
                    help="mean Poisson arrival rate, requests/sec")
    add_engine_flags(ps)
    ps.add_argument("--shared-prefix-len", type=int, default=0,
                    help="--prompt-mode shared_prefix: common prefix "
                         "length (0 = prompt-len-max // 2)")
    ps.add_argument("--prompt-len-min", type=int, default=1)
    ps.add_argument("--prompt-len-max", type=int, default=0,
                    help="0 = block_size // 2")
    ps.add_argument("--request-max-new-tokens", type=int, default=16)
    ps.add_argument("--greedy", action="store_true")
    ps.add_argument("--temperature", type=float, default=1.0)
    ps.add_argument("--top-k", type=int, default=20)
    ps.add_argument("--top-p", type=float, default=0.0)
    ps.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline after arrival (0 = none)")
    ps.add_argument("--prompt-mode", default="random",
                    choices=["random", "repeat", "shared_prefix"],
                    help="'repeat' tiles small patterns (the speculative-"
                         "friendly repetitive trace); 'shared_prefix' gives "
                         "every prompt one common prefix")
    ps.add_argument("--spec", default="off",
                    choices=["off", "ngram", "model"],
                    help="speculative decoding drafter: host-side n-gram "
                         "prompt lookup (no parameters) or a small "
                         "random-init draft model (--draft-model preset); "
                         "verify through the paged kernel at W = k+1 on "
                         "the kernel route")
    ps.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per slot per step")
    ps.add_argument("--spec-ngram", type=int, default=3,
                    help="n-gram drafter match width")
    ps.add_argument("--draft-model", default="test-tiny",
                    help="--spec model: preset whose architecture sizes the "
                         "draft model (vocab/block/dtype/cache layout "
                         "forced to the target's)")
    ps.add_argument("--json", action="store_true",
                    help="also print the summary as one JSON line")
    add_checkpoint_dir_flag(ps)
    _add_unported_flags(ps)
    ps.set_defaults(fn=cmd_serve_replay)
    pv = sub.add_parser("serve",
                        help="run the HTTP/SSE serving fleet: engine "
                             "replicas (in this process, or worker processes "
                             "with --multiproc) behind the prefix-affinity "
                             "router, with submit/stream/cancel/healthz/"
                             "readyz/metrics endpoints")
    add_config_flags(pv)
    add_train_flags(pv)
    pv.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'; "
                         "a --multiproc launcher passes it to its workers")
    add_checkpoint_dir_flag(pv)
    pv.add_argument("--host", default="127.0.0.1",
                    help="interface the HTTP server binds")
    pv.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 = ephemeral; the bound one is "
                         "printed)")
    pv.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router")
    pv.add_argument("--journal-dir", default=None,
                    help="per-replica crash journals live here "
                         "(replica{i}.jsonl): a killed replica's "
                         "unfinished requests requeue from its journal; "
                         "with --multiproc (required) the base of each "
                         "worker's private directory (worker{i}/) and of "
                         "the router's ledger")
    pv.add_argument("--ledger", default=None,
                    help="the router's own crash journal: submits at "
                         "fleet acceptance, finishes at terminal results; "
                         "a restarted router requeues its unfinished set "
                         "from here (--multiproc default: "
                         "JOURNAL_DIR/router_ledger.jsonl)")
    pv.add_argument("--ledger-fsync", action="store_true",
                    help="fsync the ledger's finish records")
    pv.add_argument("--no-affinity", action="store_true",
                    help="route least-loaded only (no radix-prefix "
                         "affinity)")
    pv.add_argument("--wedge-budget-s", type=float, default=0.0,
                    help="a replica step's budget for the wedge probe (0 = "
                         "off): over it --wedge-patience times in a row, "
                         "the replica is quarantined and its in-flight "
                         "work re-routed")
    pv.add_argument("--wedge-patience", type=int, default=2)
    add_engine_flags(pv)
    pv.add_argument("--multiproc", action="store_true",
                    help="run each replica as a serve-worker process under "
                         "the supervisor (restarts, quarantine, "
                         "autoscaling); the router drives them over RPC")
    pv.add_argument("--restart-budget", type=int, default=3,
                    help="--multiproc: crash restarts a worker before it "
                         "is quarantined and its work requeued")
    pv.add_argument("--autoscale-max", type=int, default=0,
                    help="--multiproc: grow the fleet on sustained backlog "
                         "up to this many workers, shrink it on a lull "
                         "(0 = a fixed fleet)")
    pv.add_argument("--autoscale-min", type=int, default=1,
                    help="--multiproc: the autoscaler's floor")
    pv.add_argument("--listen-host", default="127.0.0.1",
                    help="--multiproc: the registration listener's "
                         "interface (0.0.0.0 takes workers from other "
                         "hosts)")
    pv.add_argument("--step-timeout-s", type=float, default=10.0,
                    help="--multiproc: a worker step RPC's budget; past "
                         "it the step counts as slow for the wedge probe")
    pv.add_argument("--no-fsync", action="store_true",
                    help="--multiproc: the workers' journals skip the "
                         "fsync of each finish record")
    pv.add_argument("--idle-timeout-s", type=float, default=30.0,
                    help="drop a connection that stalls mid-headers or "
                         "mid-body, or stops reading its SSE stream, for "
                         "this long (0 = off)")
    pv.add_argument("--rate-limit-rps", type=float, default=0.0,
                    help="per-client submit rate (a token bucket keyed on "
                         "the x-client-id header; over it, 429 and "
                         "Retry-After; 0 = off)")
    pv.add_argument("--rate-limit-burst", type=float, default=10.0,
                    help="the bucket's capacity")
    _add_unported_flags(pv, SERVE_UNPORTED_FLAGS)
    pv.set_defaults(fn=cmd_serve)
    pw = sub.add_parser("serve-worker",
                        help="one fleet worker process: an engine behind "
                             "the RPC protocol with a locked crash journal "
                             "replayed at start (spawned by serve "
                             "--multiproc; runnable by hand)")
    add_config_flags(pw)
    add_train_flags(pw)
    pw.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    add_checkpoint_dir_flag(pw)
    pw.add_argument("--host", default="127.0.0.1",
                    help="interface the RPC server binds")
    pw.add_argument("--port", type=int, default=0,
                    help="RPC port (0 = ephemeral; the bound one goes in "
                         "the register frame and the stderr banner)")
    pw.add_argument("--journal", default=None,
                    help="crash journal path (flock-ed, replayed at start; "
                         "the router reads it only through the "
                         "journal_drain RPC)")
    pw.add_argument("--router-addr", default=None,
                    help="host:port of the fleet's registration listener: "
                         "once warm, replayed and bound, the worker "
                         "registers there (protocol version and engine "
                         "shape hash; a mismatch exits 3)")
    pw.add_argument("--worker-idx", type=int, default=-1,
                    help="the supervisor's replica index (-1: unmanaged, "
                         "joins as a new replica)")
    pw.add_argument("--gen", type=int, default=0,
                    help="spawn generation (the supervisor attaches only "
                         "the incarnation it launched)")
    pw.add_argument("--no-fsync", action="store_true",
                    help="skip the fsync of each journaled finish")
    pw.add_argument("--reregister-idle-s", type=float, default=5.0,
                    help="router silence after which the worker sends its "
                         "register frame again (full-jitter backoff)")
    add_engine_flags(pw)
    _add_unported_flags(pw, SERVE_WORKER_UNPORTED_FLAGS)
    pw.set_defaults(fn=cmd_serve_worker)
    for name, (what, _) in REFUSED_COMMANDS.items():
        sub.add_parser(name, help=f"{what} (not in this port yet; see "
                                  f"ROADMAP.md)").set_defaults(fn=cmd_refused)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args, rest = p.parse_known_args(argv)
    if rest and args.fn is not cmd_refused:
        # the refused JAX subcommands take the JAX flags unread
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)
