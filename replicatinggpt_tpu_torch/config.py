"""Model and training configuration for the PyTorch/CUDA port.

A copy of the subset of ``replicatinggpt_tpu/config.py`` that the ported
paths need: the ``ModelConfig`` architecture record, the ``TrainConfig``
optimization schedule, the presets (the GPT-2 ladder ``gpt2-small``,
``gpt2-medium``, ``gpt2-large``, ``gpt2-xl``; ``gpt2-shakespeare``,
``char-gpt``, ``char-gpt1-ref``, ``test-tiny``) and the CLI overlay.
``remat`` / ``remat_policy`` are the memory trade the larger presets
need (``torch.utils.checkpoint`` per block, ``models/gpt.py``).
``MeshConfig`` (``Config.mesh``) carries the JAX mesh axes; this port
runs the data axis (``--dp``, with ``--fsdp``) and the seq axis
(``--sp``, ring attention), ``parallel/``, and refuses the others
(ROADMAP.md queue A item 11). ``attention_impl`` picks the
core on a seq axis by the JAX rule (``parallel.select_attention_fn``);
without one, the port's own route rule (``ops/flash_attention.py``)
stands whatever it says. TPU dispatch knobs (``use_layer_scan``,
``scan_layers``, ``steps_per_dispatch``) have no counterpart here:
PyTorch runs the layer loop eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-only pre-LN transformer LM (fields and defaults as in the
    JAX package's ``ModelConfig``)."""

    vocab_size: int = 65
    block_size: int = 256
    n_layer: int = 6
    n_head: int = 6
    n_embd: int = 384
    dropout: float = 0.2          # residual + MLP dropout
    attn_dropout: float = 0.2     # dropout on attention weights
    tied_head: bool = True        # wte doubles as the output head
    activation: str = "gelu"      # 'gelu' (tanh approximation) | 'relu'
    layernorm_eps: float = 1e-5
    init_std: float = 0.02        # residual projections: std/sqrt(2L)
    dtype: str = "bfloat16"       # compute dtype; master params stay f32
    loss_chunk: int = 0           # rows of (B*T, V) logits per training CE
                                  # chunk; 0 = the one-shot head
    decode_cache_layout: str = "heads"   # 'heads' (L,N,H,page,D) |
                                         # 'packed' (L,N,page,C)
    remat: bool = False           # recompute each block in the backward
    remat_policy: str = "full"    # 'full' (save nothing) | 'dots' (save
                                  # the matrix products' outputs) |
                                  # 'dots_no_batch' (only those with no
                                  # batch dimensions)
    attention_impl: str = "auto"  # the core on a seq axis: 'auto' |
                                  # 'ring' | 'flash' (= 'auto'); 'ulysses'
                                  # and 'einsum' raise there

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def validate(self) -> "ModelConfig":
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} not divisible by "
                             f"n_head={self.n_head}")
        if self.activation not in ("gelu", "relu"):
            raise ValueError(f"activation {self.activation!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r}; have {sorted(DTYPES)}")
        if self.decode_cache_layout not in ("heads", "packed"):
            raise ValueError(f"decode_cache_layout "
                             f"{self.decode_cache_layout!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}; have "
                             f"{REMAT_POLICIES}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r}; have "
                             f"{ATTENTION_IMPLS}")
        return self


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_POLICIES = ("full", "dots", "dots_no_batch")
ATTENTION_IMPLS = ("auto", "einsum", "flash", "ring", "ulysses")


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's logical mesh (``data``, ``seq``, ``model``,
    ``pipe`` axes, ``fsdp``, pipeline ``microbatches``). This port runs
    the ``data`` axis (with ``fsdp``: ZeRO-3 over it) and the ``seq``
    axis; ``validate`` refuses the others.

    ``preset``: the data axis and FSDP came from a preset, not from the
    command line. A launch that cannot fill such a mesh (``data x seq``
    processes; one without a launcher) runs without them, as the JAX
    CLI's ``_build_mesh_if_needed`` degrades a mesh its devices cannot
    hold (``resolve_mesh``)."""

    data: int = 1
    seq: int = 1
    model: int = 1
    pipe: int = 1
    fsdp: bool = False
    microbatches: int = 0
    preset: bool = False

    @property
    def n_devices(self) -> int:
        return self.data * self.seq * self.model * self.pipe

    def validate(self) -> "MeshConfig":
        if min(self.data, self.seq, self.model, self.pipe) < 1:
            raise ValueError(f"mesh axes must be >= 1: {self}")
        if (self.model, self.pipe, self.microbatches) != (1, 1, 0):
            raise NotImplementedError(
                f"mesh {self}: tensor and pipeline parallelism in training "
                f"are not in replicatinggpt_tpu_torch yet: ROADMAP.md queue "
                f"A item 11 (the data axis, --dp/--fsdp, and the seq axis, "
                f"--sp, run)")
        return self


def resolve_mesh(mesh: MeshConfig, devices: int, warn=None) -> MeshConfig:
    """The mesh a run of ``devices`` processes trains on: a preset's data
    axis (and its FSDP) that ``data x seq`` processes would have to fill
    and this launch does not is dropped with the JAX CLI's warning ("mesh
    wants N devices, have M; running unsharded"); an axis given on the
    command line is kept (one process then holds all its shards)."""
    if mesh.preset and mesh.data > 1 and mesh.n_devices != devices:
        if warn is not None:
            warn(f"mesh wants {mesh.n_devices} devices, have {devices}; "
                 f"running unsharded")
        return dataclasses.replace(mesh, data=1, fsdp=False, preset=False)
    return mesh


@dataclass(frozen=True)
class TrainConfig:
    """Optimization and loop schedule (the JAX ``TrainConfig`` without
    its TPU dispatch fields; the checkpoint directory is the CLI's
    ``--checkpoint-dir``)."""

    batch_size: int = 64
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    grad_clip: float = 0.0           # 0 = off
    max_iters: int = 3000
    warmup_iters: int = 0
    lr_schedule: str = "constant"    # 'constant' | 'cosine'
    min_lr: float = 0.0
    eval_interval: int = 200
    eval_iters: int = 200
    log_interval: int = 10
    grad_accum_steps: int = 1        # microbatches averaged per step
    seed: int = 1337
    sampling: str = "random"         # 'random' | 'sequential'
    val_fraction: float = 0.1        # 90/10 split
    checkpoint_every: int = 0        # 0 = only at the end


@dataclass(frozen=True)
class Config:
    """A preset: the model, its training schedule, tokenizer and corpus.
    ``seed`` (the training seed) also seeds ``serve-replay``'s random
    weights."""

    name: str
    model: ModelConfig
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    tokenizer: str = "char"
    dataset: str = "datasets/shakespeare.txt"

    @property
    def seed(self) -> int:
        return self.train.seed


def _gpt2_ladder(n_layer: int, n_head: int, n_embd: int,
                 remat: bool = False) -> ModelConfig:
    """A GPT-2 size (vocab 50257, context 1024, gelu, tied head, no
    dropout); remat from 350M up, where the JAX package needs it to fit
    a device's memory."""
    return ModelConfig(vocab_size=50257, block_size=1024, n_layer=n_layer,
                       n_head=n_head, n_embd=n_embd, dropout=0.0,
                       attn_dropout=0.0, tied_head=True, activation="gelu",
                       remat=remat)


PRESETS = {
    # GPT-2 124M (vocab 50257, context 1024), the JAX preset of the
    # same name (BASELINE config 3) with its 8-way data mesh; a launch of
    # another size runs it unsharded (``resolve_mesh``), so one card
    # trains the global batch of 32 alone.
    "gpt2-small": Config(
        name="gpt2-small", model=_gpt2_ladder(12, 12, 768),
        train=TrainConfig(batch_size=32, lr=3e-4, max_iters=1000,
                          sampling="sequential", lr_schedule="cosine",
                          warmup_iters=100, grad_clip=1.0),
        mesh=MeshConfig(data=8, preset=True), tokenizer="bpe"),
    # GPT-2 350M (BASELINE config 4), 774M and 1.558B, the JAX presets of
    # the same names with their 16-way FSDP meshes (unsharded on a launch
    # of another size; gradient accumulation then sizes the global batch
    # to one card's memory)
    "gpt2-medium": Config(
        name="gpt2-medium", model=_gpt2_ladder(24, 16, 1024, remat=True),
        train=TrainConfig(batch_size=64, lr=3e-4, max_iters=1000,
                          sampling="sequential", lr_schedule="cosine",
                          warmup_iters=100, grad_clip=1.0),
        mesh=MeshConfig(data=16, fsdp=True, preset=True), tokenizer="bpe"),
    "gpt2-large": Config(
        name="gpt2-large", model=_gpt2_ladder(36, 20, 1280, remat=True),
        mesh=MeshConfig(data=16, fsdp=True, preset=True), tokenizer="bpe"),
    "gpt2-xl": Config(
        name="gpt2-xl", model=_gpt2_ladder(48, 25, 1600, remat=True),
        mesh=MeshConfig(data=16, fsdp=True, preset=True), tokenizer="bpe"),
    # the reference's GPT-2.py training run (B=4, lr 3e-4, 50 steps,
    # sequential batches, a loss line every step, no periodic eval), at
    # T=256 and the BPE's vocabulary padded to 50304: the JAX preset of
    # the same name
    "gpt2-shakespeare": Config(
        name="gpt2-shakespeare",
        model=ModelConfig(vocab_size=50304, block_size=256, n_layer=6,
                          n_head=6, n_embd=384, dropout=0.0,
                          attn_dropout=0.0, tied_head=True,
                          activation="gelu"),
        train=TrainConfig(batch_size=4, lr=3e-4, max_iters=50,
                          eval_interval=0, eval_iters=20, seed=1337,
                          sampling="sequential", log_interval=1),
        tokenizer="bpe"),
    # canonical char-GPT: untied head, ReLU, dropout 0.2
    "char-gpt": Config(
        name="char-gpt",
        model=ModelConfig(vocab_size=65, block_size=256, n_layer=6,
                          n_head=6, n_embd=384, dropout=0.2,
                          attn_dropout=0.2, tied_head=False,
                          activation="relu"),
        train=TrainConfig(batch_size=64, lr=2e-4, max_iters=3000,
                          eval_interval=200, eval_iters=200, seed=1337,
                          sampling="random"),
        tokenizer="char"),
    # the reference's GPT1.py as committed (n_embd=126: D=21)
    "char-gpt1-ref": Config(
        name="char-gpt1-ref",
        model=ModelConfig(vocab_size=65, block_size=256, n_layer=6,
                          n_head=6, n_embd=126, dropout=0.2,
                          attn_dropout=0.2, tied_head=False,
                          activation="relu"),
        train=TrainConfig(batch_size=64, lr=2e-4, max_iters=3000,
                          eval_interval=200, eval_iters=200, seed=1337,
                          sampling="random"),
        tokenizer="char"),
    # tiny config for tests and smoke runs
    "test-tiny": Config(
        name="test-tiny",
        model=ModelConfig(vocab_size=65, block_size=32, n_layer=2,
                          n_head=2, n_embd=32, dropout=0.0,
                          attn_dropout=0.0, tied_head=True,
                          activation="gelu", dtype="float32"),
        train=TrainConfig(batch_size=8, lr=1e-3, max_iters=50,
                          eval_interval=25, eval_iters=4, log_interval=10),
        tokenizer="char"),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


#: (dest, flag) model-shape overrides registered by add_config_flags
MODEL_OVERRIDE_FLAGS = (
    ("vocab_size", "--vocab-size"), ("block_size", "--block-size"),
    ("n_layer", "--n-layer"), ("n_head", "--n-head"),
    ("n_embd", "--n-embd"), ("dtype", "--dtype"),
    ("decode_cache_layout", "--decode-cache-layout"),
    ("remat_policy", "--remat-policy"),
)

#: (dest, flag, type) training overrides registered by add_train_flags
TRAIN_OVERRIDE_FLAGS = (
    ("batch_size", "--batch-size", int), ("lr", "--lr", float),
    ("max_iters", "--max-iters", int),
    ("eval_interval", "--eval-interval", int),
    ("eval_iters", "--eval-iters", int),
    ("grad_accum_steps", "--grad-accum-steps", int),
    ("warmup_iters", "--warmup-iters", int), ("min_lr", "--min-lr", float),
    ("grad_clip", "--grad-clip", float),
    ("log_interval", "--log-interval", int),
)


def add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="char-gpt", choices=sorted(PRESETS))
    for dest, flag in MODEL_OVERRIDE_FLAGS[:5]:
        p.add_argument(flag, f"--{dest}", dest=dest, type=int, default=None)
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES))
    p.add_argument("--decode-cache-layout", dest="decode_cache_layout",
                   default=None, choices=["heads", "packed"],
                   help="paged KV pool layout: 'heads' (L,N,H,page,D) "
                        "or 'packed' (L,N,page,C); the CUDA paged "
                        "attention kernel needs 'packed'")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute each block in the backward "
                        "(torch.utils.checkpoint; trades operations for "
                        "memory)")
    p.add_argument("--no-remat", dest="remat", action="store_false",
                   help="turn off the preset's remat (the 350M+ presets "
                        "default it on)")
    p.add_argument("--remat-policy", dest="remat_policy", default=None,
                   choices=list(REMAT_POLICIES),
                   help="what a recomputed block keeps: 'full' nothing, "
                        "'dots'/'dots_no_batch' the matrix products' "
                        "outputs")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (also seeds serve-replay's random "
                        "weights and trace)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    """The training overrides the JAX ``add_config_flags`` gives every
    subcommand, under the JAX names. A subcommand that does not train
    takes them as the JAX one does: parsed into the config, and unused by
    it."""
    p.add_argument("--dropout", type=float, default=None,
                   help="residual and attention dropout rate")
    p.add_argument("--loss-chunk", dest="loss_chunk", type=int,
                   default=None,
                   help="chunked training CE head: rows per chunk "
                        "(0 = one-shot logits)")
    for dest, flag, kind in TRAIN_OVERRIDE_FLAGS:
        p.add_argument(flag, dest=dest, type=kind, default=None)
    p.add_argument("--lr-schedule", dest="lr_schedule", default=None,
                   choices=["constant", "cosine"])
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--dataset", default=None,
                   help="corpus the tokenizer's vocabulary comes from")
    p.add_argument("--dp", type=int, default=None,
                   help="mesh data axis size: split every batch's rows into "
                        "this many shards (all in this process, or one per "
                        "torchrun process) and average their gradients")
    p.add_argument("--fsdp", action="store_true", default=None,
                   help="also shard the f32 masters and AdamW's moments "
                        "over the data axis (ZeRO-3): each block's weights "
                        "gathered for its forward and backward, gradients "
                        "reduce-scattered to their shards")
    p.add_argument("--sp", type=int, default=None,
                   help="mesh seq axis size: split every sequence into this "
                        "many shards, their attention the ring (all in this "
                        "process, or one per torchrun process)")
    p.add_argument("--attention", dest="attention_impl", default=None,
                   choices=list(ATTENTION_IMPLS),
                   help="the attention core on a seq axis: 'auto' (Ulysses "
                        "where the heads divide by --sp, else the ring), "
                        "'ring', 'flash' (= 'auto'); 'ulysses' is not "
                        "ported yet")


def flag_args(register, args: argparse.Namespace,
              skip: Tuple[str, ...] = ()) -> list:
    """The values on ``args`` of the flags that ``register`` adds to a
    parser, as command-line arguments that parse back to them: a flag
    that takes a value when it is set (not None), a switch when ``args``
    holds the value it stores and not the default. So one process spawns
    another, a fleet's worker, with what it parsed, each flag defined
    only where it is registered."""
    p = argparse.ArgumentParser(add_help=False)
    register(p)
    defaults = vars(p.parse_args([]))
    out: list = []
    for a in p._actions:
        if not a.option_strings or a.dest in skip or not hasattr(args,
                                                                 a.dest):
            continue
        v = getattr(args, a.dest)
        if a.nargs == 0:
            if v == a.const and v != defaults[a.dest]:
                out.append(a.option_strings[0])
        elif v is not None:
            out += [a.option_strings[0], str(v)]
    return out


def config_override_args(args: argparse.Namespace) -> list:
    """The flags of ``add_config_flags`` (but ``--preset``) and of
    ``add_train_flags`` set on ``args``, as command-line arguments: the
    worker of ``serve --multiproc`` parses them into the launcher's
    config."""
    return (flag_args(add_config_flags, args, skip=("preset",))
            + flag_args(add_train_flags, args))


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = get_config(args.preset)
    mk = {dest: getattr(args, dest) for dest, _ in MODEL_OVERRIDE_FLAGS
          if getattr(args, dest, None) is not None}
    if getattr(args, "dropout", None) is not None:
        mk["dropout"] = mk["attn_dropout"] = args.dropout
    for dest in ("loss_chunk", "remat", "attention_impl"):
        if getattr(args, dest, None) is not None:
            mk[dest] = getattr(args, dest)
    tk = {dest: getattr(args, dest) for dest, _, _ in TRAIN_OVERRIDE_FLAGS
          if getattr(args, dest, None) is not None}
    for dest in ("seed", "lr_schedule"):
        if getattr(args, dest, None) is not None:
            tk[dest] = getattr(args, dest)
    ck = {dest: getattr(args, dest) for dest in ("tokenizer", "dataset")
          if getattr(args, dest, None) is not None}
    mesh = cfg.mesh
    if getattr(args, "sp", None) is not None:
        mesh = dataclasses.replace(mesh, seq=args.sp)
    if getattr(args, "dp", None) is not None:
        mesh = dataclasses.replace(mesh, data=args.dp, preset=False)
    if getattr(args, "fsdp", None):
        mesh = dataclasses.replace(mesh, fsdp=True)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **mk).validate(),
        train=dataclasses.replace(cfg.train, **tk), mesh=mesh.validate(),
        **ck)
