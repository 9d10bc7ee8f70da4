"""Model configuration for the PyTorch/CUDA port.

A copy of the subset of ``replicatinggpt_tpu/config.py`` that the
serving path needs: the ``ModelConfig`` architecture record, the presets
``serve-replay`` runs (``gpt2-small``, ``char-gpt``, ``test-tiny``) and
the model-shape CLI overlay. TPU dispatch knobs (``use_layer_scan``,
``scan_layers``, remat, attention routing) have no counterpart here:
PyTorch runs the layer loop eagerly and the port picks its own kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

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
    tied_head: bool = True        # wte doubles as the output head
    activation: str = "gelu"      # 'gelu' (tanh approximation) | 'relu'
    layernorm_eps: float = 1e-5
    init_std: float = 0.02        # residual projections: std/sqrt(2L)
    dtype: str = "bfloat16"       # compute dtype; master params stay f32
    decode_cache_layout: str = "heads"   # 'heads' (L,N,H,page,D) |
                                         # 'packed' (L,N,page,C)

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
        return self


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Config:
    """A preset: the model plus the seed ``serve-replay`` initializes
    random weights from (the JAX preset's ``train.seed``)."""

    name: str
    model: ModelConfig
    seed: int = 1337


PRESETS = {
    # GPT-2 124M (vocab 50257, context 1024), the JAX preset of the
    # same name.
    "gpt2-small": Config(
        name="gpt2-small",
        model=ModelConfig(vocab_size=50257, block_size=1024, n_layer=12,
                          n_head=12, n_embd=768, tied_head=True,
                          activation="gelu")),
    # canonical char-GPT: untied head, ReLU
    "char-gpt": Config(
        name="char-gpt",
        model=ModelConfig(vocab_size=65, block_size=256, n_layer=6,
                          n_head=6, n_embd=384, tied_head=False,
                          activation="relu")),
    # tiny config for tests and smoke runs
    "test-tiny": Config(
        name="test-tiny",
        model=ModelConfig(vocab_size=65, block_size=32, n_layer=2,
                          n_head=2, n_embd=32, tied_head=True,
                          activation="gelu", dtype="float32")),
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
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the random weights and the replay trace")


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = get_config(args.preset)
    mk = {dest: getattr(args, dest) for dest, _ in MODEL_OVERRIDE_FLAGS
          if getattr(args, dest, None) is not None}
    model = dataclasses.replace(cfg.model, **mk).validate()
    seed = cfg.seed if args.seed is None else args.seed
    return dataclasses.replace(cfg, model=model, seed=seed)
