#!/usr/bin/env python3
"""Where a train step of the PyTorch port's training slices spends its
time, on one NVIDIA card.

    python3 tools/torch_port_train_profile.py [--preset gpt2-small] \
        [--steps 10] [--out PATH]
    python3 tools/torch_port_train_profile.py --preset gpt2-xl \
        --batch-size 16 --grad-accum-steps 4 --steps 3
    python3 tools/torch_port_train_profile.py --preset gpt2-xl --sp 4 \
        --batch-size 16 --grad-accum-steps 4 --steps 3

Builds the ``train --preset <preset>`` step (char-gpt, the default: 6
layers, C=384, H=6, T=256, B=64, bf16 compute, dropout 0.2; gpt2-small:
12 layers, C=768, H=12, T=1024, B=32, vocab 50257, dropout 0; gpt2-xl:
48 layers, C=1600, H=25, remat full, its global batch of 64 as
accumulated micro-batches, ``--batch-size`` rows each; with ``--sp N``
its attention is the ring over N sequence shards in this one process,
as ``train --sp N`` runs it) at random init on batches of the preset's tokens (the BPE is trained at first use
and cached, as ``train`` does), warms it up, then
times ``--steps`` steps with the host clock (ending in a device sync) and
traces the same number with ``torch.profiler``. From the trace: the
device's busy time (the union of kernel intervals), its idle share of
the traced window (which the profiler's own overhead stretches) and of
the untraced steps' wall time, the share of the flash attention kernels
(``csrc/flash_packed.cu``: the packed, heads and chunk entry points; the
bf16 steps run its tensor-core kernels ``*_tc_kernel``), and
device time by kernel family and by kernel name. Prints one JSON object, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from torch_port_profile import (busy_us, card, device_kernels,  # noqa: E402
                                us_by_name)

from replicatinggpt_tpu_torch.config import (MeshConfig,  # noqa: E402
                                             get_config)
from replicatinggpt_tpu_torch.parallel import (  # noqa: E402
    LocalSeqGroup, select_attention_fn)
from replicatinggpt_tpu_torch.data.loader import RandomBatcher  # noqa: E402
from replicatinggpt_tpu_torch.tokenizers import get_tokenizer  # noqa: E402
from replicatinggpt_tpu_torch.train.runner import _wire_dtype  # noqa: E402
from replicatinggpt_tpu_torch.train.state import \
    create_train_state  # noqa: E402
from replicatinggpt_tpu_torch.train.steps import make_train_step  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
# device time by family: the first family whose pattern a name contains
FLASH_KERNELS = ("fwd_kernel", "dkv_kernel", "dq_kernel",      # f32 body
                 "fwd_tc_kernel", "dkv_tc_kernel", "dq_tc_kernel")  # bf16
FAMILIES = (
    ("flash attention", tuple(f"namespace)::{k}<" for k in FLASH_KERNELS)),
    ("matrix products", ("nvjet", "sm90_xmma", "gemm")),
    ("softmax and cross-entropy", ("SoftMax", "nll_loss", "log_softmax")),
    ("layernorm", ("layer_norm", "LayerNorm")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise and copies", ("elementwise", "copy", "fill")),
)


def family(name: str) -> str:
    """A kernel's family. The cuBLAS products picked for an odd width
    (the vocabulary of 50257) are the ``align1`` ones, kept apart."""
    if "align1" in name:
        return "matrix products, align1"
    return next((fam for fam, keys in FAMILIES
                 if any(k in name for k in keys)), "other")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="char-gpt",
                   choices=["char-gpt", "gpt2-small", "gpt2-xl"])
    p.add_argument("--batch-size", type=int, default=None,
                   help="rows a micro-batch (default: the preset's)")
    p.add_argument("--grad-accum-steps", type=int, default=None,
                   help="micro-batches a step (default: the preset's)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence shards, attention through the ring")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_config(args.preset)
    mcfg, tcfg = cfg.model, cfg.train
    tcfg = dataclasses.replace(tcfg, **{
        k: v for k, v in (("batch_size", args.batch_size),
                          ("grad_accum_steps", args.grad_accum_steps))
        if v is not None})
    accum = tcfg.grad_accum_steps
    text = (REPO / cfg.dataset).read_text(encoding="utf-8")
    tokens = get_tokenizer(cfg.tokenizer, corpus_text=text,
                           cache_dir=str(REPO / "datasets")).encode_np(text)
    wire = _wire_dtype(mcfg.vocab_size)
    batcher = RandomBatcher(tokens, tcfg.batch_size, mcfg.block_size,
                            seed=tcfg.seed)
    state = create_train_state(mcfg, tcfg, "cuda")
    group = attention_fn = None
    if args.sp > 1:
        group = LocalSeqGroup(args.sp)
        attention_fn = select_attention_fn(mcfg, MeshConfig(seq=args.sp),
                                           group)
    step = make_train_step(mcfg, tcfg, attention_fn, group)

    def batch():
        arrays = [batcher.next_batch() for _ in range(accum)]
        if accum == 1:
            x, y = arrays[0]
        else:
            x, y = (np.stack(a) for a in zip(*arrays))
        return tuple(torch.from_numpy(a.astype(wire)).cuda() for a in (x, y))

    batches = [batch() for _ in range(5 + 2 * args.steps)]
    for b in batches[:5]:
        step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[5:5 + args.steps]:
        step(state, b)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[5 + args.steps:]:
            step(state, b)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    by_name = us_by_name(kernels)
    busy_ms = busy_us(kernels) / 1e3
    by_family: dict = {}
    for e in kernels:
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us()
    flash = {k: sum(us for n, us in by_name.items()
                    if f"namespace)::{k}<" in n)
             for k in FLASH_KERNELS}
    flash = {k: v for k, v in flash.items() if v}
    n = args.steps
    row = {
        "card": card(), "preset": args.preset, "sp": args.sp, "steps": n,
        "batch": tcfg.batch_size, "grad_accum_steps": accum,
        "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "step_wall_ms": round(wall_ms, 4),
        "traced_step_wall_ms": round(traced_ms / n, 4),
        "device_busy_ms_per_step": (round(busy_ms / n, 4) if kernels
                                    else "not measured"),
        "device_idle_share": (round(1.0 - busy_ms / traced_ms, 4)
                              if kernels else "not measured"),
        "device_idle_share_of_untraced_wall": (
            round(1.0 - busy_ms / n / wall_ms, 4) if kernels
            else "not measured"),
        "kernels_per_step": len(kernels) / n,
        "flash_us_per_step": {k: round(v / n, 2) for k, v in flash.items()},
        "flash_share_of_busy": (round(sum(flash.values()) / 1e3 / busy_ms, 4)
                                if kernels else "not measured"),
        "device_us_per_step_by_family": {
            k: round(v / n, 2) for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
        "device_us_per_step_by_kernel": {
            k: round(us / n, 2)
            for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    print(json.dumps(row))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(row, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
