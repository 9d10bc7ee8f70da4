#!/usr/bin/env python3
"""Where a train step of the PyTorch port's char-GPT training slice spends
its time, on one NVIDIA card.

    python3 tools/torch_port_train_profile.py [--steps 10] [--out PATH]

Builds the ``train --preset char-gpt`` step (6 layers, C=384, H=6,
T=256, B=64, bf16 compute, dropout 0.2, random init), warms it up, then
times ``--steps`` steps with the host clock (ending in a device sync) and
traces the same number with ``torch.profiler``. From the trace: the
device's busy time (the union of kernel intervals), its idle share of
the traced window (which the profiler's own overhead stretches) and of
the untraced steps' wall time, the share of the flash attention kernels
(``csrc/flash_packed.cu``), and device time by kernel name. Prints one
JSON object, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
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

from replicatinggpt_tpu_torch.config import get_config  # noqa: E402
from replicatinggpt_tpu_torch.data.loader import RandomBatcher  # noqa: E402
from replicatinggpt_tpu_torch.tokenizers import CharTokenizer  # noqa: E402
from replicatinggpt_tpu_torch.train.state import \
    create_train_state  # noqa: E402
from replicatinggpt_tpu_torch.train.steps import make_train_step  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_config("char-gpt")
    mcfg, tcfg = cfg.model, cfg.train
    text = (REPO / cfg.dataset).read_text(encoding="utf-8")
    tokens = CharTokenizer.from_text(text).encode_np(text)
    batcher = RandomBatcher(tokens, tcfg.batch_size, mcfg.block_size,
                            seed=tcfg.seed)
    state = create_train_state(mcfg, tcfg, "cuda")
    step = make_train_step(mcfg, tcfg)

    def batch():
        return tuple(torch.from_numpy(a.astype(np.uint8)).cuda()
                     for a in batcher.next_batch())

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
    flash = {k: sum(us for n, us in by_name.items()
                    if f"namespace)::{k}<" in n)
             for k in ("fwd_kernel", "dkv_kernel", "dq_kernel")}
    n = args.steps
    row = {
        "card": card(), "steps": n, "batch": tcfg.batch_size,
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
