#!/usr/bin/env python3
"""Where one launch of the fused B=1 decode kernel spends its time, phase
by phase, on one NVIDIA card.

    python3 tools/torch_port_fused_stamps.py [--pos 255] [--out PATH]

Builds ``csrc/fused_decode_layers.cu`` with ``-DFUSED_DECODE_STAMPS``
(a library of its own under ``build/kernels/``), which turns the
source's ``STAMP(layer, point)`` marks into ``clock64()`` writes by
thread 0 of every block. It then runs char-GPT (L=6, C=384, H=6, bf16,
heads cache, the smoke's inputs) at ``--pos``, three launches after an
L2 flush and three warm, and prints, per step of a layer, the median
over the blocks that run it of the cycles the step took (``sync*``: the
wait for the slowest block plus the barrier), per layer, and the SM
clock. Steps: resid, ln1, qkv, sync1 | attend (the attention blocks:
a.sums, a.kvwait, a.scores, a.softmax, a.pv inside it), proj, sync2 |
resid2, ln2, up, sync3 | downin, down (the MLP-down blocks), sync4.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (stamp, previous stamp, name, blocks: all / attention / down)
STEPS = [(1, 0, "resid", "all"), (2, 1, "ln1", "all"), (3, 2, "qkv", "all"),
         (4, 3, "sync1", "attn"), (5, 4, "attend", "attn"),
         (16, 4, "a.sums", "attn"), (17, 16, "a.kvwait", "attn"),
         (18, 17, "a.scores", "attn"), (19, 18, "a.softmax", "attn"),
         (20, 19, "a.pv", "attn"), (6, 5, "proj", "attn"),
         (7, 6, "sync2", "all"), (8, 7, "resid2", "all"),
         (9, 8, "ln2", "all"), (10, 9, "up", "all"),
         (11, 10, "sync3", "down"), (12, 11, "downin", "down"),
         (13, 12, "down", "down"), (14, 13, "sync4", "all")]


def read_stamps(lib, buf, grid: int, n_layer: int):
    """The stamps of the last launch, (grid, n_layer, 24) cycles."""
    import numpy as np
    if lib.fused_decode_stamps(buf) != 0:
        raise SystemExit("reading the stamps failed")
    return np.array(buf, dtype=np.int64).reshape(160, 6, 24)[:grid, :n_layer]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pos", type=int, default=255)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from replicatinggpt_tpu_torch.config import get_config
    from replicatinggpt_tpu_torch.ops import _build
    from replicatinggpt_tpu_torch.ops import decode as dec
    # every library this process builds takes the flag (a hash of its own)
    _build.NVCC_FLAGS += ("-DFUSED_DECODE_STAMPS",)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    char = dataclasses.replace(get_config("char-gpt").model)
    L = char.n_layer
    x0, blocks, cache = chip_smoke.fused_inputs(char, torch.bfloat16,
                                                args.pos)
    lib = _build.load("fused_decode_layers")
    buf = (ctypes.c_longlong * (160 * 6 * 24))()
    plan = dec.fused_decode_plan(char.n_embd, char.n_head, char.block_size,
                                 torch.bfloat16, "cuda")
    grid = plan["grid"]
    n_attn = plan["proj_tiles"] * plan["proj_splits"]
    n_down = plan["down_tiles"] * plan["down_splits"]
    rows = {"all": slice(0, grid), "attn": slice(grid - n_attn, grid),
            "down": slice(0, n_down)}
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result = {"card": clock, "pos": args.pos, "grid": grid}
    for label, flushed in (("flushed", True), ("warm", False)):
        for _ in range(3):
            if flushed:
                flush.zero_()
            dec.fused_decode_layers(x0, blocks, args.pos, cache, char)
            torch.cuda.synchronize()
        a = read_stamps(lib, buf, grid, L)
        steps = {}
        for k, prev, name, who in STEPS:
            d = a[rows[who], :, k] - a[rows[who], :, prev]
            steps[name] = [int(np.median(d[:, i])) for i in range(L)]
        total = a[:, L - 1, 14] - a[:, 0, 0]
        result[label] = {"total_cycles": int(np.median(total)),
                         "steps": steps}
        print(f"{label}: {int(np.median(total))} cycles, layers 0-{L - 1}")
        for name, v in steps.items():
            print(f"  {name:9s} {v}")
    print(f"card, power limit, SM clock: {clock}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
