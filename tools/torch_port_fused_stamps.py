#!/usr/bin/env python3
"""Where one launch of a fused decode kernel spends its time, phase by
phase, on one NVIDIA card.

    python3 tools/torch_port_fused_stamps.py [--kernel fused|paged]
        [--pos 255] [--out PATH]

``--kernel paged``: the paged multi-slot kernel instead
(``csrc/fused_paged_decode_layers.cu`` built with
``-DFUSED_PAGED_STAMPS``) at the smoke's char-GPT serving step (B=8 at
pos 0-255, bf16 pool, ``max_pos`` the longest); steps: resid, ln1, qkv,
sync1 (the QKV blocks) | a.q (q and the fresh column summed), a.kvwait,
a.rows, a.record (the attention items) | p.wait (a projection block's
spin on its head), p.merge, proj, sync2 (the projection blocks) |
resid2, ln2, up, sync3 (the up blocks) | kvissue (the attention
blocks) | downin, down, sync4 (the MLP-down blocks); inside p.merge
its loads, factors and combine, and inside the MLP-down product its
slab wait, slices, ticket and (the tile's last block) sum. ``--pos`` is
the B=1 kernel's.

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


PAGED_STEPS = [(1, 0, "resid", "qkv"), (2, 1, "ln1", "qkv"),
               (3, 2, "qkv", "qkv"), (4, 3, "sync1", "qkv"),
               (5, 4, "a.q", "attn"), (6, 5, "a.kvwait", "attn"),
               (7, 6, "a.rows", "attn"), (8, 7, "a.record", "attn"),
               (9, 4, "p.wait", "proj"), (10, 9, "p.merge", "proj"),
               (11, 10, "proj", "proj"), (12, 11, "sync2", "proj"),
               (13, 12, "resid2", "up"), (14, 13, "ln2", "up"),
               (15, 14, "up", "up"), (16, 15, "sync3", "up"),
               (17, 16, "kvissue", "attn"), (18, 16, "downin", "down"),
               (19, 18, "down", "down"), (20, 19, "sync4", "down"),
               # inside p.merge, and inside the layer's last product (the
               # MLP-down's: its slab wait, slices, ticket, and the tile's
               # sum by its last block)
               (21, 9, "m.loads", "proj"), (22, 21, "m.factors", "proj"),
               (23, 22, "m.combine", "proj"), (24, 18, "d.slab", "down"),
               (25, 24, "d.slices", "down"), (26, 25, "d.ticket", "down"),
               (27, 26, "d.sum", "down")]
#: stamp points a layer in each kernel's build (kStampPoints)
POINTS = {"fused": 24, "paged": 32}


def read_stamps(fn, buf, grid: int, n_layer: int, points: int):
    """The stamps of the last launch, (grid, n_layer, points) cycles."""
    import numpy as np
    if fn(buf) != 0:
        raise SystemExit("reading the stamps failed")
    return np.array(buf, dtype=np.int64).reshape(160, 6, points)[
        :grid, :n_layer]


def paged_setup(dec, _build, chip_smoke, torch):
    """The paged kernel's launch, stamp reader, grid, block sets, steps
    and its stamps' first and last points."""
    args = chip_smoke.fused_paged_inputs(torch.bfloat16, "none", "page")
    mcfg = args[-1]
    lib = _build.load("fused_paged_decode_layers")
    hint = max(chip_smoke.FPOS)
    plan = chip_smoke.fused_paged_plan(args)
    grid = plan["grid"]
    n_attn = chip_smoke.FPB * mcfg.n_head * plan["attn_splits"]
    rows = {"all": slice(0, grid), "attn": slice(grid - n_attn, grid)}
    for p in ("qkv", "proj", "up", "down"):
        rows[p] = slice(0, plan[f"{p}_tiles"] * plan[f"{p}_splits"])

    def run():
        dec.fused_paged_decode_layers(*args, max_pos=hint)

    return (run, lib.fused_paged_stamps, grid, rows, PAGED_STEPS, 20,
            mcfg.n_layer, {"pos": chip_smoke.FPOS, "plan": plan})


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", choices=("fused", "paged"), default="fused")
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
    _build.NVCC_FLAGS += ("-DFUSED_DECODE_STAMPS", "-DFUSED_PAGED_STAMPS")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.kernel == "paged":
        run, read, grid, rows, steps_of, last, L, info = paged_setup(
            dec, _build, chip_smoke, torch)
    else:
        char = dataclasses.replace(get_config("char-gpt").model)
        L = char.n_layer
        x0, blocks, cache = chip_smoke.fused_inputs(char, torch.bfloat16,
                                                    args.pos)
        read = _build.load("fused_decode_layers").fused_decode_stamps
        plan = dec.fused_decode_plan(char.n_embd, char.n_head,
                                     char.block_size, torch.bfloat16, "cuda")
        grid = plan["grid"]
        n_attn = plan["proj_tiles"] * plan["proj_splits"]
        n_down = plan["down_tiles"] * plan["down_splits"]
        rows = {"all": slice(0, grid), "attn": slice(grid - n_attn, grid),
                "down": slice(0, n_down)}
        steps_of, last, info = STEPS, 14, {"pos": args.pos}

        def run():
            dec.fused_decode_layers(x0, blocks, args.pos, cache, char)

    buf = (ctypes.c_longlong * (160 * 6 * POINTS[args.kernel]))()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result = {"card": clock, "kernel": args.kernel, "grid": grid, **info}
    for label, flushed in (("flushed", True), ("warm", False)):
        for _ in range(3):
            if flushed:
                flush.zero_()
            run()
            torch.cuda.synchronize()
        a = read_stamps(read, buf, grid, L, POINTS[args.kernel])
        steps = {}
        for k, prev, name, who in steps_of:
            d = a[rows[who], :, k] - a[rows[who], :, prev]
            if name == "d.sum":   # the blocks that summed a tile (a
                # stamp older than this launch gives no span in range)
                d = np.where((d > 0) & (d < 10 ** 6), d, np.nan)
            steps[name] = [int(np.nanmedian(d[:, i])) for i in range(L)]
        total = a[:, L - 1, last] - a[:, 0, 0]
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
