#!/usr/bin/env python3
"""Where a ``generate()`` token of the PyTorch port spends its time, on
one NVIDIA card.

    python3 tools/torch_port_generate_profile.py [--tokens 256] [--out PATH]

Two configurations at random init, bf16: char-GPT at B=1 (the fused
all-layers decode kernel, ``csrc/fused_decode_layers.cu``) and GPT-2
124M with the packed cache at B=8 (the packed decode attention kernel,
``csrc/packed_decode_attention.cu``), each from a one-token prompt for
``--tokens`` greedy tokens (one prefill and one decode segment when
``--tokens`` <= block_size). Each is warmed up, timed with the host clock
(ending in a device sync), then traced with ``torch.profiler``. From the
trace: device busy time per token (the union of kernel intervals), the
device's idle share of the traced window and of the untraced wall time,
kernels per token, the decode kernel's share of busy time, and device
time by kernel name. Prints one JSON object per configuration, and
writes the list to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from torch_port_profile import (busy_us, card, device_kernels,  # noqa: E402
                                us_by_name)

from replicatinggpt_tpu_torch.config import get_config  # noqa: E402
from replicatinggpt_tpu_torch.models.gpt import init_params  # noqa: E402
from replicatinggpt_tpu_torch.sample.generate import (  # noqa: E402
    GenerateConfig, generate)


def profile_one(mcfg, batch: int, n: int, kernel: str) -> dict:
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    prompt = [[0]] * batch
    gcfg = GenerateConfig(max_new_tokens=n, greedy=True)

    def run():
        generate(model, prompt, mcfg, gcfg).cpu()

    run()                                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    by_name = us_by_name(kernels)
    busy_ms = busy_us(kernels) / 1e3
    mine = sum(us for name, us in by_name.items() if kernel in name)
    return {
        "card": card(), "config": f"{mcfg.n_layer}L/{mcfg.n_embd}C "
        f"{mcfg.decode_cache_layout} {mcfg.dtype}", "batch": batch,
        "tokens": n, "wall_ms_per_token": round(wall_ms / n, 4),
        "traced_wall_ms_per_token": round(traced_ms / n, 4),
        "device_busy_ms_per_token": (round(busy_ms / n, 4) if kernels
                                     else "not measured"),
        "device_idle_share": (round(1.0 - busy_ms / traced_ms, 4)
                              if kernels else "not measured"),
        "device_idle_share_of_untraced_wall": (
            round(1.0 - busy_ms / wall_ms, 4) if kernels
            else "not measured"),
        "kernels_per_token": round(len(kernels) / n, 2),
        "decode_kernel": kernel,
        "decode_kernel_us_per_token": round(mine / n, 2),
        "decode_kernel_share_of_busy": (round(mine / 1e3 / busy_ms, 4)
                                        if kernels else "not measured"),
        "device_us_per_token_by_kernel": {
            k: round(us / n, 2)
            for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tokens", type=int, default=256)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    small = dataclasses.replace(get_config("gpt2-small").model,
                                decode_cache_layout="packed")
    rows = [profile_one(get_config("char-gpt").model, 1, args.tokens,
                        "fused_decode_kernel"),
            profile_one(small, 8, args.tokens, "packed_decode_kernel")]
    for row in rows:
        print(json.dumps(row))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
