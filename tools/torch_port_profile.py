#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving slice spends its
time, on one NVIDIA card.

    python3 tools/torch_port_profile.py [--preset gpt2-small|char-gpt]
        [--kv-quant none|int8|fp8] [--mesh-shape 1x1|2x2|...]
        [--decode-window K] [--steps 20] [--out PATH]

Builds a ``serve-replay`` slice's engine (random init, bf16, packed pool,
8 slots, pages of 16; ``gpt2-small`` takes the per-layer kernel route,
``char-gpt`` the fused all-layers kernel route; with ``--mesh-shape``
all shards of that mesh in this process, the kernel route then the
partials mode per data shard; with ``--decode-window K`` each engine
step is a window of K decode steps), fills every slot from
one greedy shared-prefix trace, and then, for the paged-kernel route and
the gather route in turns (kernel, gather, gather, kernel), times
``--steps`` engine steps with the host clock (a blocked step ends in
the token fetch, a device sync; a window step enqueues the next window
and reads the one before) and traces the same number with
``torch.profiler``. From the trace: the device's busy time (the union of
kernel intervals), its idle share of the traced window, kernels per
step and device time by kernel name. Prints one JSON object per
measurement, and writes them all to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from replicatinggpt_tpu_torch.config import get_config  # noqa: E402
from replicatinggpt_tpu_torch.models.gpt import init_params  # noqa: E402
from replicatinggpt_tpu_torch.parallel.mesh import (  # noqa: E402
    parse_mesh_shape)
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig,  # noqa: E402
                                            ReplayConfig, make_trace)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def filled_engine(model, mcfg, kernel: bool, kv_quant: str,
                  mesh=(1, 1), window: int = 1) -> Engine:
    """An engine whose 8 slots all decode: an 8-request greedy trace
    submitted at once, stepped until no slot is left to admit and the
    first decode step (window) is behind it."""
    eng = Engine(model, mcfg, EngineConfig(
        pool_size=8, page_size=16, paged_kernel=kernel, kv_quant=kv_quant,
        mesh_data=mesh[0], mesh_model=mesh[1], decode_window=window),
        device="cuda")
    trace = make_trace(mcfg, ReplayConfig(
        n_requests=8, seed=0, prompt_len_max=min(512, mcfg.block_size // 2),
        prompt_mode="shared_prefix", max_new_tokens=400, greedy=True))
    for _, req in trace:
        assert eng.submit(req) is None
    eng.step()
    assert int(eng._active.sum()) == 8
    return eng


def device_kernels(prof) -> list:
    """The trace's device activity, without the GPU-side spans of user
    annotations (``Optimizer.step#...``), which cover kernels and are not
    kernels themselves."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def us_by_name(kernels, width: int = 80) -> dict:
    """Device time by kernel name, names cut to ``width`` characters
    (kernels whose cut names agree are summed)."""
    out: dict = {}
    for e in kernels:
        key = e.name[:width]
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us()
    return out


def busy_us(events) -> float:
    """Length of the union of the given kernels' device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def measure(eng: Engine, steps: int, cardname: str) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    by_name = us_by_name(kernels)
    busy_ms = busy_us(kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    window = eng.ecfg.decode_window
    return {
        "route": eng.kernel_route.decode, "card": cardname, "steps": steps,
        "decode_window": window,
        "step_wall_ms_per_token_step": round(wall_ms / window, 4),
        "mesh": list(eng.ecfg.mesh_shape),
        "kv_quant": eng.kernel_route.kv_quant,
        "granularity": eng.kernel_route.granularity,
        "active_slots": int(eng._active.sum()),
        "step_wall_ms": round(wall_ms, 4),
        "traced_step_wall_ms": round(traced_ms / steps, 4),
        "device_busy_ms_per_step": (round(busy_ms / steps, 4)
                                    if kernels else "not measured"),
        "device_idle_share": (round(1.0 - busy_ms / traced_ms, 4)
                              if kernels else "not measured"),
        "kernels_per_step": len(kernels) / steps,
        "device_us_per_step_by_kernel": {
            n: round(us / steps, 2) for n, us in top},
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="gpt2-small",
                   choices=["gpt2-small", "char-gpt"])
    p.add_argument("--kv-quant", default="none",
                   choices=["none", "int8", "fp8"])
    p.add_argument("--mesh-shape", default="1x1",
                   help="serve mesh DATAxMODEL, all shards in this process")
    p.add_argument("--decode-window", type=int, default=1,
                   help="decode steps a window (a step of the engine)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=None,
                   help="also write the rows here as one JSON list")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cardname = card()
    mcfg = dataclasses.replace(get_config(args.preset).model,
                               decode_cache_layout="packed")
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    mesh = parse_mesh_shape(args.mesh_shape)
    engines = {r: filled_engine(model, mcfg, r == "kernel", args.kv_quant,
                                mesh, args.decode_window)
               for r in ("kernel", "gather")}
    for eng in engines.values():           # warm both routes
        eng.step()
    rows = [measure(engines[r], args.steps, cardname)
            for r in ("kernel", "gather", "gather", "kernel")]
    for row in rows:
        print(json.dumps(row))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
