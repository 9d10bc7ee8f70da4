#!/usr/bin/env python3
"""Time the decode kernels of a checkout of the port the same way for
any two trees, on one NVIDIA card.

    python3 tools/torch_port_decode_ab.py [--root DIR] [--out PATH]

Imports ``replicatinggpt_tpu_torch`` from ``--root`` (default: this
checkout), so an older tree unpacked beside this one is measured by the
same code and the same inputs; only the wrappers' public calls are used
(a keyword the older wrapper lacks is left out). Four kernels, at the
shapes ``chip_smoke.py`` times them:

- ``paged_window_attention`` at GPT-2 124M widths (C=768, H=12, pages of
  16, 64 pages a slot, 512 in the pool, B=8, W=1, bf16) with the slots
  at pos 0, 1, 15, 16, 17, 333, 777, 1000, on a bf16 pool and on int8 and
  fp8 pools with page scales;
- ``fused_decode_layers`` at char-GPT (L=6, C=384, H=6, bf16, heads
  cache) at pos 255;
- ``packed_decode_attention`` at GPT-2 124M (B=8, S=1024, C=768, H=12,
  bf16) at pos 318, q/k_new/v_new slices of one (B, 3C) row;
- ``fused_paged_decode_layers`` at char-GPT serving (L=6, C=384, H=6,
  B=8 at pos 0, 1, 64, 100, 129, 170, 230, 255, pages of 16, 16 a slot,
  bf16) on a bf16 pool and on int8 and fp8 pools with page and head
  scales, told the longest position as ``max_pos`` where it takes one.

For each: the median device time over 30 runs (CUDA events, L2 flushed
and the stream padded with a ~0.5 ms device spin before each run, as in
``chip_smoke.time_ms``) and the host time of one wrapper call: the
mean over 100 calls made back to back (the card drains afterwards), in 7
batches, their median and least.
Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

C, H, PSZ, MP, N, B = 768, 12, 16, 64, 512, 8
POS = [0, 1, 15, 16, 17, 333, 777, 1000]
PAD_CYCLES = 1_000_000


def time_ms(fn, flush, n=30, warm=5):
    """Median device time of ``fn``: each run after an L2 flush and a
    device spin that outlasts the host's work to launch ``fn``."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(PAD_CYCLES)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def host_us(fn, n=100, batches=7):
    """Host microseconds of one call of ``fn`` over ``batches`` batches
    of ``n`` calls back to back (the card queues the launches and drains
    after the clock stops): the batches' median and least."""
    for _ in range(5):
        fn()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return {"median": statistics.median(per), "least": min(per)}


def paged_args(kv: str, g):
    from replicatinggpt_tpu_torch.quant.kv import quantize_rows

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda")

    pos = torch.tensor(POS, dtype=torch.int32, device="cuda")
    tables = torch.randperm(N, generator=g, device="cuda")[:B * MP]
    tables = tables.reshape(B, MP).to(torch.int32)
    live = (pos + PSZ - 1) // PSZ
    past = torch.arange(MP, device="cuda")[None, :] >= live[:, None]
    tables = torch.where(past, torch.full_like(tables, N + 7), tables)
    rows = [rnd(B, 1, C).to(torch.bfloat16) for _ in range(3)]
    kp, vp = rnd(N, PSZ, C), rnd(N, PSZ, C)
    if kv == "none":
        return (*rows, kp.to(torch.bfloat16), vp.to(torch.bfloat16),
                tables.contiguous(), pos), {}
    (kq, ks), (vq, vs) = (quantize_rows(t, kv, H, "page") for t in (kp, vp))
    return (*rows, kq, vq, tables.contiguous(), pos), {"k_scales": ks,
                                                       "v_scales": vs}


def fused_args(g):
    from replicatinggpt_tpu_torch.config import get_config
    from replicatinggpt_tpu_torch.models.gpt import (BLOCK_SHAPES,
                                                    init_kv_cache)
    from replicatinggpt_tpu_torch.ops import decode as dec
    cfg = dataclasses.replace(get_config("char-gpt").model)
    L, pos = cfg.n_layer, cfg.block_size - 1

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    resid = 0.02 * (2 * L) ** -0.5
    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        if name.endswith("_scale"):
            blocks[name] = 1 + rnd(L, *shape(cfg.n_embd), scale=0.1)
        else:
            blocks[name] = rnd(L, *shape(cfg.n_embd), scale=resid if name in (
                "attn_out_kernel", "mlp_down_kernel") else 0.02)
    blocks = dec.fused_weights(blocks, torch.bfloat16)
    cache = init_kv_cache(cfg, 1, dtype=torch.bfloat16, device="cuda")
    for k in ("k", "v"):
        cache[k].copy_(rnd(*cache[k].shape, scale=0.5))
    x0 = rnd(1, cfg.n_embd, scale=0.03).to(torch.bfloat16)
    return (x0, blocks, pos, cache, cfg)


FPOS = [0, 1, 64, 100, 129, 170, 230, 255]
FPB, FPSZ, FPMP = 8, 16, 16


def packed_args(g):
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, kn, vn = rnd(B, 3 * C).split(C, dim=-1)
    return (q, kn, vn, rnd(B, 1024, C), rnd(B, 1024, C), 318)


def fused_paged_args(kv: str, gran: str, g):
    from replicatinggpt_tpu_torch.config import get_config
    from replicatinggpt_tpu_torch.models.gpt import BLOCK_SHAPES
    from replicatinggpt_tpu_torch.ops import decode as dec
    from replicatinggpt_tpu_torch.quant.kv import quantize_rows
    cfg = dataclasses.replace(get_config("char-gpt").model,
                              decode_cache_layout="packed")
    L, Cc, Hh = cfg.n_layer, cfg.n_embd, cfg.n_head
    Np = FPB * FPMP

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        blocks[name] = (1 + rnd(L, *shape(Cc), scale=0.1)
                        if name.endswith("_scale")
                        else rnd(L, *shape(Cc), scale=0.02))
    blocks = dec.fused_weights(blocks, torch.bfloat16)
    rows = [rnd(L, Np, FPSZ, Cc, scale=0.5) for _ in range(2)]
    if kv == "none":
        cache = {"k": rows[0].to(torch.bfloat16),
                 "v": rows[1].to(torch.bfloat16)}
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv, Hh, gran) for t in rows)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    tables = torch.randperm(Np, generator=g, device="cuda").reshape(
        FPB, FPMP).to(torch.int32)
    pos = torch.tensor(FPOS, dtype=torch.int32, device="cuda")
    x0 = rnd(FPB, Cc, scale=0.03).to(torch.bfloat16)
    return (x0, blocks, pos, tables, cache, cfg)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1]))
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from replicatinggpt_tpu_torch.ops import decode as dec
    from replicatinggpt_tpu_torch.ops import paged_attention as pa
    if not pathlib.Path(pa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {pa.__file__}, not a module of {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "root": str(root)}
    for kv in ("none", "int8", "fp8"):
        a, kw = paged_args(kv, g)

        def paged():
            return pa.paged_window_attention(*a, n_head=H, **kw)

        result[f"paged_{kv}"] = {"kernel_ms": time_ms(paged, flush),
                                 "host_us_per_call": host_us(paged)}
    fa = fused_args(g)

    def fused():
        return dec.fused_decode_layers(*fa)

    result["fused_char_pos255"] = {"kernel_ms": time_ms(fused, flush),
                                   "host_us_per_call": host_us(fused)}
    pk = packed_args(g)

    def packed():
        return dec.packed_decode_attention(*pk, n_head=H)

    result["packed_124m_b8_pos318"] = {"kernel_ms": time_ms(packed, flush),
                                       "host_us_per_call": host_us(packed)}
    hint = ({"max_pos": max(FPOS)} if "max_pos" in inspect.signature(
        dec.fused_paged_decode_layers).parameters else {})
    for kv, gran in (("none", "page"), ("int8", "page"), ("int8", "head"),
                     ("fp8", "page"), ("fp8", "head")):
        fp = fused_paged_args(kv, gran, g)

        def paged_fused():
            return dec.fused_paged_decode_layers(*fp, **hint)

        label = "none" if kv == "none" else f"{kv}_{gran}"
        result[f"fused_paged_char_b8_{label}"] = {
            "kernel_ms": time_ms(paged_fused, flush),
            "host_us_per_call": host_us(paged_fused)}
    print(json.dumps(result))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
