#!/usr/bin/env python3
"""Time the port's CUDA decode attention kernels over batch and position,
on one NVIDIA card.

    python3 tools/torch_port_kernel_sweep.py [--root DIR] [--out PATH]
        [--kernels paged,packed]

GPT-2 124M widths (C=768, H=12, bf16). ``paged``: row #1,
``paged_window_attention`` (pages of 16, 64 pages per slot, W=1), B in
{8, 32} x pos in {64, 256, 512, 1000}. ``packed``: row #4,
``packed_decode_attention`` over a (B, 1024, C) cache, B in {1, 8, 32}
x pos in {0, 64, 318, 1023}, the library yardstick over the split-heads
cache after the write with the causal row's mask (as ``chip_smoke.py``
times it). For every (B, pos) cell, all B slots sit at the same position:
the kernel's median time over 30 runs (CUDA events, L2 flushed and the
stream padded with a device spin before each run), the library
yardstick ``F.scaled_dot_product_attention`` over the same K/V gathered
dense, the byte bound at 3.35 TB/s, and the
achieved rate of the kernel (bound bytes / kernel time). The kernel is
told the cell's position as its ``max_pos`` where the wrapper takes one,
as the engine's step tells it. ``--root`` imports the port from another
checkout (an older tree measured by the same code). Prints one JSON
object per cell and writes them all to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

C, H, D, PSZ, MP = 768, 12, 64, 16, 64
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, flush, n=30, warm=5):
    """Median device time of ``fn``: each run after an L2 flush and a
    device spin (~0.5 ms) that outlasts the host's launch work, so the
    events bracket the device time alone."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def cell(pa, B: int, pos: int, flush, g) -> dict:
    N = B * MP
    dt = torch.bfloat16

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    q, kn, vn = rnd(B, 1, C), rnd(B, 1, C), rnd(B, 1, C)
    kp, vp = rnd(N, PSZ, C), rnd(N, PSZ, C)
    tables = torch.randperm(N, generator=g, device="cuda").reshape(
        B, MP).to(torch.int32)
    posv = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    hint = ({"max_pos": pos} if "max_pos" in inspect.signature(
        pa.paged_window_attention).parameters else {})
    ms = time_ms(lambda: pa.paged_window_attention(
        q, kn, vn, kp, vp, tables, posv, n_head=H, **hint), flush)
    live = -(-pos // PSZ)
    S = live * PSZ
    tab = tables[:, :live].long()

    def heads(x, T):
        return x.reshape(B, T, H, D).transpose(1, 2).contiguous()

    k = heads(torch.cat([kp[tab].reshape(B, S, C), kn], 1), S + 1)
    v = heads(torch.cat([vp[tab].reshape(B, S, C), vn], 1), S + 1)
    kpos = torch.arange(S + 1, device="cuda")
    mask = ((kpos < pos) | (kpos == S))[None, None, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        heads(q, 1), k, v, attn_mask=mask), flush)
    nbytes = 4 * B * C * 2 + 2 * B * live * PSZ * C * 2 + B * live * 4 + B * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"kernel": "paged", "B": B, "pos": pos, "blocks": B * H,
            "kernel_ms": round(ms, 5),
            "library_ms": round(lib_ms, 5), "bound_ms": round(bound, 5),
            "kernel_GBps": round(nbytes / ms / 1e6, 1),
            "share_of_bound": round(bound / ms, 4)}


def packed_cell(dec, B: int, pos: int, flush, g) -> dict:
    S, dt = 1024, torch.bfloat16

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(dt)

    q, kn, vn = rnd(B, 3 * C).split(C, dim=-1)
    kc, vc = rnd(B, S, C), rnd(B, S, C)
    ms = time_ms(lambda: dec.packed_decode_attention(
        q, kn, vn, kc, vc, pos, n_head=H), flush)

    def heads(x):
        return x.reshape(B, -1, H, D).transpose(1, 2).contiguous()

    kw, vw = kc.clone(), vc.clone()
    kw[:, pos], vw[:, pos] = kn, vn
    sq, sk, sv = heads(q[:, None]), heads(kw), heads(vw)
    mask = (torch.arange(S, device="cuda") <= pos)[None, None, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush)
    nbytes = 2 * B * pos * C * 2 + 4 * B * C * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"kernel": "packed", "B": B, "pos": pos,
            "kernel_ms": round(ms, 5), "library_ms": round(lib_ms, 5),
            "bound_ms": round(bound, 5),
            "kernel_GBps": round(nbytes / ms / 1e6, 1),
            "share_of_bound": round(bound / ms, 4)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1]))
    p.add_argument("--out", default=None,
                   help="also write the rows here as one JSON list")
    p.add_argument("--kernels", default="paged,packed",
                   help="comma-separated: paged (row #1), packed (row #4)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from replicatinggpt_tpu_torch.ops import decode as dec
    from replicatinggpt_tpu_torch.ops import paged_attention as pa
    kernels = set(args.kernels.split(","))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cells = [(cell, pa, B, pos) for B in (8, 32)
             for pos in (64, 256, 512, 1000) if "paged" in kernels]
    cells += [(packed_cell, dec, B, pos) for B in (1, 8, 32)
              for pos in (0, 64, 318, 1023) if "packed" in kernels]
    for fn, mod, B, pos in cells:
        row = {"card": card, **fn(mod, B, pos, flush, g)}
        print(json.dumps(row))
        rows.append(row)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
