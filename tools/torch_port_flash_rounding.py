#!/usr/bin/env python3
"""How often f32 summation order alone moves the bf16 flash roundings,
on the CPU.

    python3 tools/torch_port_flash_rounding.py [--batch 1] [--heads 12] \
        [--seq 1024] [--rate 0.1]

The bf16 flash kernels (``csrc/flash_packed.cu``) and their plain
versions (``ops/flash_packed.attention_ref`` / ``attention_bwd_ref``)
round p z and ds to bf16 at the same points, each from scores it sums in
its own order. This runs the plain versions twice on the same causal
bf16 inputs (D=64): as they are, and with the head dimension of q, k, v
and dO permuted, which sums every score and every dO V^T in another
order and leaves the function as it was (the outputs are permuted back).
It counts the outputs (o, lse, dq, dk, dv) that differ by more than the
card checks' tolerance (``chip_smoke.FLASH_TOL``: atol 1e-4, rtol 1e-2
for bf16, lse 1e-4), for unit-normal inputs and for the same inputs on
the 1/32 grid of ``chip_smoke.on_grid``, where every sum is exact in f32.
Prints one JSON object. CPU counts only: no device time.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from replicatinggpt_tpu_torch.ops import flash_packed as fp  # noqa: E402

TOL = {"o": (1e-4, 1e-2), "lse": (1e-4, 1e-4), "dq": (1e-4, 1e-2),
       "dk": (1e-4, 1e-2), "dv": (1e-4, 1e-2)}


def run(q, k, v, do, perm, rate):
    """The plain forward and backward with D permuted by ``perm``; the
    backward takes ``lse`` and ``delta`` from the unpermuted forward."""
    x = [t[..., perm] for t in (q, k, v, do)]
    kw = dict(causal=True, scale=q.shape[-1] ** -0.5, seed=7, rate=rate)
    o, lse = fp.attention_ref(*x[:3], **kw)
    o = o.to(q.dtype)
    inv = torch.argsort(perm)
    return o[..., inv], lse, x, kw, inv


def outside(shape, rate: float, grid: bool, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    if grid:
        q, k, v, do = ((t * 32).round().clamp(-128, 128) / 32
                       for t in (q, k, v, do))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    D = shape[-1]
    ident = torch.arange(D)
    perm = torch.randperm(D, generator=g)
    res = {}
    for name, p in (("ref", ident), ("alt", perm)):
        o, lse, x, kw, inv = run(q, k, v, do, p, rate)
        if name == "ref":
            delta = (do.float() * o.float()).sum(-1)
            lse_ref = lse
        grads = fp.attention_bwd_ref(*x, lse_ref, delta, **kw)
        res[name] = {"o": o, "lse": lse,
                     **{n: gr.to(q.dtype)[..., inv]
                        for n, gr in zip(("dq", "dk", "dv"), grads)}}
    counts = {}
    for n, (atol, rtol) in TOL.items():
        a, b = res["alt"][n].float(), res["ref"][n].float()
        counts[n] = int(((a - b).abs() > atol + rtol * b.abs()).sum())
    counts["elements_each"] = int(q.numel())
    return counts


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--rate", type=float, default=0.1)
    args = p.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    shape = (args.batch, args.heads, args.seq, 64)
    print(json.dumps({
        "shape": list(shape), "rate": args.rate, "device": "cpu",
        "outside_tolerance": {
            "unit_normal": outside(shape, args.rate, False, 0),
            "on_grid": outside(shape, args.rate, True, 0)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
