#!/usr/bin/env python3
"""Four-card runs of the port's data parallelism and FSDP (``train --dp N
[--fsdp]``), one NCCL process a card under ``torchrun``, beside the same
work in one process on one card.

    python3 tools/torch_port_dp_cards.py --out logs/dp_cards.json

runs, in order, each as its own ``torchrun --nproc-per-node 4`` or single
process (this file's ``run`` mode), and writes every result, its log tail
and the comparisons to ``--out``:

1. ``loss_f32``: ``train --preset gpt2-small --dp 4 --n-layer 2 --dtype
   float32``, 20 steps, on four cards and in one process (sequential
   windows: the same global batches); their losses side by side;
2. ``loss_bf16``: the same at full depth in the preset's bf16;
3. ``weak``: ``--dp 4 --batch-size 128`` on four cards (32 rows a card)
   against ``--batch-size 32`` unsharded on one card: tokens/s a card
   from the step p50 (device events), the efficiency their ratio;
4. ``fsdp``: ``gpt2-medium`` and ``gpt2-xl`` ``--dp 4`` with and without
   FSDP on four cards: step p50 and the largest peak memory allocated of
   the four;
5. with ``--only`` naming them (not in the default set): ``xl_sp``,
   ``train --preset gpt2-xl --sp 4 --batch-size 16 --grad-accum-steps
   4``, 8 steps on four cards only (the ring over the world, its
   gradients through the bucketed reducer): step p50 and the largest
   peak memory of the four; and
   ``dpsp`` and ``fsdp_accum``:
   ``--dp 2 --sp 2 --attention ring`` (the ring inside each data row's
   NCCL subgroup) and ``--dp 4 --fsdp --grad-accum-steps 2`` at 2 layers
   in f32 with dropout 0.1, each on four cards and in one process, their
   losses side by side;
6. ``ckpt``: ``gpt2-small --dp 4`` with a checkpoint every 2 steps, 6
   steps uninterrupted; again stopped by SIGTERM to rank 0 at step 3 (the
   ranks agree at the boundary of step 4) and resumed to step 6: every
   array of the two final states compared by crc32; then the step-4
   checkpoint resumed on one card (``--dp 4`` in one process) to step 6,
   its losses and weights against the four cards'.

``run`` mode (what each launch executes) is ``train`` with the CLI's
flags plus ``--no-fsdp``, ``--checkpoint-every N``, ``--stop-at K``
(rank 0 raises SIGTERM before step K) and ``--deterministic``; rank 0
prints one ``RESULT {...}`` line: the step losses, step p50 and mean, tokens/s,
the largest peak memory of the ranks, and with ``--fingerprint`` the crc32
of every array of the final state.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def run_mode(argv) -> int:
    import torch
    import torch.distributed as dist

    from replicatinggpt_tpu_torch import cli
    from replicatinggpt_tpu_torch.config import (config_from_args,
                                                 resolve_mesh)
    from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, install
    from replicatinggpt_tpu_torch.parallel import distributed
    from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
    from replicatinggpt_tpu_torch.train.runner import train
    from replicatinggpt_tpu_torch.utils.logging import StepLogger

    extra = argparse.ArgumentParser()
    extra.add_argument("--no-fsdp", action="store_true")
    extra.add_argument("--checkpoint-every", type=int, default=0)
    extra.add_argument("--stop-at", type=int, default=None)
    extra.add_argument("--deterministic", action="store_true")
    extra.add_argument("--fingerprint", action="store_true")
    opts, rest = extra.parse_known_args(argv)
    args = cli.build_parser().parse_args(["train", *rest])
    cfg = config_from_args(args)
    if opts.no_fsdp:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, fsdp=False))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=opts.checkpoint_every))
    if opts.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    launched = distributed.world_size() > 1
    if launched:
        # joined here, so that train() leaves the group for the peak; on
        # the mesh train() will run (a preset's that the launch cannot
        # fill is dropped)
        mesh = resolve_mesh(cfg.mesh, distributed.world_size())
        distributed.initialize(args.device, data=mesh.data, seq=mesh.seq)
    cuda = args.device in (None, "cuda")
    rank = dist.get_rank() if launched else 0
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    if opts.stop_at is not None and rank == 0:
        install(FaultPlan(Fault(site="train/step", kind="sigterm",
                                at=opts.stop_at)))
    ck = (CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir
          else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "log.jsonl")
        logger = StepLogger(jsonl_path=log)
        res = train(cfg, device=args.device, logger=logger,
                    checkpoint_manager=ck,
                    resume=args.resume, stop_event=stop)
        logger.close()
        events = [json.loads(line) for line in open(log)] if rank == 0 \
            else []
    peak = torch.tensor([torch.cuda.max_memory_allocated() if cuda else 0],
                        dtype=torch.float64, device="cuda" if cuda else "cpu")
    if launched:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    crc = None
    if opts.fingerprint:
        arrays = res.state.state_dict()
        crc = {k: zlib.crc32(v.detach().cpu().contiguous().reshape(-1)
                             .view(torch.uint8).numpy())
               for k, v in arrays.items()}
        weights = {k: v.detach().float().cpu() for k, v in arrays.items()
                   if k.startswith("params/")}
        if rank == 0 and args.checkpoint_dir:
            torch.save(weights, os.path.join(args.checkpoint_dir,
                                             f"final-{res.state.step}.pt"))
    if launched:
        dist.destroy_process_group()
    if rank == 0:
        print("RESULT " + json.dumps({
            "losses": {e["step"]: e["loss"] for e in events
                       if e["event"] == "step"},
            "step_times": res.step_times,
            "tokens_per_sec": res.tokens_per_sec,
            "final_eval": res.final_eval, "step": res.state.step,
            "peak_bytes": float(peak.item()), "crc": crc,
            "log": [e.get("msg") for e in events if e["event"] == "info"]}),
            flush=True)
    return 0


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def launch(name: str, argv, cards: int, logdir: str,
           timeout: int = 900) -> dict:
    """This file's ``run`` mode on ``cards`` cards (torchrun) or one;
    its RESULT, with the wall seconds and the log's tail."""
    me = os.path.abspath(__file__)
    cmd = ([sys.executable, "-m", "torch.distributed.run",
            f"--nproc-per-node={cards}", f"--master-port={_free_port()}",
            me, "run", *argv] if cards > 1
           else [sys.executable, me, "run", *argv])
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    text = p.stdout + "\n" + p.stderr
    with open(os.path.join(logdir, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + text)
    m = re.search(r"^RESULT (.*)$", p.stdout, re.M)
    if p.returncode != 0 or m is None:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{text[-4000:]}")
    out = json.loads(m.group(1))
    out["wall_s"] = wall
    print(f"{name}: {wall:.1f} s, step p50 {out['step_times']['p50_ms']:.3f}"
          f" ms, {out['tokens_per_sec']:.0f} tok/s, peak "
          f"{out['peak_bytes'] / 1e9:.3f} GB", flush=True)
    return out


def _max_diff(a: dict, b: dict) -> float:
    keys = sorted(set(a) & set(b), key=int)
    return max(abs(a[k] - b[k]) for k in keys) if keys else float("nan")


def main_mode(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="logs/dp_cards.json")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--only", default="loss,weak,fsdp,ckpt",
                   help="comma-separated cases: loss (loss_f32 and "
                   "loss_bf16), weak, fsdp, ckpt, xl_sp, dpsp, fsdp_accum")
    a = p.parse_args(argv)
    only = set(a.only.split(","))
    logdir = os.path.splitext(a.out)[0] + "_logs"
    os.makedirs(logdir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card, flush=True)
    from replicatinggpt_tpu_torch.data.dataset import load_corpus
    from replicatinggpt_tpu_torch.tokenizers import get_tokenizer
    t0 = time.perf_counter()
    get_tokenizer("bpe", corpus_text=load_corpus("datasets/shakespeare.txt"))
    res = {"cards": card.strip().splitlines(),
           "bpe_s": time.perf_counter() - t0}
    steps = ["--max-iters", str(a.steps), "--eval-interval", "0",
             "--eval-iters", "1", "--log-interval", "1"]
    small = ["--preset", "gpt2-small", "--dp", "4"]
    for tag, extra in (("loss_f32", ["--n-layer", "2", "--dtype",
                                     "float32"]),
                       ("loss_bf16", [])):
        if "loss" in only or tag in only:
            four = launch(f"{tag}_4cards", small + extra + steps, 4, logdir)
            one = launch(f"{tag}_1card", small + extra + steps, 1, logdir)
            res[tag] = {"four": four, "one": one,
                        "max_abs_loss_diff": _max_diff(four["losses"],
                                                       one["losses"])}
            print(f"{tag}: max |loss 4 cards - loss 1 process| "
                  f"{res[tag]['max_abs_loss_diff']:.3e}", flush=True)
    for tag, extra in (("dpsp", ["--dp", "2", "--sp", "2", "--attention",
                                 "ring"]),
                       ("fsdp_accum", ["--dp", "4", "--fsdp",
                                       "--grad-accum-steps", "2",
                                       "--n-layer", "2", "--dtype",
                                       "float32", "--dropout", "0.1"])):
        if tag not in only:
            continue
        argv = ["--preset", "gpt2-small", *extra, *steps]
        four = launch(f"{tag}_4cards", argv, 4, logdir)
        one = launch(f"{tag}_1card", argv, 1, logdir)
        res[tag] = {"four": four, "one": one,
                    "max_abs_loss_diff": _max_diff(four["losses"],
                                                   one["losses"])}
        print(f"{tag}: max |loss 4 cards - loss 1 process| "
              f"{res[tag]['max_abs_loss_diff']:.3e}", flush=True)
    if "xl_sp" in only:
        res["xl_sp"] = launch("xl_sp_4cards", [
            "--preset", "gpt2-xl", "--sp", "4", "--batch-size", "16",
            "--grad-accum-steps", "4", "--max-iters", "8",
            "--eval-interval", "0", "--eval-iters", "4",
            "--log-interval", "1"], 4, logdir)
    if "weak" in only:
        four = launch("weak_4cards", small + ["--batch-size", "128"] + steps,
                      4, logdir)
        one = launch("weak_1card", ["--preset", "gpt2-small", "--batch-size",
                                    "32"] + steps, 1, logdir)
        per_card = 32 * 1024 / (four["step_times"]["p50_ms"] / 1e3)
        single = 32 * 1024 / (one["step_times"]["p50_ms"] / 1e3)
        res["weak"] = {"four": four, "one": one,
                       "tok_s_per_card_p50": per_card,
                       "tok_s_one_card_p50": single,
                       "efficiency": per_card / single}
        print(f"weak scaling: {per_card:.0f} tok/s a card on 4 cards vs "
              f"{single:.0f} on one (p50), efficiency "
              f"{per_card / single:.4f}", flush=True)
    if "fsdp" in only:
        res["fsdp"] = {}
        for preset in ("gpt2-medium", "gpt2-xl"):
            for fsdp in (True, False):
                tag = f"{preset}_{'fsdp' if fsdp else 'dp'}"
                out = launch(tag, ["--preset", preset, "--dp", "4",
                                   "--max-iters", "5", "--eval-interval",
                                   "0", "--eval-iters", "1",
                                   "--log-interval", "1"]
                             + ([] if fsdp else ["--no-fsdp"]), 4, logdir)
                res["fsdp"][tag] = out
    if "ckpt" in only:
        root = tempfile.mkdtemp(prefix="dp_ckpt_")
        base = small + ["--max-iters", "6", "--eval-interval", "0",
                        "--eval-iters", "1", "--log-interval", "1",
                        "--checkpoint-every", "2", "--deterministic",
                        "--fingerprint"]
        full = launch("ckpt_full", base + ["--checkpoint-dir",
                                           f"{root}/a"], 4, logdir)
        stopped = launch("ckpt_stopped", base + ["--checkpoint-dir",
                                                 f"{root}/b", "--stop-at",
                                                 "3"], 4, logdir)
        os.makedirs(f"{root}/c")
        for name in os.listdir(f"{root}/b"):
            if name in ("4", "manifest-4.json"):
                subprocess.run(["cp", "-r", f"{root}/b/{name}",
                                f"{root}/c/"], check=True)
        resumed = launch("ckpt_resumed", base + ["--checkpoint-dir",
                                                 f"{root}/b", "--resume"],
                         4, logdir)
        one = launch("ckpt_one_card", base + ["--checkpoint-dir",
                                              f"{root}/c", "--resume"],
                     1, logdir)
        import torch
        w4 = torch.load(f"{root}/b/final-6.pt")
        w1 = torch.load(f"{root}/c/final-6.pt")
        differ = [k for k in full["crc"] if full["crc"][k]
                  != resumed["crc"].get(k)]
        res["ckpt"] = {
            "stopped_at": stopped["step"], "resumed_to": resumed["step"],
            "arrays": len(full["crc"]), "arrays_differing": differ,
            "losses_full": full["losses"], "losses_resumed": resumed["losses"],
            "losses_one_card": one["losses"],
            "one_card_max_abs_loss_diff": _max_diff(resumed["losses"],
                                                    one["losses"]),
            "one_card_max_abs_weight_diff": max(
                (w4[k] - w1[k]).abs().max().item() for k in w4),
            "logs": {"stopped": stopped["log"], "resumed": resumed["log"]}}
        print(f"checkpoint under the launch: stopped at step "
              f"{stopped['step']}, resumed to {resumed['step']}, "
              f"{len(differ)} of {len(full['crc'])} arrays differ from the "
              f"uninterrupted run; one card resumed: max |loss diff| "
              f"{res['ckpt']['one_card_max_abs_loss_diff']:.3e}, max "
              f"|weight diff| "
              f"{res['ckpt']['one_card_max_abs_weight_diff']:.3e}",
              flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(card.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "run":
        sys.exit(run_mode(sys.argv[2:]))
    sys.exit(main_mode(sys.argv[1:]))
