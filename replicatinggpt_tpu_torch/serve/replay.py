"""Offline serving-trace replay: a seeded Poisson workload through the
engine (port of ``replicatinggpt_tpu/serve/replay.py``).

``make_trace`` is numpy only, so the same ``ReplayConfig`` gives the same
trace, bit for bit, as the JAX package's. ``run_replay`` warms a
throwaway engine first (which also builds the CUDA kernels) with one
request of ``EngineConfig.warmup_tokens()`` tokens, which drives a
windowed engine through its mixed and its steady windows (with a
drafter: its verify step, and then its plain decode path, which an
auto-disable may switch to mid-replay), and then replays the trace in
wall-clock time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..ops.decode import fused_paged_decode_layers
from ..ops.paged_attention import paged_window_attention
from .engine import Engine, EngineConfig
from .requests import Request, RequestResult, SamplingParams
from .speculative import make_drafter


@dataclass(frozen=True)
class ReplayConfig:
    n_requests: int = 64
    rate: float = 200.0            # mean arrivals/sec (Poisson)
    seed: int = 0
    prompt_len_min: int = 1
    prompt_len_max: int = 32
    max_new_tokens: int = 16
    greedy: bool = False
    temperature: float = 1.0
    top_k: int = 20
    top_p: float = 0.0
    deadline_s: float = 0.0        # per-request deadline after arrival; 0=off
    prompt_mode: str = "random"    # 'random' | 'repeat' (tiled small
                                   # patterns: the speculative trace) |
                                   # 'shared_prefix'
    shared_prefix_len: int = 0     # 'shared_prefix' common-prefix length;
                                   # 0 = prompt_len_max // 2
    spec: str = "off"              # drafter: 'off' | 'ngram' | 'model'
    spec_k: int = 4                # drafted tokens per slot per step
    spec_ngram: int = 3            # n-gram drafter match width


def make_trace(mcfg: ModelConfig, rcfg: ReplayConfig
               ) -> List[Tuple[float, Request]]:
    """Seeded (arrival_time, request) list: exponential inter-arrivals,
    uniform prompt lengths (clamped to block_size) and token ids; or
    tiled <=4-token patterns ('repeat'); or one common random prefix plus
    a unique random tail per prompt ('shared_prefix')."""
    rng = np.random.default_rng(rcfg.seed)
    hi = min(rcfg.prompt_len_max, mcfg.block_size)
    lo = min(rcfg.prompt_len_min, hi)
    shared = None
    if rcfg.prompt_mode == "shared_prefix":
        n_shared = min(rcfg.shared_prefix_len or max(hi // 2, 1), hi - 1)
        shared = rng.integers(0, mcfg.vocab_size, (n_shared,),
                              dtype=np.int64)
    t = 0.0
    trace = []
    sp = SamplingParams(temperature=rcfg.temperature, top_k=rcfg.top_k,
                        top_p=rcfg.top_p, greedy=rcfg.greedy)
    for i in range(rcfg.n_requests):
        t += float(rng.exponential(1.0 / max(rcfg.rate, 1e-9)))
        if shared is not None:
            P = int(rng.integers(max(lo, shared.size + 1), hi + 1))
            prompt = np.concatenate([
                shared, rng.integers(0, mcfg.vocab_size,
                                     (P - shared.size,), dtype=np.int64)])
        elif rcfg.prompt_mode == "repeat":
            P = int(rng.integers(lo, hi + 1))
            pat = rng.integers(0, mcfg.vocab_size,
                               (min(int(rng.integers(1, 5)), P),),
                               dtype=np.int64)
            prompt = np.tile(pat, -(-P // pat.size))[:P]
        else:
            P = int(rng.integers(lo, hi + 1))
            prompt = rng.integers(0, mcfg.vocab_size, (P,), dtype=np.int64)
        trace.append((t, Request(
            id=f"r{i:04d}", prompt=prompt.astype(np.int32),
            max_new_tokens=rcfg.max_new_tokens, sampling=sp,
            rng_seed=rcfg.seed * 100_003 + i)))
    return trace


def run_replay(model, mcfg: ModelConfig, rcfg: ReplayConfig,
               ecfg: EngineConfig, device=None, draft_model=None,
               draft_cfg: Optional[ModelConfig] = None, resilience=None,
               journal=None) -> dict:
    """Replay the trace in wall-clock time, after one request through a
    throwaway engine of the same shapes (which also builds the kernel);
    returns the engine's metrics summary plus replay totals and each
    request's token stream. ``rcfg.spec`` selects a drafter, one an
    engine (drafters hold per-slot state); 'model' needs ``draft_model``
    and ``draft_cfg`` (``speculative.draft_config_from_preset``).
    ``resilience`` (``faults.watchdog.ResilienceConfig``) and ``journal``
    (``serve.journal.RequestJournal``) go to the replay's engine.
    ``kernel_launches`` counts the per-layer paged attention kernel's
    launches during the timed replay alone,
    ``partials_launches`` its partials mode's (a mesh's kernel route),
    ``kernel_launches_by_window`` the first by window width W (1 in the
    decode steps, the prefill chunk in a windowed engine's mixed
    windows), ``fused_launches`` the fused all-layers kernel's. The
    clock is the
    engine's: under ``torchrun``, rank 0's on every rank, so that every
    rank submits the same requests at the same steps."""
    def drafter():
        return make_drafter(rcfg.spec, rcfg.spec_k, rcfg.spec_ngram,
                            ecfg.pool_size, draft_model, draft_cfg,
                            ecfg.prefill_chunk, device=device)

    def tiny(rid):
        return Request(id=rid, prompt=np.zeros((1,), np.int32),
                       max_new_tokens=ecfg.warmup_tokens(),
                       sampling=SamplingParams(greedy=True))

    w = Engine(model, mcfg, ecfg, device=device, drafter=drafter())
    w.submit(tiny("warmup"))
    w.drain()
    if w.drafter is not None:
        # the plain decode path too, which an auto-disable may switch to
        w.set_spec_active(False)
        w.submit(tiny("warmup-degraded"))
        w.drain()
    del w
    engine = Engine(model, mcfg, ecfg, device=device, drafter=drafter(),
                    rcfg=resilience, journal=journal)
    clock = engine.clock
    trace = make_trace(mcfg, rcfg)
    results: List[RequestResult] = []
    i = 0
    launches0 = paged_window_attention.launches
    by_w0 = dict(paged_window_attention.launches_by_window)
    partials0 = paged_window_attention.partials_launches
    fused0 = fused_paged_decode_layers.launches
    t0 = clock()
    while len(results) < len(trace):
        now = clock() - t0
        while i < len(trace) and trace[i][0] <= now:
            req = trace[i][1]
            if rcfg.deadline_s > 0:
                req.deadline = clock() + rcfg.deadline_s
            rej = engine.submit(req)
            if rej is not None:
                results.append(rej)
            i += 1
        if engine.idle:
            if i >= len(trace):
                break
            # nothing in flight: sleep to the next arrival
            time.sleep(min(max(trace[i][0] - now, 0.0), 0.05))
            continue
        results.extend(engine.step())
    wall_s = clock() - t0
    ok = [r for r in results if r.ok]
    gen_tokens = sum(len(r.tokens) for r in results)
    summary = engine.metrics_summary()
    summary.update({
        "device": str(engine.device),
        "n_requests": len(trace),
        "n_completed": len(ok),
        "n_rejected": sum(r.finish_reason.startswith("rejected")
                          for r in results),
        "generated_tokens": gen_tokens,
        "wall_s": round(wall_s, 3),
        "aggregate_tokens_per_s": round(gen_tokens / wall_s, 1)
        if wall_s > 0 else 0.0,
        "kernel_launches": paged_window_attention.launches - launches0,
        "kernel_launches_by_window": {
            str(w): n - by_w0.get(w, 0) for w, n in
            sorted(paged_window_attention.launches_by_window.items())
            if n > by_w0.get(w, 0)},
        "partials_launches":
            paged_window_attention.partials_launches - partials0,
        "fused_launches": fused_paged_decode_layers.launches - fused0,
        "streams": {r.id: list(r.tokens) for r in results},
    })
    return summary


def format_summary(s: dict) -> str:
    """Human-readable metrics block (the serve-replay stdout report)."""
    h = s["histograms"]

    def pct(name, scale=1.0, unit=""):
        d = h.get(name, {})
        return (f"p50 {d.get('p50', 0) * scale:.2f}{unit} / "
                f"p90 {d.get('p90', 0) * scale:.2f}{unit} / "
                f"p99 {d.get('p99', 0) * scale:.2f}{unit}")

    sl = s["step_latency"]
    pg = s["pages"]
    kr = s["kernel_route"]
    dp = s["dispatch"]
    window = []
    if dp["window_k_max"] > 1:
        auto = (f" (autotuned up to {dp['window_k_max']}, "
                f"{dp['autotune_increases']} increase(s))"
                if dp["autotune"] else "")
        window = [
            f"dispatch split: window k={dp['window_k']}{auto}, "
            f"{dp['dispatches']} dispatches ({dp['decode_windows']} decode "
            f"+ {dp['mixed_windows']} mixed windows), host "
            f"{dp['mean_dispatch_ms']:.3f} ms/dispatch -> "
            f"{dp['host_dispatch_ms_per_token']:.3f} ms/token",
            "window breaks: " + " ".join(
                f"{r}={n}" for r, n in s["window_breaks"].items())]
    by_w = s.get("kernel_launches_by_window") or {}
    mesh = []
    if pg["mesh_shape"] != [1, 1]:
        d, m = pg["mesh_shape"]
        mesh = [f"mesh: {d}x{m} (data x model; effective "
                f"{pg['effective_mesh_shape'][0]}x"
                f"{pg['effective_mesh_shape'][1]}), {pg['pages_per_chip']} "
                f"pages/chip of {pg['aggregate_pages']} aggregate, per-chip "
                f"in use {pg['pages_in_use_by_chip']}"]
    sp = s.get("speculative")
    spec = []
    if sp:
        rec = s["recovery"]
        spec = [
            f"speculative ({sp['drafter']}, k={sp['k']}): accept rate "
            f"{sp['accept_rate']:.3f}, {sp['mean_tokens_per_step']:.2f} "
            f"tokens/slot-step over {sp['verify_steps']} verify steps, "
            f"draft overhead p50 "
            f"{sp['draft_overhead_s'].get('p50', 0) * 1e3:.2f} ms",
            f"recovery: {rec['spec_disables']} speculative disable(s), "
            f"{rec['spec_reprobes']} re-probe(s), "
            f"{rec['watchdog_stalls']} stall(s), {rec['shed_requests']} "
            f"shed"]
    return "\n".join([
        f"requests: {s['n_requests']} submitted, {s['n_completed']} "
        f"completed, {s['n_rejected']} rejected",
        *spec,
        f"tokens: {s['generated_tokens']} generated in {s['wall_s']}s "
        f"-> {s['aggregate_tokens_per_s']} tok/s aggregate "
        f"on {s['device']}",
        f"pages: {pg['pages_in_use']}/{pg['n_pages']} in use "
        f"({pg['page_size']} tok/page, util "
        f"{pg['page_utilization']:.2f}), prefix hits "
        f"{pg['prefix_hits']}/{pg['prefix_lookups']} "
        f"({pg['prefix_hit_tokens']} tok, rate "
        f"{pg['prefix_hit_rate']:.2f}), {pg['evictions']} evictions, "
        f"{pg['cow_copies']} COW copies",
        *mesh,
        f"quant: KV {pg['kv_quant']}"
        + (f" ({pg['quant_granularity']}-granularity scales)"
           if pg["kv_quant"] != "none" else "")
        + f", {pg['bytes_per_page']} bytes/page",
        f"TTFT: {pct('ttft_s', 1e3, ' ms')}",
        f"decode rate/request: {pct('decode_tokens_per_s', 1.0, ' tok/s')}",
        f"step latency: p50 {sl['p50_s'] * 1e3:.2f} ms / "
        f"p90 {sl['p90_s'] * 1e3:.2f} ms over {s['n_steps']} steps"
        + (" (a step is one window)" if window else ""),
        *window,
        f"batch fill: mean {h.get('batch_fill_ratio', {}).get('mean', 0):.2f}"
        f" (pool), queue wait {pct('queue_wait_s', 1e3, ' ms')}",
        f"kernel route: decode={kr['decode']}"
        + (f", window={kr['window']}" if kr["window"] != "none" else "")
        + (f", verify={kr['verify']}" if kr["verify"] != "none" else "")
        + (f" (reasons: {','.join(kr['reasons'])})" if kr["reasons"]
           else "")
        + (f", sharded over {kr['mesh'][0]}x{kr['mesh'][1]}"
           if kr["sharded"] else "")
        + f", {s['kernel_launches']} per-layer"
        + (" (" + ", ".join(f"{n} at W={w}" for w, n in by_w.items()) + ")"
           if len(by_w) > 1 else "")
        + f", {s['partials_launches']} partials and {s['fused_launches']} "
        f"fused kernel launches",
    ])
