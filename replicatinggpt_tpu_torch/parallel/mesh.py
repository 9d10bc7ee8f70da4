"""The sequence group: where the ``--sp`` shards of a sequence live, and
how their K/V chunks move around the ring.

The JAX package's ``seq`` mesh axis (``replicatinggpt_tpu/parallel/
mesh.py``) with its ``lax.ppermute`` rotation (``parallel/
ring_attention.py``), in two forms that share one ring core
(``parallel/ring_attention.py``):

- ``LocalSeqGroup(n)``: all n shards of every sequence in this one
  process, on its one device (the counterpart of the JAX virtual mesh).
  The model runs on the whole (B, T) sequence and only attention is split;
  rotating K/V is an index shift, with no copy;
- ``ProcessSeqGroup``: one shard per process of a ``torch.distributed``
  group (NCCL between cards, gloo on the CPU). Each process runs the model
  on its (B, T/n) columns at global positions, rotates K/V with
  ``batch_isend_irecv`` to rank + 1 and from rank - 1 (``RingKV``, whose
  backward rotates the gradients the other way: the VJP of
  ``ppermute``), averages the loss and the gradients over the group, and
  starts from rank 0's weights.

Both give the train step one interface: ``shards`` (the sequence shard
indices this process holds), ``ring_kv``, ``local_columns`` /
``pos_offset`` (which columns of a global batch are this process's, at
which global position), ``mean`` (a loss over the group),
``average_grads`` and ``broadcast_``.

The serving mesh's layout rules follow (``parse_mesh_shape``,
``page_shards``, ``model_shards``, ``vocab_shards``,
``shard_serve_params``); its groups are in ``serve_group.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

KV = Tuple[torch.Tensor, torch.Tensor]


class LocalSeqGroup:
    """All ``n`` sequence shards in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a seq group needs at least 1 shard, got {n}")
        self.size = n
        self.rank = 0
        self.shards = tuple(range(n))
        self.is_main = True

    def describe(self) -> str:
        return f"one process holding all {self.size} shards"

    def ring_kv(self, k: torch.Tensor, v: torch.Tensor
                ) -> List[List[KV]]:
        """k, v: (n, B, H, Tl, D), shard i's chunk at [i]. Entry [i][s] is
        the (k, v) chunk shard i holds after s rotations, chunk (i - s)
        mod n: views, no copy."""
        ks, vs = k.unbind(0), v.unbind(0)
        n = self.size
        return [[(ks[(i - s) % n], vs[(i - s) % n]) for s in range(n)]
                for i in range(n)]

    def local_columns(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pos_offset(self, local_len: int) -> int:
        return 0

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def average_grads(self, grads: Sequence[torch.Tensor]) -> None:
        pass

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass


class ProcessSeqGroup:
    """One shard per process of the default ``torch.distributed`` group
    (rank r holds shard r). Tensors must live where the backend works:
    CUDA tensors on NCCL, CPU tensors on gloo."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("ProcessSeqGroup needs an initialized "
                               "torch.distributed process group")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shards = (self.rank,)
        self.is_main = self.rank == 0
        self.backend = dist.get_backend()

    def describe(self) -> str:
        return (f"{self.size} processes, one shard each "
                f"({self.backend})")

    def check(self, t: torch.Tensor) -> None:
        cuda = t.device.type == "cuda"
        if self.backend == "nccl" and not cuda:
            raise ValueError(f"a {t.device} tensor on an NCCL group: NCCL "
                             f"moves CUDA tensors only")
        if self.backend == "gloo" and cuda:
            raise ValueError("a CUDA tensor on a gloo group: run the CPU "
                             "path (--device cpu) on gloo, or NCCL on cards")

    def rotate(self, tensors: Sequence[torch.Tensor],
               step: int) -> List[torch.Tensor]:
        """Send each tensor to rank + step and receive its counterpart
        from rank - step (mod size), in one batch of point-to-point ops."""
        dst = (self.rank + step) % self.size
        src = (self.rank - step) % self.size
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, buf in zip(tensors, out):
            self.check(t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst))
            ops.append(dist.P2POp(dist.irecv, buf, src))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def ring_kv(self, k: torch.Tensor, v: torch.Tensor
                ) -> List[List[KV]]:
        """k, v: (1, B, H, Tl, D), this rank's chunk. Entry [0][s] is the
        chunk held after s rotations, chunk (rank - s) mod size."""
        outs = RingKV.apply(self, k[0], v[0])
        return [[(outs[2 * s], outs[2 * s + 1]) for s in range(self.size)]]

    def local_columns(self, x: torch.Tensor) -> torch.Tensor:
        from .distributed import local_seq_slice
        return x[..., local_seq_slice(x.shape[-1])]

    def pos_offset(self, local_len: int) -> int:
        return self.rank * local_len

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        self.check(y)
        dist.all_reduce(y)
        return y / self.size

    def average_grads(self, grads: Sequence[torch.Tensor]) -> None:
        for g in grads:
            self.check(g)
            dist.all_reduce(g)
            g.div_(self.size)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank (outside
        autograd: parameters are leaves)."""
        with torch.no_grad():
            for t in tensors:
                self.check(t)
                dist.broadcast(t, 0)


class RingKV(torch.autograd.Function):
    """Every rotation of one rank's (k, v) chunk in one node: outputs
    (k_0, v_0, k_1, v_1, ..., k_{n-1}, v_{n-1}), chunk s being the one
    held after s rotations (k_0, v_0 = k, v). Keeping the rotations in one
    node that the diagonal hop always reads makes every rank run the same
    n - 1 reverse rotations in its backward, even the ranks whose later
    hops are causally skipped (an unread rotation's backward would never
    run there, and its peers would wait on it). The backward is Horner's
    rule over the reverse rotation R^T: dx = dy_0 + R^T(dy_1 + R^T(dy_2 +
    ...))."""

    @staticmethod
    def forward(ctx, group: ProcessSeqGroup, k, v):
        ctx.group = group
        outs = [k, v]
        cur = [k, v]
        for _ in range(group.size - 1):
            cur = group.rotate(cur, 1)
            outs += cur
        # k, v are inputs: return views so autograd tracks them as outputs
        outs[0], outs[1] = k.view_as(k), v.view_as(v)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        n = group.size
        acc = [grads[2 * (n - 1)], grads[2 * (n - 1) + 1]]
        for s in range(n - 1, 0, -1):
            acc = group.rotate(acc, -1)
            acc = [a + g for a, g in zip(acc, grads[2 * (s - 1):2 * s])]
        return (None, *acc)


# ---------------------------------------------------------------------------
# the serving mesh: (data, model) layout rules (the JAX package's
# ``parallel/mesh.py`` ``page_pool_pspec``, ``page_scale_pspec`` and its
# decode-time tensor-parallel table)
# ---------------------------------------------------------------------------

def parse_mesh_shape(text: str) -> Tuple[int, int]:
    """'2x2' / '2,2' / '4x1' -> (data, model); '1x1' is the unsharded
    identity (the JAX package's ``parse_mesh_shape``)."""
    s = text.lower().replace(",", "x").split("x")
    if len(s) != 2:
        raise ValueError(f"--mesh-shape must be DxM (e.g. 2x2), got "
                         f"{text!r}")
    d, m = int(s[0]), int(s[1])
    if d < 1 or m < 1:
        raise ValueError(f"--mesh-shape axes must be >= 1, got {text!r}")
    return d, m


def page_shards(n_pages: int, data: int) -> int:
    """Blocks the pool's physical page axis splits into over 'data': the
    axis size where it divides ``n_pages``, else 1 (the pages replicate,
    as the JAX ``page_pool_pspec`` drops a non-dividing axis). A quantized
    pool's scales follow the pages (``page_scale_pspec``)."""
    return data if data > 1 and n_pages % data == 0 else 1


def model_shards(cfg, model: int) -> int:
    """Shards of the heads, the pool's channels and the TP weights over
    'model': the axis size where it divides the heads (and so the
    channels), else 1 (replicated). The port splits q, k and v by whole
    heads, so a model axis that cuts a head is dropped."""
    return model if model > 1 and cfg.n_head % model == 0 else 1


def vocab_shards(cfg, model: int) -> int:
    """Shards of ``wte`` (and the head) over 'model': vocab-parallel
    where the vocabulary divides, else 1 (GPT-2's 50257 never does)."""
    return model if model > 1 and cfg.vocab_size % model == 0 else 1


def shard_serve_params(params, cfg, tp: int, vocab: int,
                       shards) -> dict:
    """The serving steps' weights (``models.gpt.compute_params``) split
    for the model shards ``shards`` of ``tp``: per shard m, its heads'
    q, k and v columns (each cut by heads: a contiguous cut of the (C,
    3C) kernel would hand one shard all of q and part of k), its rows of
    the attention projection and of mlp-down, its columns of mlp-up and
    their biases; layernorms and the row-parallel biases replicated.
    With ``vocab`` > 1, ``wte`` (and an untied head) split by vocabulary
    rows (columns) as well. Copies: the shards own their slices."""
    C, L = cfg.n_embd, cfg.n_layer
    cl, fl = C // tp, 4 * C // tp
    blocks = params["blocks"]
    rep = {n: blocks[n] for n in ("ln1_scale", "ln1_bias", "ln2_scale",
                                  "ln2_bias", "attn_out_bias",
                                  "mlp_down_bias")}
    tpd = {}
    for m in shards:
        heads = slice(m * cl, (m + 1) * cl)
        qkv_k = blocks["qkv_kernel"].reshape(L, C, 3, C)[..., heads]
        qkv_b = blocks["qkv_bias"].reshape(L, 3, C)[..., heads]
        ff = slice(m * fl, (m + 1) * fl)
        tpd[m] = {
            "qkv_kernel": qkv_k.reshape(L, C, 3 * cl).contiguous(),
            "qkv_bias": qkv_b.reshape(L, 3 * cl).contiguous(),
            "attn_out_kernel": blocks["attn_out_kernel"][:, heads]
            .contiguous(),
            "mlp_up_kernel": blocks["mlp_up_kernel"][..., ff].contiguous(),
            "mlp_up_bias": blocks["mlp_up_bias"][..., ff].contiguous(),
            "mlp_down_kernel": blocks["mlp_down_kernel"][:, ff]
            .contiguous(),
        }
    out = {"wpe": params["wpe"], "ln_f_scale": params["ln_f_scale"],
           "ln_f_bias": params["ln_f_bias"], "blocks": rep, "tp": tpd,
           "tp_size": tp, "vocab_shards": vocab}
    V = cfg.vocab_size
    vl = V // vocab
    if vocab > 1:
        out["wte"] = {m: params["wte"][m * vl:(m + 1) * vl].contiguous()
                      for m in shards}
        if not cfg.tied_head:
            out["lm_head"] = {m: params["lm_head"][:, m * vl:(m + 1) * vl]
                              .contiguous() for m in shards}
    else:
        out["wte"] = params["wte"]
        if not cfg.tied_head:
            out["lm_head"] = params["lm_head"]
    return out
