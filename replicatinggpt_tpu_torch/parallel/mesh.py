"""The training groups: where the shards of the data and seq axes live,
how a sequence's K/V chunks move around the ring, and the FSDP layout.

The JAX package's ``data`` and ``seq`` mesh axes (``replicatinggpt_tpu/
parallel/mesh.py``) with GSPMD's reductions and its ``lax.ppermute``
rotation (``parallel/ring_attention.py``), each in two forms:

- the seq axis: ``LocalSeqGroup(n)``, all n shards of every sequence in
  this process (the model runs on the whole (B, T) sequence and only
  attention is split; rotating K/V is an index shift), and
  ``ProcessSeqGroup``, one shard per process of a ``torch.distributed``
  group (the world, or a data row's subgroup): each process runs the
  model on its (B, T/n) columns at global positions and rotates K/V with
  ``batch_isend_irecv`` to rank + 1 and from rank - 1 (``RingKV``, whose
  backward rotates the gradients the other way: the VJP of
  ``ppermute``);
- the data axis: ``LocalDataGroup(n)``, all n data shards in this process
  (the counterpart of the JAX virtual mesh: each shard's B/n rows run
  their own forward and backward in turn, at a rank's shapes, and the
  collectives are in-process sums in shard order), and
  ``ProcessDataGroup``, one data shard per process (NCCL between cards,
  gloo on the CPU), with its seq subgroup when ``--sp`` > 1.

The train step (``train/steps.py``) reads a data group's ``shards``,
``rows``, ``seq``, ``mean`` and ``broadcast_``; the gradient reduction
and FSDP's gathers are ``parallel/data_parallel.py``'s, over the group's
``comm`` / ``data_comm`` / ``seq_comm``. ``fsdp_shard_dim`` is the JAX
``_leaf_spec`` FSDP rule.

The serving mesh's layout rules follow (``parse_mesh_shape``,
``page_shards``, ``model_shards``, ``vocab_shards``,
``shard_serve_params``); its groups are in ``serve_group.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

KV = Tuple[torch.Tensor, torch.Tensor]


#: the JAX tensor-parallel placement (``replicatinggpt_tpu/parallel/
#: mesh.py`` ``_tp_spec``): leaf name -> the dim 'model' takes, counted
#: from the end of the shape for the layer-stacked block leaves
_TP_DIM = {"wte": 0, "lm_head": 1, "qkv_kernel": -1, "mlp_up_kernel": -1,
           "qkv_bias": -1, "mlp_up_bias": -1, "attn_out_kernel": -2,
           "mlp_down_kernel": -2}


def fsdp_shard_dim(name: str, shape: Sequence[int],
                   data: int) -> Optional[int]:
    """The dim of the leaf ``name`` (``wte``, ``blocks/qkv_kernel``) of
    ``shape`` that FSDP shards over a data axis of ``data``: the JAX
    ``_leaf_spec`` rule, the largest dim (the first of equals) that the
    model axis does not hold, divides by ``data`` and is at least
    ``data``; None (the leaf stays whole on every shard) when none does.
    The model axis holds its tensor-parallel dim even at size 1, as in
    JAX. AdamW's moments follow their parameter."""
    ndim = len(shape)
    tp = _TP_DIM.get(name.rsplit("/", 1)[-1])
    taken = None if tp is None or ndim == 0 else tp % ndim
    for d in sorted(range(ndim), key=lambda d: -shape[d]):
        if d != taken and shape[d] % data == 0 and shape[d] >= data:
            return d
    return None


def check_backend(backend: str, t: torch.Tensor) -> None:
    """Raise for a tensor the process group's backend cannot move."""
    cuda = t.device.type == "cuda"
    if backend == "nccl" and not cuda:
        raise ValueError(f"a {t.device} tensor on an NCCL group: NCCL "
                         f"moves CUDA tensors only")
    if backend == "gloo" and cuda:
        raise ValueError("a CUDA tensor on a gloo group: run the CPU "
                         "path (--device cpu) on gloo, or NCCL on cards")


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

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass


class ProcessSeqGroup:
    """One shard per process of a ``torch.distributed`` group: the
    default (world) group, or ``group``, a data row's seq subgroup (rank
    r of the group holds shard r). Tensors must live where the backend
    works: CUDA tensors on NCCL, CPU tensors on gloo."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessSeqGroup needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shards = (self.rank,)
        self.is_main = dist.get_rank() == 0
        self.backend = dist.get_backend(group)

    def describe(self) -> str:
        return (f"{self.size} processes, one shard each "
                f"({self.backend})")

    def global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def check(self, t: torch.Tensor) -> None:
        check_backend(self.backend, t)

    def rotate(self, tensors: Sequence[torch.Tensor],
               step: int) -> List[torch.Tensor]:
        """Send each tensor to rank + step and receive its counterpart
        from rank - step (mod size), in one batch of point-to-point ops."""
        dst = self.global_rank((self.rank + step) % self.size)
        src = self.global_rank((self.rank - step) % self.size)
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, buf in zip(tensors, out):
            self.check(t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group))
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
        T, n = x.shape[-1], self.size
        if T % n:
            raise ValueError(f"sequence length {T} does not split into {n} "
                             f"shards")
        return x[..., self.rank * T // n:(self.rank + 1) * T // n]

    def pos_offset(self, local_len: int) -> int:
        return self.rank * local_len

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        self.check(y)
        dist.all_reduce(y, group=self.group)
        return y / self.size

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank (outside
        autograd: parameters are leaves)."""
        with torch.no_grad():
            for t in tensors:
                self.check(t)
                dist.broadcast(t, self.global_rank(0), group=self.group)


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


class LocalDataGroup:
    """All ``n`` data shards in this process (``seq``: the ``LocalSeqGroup``
    each shard's sequences run over, or None). ``fsdp``: the masters and
    moments live as n shards (``parallel.data_parallel.FSDPParams``)."""

    def __init__(self, n: int, seq: Optional[LocalSeqGroup] = None,
                 fsdp: bool = False):
        if n < 1:
            raise ValueError(f"a data group needs at least 1 shard, got {n}")
        self.data = n
        self.shards = tuple(range(n))
        self.seq = seq
        self.fsdp = fsdp
        self.is_main = True
        self.processes = 1
        # the loss terms a step averages
        self.replicas = n
        # this process's seq rank, and the seq ranks that are processes
        self.seq_rank, self.seq_ranks = 0, 1
        self.comm = self.backend = self.data_comm = self.seq_comm = None

    def describe(self) -> str:
        return f"one process holding all {self.data} shards"

    def rows(self, x: torch.Tensor, shard: int) -> torch.Tensor:
        """Shard ``shard``'s rows of a global batch (its dim -2)."""
        B = x.shape[-2]
        if B % self.data:
            raise ValueError(f"global batch {B} not divisible by "
                             f"{self.data} processes")
        b = B // self.data
        return x[..., shard * b:(shard + 1) * b, :]

    def mean(self, losses: Sequence[torch.Tensor]) -> torch.Tensor:
        """The step's loss: the held shards' losses summed in shard order,
        summed over the processes, over the replicas."""
        total = losses[0].detach().clone()
        for x in losses[1:]:
            total = total + x.detach()
        if self.comm is not None:
            check_backend(self.backend, total)
            dist.all_reduce(total, group=self.comm)
        return total / self.replicas

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass


class ProcessDataGroup(LocalDataGroup):
    """One data shard per process of the launch's world of ``data x seq``
    ranks, rank = d * seq + s as the JAX mesh lays out its devices
    (``make_mesh``: data before seq). On a mesh of both axes every rank
    creates every subgroup (``dist.new_group`` is collective): the seq
    groups of each data row (the ring rotates inside them) and the data
    groups of each seq column (FSDP's gathers and reduce-scatters); on a
    mesh of one axis that axis is the world. Gradients and the loss are
    summed over the whole world."""

    def __init__(self, data: int, seq: int = 1, fsdp: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("ProcessDataGroup needs an initialized "
                               "torch.distributed process group")
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != data * seq:
            raise ValueError(f"{world} processes for data {data} x seq "
                             f"{seq}: launch one process per shard")
        super().__init__(data, fsdp=fsdp)
        d, s = divmod(rank, seq)
        self.data_rank = d
        self.shards = (d,)
        self.is_main = rank == 0
        self.processes = self.replicas = world
        self.seq_rank, self.seq_ranks = s, seq
        self.comm = dist.group.WORLD
        self.backend = dist.get_backend()
        if data > 1 and seq > 1:
            seq_groups = [dist.new_group([r * seq + c for c in range(seq)])
                          for r in range(data)]
            data_groups = [dist.new_group([r * seq + c for r in range(data)])
                           for c in range(seq)]
            self.seq_comm, self.data_comm = seq_groups[d], data_groups[s]
            self.seq = ProcessSeqGroup(self.seq_comm)
        elif seq > 1:
            self.seq_comm = dist.group.WORLD
            self.seq = ProcessSeqGroup()
        else:
            self.data_comm = dist.group.WORLD

    def describe(self) -> str:
        return f"{self.processes} processes, one shard each ({self.backend})"

    def rows(self, x: torch.Tensor, shard: int) -> torch.Tensor:
        # the batchers draw this rank's rows only
        return x

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank."""
        with torch.no_grad():
            for t in tensors:
                check_backend(self.backend, t)
                dist.broadcast(t, 0)


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
