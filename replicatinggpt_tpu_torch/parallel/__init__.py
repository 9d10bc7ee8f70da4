"""Data and sequence parallelism in training and the serving mesh (a
port of part of ``replicatinggpt_tpu/parallel``).

``--dp N`` splits every global batch into N data shards, each a forward
and backward of its rows whose gradients are averaged
(``data_parallel``: bucketed all-reduces; with ``--fsdp`` the masters
and AdamW's moments sharded too, weights gathered per block and
gradients reduce-scattered), each shard's dropout its own
(``sharded_flash``). ``--sp N`` splits every sequence into N shards
whose causal attention is the ring (``ring_attention``). The groups are
in ``mesh``: all shards in one process, or one per ``torchrun`` process
(``distributed``). ``serve-replay --mesh-shape DxM`` serves on a (data,
model) mesh: the layout rules and the TP split of the weights in
``mesh``, the shards' group in ``serve_group`` (one process, or one
shard per ``torchrun`` process). Tensor and pipeline parallelism in
training and Ulysses attention are not in this port yet (ROADMAP.md
queue A item 11).
"""

from .mesh import (LocalDataGroup, LocalSeqGroup, ProcessDataGroup,
                   ProcessSeqGroup, fsdp_shard_dim, parse_mesh_shape,
                   shard_serve_params)
from .ring_attention import (describe_ring_route, make_ring_attention_fn,
                             ring_attention)
from .serve_group import LocalServeGroup, ProcessServeGroup, serve_group

__all__ = ["LocalDataGroup", "ProcessDataGroup", "fsdp_shard_dim",
           "LocalSeqGroup", "ProcessSeqGroup", "ring_attention",
           "make_ring_attention_fn", "describe_ring_route",
           "select_attention_fn", "LocalServeGroup", "ProcessServeGroup",
           "serve_group", "parse_mesh_shape", "shard_serve_params"]


def select_attention_fn(mcfg, mesh_cfg, group):
    """The seq-parallel attention core for a configuration, by the JAX
    package's rule (``replicatinggpt_tpu/parallel/__init__.py``
    ``select_attention_fn``) on a seq axis: 'flash' asks for the
    seq-parallel core whose hops are the kernel, so it means 'auto';
    'auto' takes Ulysses where the local heads divide by the seq axis and
    the ring otherwise. Ulysses raises (not ported yet), and so does
    'einsum', whose JAX form is GSPMD's dense attention over the sharded
    sequence. Returns None without a seq axis (``mesh_cfg.seq`` 1): the
    dense routes stand as they are."""
    if mesh_cfg.seq <= 1:
        return None
    impl = mcfg.attention_impl
    if impl == "flash":
        impl = "auto"
    if impl == "auto":
        local_heads = mcfg.n_head // max(mesh_cfg.model, 1)
        impl = "ulysses" if local_heads % mesh_cfg.seq == 0 else "ring"
    if impl == "ring":
        return make_ring_attention_fn(group, dropout_rate=mcfg.attn_dropout)
    if impl == "ulysses":
        raise NotImplementedError(
            f"Ulysses attention (seq axis {mesh_cfg.seq}, {mcfg.n_head} "
            f"heads, configured {mcfg.attention_impl!r}) is not in "
            f"replicatinggpt_tpu_torch yet: ROADMAP.md queue A item 11; "
            f"--attention ring runs the ring")
    raise NotImplementedError(
        f"attention_impl {impl!r} on a seq axis (GSPMD's dense attention "
        f"over a sharded sequence) is not in replicatinggpt_tpu_torch: "
        f"ROADMAP.md queue A item 11; --attention ring runs the ring")
