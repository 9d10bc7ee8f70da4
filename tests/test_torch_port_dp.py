"""Data parallelism and FSDP in the port's training (``train --dp N
[--fsdp]``), against the JAX package's data axis.

At the JAX sharding tests' size (2 layers, C=32, T=32, f32), on the CPU:

- the FSDP shard rule (``parallel.mesh.fsdp_shard_dim``) against JAX's
  ``state_pspecs`` for data in {2, 4, 8}, over every leaf of the
  parameters and both AdamW moments, and the presets' meshes against
  JAX's;
- the one-process ``--dp 2`` step (``LocalDataGroup``), with and without
  FSDP, against the JAX step on the conftest's virtual mesh
  (``MeshConfig(data=2[, fsdp=True])``): 3 steps, losses to 2e-4
  relative, weights to 1e-5;
- ``SequentialBatcher(shard=(i, n))``, ``local_batch_slice`` and
  ``per_process_seed`` against the JAX functions;
- 2 gloo processes (``ProcessDataGroup``) against one process: 3 steps
  with and without FSDP, 2 accumulated micro-batches, clip 1.0 and
  attention dropout 0.1 through the plain core (each data shard's own
  streams), one gradient bucket a unit of weights (so buckets land while
  the backward runs): losses, weights and both moments to 1e-5; then, in
  the same
  processes, a checkpointed run stopped at a checkpoint boundary by rank
  0's SIGTERM and resumed, bit for bit the uninterrupted run, and its
  last step restored into one process;
- 4 gloo processes of ``--dp 2 --sp 2`` (the ring inside each data row's
  seq subgroup) against one process;
- the CLI: ``--tp``, ``--pp``, ``--microbatches``, ``--attention
  ulysses`` and a model axis still refused with queue A item 11; a launch
  of another size than data x seq refused; a preset's mesh degraded with
  the JAX warning.

The children import the port only (no JAX); each costs ~3 s of torch
import and ~2 s of ``torch._dynamo`` import at its first AdamW step, so
both launches start together and run while JAX compiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import (MeshConfig as JMesh,
                                       ModelConfig as JModel,
                                       TrainConfig as JTrain,
                                       get_config as jget)
from replicatinggpt_tpu.data import loader as jloader
from replicatinggpt_tpu.parallel import distributed as jdist
from replicatinggpt_tpu.parallel.mesh import (make_batch_sharding,
                                              make_mesh, shard_train_state,
                                              state_pspecs)
from replicatinggpt_tpu.train import state as jstate, steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import (PRESETS, MeshConfig, ModelConfig,
                                             TrainConfig, resolve_mesh)
from replicatinggpt_tpu_torch.data import loader as tloader
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.parallel import distributed as tdist
from replicatinggpt_tpu_torch.parallel.data_parallel import FSDPParams
from replicatinggpt_tpu_torch.parallel.mesh import (LocalDataGroup,
                                                    fsdp_shard_dim)
from replicatinggpt_tpu_torch.train import state as tstate, steps as tsteps
from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
from replicatinggpt_tpu_torch.train.runner import train
from replicatinggpt_tpu_torch.utils.logging import StepLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
KW = dict(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=32,
          dropout=0.0, attn_dropout=0.0, dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the FSDP layout and the presets' meshes
# ---------------------------------------------------------------------------

def _jax_leaf_dims(tree, mesh_cfg):
    """{path: index of 'data' in the leaf's spec, or None}."""
    specs = state_pspecs(tree, mesh_cfg)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(k.key) if isinstance(k, jax.tree_util.DictKey)
                else k.name for k in path
                if isinstance(k, (jax.tree_util.DictKey,
                                  jax.tree_util.GetAttrKey))]
        out[tuple(keys)] = (tuple(spec).index("data") if "data" in
                            tuple(spec) else None)
    return out


@pytest.mark.parametrize("data", [2, 4, 8])
def test_fsdp_shard_rule_matches_jax_state_pspecs(data):
    """Every leaf of the parameters and of AdamW's mu and nu: the port's
    shard dim is the dim JAX's ``_leaf_spec`` puts 'data' on, and the
    port's shards have JAX's shard shapes."""
    mcfg = dataclasses.replace(JModel(**KW), vocab_size=66)
    abstract = jax.eval_shape(lambda: jstate.create_train_state(
        jax.random.PRNGKey(0), mcfg, JTrain(lr=1e-3)))
    dims = _jax_leaf_dims(abstract.params, JMesh(data=data, fsdp=True))
    opt_dims = _jax_leaf_dims(abstract.opt_state, JMesh(data=data,
                                                        fsdp=True))
    model = tgpt.init_params(ModelConfig(**{**KW, "vocab_size": 66}),
                             torch.Generator().manual_seed(0))
    fsdp = FSDPParams(tstate.param_leaves(model), data, range(data))
    seen = 0
    for spec in fsdp.specs:
        path = tuple(spec.name.split("/"))
        assert fsdp_shard_dim(spec.name, spec.shape, data) == dims[path], \
            spec
        for k, moments in opt_dims.items():
            if k[-len(path):] == path and k[0] in ("mu", "nu"):
                assert moments == dims[path], (k, spec)
                seen += 1
        shard = fsdp.shards[spec.name][data - 1]
        want = list(spec.shape)
        if dims[path] is not None:
            want[dims[path]] //= data
        assert list(shard.shape) == want, spec
    assert seen == 2 * len(fsdp.specs)


def test_presets_carry_the_jax_meshes():
    for name, cfg in PRESETS.items():
        j = jget(name).mesh
        assert (cfg.mesh.data, cfg.mesh.seq, cfg.mesh.fsdp) == (
            j.data, j.seq, j.fsdp), name
    assert resolve_mesh(PRESETS["gpt2-small"].mesh, 8).data == 8
    one = resolve_mesh(PRESETS["gpt2-xl"].mesh, 1)
    assert (one.data, one.fsdp) == (1, False)
    assert resolve_mesh(MeshConfig(data=4), 1).data == 4   # explicit --dp


# ---------------------------------------------------------------------------
# the one-process step against the JAX sharded step
# ---------------------------------------------------------------------------

#: the weights' bound against JAX: AdamW turns float noise in a gradient
#: near its eps into lr-sized steps, and 3 steps at lr 1e-3 leave JAX's own
#: FSDP and single-device weights 2.7e-5 apart on this model (the ring
#: test's bound); the port's processes against one process hold TOL
JAX_WEIGHTS_TOL = 1e-4


@pytest.mark.parametrize("fsdp", [False, True])
def test_local_dp_step_matches_jax_sharded_step(fsdp, launches):
    tk = dict(batch_size=4, lr=1e-3, grad_clip=1.0)
    jt, tt = JTrain(**tk), TrainConfig(**tk)
    jcfg, tcfg = JModel(**KW), ModelConfig(**KW)
    mesh_cfg = JMesh(data=2, fsdp=fsdp)
    mesh = make_mesh(mesh_cfg)
    state = shard_train_state(
        lambda: jstate.create_train_state(jax.random.PRNGKey(0), jcfg, jt),
        mesh, mesh_cfg)
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    bs = make_batch_sharding(mesh)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jt, donate=False))
    group = LocalDataGroup(2, fsdp=fsdp)
    ts = tstate.create_train_state(
        tcfg, tt, "cpu", model=tgpt.params_from_numpy(tree, tcfg),
        group=group)
    tstep = tsteps.make_train_step(tcfg, tt, None, group)
    rng = np.random.default_rng(0)
    jl, tl = [], []
    for _ in range(3):
        x = rng.integers(0, 65, (4, 32), dtype=np.int32)
        y = np.roll(x, -1, axis=1).astype(np.int32)
        state, m = jstep(state, (jax.device_put(x, bs),
                                 jax.device_put(y, bs)))
        jl.append(float(m["loss"]))
        tl.append(float(tstep(ts, (torch.from_numpy(x),
                                   torch.from_numpy(y)))))
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    want = jax.tree_util.tree_map(np.asarray, state.params)
    got = ts.state_dict()
    for name, t in got.items():
        if name.startswith("params/"):
            keys = name.split("/")[1:]
            ref = want[keys[0]] if len(keys) == 1 else want[keys[0]][keys[1]]
            np.testing.assert_allclose(t.numpy(), ref, atol=JAX_WEIGHTS_TOL,
                                       rtol=JAX_WEIGHTS_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the data-sharded batchers
# ---------------------------------------------------------------------------

def test_sharded_batchers_and_seeds_match_jax(monkeypatch):
    data = np.arange(5000, dtype=np.int32) % 65
    for n in (1, 2, 4):
        for i in range(n):
            a = tloader.SequentialBatcher(data, 3, 16, shard=(i, n))
            b = jloader.SequentialBatcher(data, 3, 16, shard=(i, n))
            for _ in range(40):     # past a wrap of the global cursor
                for u, v in zip(a.next_batch(), b.next_batch()):
                    np.testing.assert_array_equal(u, v)
            assert a.state() == b.state()
    # the shards together are one process's stream
    one = tloader.SequentialBatcher(data, 4, 16)
    parts = [tloader.SequentialBatcher(data, 2, 16, shard=(i, 2))
             for i in range(2)]
    for _ in range(5):
        x, _ = one.next_batch()
        np.testing.assert_array_equal(
            x, np.concatenate([p.next_batch()[0] for p in parts]))
    for i in range(4):
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        assert tdist.per_process_seed(1337, i) == jdist.per_process_seed(1337)
        assert tdist.local_batch_slice(32, 4, i) == \
            jdist.local_batch_slice(32)
    with pytest.raises(ValueError, match="global batch 30 not divisible by "
                                         "4 processes"):
        tdist.local_batch_slice(30, 4, 0)


# ---------------------------------------------------------------------------
# gloo processes against one process
# ---------------------------------------------------------------------------

#: run in the spawned ranks (no JAX) and, for the one-process side, here
WORKER = r'''
import dataclasses, io, os, signal, sys, threading
import numpy as np
import torch
import torch.distributed as dist
from replicatinggpt_tpu_torch.config import (MeshConfig, ModelConfig,
                                             TrainConfig, get_config)
from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, clear, install
from replicatinggpt_tpu_torch.parallel import (data_parallel,
                                               select_attention_fn)
from replicatinggpt_tpu_torch.parallel.mesh import (LocalDataGroup,
                                                    LocalSeqGroup,
                                                    ProcessDataGroup)
from replicatinggpt_tpu_torch.train import state as tstate, steps as tsteps
from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
from replicatinggpt_tpu_torch.train.runner import train
from replicatinggpt_tpu_torch.utils.logging import StepLogger

DP_KW = dict(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=32,
             dropout=0.0, attn_dropout=0.1, dtype="float32")
SP_KW = dict(vocab_size=65, block_size=64, n_layer=2, n_head=4, n_embd=64,
             dropout=0.0, attn_dropout=0.0, dtype="float32",
             attention_impl="ring")


def rows_of(group, x):
    """A global (accum, B, T) batch's rows that the group's process runs:
    all of them in one process, a data rank's under a launch."""
    if group.comm is None or group.data == 1:
        return x
    b = x.shape[1] // group.data
    return x[:, group.data_rank * b:(group.data_rank + 1) * b]


def run_steps(group, kw, accum, n_steps, mesh=None):
    """n_steps train steps: (losses, every array of the gathered state)."""
    mcfg = ModelConfig(**kw)
    tcfg = TrainConfig(batch_size=4, lr=1e-3, grad_clip=1.0,
                       grad_accum_steps=accum, seed=5)
    state = tstate.create_train_state(mcfg, tcfg, "cpu", group=group)
    fn = None if mesh is None else select_attention_fn(mcfg, mesh, group.seq)
    step = tsteps.make_train_step(mcfg, tcfg, fn, group)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(n_steps):
        x = rng.integers(0, 65, (accum, 4, mcfg.block_size))
        y = np.roll(x, -1, -1)
        x, y = rows_of(group, x), rows_of(group, y)
        if accum == 1:
            x, y = x[0], y[0]
        losses.append(float(step(state, (torch.from_numpy(x),
                                         torch.from_numpy(y)))))
    return losses, state.state_dict()


def ckpt_config():
    cfg = get_config("test-tiny")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.1,
                                       attn_dropout=0.1),
        train=dataclasses.replace(cfg.train, max_iters=6, eval_interval=0,
                                  eval_iters=1, log_interval=1,
                                  checkpoint_every=2),
        mesh=MeshConfig(data=2))


def ckpt_runs(root, rank):
    """Uninterrupted; stopped by rank 0's SIGTERM at step 3 (so at the
    boundary of step 4); resumed. (full state, resumed state, log)."""
    cfg = ckpt_config()
    out = io.StringIO()
    log = StepLogger(stream=out)
    full = train(cfg, device="cpu", logger=log,
                 checkpoint_manager=CheckpointManager(f"{root}/a"))
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    if rank == 0:
        install(FaultPlan(Fault(site="train/step", kind="sigterm", at=3)))
    try:
        train(cfg, device="cpu", logger=log, stop_event=stop,
              checkpoint_manager=CheckpointManager(f"{root}/b"))
    finally:
        clear()
        signal.signal(signal.SIGTERM, prev)
    steps = CheckpointManager(f"{root}/b").all_steps()
    resumed = train(cfg, device="cpu", logger=log, resume=True,
                    checkpoint_manager=CheckpointManager(f"{root}/b"))
    return (full.state.state_dict(), resumed.state.state_dict(), steps,
            out.getvalue())


def child(kind, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    try:
        if kind == "dp":
            # a bucket a unit of weights: more buckets in flight than the
            # reducer keeps, so the older ones land during the backward
            data_parallel.BUCKET_BYTES = 1
            res = {f: run_steps(ProcessDataGroup(2, 1, f), DP_KW, 2, 3)
                   for f in (False, True)}
            res["ckpt"] = ckpt_runs(out + ".ck", rank)
        else:
            res = run_steps(ProcessDataGroup(2, 2), SP_KW, 1, 2,
                            MeshConfig(seq=2))
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()
'''


def _start(kind: str, n: int, root):
    """``WORKER.child(kind)`` in ``n`` gloo processes as torchrun starts
    them: (the processes, rank 0's result file)."""
    out = str(root / f"{kind}.pt")
    with socket.socket() as sock:       # a free port for the rendezvous
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    code = WORKER + f"\nchild({kind!r}, {out!r})\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                 MASTER_ADDR="localhost", MASTER_PORT=port,
                 PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
        for r in range(n)]
    return procs, out


def _result(run):
    procs, out = run
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both gloo launches, started together by the module's first
    comparison, so that they run while JAX compiles its steps; each
    gloo test waits on its own."""
    root = tmp_path_factory.mktemp("dp")
    runs = {"dp": _start("dp", 2, root), "sp": _start("sp", 4, root),
            "root": root}
    yield runs
    for kind in ("dp", "sp"):
        for p in runs[kind][0]:
            p.kill()


@pytest.fixture(scope="module")
def worker():
    ns: dict = {}
    exec(compile(WORKER, "WORKER", "exec"), ns)
    return ns


def _same(got: dict, want: dict, names, tol=TOL):
    for k in names:
        torch.testing.assert_close(got[k], want[k], atol=tol, rtol=tol,
                                   msg=k)


def test_two_gloo_processes_match_one_process(worker, launches):
    """``ProcessDataGroup(2)`` against ``LocalDataGroup(2)``, FSDP off and
    on: accumulation 2, clip 1.0, attention dropout 0.1 (each data
    shard's own streams, so the masks agree); then the checkpoint stopped
    at a boundary by rank 0's flag and resumed bit for bit, restored into
    one process."""
    res = _result(launches["dp"])
    for fsdp in (False, True):
        losses, arrays = res[fsdp]
        want_l, want = worker["run_steps"](LocalDataGroup(2, fsdp=fsdp),
                                           worker["DP_KW"], 2, 3)
        np.testing.assert_allclose(losses, want_l, rtol=TOL)
        names = [k for k in want if k.startswith(("params/", "opt/exp"))]
        assert len(names) == 3 * 16
        _same(arrays, want, names)
    full, resumed, steps, log = res["ckpt"]
    assert steps == [2, 4], (steps, log)
    assert "stop requested at step 4" in log, log
    assert "resumed from step 4" in log, log
    assert set(full) == set(resumed)
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    # the launch's last step, gathered, restores into one process holding
    # both data shards (and their dropout streams)
    cfg = worker["ckpt_config"]()
    one = tstate.create_train_state(cfg.model, cfg.train, "cpu",
                                    group=LocalDataGroup(2))
    CheckpointManager(str(launches["root"] / "dp.pt.ck" / "b")
                      ).restore_latest(one)
    mine = one.state_dict()
    assert set(mine) == set(resumed) and one.step == 6
    for k in mine:
        assert torch.equal(mine[k], resumed[k]), k


def test_dp2_sp2_gloo_processes_match_one_process(worker, launches):
    """4 ranks, data 2 x seq 2: the ring rotates inside each data row's
    seq subgroup, the gradients average over the world."""
    losses, arrays = _result(launches["sp"])
    want_l, want = worker["run_steps"](
        LocalDataGroup(2, worker["LocalSeqGroup"](2)), worker["SP_KW"], 1,
        2, MeshConfig(seq=2))
    np.testing.assert_allclose(losses, want_l, rtol=TOL)
    _same(arrays, want, [k for k in want if k.startswith("params/")])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--preset", "test-tiny", "--device", "cpu",
                         "--eval-iters", "1", *argv]) == 0
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--pp", "2"], ["--microbatches", "4"],
    ["--attention", "ulysses"], ["--mesh-shape", "2x2"],
    ["--dp", "2", "--tp", "2"]])
def test_train_still_refuses_the_other_axes(argv):
    with pytest.raises(SystemExit, match="queue A item 11"):
        _cli(*argv, "--max-iters", "1")


def test_launch_size_and_batch_must_fit_the_mesh(monkeypatch):
    with pytest.raises(ValueError, match="global batch 8 not divisible by "
                                         "3 processes"):
        _cli("--dp", "3", "--max-iters", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="3 processes for data 2 x seq 1"):
        _cli("--dp", "2", "--max-iters", "1")


def test_dp_cli_and_the_preset_degrade(capsys):
    """``--dp 2`` and ``--mesh-shape 2x1`` run the one-process group with
    the plain run's losses (random windows of the global batch); a
    preset's mesh that one process cannot fill runs unsharded, warned."""
    argv = ("--max-iters", "4", "--eval-interval", "0", "--log-interval",
            "2", "--seed", "3")
    plain = _cli(*argv)
    for extra in (("--dp", "2"), ("--mesh-shape", "2x1"),
                  ("--dp", "2", "--fsdp")):
        text = _cli(*argv, *extra)
        assert ("data parallelism: data axis 2, FSDP "
                f"{'on' if '--fsdp' in extra else 'off'}, one process "
                f"holding all 2 shards") in text
        steps = [line for line in text.splitlines() if line.startswith(
            "Step")]
        want = [line for line in plain.splitlines() if line.startswith(
            "Step")]
        assert [s.split("|")[0] for s in steps] == \
            [s.split("|")[0] for s in want]
    capsys.readouterr()
    cfg = PRESETS["test-tiny"]
    cfg = dataclasses.replace(
        cfg, mesh=MeshConfig(data=8, fsdp=True, preset=True),
        train=dataclasses.replace(cfg.train, max_iters=1, eval_interval=0,
                                  eval_iters=1))
    out = io.StringIO()
    res = train(cfg, device="cpu", logger=StepLogger(stream=out))
    assert ("warning: mesh wants 8 devices, have 1; running unsharded"
            in capsys.readouterr().err)
    assert "data parallelism" not in out.getvalue()
    assert res.state.fsdp is None and res.state.rngs is None
