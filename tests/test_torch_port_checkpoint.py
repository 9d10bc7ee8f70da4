"""Checkpoints, resume, supervision, ``eval`` and ``export-torch`` of the
PyTorch port (``train/checkpoint.py``, ``faults/``), held against the
JAX package or against an uninterrupted run of the port.

The runs are a 2-layer model at C=128, 4 heads (D=32: the packed flash
route), T=32, B=8, dropout 0.2, random windows, 8 steps, one intra-op
thread. Every block draws its dropout seed from ``DropoutRNG.seeds``
(its residual masks and the flash plain version's mask come from it), so
a resume that did not restore that stream would fail here. Resumes and
rollbacks are held bit for bit: the losses, the weights, AdamW's moments
and count, and both generators' states.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.data import loader as jloader
from replicatinggpt_tpu.faults.supervise import (
    LossSpikeError as JLossSpikeError, LossTracker as JLossTracker,
    NonFiniteLossError as JNonFiniteLossError,
    SupervisionConfig as JSupervisionConfig)
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.reference_torch import RefGPT, params_to_torch
from replicatinggpt_tpu.train import steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.data import loader as tloader
from replicatinggpt_tpu_torch.data.dataset import TokenDataset, load_corpus
from replicatinggpt_tpu_torch.faults import (Fault, FaultPlan, LossSpikeError,
                                             LossTracker, NonFiniteLossError,
                                             SupervisionConfig,
                                             SupervisionExhausted, installed,
                                             supervised_train)
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.tokenizers import CharTokenizer
from replicatinggpt_tpu_torch.train import state as tstate
from replicatinggpt_tpu_torch.train import steps as tsteps
from replicatinggpt_tpu_torch.train.checkpoint import (CheckpointManager,
                                                       CorruptCheckpointError)
from replicatinggpt_tpu_torch.train.runner import train
from replicatinggpt_tpu_torch.utils.logging import StepLogger

CORPUS = "datasets/shakespeare.txt"
STEPS = 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(max_iters=STEPS, checkpoint_every=3):
    cfg = get_config("test-tiny")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, n_embd=128, n_head=4,
                                  dropout=0.2, attn_dropout=0.2),
        train=dataclasses.replace(cfg.train, max_iters=max_iters,
                                  eval_interval=0, eval_iters=1,
                                  log_interval=1, batch_size=8,
                                  checkpoint_every=checkpoint_every))


def _run(ck=None, **kw):
    """train() on the CPU: (result, the logged loss of each step)."""
    out = io.StringIO()
    res = train(_cfg(), device="cpu", logger=StepLogger(stream=out),
                checkpoint_manager=ck, **kw)
    losses = {int(i): float(x) for i, x in
              re.findall(r"^Step (\d+), Loss: (\S+) \|", out.getvalue(),
                         re.M)}
    return res, losses


def _assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The uninterrupted 8-step run (checkpoints at 3, 6 and 8): the
    oracle of every resume and rollback below."""
    d = tmp_path_factory.mktemp("full")
    res, losses = _run(CheckpointManager(str(d)))
    assert sorted(losses) == list(range(STEPS))
    return res, losses, str(d)


def _fresh_state():
    cfg = _cfg()
    return tstate.create_train_state(cfg.model, cfg.train, "cpu")


# ---------------------------------------------------------------------------
# batchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "sequential"])
def test_batcher_state_matches_jax_and_restore_continues(kind):
    data = np.arange(5000, dtype=np.int32) % 65
    a = tloader.make_batcher(kind, data, 4, 16, seed=5)
    b = jloader.make_batcher(kind, data, 4, 16, seed=5)
    for _ in range(3):
        a.next_batch(), b.next_batch()
    assert a.state() == b.state()
    snap = json.loads(json.dumps(a.state()))      # as a checkpoint keeps it
    want = [a.next_batch() for _ in range(2)]
    c = tloader.make_batcher(kind, data, 4, 16, seed=99)
    c.restore(snap)
    for (x, y), (cx, cy) in zip(want, (c.next_batch() for _ in range(2))):
        np.testing.assert_array_equal(x, cx)
        np.testing.assert_array_equal(y, cy)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def _trained_state(steps=2):
    cfg = _cfg()
    state = _fresh_state()
    step = tsteps.make_train_step(cfg.model, cfg.train)
    x = torch.randint(0, 65, (8, 32), generator=torch.Generator()
                      .manual_seed(1))
    for _ in range(steps):
        step(state, (x, x))
    return state


def test_full_state_round_trip_is_bitwise(tmp_path):
    state = _trained_state()
    data = np.arange(5000, dtype=np.int32) % 65
    batcher = tloader.make_batcher("random", data, 4, 16, seed=3)
    batcher.next_batch()
    ck = CheckpointManager(str(tmp_path))
    assert ck.save(state, batcher) == 2
    keys = set(state.state_dict())
    assert {"opt/count", "step", "rng/bits/cpu", "rng/seeds",
            "opt/exp_avg/blocks/qkv_kernel", "opt/exp_avg_sq/wte",
            "opt/step/wpe", "params/ln_f_bias"} <= keys
    fresh = _fresh_state()
    other = tloader.make_batcher("random", data, 4, 16, seed=4)
    assert ck.restore_latest(fresh, other) is fresh
    _assert_states_equal(state, fresh)
    assert fresh.step == 2 and fresh.optimizer.count == 2
    assert other.state() == batcher.state()
    # the weights alone restore into a template without optimizer/streams
    w = tstate.weights_state(_cfg().model, 0, "cpu")
    ck.restore(2, w)
    for (k, p), (_, q) in zip(tstate.param_leaves(state.model),
                              tstate.param_leaves(w.model)):
        assert torch.equal(p, q), k
    # another model does not fit: an error, not a fallback
    small = tstate.weights_state(get_config("test-tiny").model, 0, "cpu")
    with pytest.raises(ValueError, match="leaf wte"):
        ck.restore_latest(small)


def test_save_is_idempotent_and_max_to_keep_prunes(tmp_path):
    state = _fresh_state()
    ck = CheckpointManager(str(tmp_path), max_to_keep=2)
    ck.save(state)
    mtime = os.path.getmtime(tmp_path / "0" / "state.pt")
    assert ck.save(state) == 0
    assert os.path.getmtime(tmp_path / "0" / "state.pt") == mtime
    for s in (1, 2, 3):
        state.step = s
        ck.save(state)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(n for n in os.listdir(tmp_path)) == [
        "2", "3", "manifest-2.json", "manifest-3.json"]


def test_params_manifest_matches_jax_fingerprint(tmp_path):
    """The port's manifest records of ``params/<leaf>`` equal JAX
    ``_state_fingerprint`` of the same tree; key map: ``params/wte`` <->
    ``['wte']``, ``params/blocks/qkv_kernel`` <-> ``['blocks']
    ['qkv_kernel']``."""
    from replicatinggpt_tpu.train.checkpoint import _state_fingerprint
    jcfg = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=4,
                   n_embd=128, dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jax.random.PRNGKey(0), jcfg))
    model = tgpt.params_from_numpy(tree, _cfg().model, device="cpu")
    ck = CheckpointManager(str(tmp_path))
    ck.save(tstate.TrainState(step=0, model=model, optimizer=None, rng=None))
    with open(tmp_path / "manifest-0.json") as f:
        got = json.load(f)["arrays"]
    want = _state_fingerprint(tree)
    mapped = {"params/" + "/".join(re.findall(r"\['(\w+)'\]", k)): v
              for k, v in want.items()}
    assert {k: v for k, v in got.items() if k.startswith("params/")} == mapped


def _corrupt_newest(tmp_path, kind):
    """Steps 0 (good) and 2 (broken by ``kind``) of a trained state."""
    ck = CheckpointManager(str(tmp_path))
    ck.save(_fresh_state())
    state = _trained_state()
    with installed(FaultPlan(Fault(site="ckpt/finalize", kind=kind, at=2))):
        ck.save(state)
    return ck


@pytest.mark.parametrize("kind", ["corrupt", "truncate", "drop_manifest"])
def test_corrupt_checkpoint_named_and_fallen_past(tmp_path, kind):
    ck = _corrupt_newest(tmp_path, kind)
    with pytest.raises(CorruptCheckpointError, match="step 2 is corrupt"):
        ck.restore(2, _fresh_state())
    fresh = _fresh_state()
    assert ck.restore_latest(fresh).step == 0
    assert ck.recovery["ckpt_fallbacks"] == 1
    _assert_states_equal(_fresh_state(), fresh)


def test_nan_poisoned_checkpoint_rejected_and_all_corrupt_raises(tmp_path):
    ck = CheckpointManager(str(tmp_path), retries=0)
    assert ck.restore_latest(_fresh_state()) is None     # empty: fresh run
    ck.save(_fresh_state())
    poisoned = _fresh_state()
    with torch.no_grad():
        poisoned.model.wpe[0, 0] = float("nan")
    poisoned.step = 1
    ck.save(poisoned)
    with pytest.raises(CorruptCheckpointError, match="non-finite"):
        ck.restore(1, _fresh_state())
    assert ck.restore_latest(_fresh_state()).step == 0
    with installed(FaultPlan(Fault(site="ckpt/finalize", kind="truncate",
                                   at=2))):
        poisoned.step = 2
        ck.save(poisoned)
    os.unlink(tmp_path / "manifest-0.json")
    with pytest.raises(CorruptCheckpointError,
                       match="no restorable checkpoint"):
        ck.restore_latest(_fresh_state())


def test_transient_save_and_restore_io_retries(tmp_path):
    state = _fresh_state()
    ck = CheckpointManager(str(tmp_path))
    with installed(FaultPlan(Fault(site="ckpt/save", kind="io", times=2))):
        assert ck.save(state) == 0
    assert ck.recovery["save_retries"] == 2
    fresh = _fresh_state()
    with installed(FaultPlan(Fault(site="ckpt/restore", kind="io",
                                   times=2))):
        assert ck.restore_latest(fresh) is fresh
    assert ck.recovery["restore_retries"] == 2
    assert ck.recovery["ckpt_fallbacks"] == 0
    _assert_states_equal(state, fresh)
    with installed(FaultPlan(Fault(site="ckpt/restore", kind="io",
                                   times=99))):
        with pytest.raises(CorruptCheckpointError,
                           match="no restorable checkpoint"):
            ck.restore_latest(_fresh_state())


# ---------------------------------------------------------------------------
# resume and supervision
# ---------------------------------------------------------------------------

def test_stop_and_resume_is_bitwise(tmp_path, full_run):
    """SIGTERM at step 4 through a real handler: the run saves step 4 and
    returns (prefetch has drawn ahead; the saved cursor is the consumed
    one); a fresh state resumed from it trains to 8 bit for bit as the
    uninterrupted run, which checkpointed at 3 and 6."""
    res8, losses8, _ = full_run
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    ck = CheckpointManager(str(tmp_path))
    try:
        with installed(FaultPlan(Fault(site="train/step", kind="sigterm",
                                       at=4))):
            res, losses = _run(ck, stop_event=stop)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert res.state.step == 4 and ck.all_steps() == [3, 4]
    assert losses == {i: losses8[i] for i in range(4)}
    res2, tail = _run(ck, resume=True)
    assert tail == {i: losses8[i] for i in range(4, STEPS)}
    _assert_states_equal(res8.state, res2.state)
    assert ck.all_steps() == [4, 6, 8]


def test_nan_rollback_resumes_bitwise(tmp_path, full_run):
    res8, _, _ = full_run
    ck = CheckpointManager(str(tmp_path))
    with installed(FaultPlan(Fault(site="train/step", kind="nan_params",
                                   at=6))) as plan:
        out = supervised_train(_cfg(), checkpoint_manager=ck, device="cpu",
                               logger=StepLogger(stream=io.StringIO()),
                               supervision=SupervisionConfig(check_every=1))
    assert plan.count("train/step", "nan_params") == 1
    assert out.counters.get("rollbacks") == 1
    assert out.counters.get("data_skips") is None
    assert out.result.state.step == STEPS
    _assert_states_equal(res8.state, out.result.state)


def test_repeat_failure_advances_cursor_then_exhausts(tmp_path):
    quiet = {"device": "cpu", "logger": StepLogger(stream=io.StringIO()),
             "supervision": SupervisionConfig(check_every=1)}
    ck = CheckpointManager(str(tmp_path / "a"))
    with installed(FaultPlan(Fault(site="train/loss", kind="nan", at=5,
                                   times=2))):
        out = supervised_train(_cfg(), checkpoint_manager=ck, **quiet)
    assert out.counters.get("rollbacks") == 2
    assert out.counters.get("data_skips") == 1
    assert out.result.state.step == STEPS
    ck = CheckpointManager(str(tmp_path / "b"))
    with installed(FaultPlan(Fault(site="train/loss", kind="nan", at=5,
                                   times=99))):
        with pytest.raises(SupervisionExhausted):
            supervised_train(_cfg(), checkpoint_manager=ck,
                             max_rollbacks=2, **quiet)


def test_loss_tracker_decides_as_jax():
    losses = [4.0, 3.9, 3.8, 3.85, 3.7, 3.6, 50.0, 3.5, float("nan"),
              float("inf")]
    for cfg in ({"spike_factor": 5.0, "warmup_checks": 2},
                {"spike_factor": 0.0}):
        got = LossTracker(SupervisionConfig(**cfg))
        want = JLossTracker(JSupervisionConfig(**cfg))
        for i, x in enumerate(losses):
            outcome = []
            for tr, kinds in ((got, (NonFiniteLossError, LossSpikeError)),
                              (want, (JNonFiniteLossError,
                                      JLossSpikeError))):
                try:
                    tr.check(i, x)
                    outcome.append(None)
                except kinds as e:
                    outcome.append(kinds.index(type(e)))
            assert outcome[0] == outcome[1] and got.ema == want.ema, (i, x)


def test_train_cli_sigterm_saves_exits_0_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    argv = ["train", "--preset", "test-tiny", "--device", "cpu",
            "--max-iters", "6", "--eval-interval", "0", "--eval-iters", "1",
            "--log-interval", "1", "--checkpoint-dir", d]
    out = io.StringIO()
    with installed(FaultPlan(Fault(site="train/step", kind="sigterm",
                                   at=2))):
        with contextlib.redirect_stdout(out):
            assert cli.main(argv) == 0
    assert "stop requested at step 2" in out.getvalue()
    assert CheckpointManager(d).all_steps() == [2]
    with contextlib.redirect_stdout(out):
        assert cli.main(argv + ["--resume"]) == 0
    assert "resumed from step 2" in out.getvalue()
    assert CheckpointManager(d).all_steps() == [2, 6]
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        cli.main(argv[:-2] + ["--resume"])


#: one rank of ``train --sp 2`` as ``torchrun`` starts it; rank 1 raises
#: SIGTERM through the train/step seam at step 2
LAUNCH_CHILD = """
import os, sys
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, install
if os.environ["RANK"] == "1":
    install(FaultPlan(Fault(site="train/step", kind="sigterm", at=2)))
sys.exit(cli.main(sys.argv[1:]))
"""


def test_sigterm_under_a_launch_is_ignored_and_both_ranks_finish():
    """Signals reach a launch's ranks at different steps: a rank that
    left the loop alone would wait in the final estimate's ring
    collectives for the other's train step. So under a launch the stop
    is off (logged), and both ranks run every step and exit 0."""
    argv = [sys.executable, "-c", LAUNCH_CHILD, "train", "--preset",
            "test-tiny", "--device", "cpu", "--sp", "2", "--attention",
            "ring", "--max-iters", "5", "--eval-interval", "0",
            "--eval-iters", "1", "--log-interval", "1"]
    with socket.socket() as sock:      # a free port for the rendezvous
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r),
                           LOCAL_RANK=str(r), WORLD_SIZE="2",
                           MASTER_ADDR="localhost", MASTER_PORT=port,
                           PYTHONPATH=str(REPO) + os.pathsep
                           + os.environ.get("PYTHONPATH", "")))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    log = outs[0][0]
    assert "note: graceful stop disabled" in log, log
    assert "stop requested" not in log and "Step 4, Loss:" in log, log


@pytest.mark.parametrize("cmd", [
    ["eval"], ["generate"], ["serve-replay", "--n-requests", "1"],
    ["export-torch", "--out", "model.pth"]])
def test_read_only_commands_refuse_a_missing_checkpoint_dir(tmp_path, cmd):
    """A mistyped --checkpoint-dir fails: it is not made, and no command
    goes on from random init (an existing, empty one still does)."""
    d = tmp_path / "no-such-dir"
    argv = cmd[:1] + ["--preset", "test-tiny", "--device", "cpu",
                      "--checkpoint-dir", str(d)] + cmd[1:]
    if cmd[0] == "export-torch":
        argv = [a for a in argv if a not in ("--device", "cpu")]
        argv[-1] = str(tmp_path / argv[-1])
    with pytest.raises(SystemExit, match="no such directory"):
        cli.main(argv)
    assert not d.exists() and not (tmp_path / "model.pth").exists()


def test_checkpoints_under_a_launch_are_refused(tmp_path, monkeypatch):
    """A launch whose size is not the mesh's (2 processes, no --dp) is
    refused before it writes a step."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="2 processes for data 1 x seq 1"):
        cli.main(["train", "--preset", "test-tiny", "--device", "cpu",
                  "--checkpoint-dir", str(tmp_path)])
    assert CheckpointManager(str(tmp_path)).all_steps() == []


# ---------------------------------------------------------------------------
# eval and export-torch
# ---------------------------------------------------------------------------

def _jax_tree(model):
    return jax.tree_util.tree_map(
        lambda t: np.asarray(t.detach().numpy()), model.tree())


def test_eval_cli_equals_jax_estimate_loss(full_run):
    res8, _, d = full_run
    cfg = _cfg()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["eval", "--preset", "test-tiny", "--n-embd", "128",
                         "--n-head", "4", "--device", "cpu", "--eval-iters",
                         "2", "--checkpoint-dir", d]) == 0
    printed = re.fullmatch(r"train loss (\S+), val loss = (\S+)\n",
                           out.getvalue()).groups()
    text = load_corpus(CORPUS)
    tok = CharTokenizer.from_text(text)
    ds = TokenDataset.from_text(text, tok, cfg.train.val_fraction)
    mk = (lambda lib: {s: lib.make_batcher("random", data, 8, 32, seed=n)
                       for s, data, n in (("train", ds.train, 1),
                                          ("val", ds.val, 2))})
    got = tsteps.estimate_loss(res8.state.model.tree(), mk(tloader),
                               tsteps.make_eval_step(cfg.model), 2, "cpu")
    jcfg = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=4,
                   n_embd=128, dtype="float32", dropout=0.2,
                   attn_dropout=0.2)
    want = jsteps.estimate_loss(_jax_tree(res8.state.model), mk(jloader),
                                jsteps.make_eval_step(jcfg), 2)
    for i, split in enumerate(("train", "val")):
        assert got[split] == pytest.approx(want[split], rel=1e-5)
        assert printed[i] == f"{got[split]:.4f}"


def test_export_torch_loads_into_reference(tmp_path, full_run):
    res8, _, d = full_run
    out_file = str(tmp_path / "model.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["export-torch", "--preset", "test-tiny",
                         "--n-embd", "128", "--n-head", "4",
                         "--checkpoint-dir", d, "--out", out_file]) == 0
    sd = torch.load(out_file, weights_only=True)
    jcfg = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=4,
                   n_embd=128, dtype="float32", dropout=0.0,
                   attn_dropout=0.0)
    ref = RefGPT(jcfg)
    ref.load_state_dict(sd, strict=True)
    want = params_to_torch(_jax_tree(res8.state.model),
                           RefGPT(jcfg)).state_dict()
    assert list(sd) == list(want)
    for k in want:
        assert sd[k].dtype == torch.float32 and sd[k].device.type == "cpu"
        assert torch.equal(sd[k], want[k]), k
    idx = torch.randint(0, 65, (2, 32), generator=torch.Generator()
                        .manual_seed(0))
    mcfg = dataclasses.replace(_cfg().model, dropout=0.0, attn_dropout=0.0)
    with torch.no_grad():
        port, _ = tgpt.forward(res8.state.model.tree(), idx, mcfg)
        logits, _ = ref(idx)
    torch.testing.assert_close(logits, port, atol=1e-5, rtol=1e-5)
