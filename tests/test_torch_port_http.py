"""The port's HTTP/SSE front door (serve/http.py) and its ``serve``
subcommand, on the CPU, over real loopback sockets, mirroring the JAX
front door's tests: submit and stream against the port's offline greedy
``generate()`` (itself held against the JAX package), generate and
result, the rejection status codes with ``request_from_json`` held
against the JAX function on the same bodies, cancel mid-stream, a client
disconnect that frees the slot and pages, the stepping task's death, the
ledger drain before ``done``, the rate limit, the slow-loris guard,
liveness and readiness (503 until the replicas are warm). Then the CLI:
one ``serve --device cpu --preset test-tiny`` subprocess round trip, and
every JAX flag and subcommand the port refuses, each with its ROADMAP
item.
"""

import asyncio
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from replicatinggpt_tpu.serve.http import \
    request_from_json as jrequest_from_json
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models.gpt import init_params
from replicatinggpt_tpu_torch.sample.generate import (GenerateConfig,
                                                      generate)
from replicatinggpt_tpu_torch.serve import EngineConfig, Router, RouterConfig
from replicatinggpt_tpu_torch.serve.http import (RateLimitConfig, ServeApp,
                                                 request_from_json)
from replicatinggpt_tpu_torch.serve.requests import RequestResult

REPO = pathlib.Path(__file__).resolve().parents[1]
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=32, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")


def _app(model, n_replicas=1, **kw):
    router = Router(model, TCFG, RouterConfig(n_replicas=n_replicas),
                    EngineConfig(pool_size=2, max_queue=4), device="cpu")
    return ServeApp(router, **kw)


def _offline(model, prompt, n):
    return generate(model, [prompt], TCFG,
                    GenerateConfig(max_new_tokens=n, greedy=True),
                    device="cpu")[0].tolist()


async def _request(host, port, method, path, body=None, headers=""):
    """One HTTP exchange; (status, parsed or raw body, raw head)."""
    r, w = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    w.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n{headers}"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await w.drain()
    data = await r.read()
    w.close()
    await w.wait_closed()
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    try:
        return status, json.loads(rest), head
    except ValueError:
        return status, rest, head


def _sse_events(raw: bytes):
    out = []
    for block in raw.decode().split("\n\n"):
        ev, data = "message", None
        for line in block.splitlines():
            if line.startswith("event: "):
                ev = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        if data is not None:
            out.append((ev, data))
    return out


async def _stream(host, port, rid):
    r, w = await asyncio.open_connection(host, port)
    w.write(f"GET /v1/stream/{rid} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await w.drain()
    data = await r.read()
    w.close()
    await w.wait_closed()
    return _sse_events(data.partition(b"\r\n\r\n")[2])


def _rst(w):
    """Vanish mid-stream: RST, not a graceful close."""
    w.get_extra_info("socket").setsockopt(
        socket.SOL_SOCKET, socket.SO_LINGER,
        b"\x01\x00\x00\x00\x00\x00\x00\x00")
    w.close()


def test_submit_stream_generate_and_result(model):
    """Submit + SSE stream delivers offline greedy's tokens, one done
    event, and frees the id; /v1/generate streams in one round trip; the
    result endpoint answers 202 while running, then the result once."""
    want = _offline(model, [1, 2, 3], 8)

    async def main():
        app = _app(model, n_replicas=2)
        host, port = await app.start()
        try:
            st, body, _ = await _request(
                host, port, "POST", "/v1/submit",
                {"id": "a", "prompt": [1, 2, 3], "max_new_tokens": 8,
                 "greedy": True})
            assert st == 200 and body["status"] == "accepted"
            events = await _stream(host, port, "a")
            assert [d["token"] for ev, d in events if ev == "message"] \
                == want
            done = [d for ev, d in events if ev == "done"]
            assert len(done) == 1 and done[0]["n_tokens"] == 8
            assert done[0]["finish_reason"] == "max_tokens"
            st, _, _ = await _request(host, port, "GET", "/v1/result/a")
            assert st == 404
            r, w = await asyncio.open_connection(host, port)
            payload = json.dumps({"prompt": [5, 6], "max_new_tokens": 4,
                                  "greedy": True}).encode()
            w.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                    + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                    + payload)
            await w.drain()
            data = await r.read()
            w.close()
            assert b"text/event-stream" in data.partition(b"\r\n\r\n")[0]
            events = _sse_events(data.partition(b"\r\n\r\n")[2])
            assert [d["token"] for ev, d in events if ev == "message"] \
                == _offline(model, [5, 6], 4)
            app.router.step = lambda: []      # hold the next one running
            st, _, _ = await _request(host, port, "POST", "/v1/submit",
                                      {"id": "p", "prompt": [7, 8],
                                       "max_new_tokens": 3, "greedy": True})
            st, body, _ = await _request(host, port, "GET", "/v1/result/p")
            assert st == 202 and body["status"] == "running"
            del app.router.step
            for _ in range(400):
                st, body, _ = await _request(host, port, "GET",
                                             "/v1/result/p")
                if st == 200:
                    break
                await asyncio.sleep(0.005)
            assert st == 200 and body["tokens"] == _offline(model, [7, 8], 3)
            st, _, _ = await _request(host, port, "GET", "/v1/result/p")
            assert st == 404
        finally:
            await app.stop()

    asyncio.run(main())


BODIES = [{"prompt": [1, 2], "max_new_tokens": 3, "greedy": True,
           "rng_seed": 4, "temperature": 0.5, "top_k": 3, "top_p": 0.9,
           "eos_token_id": 7, "id": "x"},
          {"prompt": []}, {"prompt": "nope"}, {"prompt": [True]},
          {"prompt": [1, 70]}, {"prompt": [-1]}, {"prompt": [1], "id": ""},
          {"prompt": [1], "deadline_s": "ten"},
          {"prompt": [1], "deadline_s": 2.5}, {"prompt": [3, 4]}]


def test_request_from_json_matches_jax():
    """The same bodies build the same requests, or the same errors."""
    for body in BODIES:
        got, gerr = request_from_json(body, "d0", lambda: 10.0, vocab=65)
        want, werr = jrequest_from_json(body, "d0", lambda: 10.0, vocab=65)
        assert gerr == werr, body
        if want is None:
            assert got is None
            continue
        assert (got.id, got.max_new_tokens, got.deadline, got.rng_seed,
                got.eos_token_id) == (want.id, want.max_new_tokens,
                                      want.deadline, want.rng_seed,
                                      want.eos_token_id), body
        assert np.array_equal(got.prompt, want.prompt)
        assert vars(got.sampling) == vars(want.sampling), body


def test_backpressure_and_validation_status_codes(model):
    async def main():
        app = _app(model)             # pool 2, queue 4
        host, port = await app.start()
        real_step = app.router.step
        app.router.step = lambda: []  # freeze the fleet under the storm
        try:
            statuses = []
            for i in range(12):
                st, _, _ = await _request(
                    host, port, "POST", "/v1/submit",
                    {"id": f"b{i}", "prompt": [1, 2],
                     "max_new_tokens": 20, "greedy": True})
                statuses.append(st)
            assert statuses[:4] == [200] * 4
            assert set(statuses[4:]) == {429}
            for body, want in (({"prompt": []}, 400),
                               ({"prompt": [1] * 100,
                                 "max_new_tokens": 2}, 413),
                               ({"prompt": "nope"}, 400),
                               ({"prompt": [1, 10_000]}, 400),
                               ({"prompt": [1], "deadline_s": "ten"}, 400),
                               ({"id": "b0", "prompt": [3]}, 400)):
                st, resp, _ = await _request(host, port, "POST",
                                             "/v1/submit", body)
                assert st == want, (body, st, resp)
            r, w = await asyncio.open_connection(host, port)
            w.write(b"POST /v1/submit HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: ten\r\n\r\n")
            await w.drain()
            data = await r.read()
            w.close()
            assert b" 400 " in data.split(b"\r\n", 1)[0]
            for path in ("/v1/stream/nonexistent", "/no/such/route"):
                st, _, _ = await _request(host, port, "GET", path)
                assert st == 404
        finally:
            app.router.step = real_step
            await app.stop()

    asyncio.run(main())


def test_dead_on_arrival_deadline_is_504(model):
    async def main():
        app = _app(model)
        host, port = await app.start()
        try:
            st, body, _ = await _request(host, port, "POST", "/v1/submit",
                                         {"prompt": [1],
                                          "deadline_s": -1.0})
            # a negative relative deadline is already past at submit
            assert st == 504 and body["error"] == "deadline"
        finally:
            await app.stop()

    asyncio.run(main())


def test_cancel_mid_stream_and_disconnect_free_slot_and_pages(model):
    """An explicit cancel ends the stream with finish_reason cancelled; a
    client that vanishes mid-stream cancels its request: the slot and its
    reserved pages free at once, and its terminal result is popped."""
    async def main():
        app = _app(model)
        host, port = await app.start()
        router = app.router
        eng = router.replicas[0].engine
        try:
            await _request(host, port, "POST", "/v1/submit",
                           {"id": "long", "prompt": [1],
                            "max_new_tokens": 28, "greedy": True})
            task = asyncio.ensure_future(_stream(host, port, "long"))
            while not (router.take_new_tokens("long")
                       or router.result("long")):
                await asyncio.sleep(0.002)
            st, body, _ = await _request(host, port, "POST",
                                         "/v1/cancel/long")
            assert st == 200 and body["cancelled"]
            done = [d for ev, d in await task if ev == "done"]
            assert len(done) == 1 and done[0]["finish_reason"] == "cancelled"
            assert eng.pool.n_free == eng.pool.n_slots
            await _request(host, port, "POST", "/v1/submit",
                           {"id": "gone", "prompt": [2, 3],
                            "max_new_tokens": 28, "greedy": True})
            r, w = await asyncio.open_connection(host, port)
            w.write(b"GET /v1/stream/gone HTTP/1.1\r\nHost: t\r\n\r\n")
            await w.drain()
            await r.readuntil(b"data: ")
            assert eng.pool.alloc.pages_in_use > 0
            _rst(w)
            for _ in range(400):
                if (eng.pool.n_free == eng.pool.n_slots
                        and not app._abandoned
                        and not router.knows("gone")):
                    break
                await asyncio.sleep(0.005)
            assert eng.pool.n_free == eng.pool.n_slots
            assert not eng._active.any()
            assert (eng.pool.alloc.ref > 0).sum() == 0
            assert "gone" not in router.results
            assert "gone" not in router._delivered
            assert not app._abandoned
        finally:
            await app.stop()

    asyncio.run(main())


def test_stepping_task_death_is_loud_and_fails_server(model, capsys):
    async def main():
        app = _app(model)
        host, port = await app.start()
        boom = RuntimeError("scheduler invariant violated")

        def exploding_step():
            raise boom

        app.router.step = exploding_step
        st, _, _ = await _request(host, port, "POST", "/v1/submit",
                                  {"id": "d", "prompt": [1],
                                   "max_new_tokens": 4, "greedy": True})
        assert st == 200
        for _ in range(400):
            if not app._running:
                break
            await asyncio.sleep(0.005)
        assert not app._running and app._stepper.done()
        assert app._step_fut.exception() is boom
        with pytest.raises(OSError):
            await asyncio.open_connection(host, port)
        with pytest.raises(RuntimeError, match="scheduler invariant"):
            await app.stop()

    asyncio.run(main())
    assert "serve stepping task died" in capsys.readouterr().err


def test_stream_drains_ledger_before_done_event():
    """The request finished (with more tokens) while the handler was
    suspended: the tail goes out before ``done``."""
    class ScriptedRouter:
        def __init__(self):
            self._takes = [[7], [8, 9]]
            self._results = [RequestResult(id="r", tokens=[7, 8, 9],
                                           finish_reason="max_tokens")]
            self.popped = False

        def take_new_tokens(self, rid):
            return self._takes.pop(0) if self._takes else []

        def result(self, rid):
            return self._results.pop(0) if self._results else None

        def pop_result(self, rid):
            self.popped = True

        def knows(self, rid):
            return True

    class FakeWriter:
        data = b""

        def write(self, b):
            self.data += b

        async def drain(self):
            pass

    router = ScriptedRouter()
    app = ServeApp.__new__(ServeApp)
    app.router = router
    app.idle_timeout_s = app.step_wait_s = app.idle_sleep_s = 0.0
    app._step_fut = None
    w = FakeWriter()
    asyncio.run(app._stream("r", w))
    events = _sse_events(w.data.partition(b"\r\n\r\n")[2])
    assert [d["token"] for ev, d in events if ev == "message"] == [7, 8, 9]
    assert [d["n_tokens"] for ev, d in events if ev == "done"] == [3]
    assert router.popped


def test_rate_limit_and_slow_loris(model):
    """An over-rate client gets 429 with Retry-After while another client
    id is served; a peer that stalls mid-headers or mid-body gets 408."""
    async def main():
        app = _app(model, idle_timeout_s=0.3,
                   rate_limit=RateLimitConfig(rps=0.1, burst=2))
        host, port = await app.start()
        try:
            hdr = "x-client-id: greedy\r\n"
            sts = []
            for i in range(3):
                st, body, head = await _request(
                    host, port, "POST", "/v1/submit",
                    {"prompt": [1], "max_new_tokens": 1}, headers=hdr)
                sts.append(st)
            assert sts == [200, 200, 429] and body["client"] == "greedy"
            # a token accrues in 1 / rps = 10 s: what the header says,
            # whole seconds rounded up, less any time the submits took
            retry = re.search(rb"Retry-After: (\d+)", head)
            assert retry and 1 <= int(retry.group(1)) <= 10, head
            st, _, _ = await _request(host, port, "POST", "/v1/submit",
                                      {"prompt": [1], "max_new_tokens": 1},
                                      headers="x-client-id: other\r\n")
            assert st == 200
            assert app.router.metrics.counters["http_rate_limited"] == 1
            for raw in (b"POST /v1/submit HTTP/1.1\r\nHost:",
                        b"POST /v1/submit HTTP/1.1\r\nHost: t\r\n"
                        b"Content-Length: 64\r\n\r\n{\"pro"):
                r, w = await asyncio.open_connection(host, port)
                w.write(raw)
                await w.drain()
                data = await asyncio.wait_for(r.read(), timeout=10)
                assert b" 408 " in data.split(b"\r\n", 1)[0]
                w.close()
        finally:
            await app.stop()

    asyncio.run(main())


def test_healthz_readyz_and_metrics(model):
    """/readyz is 503 until every replica is warm, 200 after; 503 through
    a drain of every replica and once every replica is dead, while
    /healthz stays 200; /metrics carries the fleet counters and gauges."""
    async def main():
        app = _app(model, n_replicas=2)
        host, port = await app.start(warm=False)
        router = app.router
        try:
            st, body, _ = await _request(host, port, "GET", "/readyz")
            assert st == 503 and body["ready_replicas"] == 0
            router.warmup()
            st, body, _ = await _request(host, port, "GET", "/readyz")
            assert st == 200 and body["ready_replicas"] == 2
            st, body, _ = await _request(host, port, "GET", "/healthz")
            assert st == 200 and body["live"] and len(body["replicas"]) == 2
            assert {"alive", "wedged", "queue_depth", "slots_active",
                    "pages_in_use", "warmed"} <= set(body["replicas"][0])
            await _request(host, port, "POST", "/v1/submit",
                           {"id": "m", "prompt": [4], "max_new_tokens": 2,
                            "greedy": True})
            st, raw, _ = await _request(host, port, "GET", "/metrics")
            text = raw.decode()
            assert st == 200
            assert "tpu_gpt_fleet_fleet_requests_routed 1" in text
            assert "tpu_gpt_fleet_replica0_queue_depth" in text
            assert "tpu_gpt_fleet_fleet_replica_kills 0" in text
            router.drain_replica(0)
            router.drain_replica(1)
            st, body, _ = await _request(host, port, "GET", "/readyz")
            assert st == 503 and body["draining"] == [0, 1]
            router.undrain_replica(0)
            st, body, _ = await _request(host, port, "GET", "/readyz")
            assert st == 200 and body["ready_replicas"] == 1
            router.undrain_replica(1)
            router.abandon_replica(0)
            router.abandon_replica(1)
            st, body, _ = await _request(host, port, "GET", "/readyz")
            assert st == 503 and body["n_alive"] == 0
            st, body, _ = await _request(host, port, "GET", "/healthz")
            assert st == 200 and body["live"]
        finally:
            await app.stop()

    asyncio.run(main())


def test_serve_cli_subprocess_smoke(tmp_path):
    """``python -m replicatinggpt_tpu_torch serve --device cpu``: binds an
    ephemeral port, is ready, completes a /v1/generate round trip over
    SSE, and exits 0 on SIGINT with both journals closed, every request
    in them finished."""
    import http.client

    jdir = tmp_path / "journals"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "replicatinggpt_tpu_torch", "serve",
         "--preset", "test-tiny", "--device", "cpu", "--replicas", "2",
         "--port", "0", "--pool-size", "2", "--journal-dir", str(jdir)],
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line and proc.poll() is not None:
                raise AssertionError("serve exited before binding")
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port is not None, "never saw the serving banner"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/readyz")
        assert conn.getresponse().status == 200
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt": [1, 2, 3], "max_new_tokens": 4, "greedy": True}))
        r = conn.getresponse()
        assert r.status == 200
        events = _sse_events(r.read())
        assert len([d for ev, d in events if ev == "message"]) == 4
        assert [d["finish_reason"] for ev, d in events
                if ev == "done"] == ["max_tokens"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        recs = [json.loads(x) for i in (0, 1) for x in
                (jdir / f"replica{i}.jsonl").read_text().splitlines()]
        assert [r["ev"] for r in recs] == ["submit", "finish"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


@pytest.mark.parametrize("argv,item", [
    (["train", "--rng-impl", "rbg"], "ground rules"),
    (["generate", "--rng-impl", "threefry2x32"], "ground rules"),
    (["eval", "--rng-impl", "rbg"], "ground rules"),
    (["serve-replay", "--rng-impl", "rbg"], "ground rules"),
    (["serve", "--rng-impl", "rbg"], "ground rules"),
    (["train", "--coordinator", "h:1", "--num-processes", "2",
      "--process-id", "0"], "torchrun"),
    (["train", "--num-processes", "2"], "torchrun"),
    (["train", "--process-id", "1"], "torchrun"),
    (["serve", "--trace-out", "t.json"], "item 12"),
    (["serve", "--trace-jsonl", "t.jsonl"], "item 12"),
    (["serve", "--weight-quant", "int8"], "item 8"),
    (["serve", "--backend", "jax"], "ground rules"),
    (["train", "--backend", "jax"], "ground rules"),
    (["serve", "--tp", "2"], "item 11"),
    (["serve", "--act-quant", "int8"], "item 8"),
    (["import-hf", "--model-type", "gpt2"], "item 7"),
    (["serve-worker", "--tier", "prefill"], r"item 9\(e\)"),
    (["serve-worker", "--weight-quant", "int8"], "item 8"),
    (["serve-worker", "--backend", "jax"], "ground rules"),
    (["generate", "--backend", "jax"], "ground rules"),
    (["eval", "--backend", "jax"], "ground rules"),
    (["export-torch", "--backend", "jax"], "ground rules"),
    (["serve-replay", "--backend", "jax"], "ground rules"),
    (["eval", "--tp", "2"], "item 11"),
    (["lint", "replicatinggpt_tpu_torch"], "item 12"),
])
def test_refused_flags_and_commands_name_their_item(argv, item):
    """A JAX flag or subcommand the port does not implement fails with
    its ROADMAP item, before any run; never argparse's "unrecognized
    arguments" or "invalid choice". The refused subcommands exit 2."""
    with pytest.raises(SystemExit, match=f"ROADMAP.md .*{item}") as e:
        cli.main(argv)
    if argv[0] in cli.REFUSED_COMMANDS:
        assert e.value.code == 2


#: each subcommand's refusals (train's ported flags with refused values
#: too)
UNPORTED_BY_COMMAND = {
    "train": (cli.TRAIN_UNPORTED_FLAGS, cli.TRAIN_UNPORTED_VALUES),
    "generate": (cli.GENERATE_UNPORTED_FLAGS, ()),
    "eval": (cli.EVAL_UNPORTED_FLAGS, ()),
    "export-torch": (cli.CONFIG_UNPORTED_FLAGS, ()),
    "serve-replay": (cli.UNPORTED_FLAGS, ()),
    "serve": (cli.SERVE_UNPORTED_FLAGS, ()),
    "serve-worker": (cli.SERVE_WORKER_UNPORTED_FLAGS, ()),
}
#: a value for a JAX option that takes one and has no choices
OPTION_VALUES = {"--dtype": "float32", "--mesh-shape": "1x1",
                 "--router-addr": "127.0.0.1:1"}
_JAX_COMMANDS = {}


def _jax_subcommands():
    """The JAX CLI's subparsers, grabbed from its own ``main``."""
    if not _JAX_COMMANDS:
        import argparse

        from replicatinggpt_tpu import cli as jcli

        class Grabbed(Exception):
            pass

        grabbed = []

        def grab(self, args=None, namespace=None):
            grabbed.append(self)
            raise Grabbed

        real = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(Grabbed):
                jcli.main(["serve"])
        finally:
            argparse.ArgumentParser.parse_args = real
        _JAX_COMMANDS.update(_subcommands(grabbed[0]))
    return _JAX_COMMANDS


def _subcommands(p):
    import argparse
    return next(a.choices for a in p._actions
                if isinstance(a, argparse._SubParsersAction))


def _option_argv(action, opt):
    if action.nargs == 0:
        return [opt]
    if action.choices:
        return [opt, str(next(iter(action.choices)))]
    if action.type in (int, float):
        return [opt, "1"]
    return [opt, OPTION_VALUES.get(opt, "x")]


@pytest.mark.parametrize("name", ["train", "generate", "eval",
                                  "export-torch", "serve-replay", "serve",
                                  "serve-worker", "import-hf", "lint"])
def test_serve_and_train_take_every_jax_flag(name):
    """Every option string of each JAX subcommand parses in the port's
    subcommand of that name, with a value the JAX option takes, and then
    either works or is refused with its ROADMAP item or ground rule: no
    JAX command line fails on argparse's "unrecognized arguments" (C3).
    The subcommands the port refuses whole exit 2 with their item."""
    jax_cmds = _jax_subcommands()
    parser = cli.build_parser()
    assert set(jax_cmds) <= set(_subcommands(parser))
    opts = [(a, o) for a in jax_cmds[name]._actions
            for o in a.option_strings if o not in ("-h", "--help")]
    assert opts
    for action, opt in opts:
        argv = [name, *_option_argv(action, opt)]
        if name in cli.REFUSED_COMMANDS:
            with pytest.raises(SystemExit, match="ROADMAP.md") as e:
                cli.main(argv)
            assert e.value.code == 2
            continue
        args = parser.parse_args(argv)
        flags, values = UNPORTED_BY_COMMAND[name]
        try:
            cli.check_unported(args, flags, values)
        except SystemExit as e:
            assert re.search(r"ROADMAP\.md (queue A item|ground rules)",
                             str(e)), (argv, str(e))
