"""The port's (B, H, T, D) flash attention against the JAX package, on
the CPU.

``flash_heads_fwd_ref`` / ``flash_heads_bwd_ref`` (through ``FlashHeads``,
the CPU path of the kernel's wrappers) against ``pallas_flash_attention``
in Pallas interpret mode, as ``tests/test_flash_attention.py`` runs it,
one case for each of its families (64-row blocks, so T=128 walks two
tiles): the resident forward with the kv-major fused backward (``_flash_fwd``, ``_fused_kv_major_bwd``), the
two-kernel backward (``_flash_bwd``'s split kernels, reached with the
fused-scratch budget at 0), the single-tile fused backward
(``_flash_bwd_fused``), the streamed kernels (``stream=True`` at
``block_q != block_k``) and the triangular ones (``stream=True`` at
equal blocks, causal). Inputs from a numpy seed at B=1, H <= 3,
T in {128, 192, 256}; dropout off and at 0.1 from the same int32 seed (the
hash is bit-exact), ``causal=False``, a custom scale, D in {32, 64, 256}.
f32 elementwise at 1e-5 (output) and 2e-4 (gradients, the JAX package's
own tolerance for its flash gradients); bf16 in norm against JAX and an
f64 witness (``BF16_REL``, as ``tests/test_torch_port_gpt2_train.py``
holds the packed kernels), at T=128 and at T=192 (three 64-key tiles,
each rounding p from a new running max). Then the route: gpt2-xl's 25 heads and D=256
reach the kernel's wrappers, and a call the kernel cannot take raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.ops import flash_pallas as jfp
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import attention as tattn
from replicatinggpt_tpu_torch.ops import flash_attention as tfa
from replicatinggpt_tpu_torch.ops import flash_heads as tfh
from replicatinggpt_tpu_torch.ops import flash_packed as tfp

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOLS = ((1e-5, 0.0), (2e-4, 0.0))   # (atol, rtol): output, gradients
# bf16, as ||x - ref|| / ||ref||: the plain versions round where the
# JAX kernels round (p z and ds to bf16, over 64-key tiles), so they
# agree with JAX up to f32 summation order (read at most 1.1e-4) and sit
# as far from the f64 witness as JAX does (read at most 2.7e-3)
BF16_REL = {"jax": 1e-3, "witness": 4e-3}
# id: (dtype, H, T, D, rate, pallas_flash_attention keywords, fused-dq
# scratch budget or None). Each walks more than one tile except
# single_tile, where T is one block.
CASES = {
    "resident": ("float32", 2, 128, 64, 0.0,
                 dict(block_q=64, block_k=64), None),
    "two_kernel_bwd_dropout_scale": ("float32", 3, 128, 32, 0.1,
                                     dict(block_q=64, block_k=64,
                                          scale=0.3), 0),
    "noncausal": ("float32", 2, 128, 64, 0.1,
                  dict(block_q=64, block_k=64, causal=False), None),
    "single_tile_d256": ("float32", 1, 128, 256, 0.1,
                         dict(block_q=128, block_k=128), None),
    "stream": ("float32", 2, 128, 32, 0.1,
               dict(block_q=64, block_k=32, stream=True), None),
    "tri": ("float32", 1, 256, 64, 0.0,
            dict(block_q=64, block_k=64, stream=True), None),
    "bf16": ("bfloat16", 2, 128, 64, 0.1,
             dict(block_q=64, block_k=64), None),
    "bf16_t192": ("bfloat16", 2, 192, 64, 0.1,
                  dict(block_q=64, block_k=64), None),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_seed(key) -> int:
    """The int32 kernel seed _flash_prologue derives from a dropout key."""
    return int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])


def _witness(q, k, v, w, *, causal, scale, seed, rate):
    """Attention with the hash's dropout, and its gradients, in f64 from
    the (rounded) inputs the kernels see."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    B, H, T, _ = q.shape
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.softmax(s, -1)
    if rate:
        p = p * tfp._mult(B, H, T, seed, rate, "cpu").double()
    o = p @ v
    o.backward(w.double())
    return o.detach(), (q.grad, k.grad, v.grad)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("case", list(CASES))
def test_flash_heads_twins_match_pallas_flash_attention(case, monkeypatch):
    dtype, H, T, D, rate, kw, scratch = CASES[case]
    if scratch is not None:
        monkeypatch.setattr(jfp, "FUSED_DQ_SCRATCH_BYTES", scratch)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal((1, H, T, D)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((1, H, T, D)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    drop = dict(dropout_rate=rate, dropout_rng=key) if rate else {}

    def attend(*qkv):
        return jfp.pallas_flash_attention(*qkv, **kw, **drop)

    want_o, vjp = jax.vjp(attend, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(w, jdt))
    want_o = np.asarray(want_o, np.float32)
    want_g = [np.asarray(g, np.float32) for g in want_g]
    causal, scale = kw.get("causal", True), kw.get("scale")
    seed = _jax_seed(key) if rate else 0
    x = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    before = (tfh.flash_heads_fwd.launches, tfh.flash_heads_bwd.launches)
    o = tfh.flash_heads_attention(*x, causal=causal, scale=scale, seed=seed,
                                  rate=rate)
    o.backward(torch.from_numpy(w).to(tdt))
    assert (tfh.flash_heads_fwd.launches,
            tfh.flash_heads_bwd.launches) == before   # CPU: plain versions
    assert o.dtype == tdt and all(t.grad.dtype == tdt for t in x)
    got_o = o.detach().float().numpy()
    got_g = [t.grad.float().numpy() for t in x]
    if dtype == "float32":
        (atol_o, rtol_o), (atol_g, rtol_g) = F32_TOLS
        np.testing.assert_allclose(got_o, want_o, atol=atol_o, rtol=rtol_o)
        for got, want in zip(got_g, want_g):
            np.testing.assert_allclose(got, want, atol=atol_g, rtol=rtol_g)
        return
    ref_o, ref_g = _witness(*(t.detach() for t in x),
                            torch.from_numpy(w).to(tdt), causal=causal,
                            scale=D ** -0.5 if scale is None else scale,
                            seed=seed, rate=rate)
    for got, want, ref in ((got_o, want_o, ref_o),
                           *zip(got_g, want_g, ref_g)):
        assert _rel(got, want) <= BF16_REL["jax"]
        assert _rel(got, ref) <= BF16_REL["witness"]


def test_flash_heads_lse_and_bwd_form_match_jax_kernels():
    """The wrappers' (o, lse) against ``_flash_fwd`` and the lse/delta
    backward against autograd through the plain forward, with dropout."""
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
                  for _ in range(4))
    seed, rate = 4242, 0.1
    _, want_lse = jfp._flash_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.array([seed], jnp.int32),
        32 ** -0.5, True, 64, 64, rate)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = tfh.flash_heads_fwd(*t, seed=seed, rate=rate)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0]
                               .reshape(1, 2, 128), atol=1e-5, rtol=0)
    g = torch.from_numpy(w)
    grads = tfh.flash_heads_bwd(*t, g, lse, tfh.heads_delta(g, o),
                                seed=seed, rate=rate)
    x = [a.clone().requires_grad_(True) for a in t]
    tfh.flash_heads_fwd_ref(*x, seed=seed, rate=rate)[0].backward(g)
    for got, want in zip(grads, x):
        np.testing.assert_allclose(got.numpy(), want.grad.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("n_head,n_embd,seq,kernel", [
    (25, 1600, 64, True),     # gpt2-xl's heads: no head pair, D=64
    (2, 512, 64, True),       # D=256
    (2, 32, 32, False),       # D=16: the plain core
])
def test_split_heads_route_reaches_the_kernel(n_head, n_embd, seq, kernel,
                                              monkeypatch):
    """The split-heads route calls the kernel's wrapper wherever its
    envelope holds (a recorder in place of ``flash_heads_attention``) and
    the plain core elsewhere; both give the plain core's numbers. The
    model takes that route for gpt2-xl's heads and for D=16; at D=256
    heads lay out in the packed kernel, as in the JAX package."""
    calls = []

    def recorder(*a, **kw):
        calls.append(a[0].shape)
        return tfh.flash_heads_attention(*a, **kw)

    monkeypatch.setattr(tfa, "flash_heads_attention", recorder)
    mcfg = dataclasses.replace(get_config("gpt2-xl").model, n_head=n_head,
                               n_embd=n_embd, block_size=seq, n_layer=1,
                               dtype="float32")
    assert (tgpt.attention_for(mcfg, seq) is tgpt.split_attention) == (
        n_embd // n_head != 256)
    qkv = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, seq, 3 * n_embd)).astype(np.float32))
    got = tgpt.split_attention(qkv, mcfg, None, False)
    assert len(calls) == int(kernel)
    q, k, v = (tgpt._split_heads(t, n_head) for t in qkv.split(n_embd, -1))
    want = tgpt._merge_heads(tattn.full_causal_attention(q, k, v))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_kernel_calls_outside_the_envelope_raise():
    """Off the CPU the wrappers launch the kernel or raise: shapes outside
    the envelope and a device that is not a card raise (meta tensors
    stand for a card here), and dropout outside the envelope raises in
    ``flash_attention`` instead of degrading."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="envelope"):
        tfh.flash_heads_fwd(*(torch.empty(1, 2, 64, 48, **meta)
                              for _ in range(3)))
    with pytest.raises(ValueError, match="envelope"):
        tfh.flash_heads_fwd(*(torch.empty(1, 2, 96, 64, **meta)
                              for _ in range(3)))
    with pytest.raises(TypeError):
        tfh.flash_heads_fwd(*(torch.empty(1, 2, 64, 64, device="meta",
                                          dtype=torch.float16)
                              for _ in range(3)))
    with pytest.raises(ValueError, match="device"):
        tfh.flash_heads_fwd(*(torch.empty(1, 2, 64, 256, **meta)
                              for _ in range(3)))
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="flash kernel"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1,
                            rng=tattn.DropoutRNG(0))
    assert tfh.flash_heads_envelope(1024, 64, 2) == (True, ())
    assert tfh.flash_heads_envelope(100, 21, 8) == (
        False, ("head_dim", "seq_len", "dtype"))
