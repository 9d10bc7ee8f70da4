"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a card every test here skips.

Imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from replicatinggpt_tpu_torch.ops import flash_packed as fp
from replicatinggpt_tpu_torch.ops import paged_attention as pa

H, PSZ, MP, N, C = 2, 8, 4, 24, 64


def _inputs(W, dtype, seed=0):
    """Slots at pos 0, a page edge, mid-page and inside the last page;
    table entries past each live frontier hold ids past the pool."""
    rng = np.random.default_rng(seed)
    pos = np.array([0, 8, 13, 16, 29], np.int32)
    B = pos.size
    tables = rng.permutation(N)[: B * MP].reshape(B, MP).astype(np.int32)
    live = (pos + PSZ - 1) // PSZ
    tables[np.arange(MP)[None, :] >= live[:, None]] = N + 3
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
    return (mk(B, W, C), mk(B, W, C), mk(B, W, C), mk(N, PSZ, C),
            mk(N, PSZ, C), torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_matches_ref(card, W, dtype, tol):
    args = _inputs(W, dtype)
    before = pa.paged_window_attention.launches
    got = pa.paged_window_attention(*args, n_head=H)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.launches == before + 1
    ref = pa.paged_window_attention_ref(*args, n_head=H)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(card):
    args = list(_inputs(1, torch.float32))
    with pytest.raises(TypeError):
        pa.paged_window_attention(*args[:5], args[5].long(), args[6],
                                  n_head=H)
    with pytest.raises(TypeError):
        pa.paged_window_attention(args[0].half(), *args[1:], n_head=H)
    strided = torch.cat([args[0], args[0]], dim=-1)[..., :C]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        pa.paged_window_attention(strided, *args[1:], n_head=H)


def _flash_inputs(T, H, dtype, D=64, B=2, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
    return mk(B, T, 3 * H * D), mk(B, T, H * D)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 256])
@pytest.mark.parametrize("H", [1, 6])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_packed_kernels_match_ref(card, T, H, rate, dtype, tol):
    """Forward (o, lse) and backward (d(qkv), from the same lse and
    delta) of the CUDA kernels against the plain versions, with the
    same dropout seed."""
    qkv, do = _flash_inputs(T, H, dtype)
    seed = 987_654_321
    f0, b0 = fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches
    o, lse = fp.flash_packed_fwd(qkv, H, seed=seed, rate=rate)
    delta = fp.packed_delta(do, o, H)
    dqkv = fp.flash_packed_bwd(qkv, do, lse, delta, H, seed=seed, rate=rate)
    torch.cuda.synchronize()
    assert (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches) \
        == (f0 + 1, b0 + 1)
    ro, rlse = fp.flash_packed_fwd_ref(qkv, H, seed=seed, rate=rate)
    rd = fp.flash_packed_bwd_ref(qkv, do, lse, delta, H, seed=seed,
                                 rate=rate)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)
    torch.testing.assert_close(dqkv.float(), rd.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_packed_autograd_on_card(card):
    """FlashPacked launches one forward and one backward and its gradient
    (with a non-contiguous upstream gradient) matches autograd through
    the plain forward."""
    qkv, _ = _flash_inputs(128, 6, torch.float32, seed=1)
    g = torch.randn(2, 128, 2 * 384, device="cuda")[..., ::2]
    assert not g.is_contiguous()
    x = qkv.clone().requires_grad_(True)
    f0, b0 = fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches
    fp.flash_packed_attention(x, 6, seed=5, rate=0.2).backward(g)
    torch.cuda.synchronize()
    assert (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches) \
        == (f0 + 1, b0 + 1)
    y = qkv.clone().requires_grad_(True)
    fp.flash_packed_fwd_ref(y, 6, seed=5, rate=0.2)[0].backward(g)
    torch.testing.assert_close(x.grad, y.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_packed_kernel_rejects_what_it_does_not_take(card):
    qkv, _ = _flash_inputs(64, 2, torch.float32, D=48)
    with pytest.raises(ValueError, match="envelope"):
        fp.flash_packed_fwd(qkv, 2)
    qkv, _ = _flash_inputs(96, 2, torch.float32)
    with pytest.raises(ValueError, match="envelope"):
        fp.flash_packed_fwd(qkv, 2)
    qkv, _ = _flash_inputs(64, 2, torch.float16)
    with pytest.raises(TypeError):
        fp.flash_packed_fwd(qkv, 2)
