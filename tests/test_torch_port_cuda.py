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
