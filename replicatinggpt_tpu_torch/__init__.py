"""PyTorch/CUDA port of ``replicatinggpt_tpu``, slice by slice.

Imports ``torch`` and never ``jax`` or the JAX package. Its slices: the
paged serving path (``python -m replicatinggpt_tpu_torch serve-replay``,
with the paged attention kernel ``csrc/paged_window_attention.cu``, the
all-layers paged decode kernel ``csrc/fused_paged_decode_layers.cu`` and
int8/fp8 KV pools), char-GPT and GPT-2 training (``python -m
replicatinggpt_tpu_torch train``, on the char tokenizer or a byte-level
BPE, with the packed flash attention kernels ``csrc/flash_packed.cu``)
and generation (``generate``, with
``csrc/fused_decode_layers.cu`` and ``csrc/packed_decode_attention.cu``),
the kernels written in CUDA C++ for Hopper. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
