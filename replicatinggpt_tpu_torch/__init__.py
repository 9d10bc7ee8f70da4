"""PyTorch/CUDA port of ``replicatinggpt_tpu``, slice by slice.

Imports ``torch`` and never ``jax`` or the JAX package. Its first slice
is the paged serving path (``python -m replicatinggpt_tpu_torch
serve-replay``), with the paged attention kernel written in CUDA C++
for Hopper (``csrc/paged_window_attention.cu``). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
