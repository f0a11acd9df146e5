"""Tensor ops: plain PyTorch versions plus the hand-written CUDA kernels.

Each kernel module (``kv_write``, ``ragged_paged_attention``,
``paged_decode_attention``, ``paged_prefill_attention``) holds the
kernel's wrapper, its plain PyTorch
version and its launch counter. A wrapper runs the plain version for a
tensor on the CPU and launches the kernel for a CUDA tensor; it never falls
back from one to the other.
"""
