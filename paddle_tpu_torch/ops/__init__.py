"""Kernels of the port, each beside its plain PyTorch version.

``int8_matmul.int8_matmul``,
``ragged_paged_attention.ragged_paged_attention`` and
``flash_attention.{flash_fwd, flash_bwd}`` launch hand-written CUDA
kernels (``csrc/*.cu``, built by ``_build``) for CUDA tensors and run
their plain versions for CPU tensors.  Each wrapper keeps a plain
integer ``launches`` count of the calls that launched its kernels.
``flash_attention.causal_attention`` is the autograd function over the
two flash wrappers.  (The functions are not re-exported here: some
share their modules' names.)
"""
