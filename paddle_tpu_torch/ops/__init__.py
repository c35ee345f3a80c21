"""Kernels of the port, each beside its plain PyTorch version.

``int8_matmul.int8_matmul`` and
``ragged_paged_attention.ragged_paged_attention`` launch hand-written
CUDA kernels (``csrc/*.cu``, built by ``_build``) for CUDA tensors and
run their plain versions for CPU tensors.  Each wrapper keeps a plain
integer ``launches`` count of kernel launches.  (The functions are not
re-exported here: they share their modules' names.)
"""
