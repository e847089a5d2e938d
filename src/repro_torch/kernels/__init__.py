"""Hand-written Hopper kernels of the serving path, with their plain
PyTorch versions (``ref.py``).

``paged_attention.paged_decode_attention`` and
``chunked_prefill.chunked_prefill_attention`` launch CUDA C++ kernels
(``csrc/*.cu``, built by ``_build`` at first use) for CUDA tensors and
call their plain version for CPU tensors. There is no switch: the device
of the tensors decides.
"""
