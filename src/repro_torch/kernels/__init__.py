"""Hand-written Hopper kernels of the serving and training paths, with
their plain PyTorch versions (``ref.py``).

``paged_attention.paged_decode_attention``,
``chunked_prefill.chunked_prefill_attention``,
``decode_attention.decode_attention``,
``flash_attention.flash_attention``, ``ssd.ssd_chunk`` (Mamba-2's SSD
chunk pieces) and ``rglru.rglru_scan`` (the RG-LRU recurrence), and the
backward of the last three (``flash_attention.flash_attention_bwd``,
``ssd.ssd_chunk_bwd``, ``rglru.rglru_scan_bwd``) launch CUDA C++
kernels (``csrc/*.cu``, built by ``_build`` at first use) for CUDA
tensors and call their plain version for CPU and meta tensors
(``_build.PLAIN_DEVICES``; on meta tensors that is abstract evaluation:
shapes only, no launch). There is no switch: the device of the tensors
decides.
"""
