"""training of the PyTorch/CUDA port (see ``repro_torch``): AdamW, its
schedule and clipping (``optim``)."""
