"""obs of the PyTorch/CUDA port (see ``repro_torch``)."""
