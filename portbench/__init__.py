"""The benchmark of the PyTorch/CUDA port (``pint_tpu_torch``); see
``portbench.run``."""
