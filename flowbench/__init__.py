"""The benchmark of the PyTorch and CUDA port of DIS dense optical flow
(``flowonthego_tpu_torch``): one command runs one cell, a deployment's
configuration under one traffic mix (``python -m flowbench.run``)."""
