"""PyTorch/CUDA port of the warehouse (the JAX package ``repro`` is the
reference).  SQL through ``repro_torch.api.connect``; the kernels under
``repro_torch.kernels`` are hand-written CUDA C++ for Hopper (``csrc/``)."""
