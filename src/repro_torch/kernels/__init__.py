# Hand-written CUDA kernels for Hopper (sources in ../csrc) with a plain torch
# version beside each.  Backend selection (cuda vs ref) is centralized in
# .registry; session config `engine: cuda|ref|auto` picks per query.
from .registry import (VALID_ENGINES, backends, kernels, launch_counts,  # noqa: F401
                       on_gpu, register, resolve)
