"""The port's copies of the JAX package's examples: ``quickstart`` and
``federated_warehouse`` (``python -m repro_torch.examples.<name>
[--engine cuda|ref|auto]``).  The training example is
``repro_torch.train.lm_from_warehouse``."""
