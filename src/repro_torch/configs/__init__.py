"""Model and shape configurations (a copy of the JAX package's, which are
plain dataclasses)."""
