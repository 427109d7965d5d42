"""Meshes and sharding specs over ``torch.distributed``."""
