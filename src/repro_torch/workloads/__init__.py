"""Workloads that drive the port end to end (data loaders + query sets)."""
