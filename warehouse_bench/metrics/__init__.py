"""Metric readers, one a file, found by the metric's name."""
