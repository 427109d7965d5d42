"""Serving steps for the LM side (training waits for ROADMAP A6)."""
