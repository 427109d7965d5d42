"""Fault tolerance for the port: checkpoints and save-on-preemption.  The
sharded relational operators and gradient compression wait for ROADMAP A7."""
