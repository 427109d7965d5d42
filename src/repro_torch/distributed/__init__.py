"""The distributed layer: relational operators and gradient compression as
``torch.distributed`` collectives, and sharded checkpoints with an elastic
restore; save-on-preemption."""
