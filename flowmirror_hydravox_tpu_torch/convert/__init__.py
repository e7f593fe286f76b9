"""Weight conversion from the reference checkpoints."""
