"""Checkpoints of the port (``repro_torch.checkpoint.manager``), in the
reference's on-disk format."""
