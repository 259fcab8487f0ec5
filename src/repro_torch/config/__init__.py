"""Model and training configs of the port (``repro_torch.config.base``)."""
