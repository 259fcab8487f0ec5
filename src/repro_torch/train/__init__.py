"""The LM train path of the port: optimizer, gradient compression and the
trainer (``repro_torch.train.trainer``)."""
