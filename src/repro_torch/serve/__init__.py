"""The continuous-batching LM server of the port (``repro_torch.serve.engine``)."""
