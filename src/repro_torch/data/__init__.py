"""The data pipeline of the port (``repro_torch.data.pipeline``): host
NumPy, copied from the reference."""
