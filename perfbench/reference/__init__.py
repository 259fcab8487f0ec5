"""The plain reference: a dense Qwen-style decoder in float32 PyTorch,
written from the published architecture, with no kernel, cache or batch
of the program's. It imports nothing of the program."""
