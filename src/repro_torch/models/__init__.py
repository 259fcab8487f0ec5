"""The LM stack: layers, attention (GQA and MLA), MoE, Mamba2 SSD and the
unified model (``repro_torch.models.model``), plain PyTorch code that
mirrors ``repro.models`` operation for operation."""
