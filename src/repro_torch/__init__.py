"""repro_torch — the PyTorch/CUDA port of the PULSAR reproduction.

A second package beside the JAX reference (``repro``), held bit-exact and
stats-identical against it. Entry point: :mod:`repro_torch.pum`. The
package imports ``torch`` and NumPy, never JAX or ``repro``.
"""
