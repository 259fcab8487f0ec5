"""Sharding-constraint helpers, as identities on one GPU.

The reference's ``maybe_shard`` applies a ``with_sharding_constraint``
when the surrounding JAX mesh has the named axes, and
``gather_layer_params`` pins one scanned layer's weights to their
tensor-parallel sharding. The port runs each model on one device, with
no mesh, so both return their argument unchanged. The model code calls
them where the reference's does (per layer, the MoE dispatch buffers,
the loss logits), so a multi-GPU slice has the places for its own
constraints; the sequence-parallel serving branches
(``serve_seq_parallel``) are left out until then.
"""

from __future__ import annotations


def gather_layer_params(cfg, lp):
    """One layer's parameters, unchanged (no FSDP gather on one GPU)."""
    return lp


def maybe_shard(x, *spec):
    """``x`` unchanged (no mesh axes on one GPU)."""
    return x
