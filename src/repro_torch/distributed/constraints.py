"""Sharding-constraint helpers, as identities in one process.

The reference's ``maybe_shard`` applies a ``with_sharding_constraint``
when the surrounding JAX mesh has the named axes, and
``gather_layer_params`` pins one scanned layer's weights to their
tensor-parallel sharding. The port runs each model in one process on one
device: the sharding rules (``distributed/sharding.py``) and the cell
builders (``launch/steps.py``) describe the production layout, and the
dry run reads per-device shapes from them, but nothing partitions a
tensor, so both helpers return their argument unchanged. The model code
calls them where the reference's does (per layer, the MoE dispatch
buffers, the loss logits), so a multi-process execution of the specs has
the places for its own constraints. The sequence-parallel serving
branches (``serve_seq_parallel``, which ``launch/steps.py`` sets for
small models) are left out until then: in one process they would be
identities, and the flag changes no number.
"""

from __future__ import annotations


def gather_layer_params(cfg, lp):
    """One layer's parameters, unchanged (no FSDP gather on one GPU)."""
    return lp


def maybe_shard(x, *spec):
    """``x`` unchanged (no mesh axes on one GPU)."""
    return x
