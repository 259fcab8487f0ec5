"""Sharding-constraint helpers that degrade gracefully.

The port's copy of ``repro.distributed.constraints``. A ``DeviceMesh``
made current by :func:`use_mesh` (the reference's ``with mesh:``) turns
the model code's constraints into DTensor redistributions:
``maybe_shard(x, *spec)`` lays a DTensor out by ``spec`` over the
current mesh's axes, and ``gather_layer_params`` pins one layer's
weights to their tensor-parallel spec (the per-layer FSDP gather). With
no mesh current, or on a plain tensor, both return their argument
unchanged, so the same model code runs unsharded in one process.
``launch/steps.py`` ``Cell.run`` makes a cell's mesh current while its
step executes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(device_mesh):
    """Make ``device_mesh`` (a ``DeviceMesh`` with named dims) current for
    the constraints inside the block."""
    token = _MESH.set(device_mesh)
    try:
        yield device_mesh
    finally:
        _MESH.reset(token)


def _axes(mesh) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A ``DeviceMesh``'s dim names and sizes."""
    return mesh.mesh_dim_names, tuple(mesh.size(i) for i in range(mesh.ndim))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; a plain tensor answers at once (the
    unsharded path imports nothing of ``torch.distributed``)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gather_layer_params(cfg, lp):
    """Constrain one layer slice to its TP-only sharding (drop the FSDP
    data-axis factor): each weight is gathered over the data axes for
    this layer only, never the whole stacked ``[L, ...]`` tensor."""
    mesh = _MESH.get()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return lp
    from repro_torch.distributed.sharding import P, param_pspec, placements
    from repro_torch.models.tree import tree_map_with_path
    msize = mesh.size(mesh.mesh_dim_names.index("model"))

    def one(path, leaf):
        if not is_dtensor(leaf):
            return leaf
        # The rules read the stacked [L, ...] shape (a shared expert's
        # 2-D slice would fall under the 3-D expert rule); the slice drops
        # the layer dim, which is never sharded.
        spec = param_pspec(cfg, path, (1,) + tuple(leaf.shape), msize,
                           dsize=1, fsdp=False)
        return leaf.redistribute(mesh, placements(P(*spec[1:]),
                                                  *_axes(mesh)))

    return tree_map_with_path(one, lp)


def layout_like(x, ref):
    """``x`` laid out as the DTensor ``ref`` is: a gradient reduced to
    its parameter's sharding (a partial sum is all-reduced or
    reduce-scattered), as the reference's partitioner lays out the
    gradients it feeds the optimizer. Unchanged when either is a plain
    tensor."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def clean_spec(spec, axes: tuple[str, ...]) -> tuple:
    """``spec`` with every axis ``axes`` lacks dropped: a tuple entry
    keeps the axes it has (``None`` when none is left), a name entry
    becomes ``None``."""
    def ok(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            return kept if kept else None
        return entry if entry in axes else None

    return tuple(ok(e) for e in spec)


def maybe_shard(x, *spec):
    """spec entries: axis name, tuple of axis names, or None. Entries whose
    axes are absent from the current mesh collapse to None; a spec that
    collapses entirely leaves ``x`` as it is."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    cleaned = clean_spec(spec, mesh.mesh_dim_names)
    if all(c is None for c in cleaned):
        return x
    from repro_torch.distributed.sharding import placements
    return x.redistribute(mesh, placements(cleaned, *_axes(mesh)))
