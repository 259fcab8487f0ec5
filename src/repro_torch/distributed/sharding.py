"""Sharding rules: DP / TP / EP / SP over the (pod, data, model) mesh.

The port's copy of ``repro.distributed.sharding``. Name-based rules map
parameter paths to partition specs:
  * vocab (embedding/unembedding)      -> model
  * attention heads (q and kv)         -> model when divisible, else
    replicated (decided per-arch; uneven shards are avoided by construction)
  * FFN hidden                          -> model (all assigned d_ff are
    divisible by 16)
  * MoE experts                         -> model (EP: 64/16, 160/16)
  * MLA latent up-projections (heads)   -> model
  * SSM projections                     -> replicated in the baseline
  * batch                               -> (pod?, data)
  * everything 1-D (norms, biases)      -> replicated

Optimizer states mirror their parameters (same tree structure).

A spec is the port's :class:`P`, a tuple whose entries mirror
``jax.sharding.PartitionSpec``'s (``None``, an axis name, or a tuple of
names); a :class:`Sharding` pairs it with a :class:`Mesh`. The trees
returned have the structure of the tree given (``models/tree.py``).

:func:`placements` turns a spec into DTensor placements over a mesh's
axes, and :func:`distribute_tree` places a tree of tensors by a tree of
shardings on a ``DeviceMesh`` (``launch/mesh.py`` ``device_mesh``): each
rank then holds the :func:`local_shape` of every leaf, which is what the
dry run counts as its argument bytes. :func:`gather_tree` is the
inverse, every leaf as its full tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import Mesh, data_axes, model_axis_size
from repro_torch.models.tree import tree_map, tree_map_with_path


class P(tuple):
    """Partition spec: one entry per leading dim (trailing dims are
    unsharded), each ``None``, an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh (``NamedSharding``'s counterpart)."""
    mesh: Mesh
    spec: P


def _shardable(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_pspec(cfg, path_s: str, shape: tuple[int, ...], msize: int,
                dsize: int = 1, fsdp: bool = False,
                daxes: tuple[str, ...] = ("data",)) -> P:
    """Partition spec for one parameter. ``shape`` may include a leading
    stacked-layer dim (never sharded); rules index from the trailing dims.

    ``fsdp``: additionally shard a second (non-TP) dim over the data axes
    (ZeRO-3: per-layer weight all-gathers and gradient reduce-scatters).
    Used for training (and for serving models whose TP-only shards exceed
    device memory)."""
    none = P()
    dax = daxes if len(daxes) > 1 else daxes[0]

    def fs(dim_size):
        """data-axis entry for an fsdp-shardable dim."""
        return dax if fsdp and _shardable(dim_size, dsize) else None

    def spec_trailing(*trailing):
        pad = len(shape) - len(trailing)
        return P(*([None] * pad + list(trailing)))

    name = path_s.rsplit("/", 1)[-1]
    if len(shape) <= 1:
        return none
    # --- embeddings ---
    if name in ("embedding", "unembed"):
        if _shardable(shape[0], msize):
            return P("model", fs(shape[1]))
        return none
    # --- attention (GQA) ---
    if name == "wq" or name in ("wk", "wv"):
        h = shape[-2]
        if _shardable(h, msize):
            return spec_trailing(fs(shape[-3]), "model", None)
        return spec_trailing(fs(shape[-3]), None, None)
    if name == "wo":
        h = shape[-3]
        if _shardable(h, msize):
            return spec_trailing("model", None, fs(shape[-1]))
        return spec_trailing(None, None, fs(shape[-1]))
    if name in ("bq", "bk", "bv"):
        h = shape[-2]
        return (spec_trailing("model", None)
                if _shardable(h, msize) else none)
    # --- MLA ---
    if name in ("w_uq", "w_uk", "w_uv"):
        h = shape[-2]
        return (spec_trailing(fs(shape[-3]), "model", None)
                if _shardable(h, msize)
                else spec_trailing(fs(shape[-3]), None, None))
    if name in ("w_dq", "w_dkv", "w_kr"):
        return spec_trailing(fs(shape[-2]), None)
    # --- MoE ---
    if "moe" in path_s and name in ("w_gate", "w_up", "w_down"):
        e = shape[-3]
        if _shardable(e, msize):
            return spec_trailing("model", fs(shape[-2]), None)
        return spec_trailing(None, fs(shape[-2]), None)
    if name == "router":
        return none
    # --- dense MLP / shared experts ---
    if name in ("w_gate", "w_up"):
        f = shape[-1]
        return (spec_trailing(fs(shape[-2]), "model")
                if _shardable(f, msize)
                else spec_trailing(fs(shape[-2]), None))
    if name == "w_down":
        f = shape[-2]
        return (spec_trailing("model", fs(shape[-1]))
                if _shardable(f, msize)
                else spec_trailing(None, fs(shape[-1])))
    # --- SSM: TP-replicated in baseline; FSDP on d_model/d_inner dims ---
    if name in ("in_proj", "out_proj"):
        return spec_trailing(fs(shape[-2]), None)
    if name == "conv_w":
        return none
    return none


def _data_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def param_shardings(cfg, mesh: Mesh, params_shape: Any, fsdp: bool = False,
                    tp: bool = True):
    """:class:`Sharding` tree for a params (or optimizer-state) tree.

    ``tp=False`` (small-model serving): weights replicate (the embedding /
    unembedding keep vocab TP — they are the one big matmul) and the model
    axis carries SEQUENCE parallelism instead, which removes the per-layer
    FFN all-reduce."""
    msize = model_axis_size(mesh)
    daxes = data_axes(mesh)
    dsize = _data_size(mesh) if daxes else 1

    def one(name, leaf):
        if not tp and name.rsplit("/", 1)[-1] not in ("embedding", "unembed"):
            return Sharding(mesh, P())
        spec = param_pspec(cfg, name, tuple(leaf.shape), msize,
                           dsize=dsize, fsdp=fsdp, daxes=daxes)
        return Sharding(mesh, spec)

    return tree_map_with_path(one, params_shape)


def batch_pspec(mesh: Mesh) -> P:
    axes = data_axes(mesh)
    return P(axes if len(axes) > 1 else axes[0])


def batch_shardings(mesh: Mesh, batch_shape: Any, *, batch_divisible: bool
                    = True):
    """Shard the leading (batch) dim of every batch leaf over (pod, data);
    falls back to replication when the batch is too small (long_500k B=1,
    where sequence sharding takes over via activation constraints)."""
    dsize = _data_size(mesh)

    def one(leaf):
        if leaf.shape and leaf.shape[0] % dsize == 0:
            return Sharding(mesh, batch_pspec(mesh))
        return Sharding(mesh, P())

    return tree_map(one, batch_shape)


def cache_shardings(cfg, mesh: Mesh, cache_shape: Any,
                    tp_threshold_bytes: float = 256e6):
    """Decode caches: batch -> data axes; kv-head dim -> model when it
    divides; seq (ring) dim -> model for B=1 long-context cells (SP).

    ``tp_threshold_bytes``: model-axis sharding of the KV head/head_dim is
    a MEMORY measure, but it back-propagates into the attention compute and
    (when only head_dim divides) forces partial-sum all-reduces per
    attention block. So it is applied only when the batch-sharded leaf
    exceeds this per-device size."""
    daxes = data_axes(mesh)
    dsize = _data_size(mesh)
    msize = model_axis_size(mesh)
    dspec = daxes if len(daxes) > 1 else daxes[0]

    def one(p, leaf):
        s = tuple(leaf.shape)
        name = p.rsplit("/", 1)[-1]
        base_rank = {"k": 4, "v": 4, "c_kv": 3, "k_rope": 3,
                     "conv": 3, "state": 4}.get(name, len(s))
        lead = [None] * (len(s) - base_rank)  # stacked-layer dims: unsharded
        bi = len(s) - base_rank               # batch-dim index
        batch_ok = s and s[bi] % dsize == 0
        bdim = dspec if batch_ok else None
        nbytes = float(math.prod(s)) * leaf.dtype.itemsize
        per_dev = nbytes / (dsize if batch_ok else 1)
        if name in ("k", "v"):
            # [*, B, C, Hkv, dh]: prefer kv-head TP; fall back to head_dim
            # TP (partial-sum attention); SP on the ring for B=1 cells.
            need_tp = per_dev > tp_threshold_bytes
            hdim = ("model" if need_tp and _shardable(s[bi + 2], msize)
                    else None)
            ddim = ("model" if need_tp and hdim is None
                    and _shardable(s[bi + 3], msize) else None)
            cdim = (dspec if not batch_ok and _shardable(s[bi + 1], dsize)
                    else None)
            return Sharding(mesh, P(*lead, bdim, cdim, hdim, ddim))
        if name in ("c_kv", "k_rope"):
            # [*, B, C, R]: flash-decoding layout — the cache SEQUENCE
            # shards over `model`, so absorbed-MLA scores compute locally
            # per seq-shard and only [B, H, R] partials cross the wire.
            cdim = None
            if _shardable(s[bi + 1], msize):
                cdim = "model"
            elif not batch_ok and _shardable(s[bi + 1], dsize):
                cdim = dspec
            return Sharding(mesh, P(*lead, bdim, cdim, None))
        return Sharding(mesh, P(*lead, bdim, *([None] * (base_rank - 1))))

    return tree_map_with_path(one, cache_shape)


def replicated(mesh: Mesh, tree: Any):
    return tree_map(lambda _: Sharding(mesh, P()), tree)


def _names(entry) -> tuple[str, ...]:
    return (() if entry is None
            else entry if isinstance(entry, tuple) else (entry,))


def placements(spec: P, axis_names: tuple[str, ...],
               axis_sizes: tuple[int, ...] | None = None) -> tuple:
    """DTensor placements, one per mesh axis of ``axis_names``, for a
    tensor laid out by ``spec``: each entry shards its tensor dim over
    the axes it names (a tuple entry over several, in mesh order, as
    ``PartitionSpec`` does); an axis no entry names replicates, and so
    does an axis of size 1 in ``axis_sizes`` (the same layout; DTensor
    cannot reshape a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    out: list = [Replicate()] * len(axis_names)
    taken = set()
    for dim, entry in enumerate(spec):
        idx = [axis_names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} names axes out of "
                             f"mesh order {axis_names}")
        for i in idx:
            if i in taken:
                raise ValueError(f"{spec} names axis {axis_names[i]} "
                                 f"twice")
            taken.add(i)
            if axis_sizes is None or axis_sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def _place(x: torch.Tensor, sharding: Sharding, device_mesh):
    """``x`` as a DTensor laid out by ``sharding`` on ``device_mesh``: a
    plain tensor (the same on every rank) is split, a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(sharding.spec, sharding.mesh.axis_names,
                    sharding.mesh.axis_sizes)
    if isinstance(x, DTensor):
        return x.redistribute(device_mesh, pl)
    return distribute_tensor(x, device_mesh, pl)


def distribute_tree(tree: Any, shardings: Any, device_mesh) -> Any:
    """``tree`` placed leaf by leaf by ``shardings`` (a tree of
    :class:`Sharding` of the same structure, or one for a whole
    subtree); a ``None`` sharding leaves its subtree as it is, as a
    ``None`` entry of ``out_shardings`` does in the reference."""
    if shardings is None:
        return tree
    if isinstance(shardings, Sharding):
        return tree_map(lambda x: _place(x, shardings, device_mesh), tree)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k], device_mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, device_mesh)
                          for v, s in zip(tree, shardings, strict=True))
    raise TypeError(f"no sharding for a {type(tree).__name__} leaf")


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its full tensor on this rank
    (plain leaves unchanged)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def shard_box(x) -> list[tuple[int, int]]:
    """``(start, size)`` per dim of the part of DTensor ``x`` this rank
    holds: each ``Shard`` placement splits its dim as ``torch.chunk``
    does, mesh dim by mesh dim in order."""
    coord = x.device_mesh.get_coordinate()
    box = [(0, int(n)) for n in x.shape]
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            start, size = box[pl.dim]
            chunk = -(-size // x.device_mesh.size(i))
            lo = min(coord[i] * chunk, size)
            box[pl.dim] = (start + lo, min(chunk, size - lo))
    return box


def local_shape(shape, spec: P, mesh: Mesh) -> tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor laid out by ``spec``
    over ``mesh``: each dim divided (rounding up, as an uneven shard
    pads) by the product of the sizes of the axes its entry names."""
    sizes = mesh.shape
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = math.prod(sizes[a] for a in _names(entry))
        out.append(-(-int(dim) // n))
    return tuple(out)


# --------------------------------------------------------------------- #
# PuM word-axis sharding (the fused dataplane's `shard-words` backend)
# --------------------------------------------------------------------- #


def words_mesh(devices=None) -> Mesh:
    """1-D ``("words",)`` mesh over ``devices`` (default: the visible CUDA
    cards; a host with no card raises): the PuM fused dataplane is
    elementwise across packed words, so the word axis is the one natural
    partition dimension (every device runs the same fused program on its
    slice, no collectives)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("words_mesh: no CUDA card is visible; pass "
                               "devices= to shard over other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    return Mesh(("words",), (len(devices),), devices)


def words_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis sharding of a flat packed-word array over ``mesh``."""
    return Sharding(mesh, P("words"))
