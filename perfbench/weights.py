"""Seeded weights in the port's parameter tree, made on the device.

Every leaf has a generator of its own, seeded from the run's seed and the
leaf's place in the tree, so one leaf can be drawn again alone (the
training check compares each leaf's change with its start) and the
reference gets exactly the values the program got. Each leaf is one
``randn`` call in the dtype it is held in; the configuration file's
``weights`` table gives each leaf's spread by name."""

from __future__ import annotations

import torch

MASK63 = (1 << 63) - 1


def leaf_paths(tree: dict, prefix: tuple = ()) -> list[tuple]:
    """Paths to the tensors of a nested dict, keys sorted at each level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaf_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (index + 1)
            ) & MASK63


def draw_leaf(config: dict, path: tuple, shape, seed: int, index: int,
              device, dtype) -> torch.Tensor:
    table = config["weights"]
    name = path[-1]
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(tuple(shape), generator=g, device=device, dtype=dtype)
    if name in table["one_plus_std"]:
        return x.mul_(table["one_plus_std"][name]).add_(1.0)
    if name in table["normal_std"]:
        return x.mul_(table["normal_std"][name])
    raise KeyError(f"no spread for leaf {'/'.join(path)} in the "
                   f"configuration's weights table")


def shapes(cfg) -> dict:
    """The port's parameter tree for ``cfg`` as shapes (the program's own
    layout, read on the ``meta`` device: nothing is allocated)."""
    from repro_torch.models.model import init_params
    return init_params(cfg, device="meta")


def make(config: dict, tree_shapes: dict, seed: int, device,
         dtype=torch.float32) -> dict:
    """Every leaf of ``tree_shapes`` drawn from ``seed`` in ``dtype``."""
    out: dict = {}
    for i, path in enumerate(leaf_paths(tree_shapes)):
        put(out, path, draw_leaf(config, path, get(tree_shapes, path).shape,
                                 seed, i, device, dtype))
    return out


def redraw(config: dict, tree_shapes: dict, seed: int, path: tuple, device,
           dtype=torch.float32) -> torch.Tensor:
    """Leaf ``path`` exactly as :func:`make` drew it."""
    i = leaf_paths(tree_shapes).index(path)
    return draw_leaf(config, path, get(tree_shapes, path).shape, seed, i,
                     device, dtype)
