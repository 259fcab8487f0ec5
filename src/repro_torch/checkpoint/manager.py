"""Checkpointing: save/restore with atomic commits, async writer,
retention, and restore onto a named device.

The port's copy of ``repro.checkpoint.manager``, with the same on-disk
format: one directory ``step_XXXXXXXX`` per step holding ``params.npz``
and ``opt_state.npz`` (one array per leaf, named by its ``/``-joined dict
keys and list indices) and ``meta.json``. A checkpoint written by either
package restores in the other.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.tree import tree_items


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """Host copies of the leaves by path. Always a copy: on the CPU
    ``Tensor.numpy()`` aliases the tensor, and the in-place optimizer
    would let an async write save a later step."""
    return {_key(path): leaf.detach().to("cpu", copy=True).numpy()
            for path, leaf in tree_items(tree)}


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _unflatten_into(template: Any, flat: dict[str, np.ndarray],
                    device=None) -> Any:
    def one(path, leaf):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        return torch.from_numpy(np.require(arr, requirements="C")).to(
            leaf.device if device is None else device, leaf.dtype)
    return _map_with_path(one, template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: concurrent.futures.Future | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, params: Any, opt_state: Any,
             meta: dict | None = None) -> None:
        """Async by default; the device->host copy happens synchronously
        (so the next step may update the tensors in place), the file
        write overlaps the next steps."""
        host = {
            "params": _flatten(params),
            "opt_state": _flatten(opt_state),
        }
        meta = dict(meta or {})
        meta["step"] = step
        meta["time"] = time.time()
        if self.async_write:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host, meta)
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, flat in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):      # re-save of the same step (idempotent)
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_template: Any,
                opt_template: Any, device=None) -> tuple[Any, Any, dict]:
        """Restore into trees shaped like the templates, with their
        dtypes, on ``device`` (default: each template leaf's device). The
        checkpoint holds no device, so it restores onto any."""
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "params.npz"),
                     allow_pickle=False) as z:
            params = _unflatten_into(params_template, dict(z), device)
        with np.load(os.path.join(d, "opt_state.npz"),
                     allow_pickle=False) as z:
            opt = _unflatten_into(opt_template, dict(z), device)
        return params, opt, meta
