#!/usr/bin/env python3
"""Public-API snapshot test for ``repro_torch.pum``, the port's surface.

Compares the port's exports (module ``__all__``, the public attribute
surface of ``PumArray``/``Device``/``EngineConfig``, the built-in backend
registrations) against the reference's frozen snapshot, ``EXPECTED`` in
``tools/check_api.py`` beside this file, with the port's known
differences applied, and exits 1 on any other drift:

* the port's names for where it computes (:data:`EXTRA`):
  ``EngineConfig.device``, the torch device the engine computes on
  (``"cuda"`` unless the caller asks for the CPU),
  ``Device.torch_device``, that device as a ``torch.device``, and
  ``select_backend``'s required ``device`` keyword: a backend's
  availability depends on the device, and the port does not fall back;
* the parameters of the functions in :data:`SIGNATURES`, read from the
  reference's source with ``ast``;
* the built-in fused backends carry the port's names
  (:data:`RENAMED_BACKENDS`): the TPU's Pallas pipeline is the CUDA
  kernels' pipeline, the CPU word-domain evaluator runs in torch.

The snapshot file and the reference's sources are read as files; nothing
of the reference package is imported.

Usage: ``PYTHONPATH=src python tools/check_api_torch.py [--print]``
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import inspect
import pathlib
import sys
import types

REFERENCE = pathlib.Path(__file__).resolve().parent / "check_api.py"
# function of the surface -> the reference's module that defines it
SIGNATURES = {"select_backend": REFERENCE.parents[1] / "src" / "repro"
              / "backends.py"}
EXTRA = {"EngineConfig": ["device"], "Device": ["torch_device"],
         "select_backend": ["device"]}
RENAMED_BACKENDS = {"pallas-tpu": "vertical-cuda",
                    "pallas-tpu-64": "vertical-cuda-64",
                    "words-cpu": "words-torch",
                    "words-cpu-64": "words-torch-64"}


def reference_snapshot():
    """``tools/check_api.py`` as a module (its imports are ``sys`` only)."""
    spec = importlib.util.spec_from_file_location("check_api", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_parameters(path: pathlib.Path, name: str) -> list[str]:
    """The parameter names of the function ``name`` defined at the top of
    the module at ``path``, from its source."""
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef) and node.name == name)
    a = fn.args
    return sorted(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)


def expected(ref) -> dict[str, list[str]]:
    """The reference's ``EXPECTED`` with the port's differences applied."""
    want = {key: list(names) for key, names in ref.EXPECTED.items()}
    for name, path in SIGNATURES.items():
        want[name] = reference_parameters(path, name)
    for key, names in EXTRA.items():
        want[key] = want[key] + names
    want["backends"] = [RENAMED_BACKENDS.get(n, n) for n in want["backends"]]
    want["repro_torch.pum"] = want.pop("repro.pum")
    return want


def actual_surface(ref) -> dict[str, list[str]]:
    import repro_torch.pum as pum

    missing = [n for n in pum.__all__ if not hasattr(pum, n)]
    if missing:
        raise AssertionError(f"__all__ names missing from module: {missing}")
    stray = sorted(
        n for n, v in vars(pum).items()
        if not n.startswith("_") and n not in pum.__all__
        and not isinstance(v, types.ModuleType))
    return {
        "repro_torch.pum": (sorted(pum.__all__)
                            + [f"<stray:{n}>" for n in stray]),
        "PumArray": ref._class_surface(pum.PumArray),
        "Device": ref._class_surface(pum.Device),
        "EngineConfig": sorted(f.name for f in
                               dataclasses.fields(pum.EngineConfig)),
        "backends": sorted(pum.available_backends()),
        **{name: sorted(inspect.signature(getattr(pum, name)).parameters)
           for name in SIGNATURES},
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ref = reference_snapshot()
    got = actual_surface(ref)
    if "--print" in argv:
        import pprint
        pprint.pprint(got)
        return 0
    failures = []
    for key, want in expected(ref).items():
        have = got[key]
        if key == "backends":  # a superset is allowed, as in the reference
            lost = sorted(set(want) - set(have))
            if lost:
                failures.append(f"{key}: built-in backends missing: {lost}")
            continue
        if sorted(want) != have:
            extra = sorted(set(have) - set(want))
            lost = sorted(set(want) - set(have))
            failures.append(
                f"{key}: surface drift"
                + (f" — unexpected exports {extra}" if extra else "")
                + (f" — missing exports {lost}" if lost else ""))
    if failures:
        print("repro_torch.pum public-API snapshot mismatch:",
              file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        print("(intentional? a difference from the reference goes in "
              "EXTRA or RENAMED_BACKENDS with its reason)",
              file=sys.stderr)
        return 1
    print(f"check_api_torch: repro_torch.pum surface OK "
          f"({sum(len(v) for v in got.values())} names)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
