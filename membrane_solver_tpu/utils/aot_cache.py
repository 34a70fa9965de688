"""Disk-backed AOT cache for jitted entry points (jax.export serialization).

The persistent XLA compilation cache removes compile time across processes,
but Python tracing + StableHLO lowering still re-run per process — on the
small interactive lanes (cube, catenoid) that cost dominates wall-clock
(~0.5 s per minimize-block signature; the reference's NumPy loop has no
such cost).  This wrapper serializes the exported StableHLO of each jitted
entry to ``<compile cache>/aot`` (the persistent XLA cache's directory,
``membrane_solver_tpu.compile_cache_dir``) keyed by

    (entry name, arg platform/avals/treedef, jax version, source hash)

and replays it with ``jax.export.deserialize(...).call`` on later
processes (the replay's XLA compile hits the persistent compilation
cache, so a warm process pays neither trace nor compile).

Design notes (hard-won):

- The export is taken of a FLAT-LEAVES wrapper ``g(*leaves) ->
  tuple(out_leaves)`` — never of a function whose signature contains the
  package's registered pytree dataclasses.  Round-tripping custom pytree
  nodes through ``register_pytree_node_serialization`` (pickled auxdata)
  produced scrambled leaf bindings on deserialize, which fed garbage into
  bounded-looking device loops and hung entire lanes.  Flat leaves make
  the serialized calling convention position-only; argument and result
  structure live host-side in this module's codec.
- The output structure is stored next to the StableHLO as a small JSON
  descriptor (tuples/lists/dicts/None/leaves plus a WHITELIST of the
  package's pytree dataclasses).  No pickle anywhere — a tampered cache
  file can fail to load, but cannot execute code.
- Each (name, static_key) wrapper holds per-aval-signature entries, so a
  params pytree that changes shape/dtype mid-session (REPL `set` of a new
  global) simply compiles a new entry instead of raising.
- On any failure (missing class, codec mismatch, deserialize error) the
  wrapper falls back to the plain jitted callable for that signature.

Set MEMBRANE_SOLVER_AOT_CACHE=0 to disable, MEMBRANE_SOLVER_AOT_VALIDATE=1
to cross-check each newly created export against the live-traced function
once at write time (costs one extra compile+execution per entry).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
from typing import Any, Callable

import jax

_SRC_HASH: str | None = None


def _cache_dir() -> pathlib.Path | None:
    from membrane_solver_tpu import compile_cache_dir

    root = compile_cache_dir()
    return None if root is None else root / "aot"


def enabled() -> bool:
    """On unless MEMBRANE_SOLVER_AOT_CACHE=0 (the test suite's setting: it
    creates hundreds of one-shot signatures) or the compile cache is off."""
    return (
        os.environ.get("MEMBRANE_SOLVER_AOT_CACHE", "1") in {"1", "true", "yes"}
        and _cache_dir() is not None
    )


def _validate() -> bool:
    return os.environ.get("MEMBRANE_SOLVER_AOT_VALIDATE", "0") in {"1", "true", "yes"}


def _source_hash() -> str:
    global _SRC_HASH
    if _SRC_HASH is None:
        import membrane_solver_tpu

        root = pathlib.Path(membrane_solver_tpu.__file__).parent
        h = hashlib.sha256()
        for p in sorted(root.rglob("*.py")):
            h.update(p.read_bytes())
        _SRC_HASH = h.hexdigest()[:16]
    return _SRC_HASH


# ----------------------------------------------------------------------
# structure codec (no pickle): tuple / list / dict / None / leaf /
# whitelisted pytree dataclasses
# ----------------------------------------------------------------------
def _class_registry() -> dict[str, type]:
    from membrane_solver_tpu.device.state import MeshState, Topology
    from membrane_solver_tpu.runtime.jit_core import (
        LineSearchResult,
        MinimizeStats,
        StepperState,
    )
    from membrane_solver_tpu.runtime.tilt_relax import TiltRelaxStats

    return {
        c.__name__: c
        for c in (
            MeshState,
            Topology,
            MinimizeStats,
            StepperState,
            LineSearchResult,
            TiltRelaxStats,
        )
    }


def encode_structure(obj: Any) -> dict:
    """JSON-able descriptor of a pytree's structure (leaves elided)."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, tuple):
        return {"t": "tuple", "c": [encode_structure(x) for x in obj]}
    if isinstance(obj, list):
        return {"t": "list", "c": [encode_structure(x) for x in obj]}
    if isinstance(obj, dict):
        keys = sorted(obj)  # jax flattens dicts in sorted-key order
        return {
            "t": "dict",
            "k": list(keys),
            "c": [encode_structure(obj[k]) for k in keys],
        }
    cls = type(obj)
    if dataclasses.is_dataclass(obj) and cls.__name__ in _class_registry():
        fields = [f.name for f in dataclasses.fields(cls)]
        return {
            "t": "dc",
            "cls": cls.__name__,
            "f": fields,
            "c": [encode_structure(getattr(obj, f)) for f in fields],
        }
    # anything else is a leaf (array / scalar)
    return {"t": "leaf"}


def _decode(desc: dict, leaves: list, pos: int) -> tuple[Any, int]:
    t = desc["t"]
    if t == "none":
        return None, pos
    if t == "leaf":
        return leaves[pos], pos + 1
    if t in ("tuple", "list"):
        out = []
        for c in desc["c"]:
            v, pos = _decode(c, leaves, pos)
            out.append(v)
        return (tuple(out) if t == "tuple" else out), pos
    if t == "dict":
        out = {}
        for k, c in zip(desc["k"], desc["c"]):
            out[k], pos = _decode(c, leaves, pos)
        return out, pos
    if t == "dc":
        cls = _class_registry()[desc["cls"]]
        kwargs = {}
        for f, c in zip(desc["f"], desc["c"]):
            kwargs[f], pos = _decode(c, leaves, pos)
        return cls(**kwargs), pos
    raise ValueError(f"unknown structure tag {t!r}")


def decode_structure(desc: dict, leaves: list) -> Any:
    obj, pos = _decode(desc, leaves, 0)
    if pos != len(leaves):
        raise ValueError(f"leaf count mismatch: consumed {pos} of {len(leaves)}")
    return obj


def _multi_device(leaf) -> bool:
    sharding = getattr(leaf, "sharding", None)
    if sharding is None:
        return False
    try:
        return len(sharding.device_set) > 1
    except Exception:
        return False


def _platform(leaves) -> str:
    """Export platform of the call: the device its array arguments live on
    (a process may run one problem on the GPU and another on the host)."""
    for leaf in leaves:
        devices = getattr(leaf, "devices", None)
        if callable(devices):
            platform = next(iter(devices())).platform
            return "cuda" if platform == "gpu" else platform
    return "cuda" if jax.default_backend() == "gpu" else jax.default_backend()


def _aval_key(leaves) -> str:
    parts = [_platform(leaves)]
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None:
            parts.append(f"py:{type(leaf).__name__}:{leaf!r}")
        elif _multi_device(leaf):
            # sharded input: keep a distinct signature so a single-device
            # cache entry is never replayed with (and never recorded for)
            # multi-device arguments — replay would silently drop the
            # sharding the caller laid out
            parts.append(f"{tuple(shape)}:{dtype}@sharded")
        else:
            parts.append(f"{tuple(shape)}:{dtype}")
    return "|".join(parts)


def aot_wrap(name: str, static_key: str, jitted: Callable) -> Callable:
    """Wrap ``jitted`` with the disk-backed flat-leaves export cache.

    ``static_key`` must uniquely describe the traced computation for fixed
    arg avals (e.g. repr of the ProblemSpec + options).
    """
    if not enabled():
        return jitted

    from jax import export as jexport

    cache_dir = _cache_dir()
    # per-aval-signature entries: {"fn": replay, "out": desc} or {"fallback": True}
    entries: dict[str, dict] = {}

    def call(*args):
        leaves, in_treedef = jax.tree_util.tree_flatten(args)
        akey = _aval_key(leaves)
        ent = entries.get(akey)
        if ent is not None:
            if "fn" in ent:
                out_leaves = ent["fn"](*leaves)
                return decode_structure(ent["out"], list(out_leaves))
            return jitted(*args)  # fallback signature
        if any(_multi_device(leaf) for leaf in leaves):
            # multi-device programs never touch the export cache (the
            # sweep/TP paths own their shardings; a replayed module would
            # re-lay the computation out single-device)
            entries[akey] = {"fallback": True}
            return jitted(*args)

        digest = hashlib.sha256(
            "|".join(
                [
                    name,
                    static_key,
                    str(in_treedef),
                    akey,
                    jax.__version__,
                    _source_hash(),
                ]
            ).encode()
        ).hexdigest()[:32]
        hlo_path = cache_dir / f"{name}-{digest}.stablehlo"
        out_path = cache_dir / f"{name}-{digest}.out.json"

        def flat_fn(*ls):
            a = jax.tree_util.tree_unflatten(in_treedef, list(ls))
            return tuple(jax.tree_util.tree_leaves(jitted(*a)))

        if hlo_path.exists() and out_path.exists():
            try:
                exp = jexport.deserialize(hlo_path.read_bytes())
                desc = json.loads(out_path.read_text())
                fn = jax.jit(exp.call)
                out_leaves = fn(*leaves)
                result = decode_structure(desc, list(out_leaves))
                entries[akey] = {"fn": fn, "out": desc}
                return result
            except Exception:
                hlo_path.unlink(missing_ok=True)
                out_path.unlink(missing_ok=True)

        try:
            exp = jexport.export(jax.jit(flat_fn), platforms=[_platform(leaves)])(*leaves)
            data = exp.serialize()
            # the output structure descriptor comes from an abstract
            # evaluation of the wrapped callable (no FLOPs)
            out_shape = jax.eval_shape(lambda *a: jitted(*a), *args)
            desc = encode_structure(out_shape)
            # run the replayed module (its compile seeds the persistent
            # XLA cache entry the next process will hit)
            fn = jax.jit(exp.call)
            out_leaves = fn(*leaves)
            result = decode_structure(desc, list(out_leaves))
            if _validate():
                ref_leaves = jax.tree_util.tree_leaves(jitted(*args))
                import numpy as _np

                for a, b in zip(ref_leaves, out_leaves, strict=True):
                    _np.testing.assert_array_equal(_np.asarray(a), _np.asarray(b))
            cache_dir.mkdir(parents=True, exist_ok=True)
            # write each file under a writer-private name, then rename: a
            # reader never sees a partial file (two writers of one digest
            # write identical bytes)
            for path, payload in ((hlo_path, data), (out_path, json.dumps(desc).encode())):
                fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
                with os.fdopen(fd, "wb") as fh:
                    fh.write(payload)
                os.replace(tmp, path)
            entries[akey] = {"fn": fn, "out": desc}
            return result
        except Exception:
            if os.environ.get("MEMBRANE_SOLVER_AOT_DEBUG"):
                import traceback

                traceback.print_exc()
            # unexportable computation (or codec limit): plain jit
            entries[akey] = {"fallback": True}
            return jitted(*args)

    return call
