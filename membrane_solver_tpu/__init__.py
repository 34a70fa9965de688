"""membrane_solver_tpu — a GPU-accelerated Surface-Evolver-style membrane energy minimizer.

A ground-up JAX/XLA rebuild of the capabilities of
``AvishaiBarnoy/membrane_solver``: triangulated-mesh energy minimization over
vertex positions and per-vertex bilayer tilt fields, with pluggable energy
functionals and hard constraints, Evolver-style mesh operations (refine /
equiangulate / vertex-average), an interactive CLI, and a benchmark +
acceptance-test harness.

Architecture:

- Host layer (`geometry`, `runtime.refinement`, ...): a light entity mesh used
  for I/O, topology surgery, and option/tag bookkeeping.  Topology changes are
  index-rewrite passes producing new dense index buffers.
- Device layer (`device`, `energy`, `constraints`, `runtime.jit_core`): all
  per-step numerics are pure functions of capacity-padded SoA arrays
  (positions, tilts, triangle rows, edge rows, masks, per-facet parameters),
  compiled once with `jax.jit` and re-used across topology changes of the same
  padded capacity.  Gradients come from `jax.grad` through the shared geometry
  context.
- Minimization (`runtime.minimizer`): an Evolver-compatible outer loop whose
  inner iteration blocks (energy/gradient assembly, KKT constraint projection,
  Armijo line search with normal-flip safety, tilt inner solves) run as jitted
  fixed-shape `lax.while_loop`s on device.

Precision: the solver runs in float64 (like the reference); importing this
package enables JAX x64 mode.  Work runs on JAX's default device (the GPU
when one is present); ``JAX_PLATFORMS=cpu`` or the CLI's ``--cpu`` selects
the host.
"""

from __future__ import annotations

import os
from pathlib import Path

# cached CPU executables log a spurious machine-feature-mismatch ERROR per
# load (XLA records tuning flags like +prefer-no-gather in the feature list
# and the loader compares them against host CPU features); the env var must
# be set before the jaxlib extension loads to take effect
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

# Precision: float64 by default (parity with the reference solver).  Set
# MEMBRANE_SOLVER_X64=0 to run in float32.
if os.environ.get("MEMBRANE_SOLVER_X64", "1") not in {"0", "false", "no"}:
    jax.config.update("jax_enable_x64", True)

# Matmul precision: full float32 for every dot/matmul/einsum.  On NVIDIA
# GPUs the default precision may run f32 contractions in TF32 (~10 mantissa
# bits), which would put ~1e-3 relative error into the KKT projector solves
# (G @ G.T, lam @ G in jit_core/tilt_relax) and the CG coefficient dots.
# Every contraction in this workload is small (k x 3N KKT rows, 3-vector
# dots), so full precision costs little.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the minimize block recompiles per padded
# capacity (a refinement ladder hits 3-4 capacities); caching the executables
# on disk makes later processes start warm.  JAX itself reads
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at one fixed path in
# the checkout.  MEMBRANE_SOLVER_COMPILE_CACHE=0 disables it.
CACHE_ROOT_DEFAULT = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> Path | None:
    """Directory of the persistent compile cache, or None when disabled."""
    if os.environ.get("MEMBRANE_SOLVER_COMPILE_CACHE", "1") in {"0", "false", "no"}:
        return None
    return Path(os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_ROOT_DEFAULT)


_cache_dir = compile_cache_dir()
jax.config.update("jax_compilation_cache_dir", None if _cache_dir is None else str(_cache_dir))
if _cache_dir is not None:
    # cache small executables too: the classic lanes compile many
    # sub-second programs per capacity epoch
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.02)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

__version__ = "0.1.0"

from membrane_solver_tpu.core.parameters import GlobalParameters, ParameterResolver  # noqa: E402
from membrane_solver_tpu.geometry.io_readers import load_data, parse_geometry  # noqa: E402
from membrane_solver_tpu.geometry.io_writers import save_geometry  # noqa: E402
from membrane_solver_tpu.geometry.mesh import Mesh  # noqa: E402
from membrane_solver_tpu.runtime.minimizer import Minimizer  # noqa: E402

__all__ = [
    "GlobalParameters",
    "ParameterResolver",
    "Mesh",
    "Minimizer",
    "load_data",
    "parse_geometry",
    "save_geometry",
    "__version__",
]
