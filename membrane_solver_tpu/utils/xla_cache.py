"""Persistent-cache hygiene helpers.

XLA:CPU's persistent compilation cache occasionally aborts or SIGSEGVs
inside ``get_executable_and_time`` when deserializing LARGE executables —
observed for entries written on a host with other CPU features and,
independently, for MULTI-DEVICE host-platform executables (the 8-virtual-device tensor-
parallel minimize block aborted on a warm read even same-host).  Rather
than risk the crash, multi-device programs never touch the cache: they
compile fresh per process, which is the test/dryrun scale anyway.

The same instability class also hits COMPILES, not just cache reads: a
full pytest run once SIGSEGV'd 3/3 times at the first 8-virtual-device
compile after ~226 tests' executables had accumulated in-process, while
the identical compile passed standalone (see
tools/repro_xlacpu_multidevice_crash.py for the recorded investigation).
The suite's mitigation is the same doctrine: multi-device compiles run
only in short-lived forked subprocesses
(tests/test_tensor_parallel.py::run_multidevice_driver).

Third sighting (2026-08-20): after a day of bench/profile processes had
grown the shared cache directory, full-suite runs SIGSEGV'd 2/2 inside
``get_executable_and_time`` on a WARM SINGLE-DEVICE read
(tests/test_vertex_tilt_lane.py, ~300 green tests in) while the same test
passed alone in 2.5 s reading the same entry — accumulation-dependent
again, now at the read site.  Mitigation: the pytest suite runs with
MEMBRANE_SOLVER_COMPILE_CACHE=0 (tests/conftest.py), so a suite process
never deserializes a cached executable.

Note on the ``cpu_aot_loader.cc`` "machine type ... doesn't match" /
"could lead to SIGILL" stderr lines seen on warm same-host cache reads:
XLA's loader compares the full LLVM target-feature string, which includes
the tuning pseudo-features ``+prefer-no-scatter``/``+prefer-no-gather``
that runtime host-CPU detection never reports.  Treat the warning as
spurious ONLY when the two feature lists printed in the warning differ
solely in those tuning pseudo-features — that exact diff was verified for
this host's same-host entries.  Any other difference means a genuinely
foreign entry: wipe the cache directory, and use
``MEMBRANE_SOLVER_AOT_VALIDATE=1`` (utils/aot_cache.py) to force a
validated recompile-and-compare pass when in doubt.
"""

from __future__ import annotations

import functools


def disable_persistent_cache():
    """Disable the persistent cache for the current process state.

    Setting ``jax_compilation_cache_dir = None`` alone is NOT enough once
    any compile has used the cache: ``compilation_cache.is_cache_used``
    memoizes a sticky ``_cache_used`` global and the LRU object keeps the
    directory it was initialized with.  ``reset_cache()`` drops both so
    the config is re-evaluated.
    """
    import jax
    from jax._src import compilation_cache as _cc

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    _cc.reset_cache()
    return prev


def restore_persistent_cache(prev) -> None:
    import jax
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_compilation_cache_dir", prev)
    _cc.reset_cache()  # re-evaluate with the restored directory


def no_persistent_cache(fn):
    """Run ``fn`` with the XLA persistent compilation cache disabled."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = disable_persistent_cache()
        try:
            return fn(*args, **kwargs)
        finally:
            restore_persistent_cache(prev)

    # preserve the jit inspection surface (HLO tests call .lower())
    for attr in ("lower", "trace", "eval_shape"):
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    return wrapped
