#!/usr/bin/env python
"""Per-command wall-clock timing for a macro, plus optional deep profiling.

JAX analog of the reference's ``tools/profile_macro_hotspots.py``
(reference README.md:137-146): run an instruction macro one command at a
time, print per-command timing, and optionally cProfile (host-side
orchestration) or jax-profile (device trace) one hot command.

    python tools/profile_macro_hotspots.py meshes/cube.json "g50;r;u;V2;g50"
    python tools/profile_macro_hotspots.py gen:kozlov_1disk "g10;u;g10" \
        --cprofile g10 --jax-trace /tmp/trace
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import io
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="mesh path or gen:<builder>")
    ap.add_argument("macro", help="semicolon-separated instruction line")
    ap.add_argument("--cprofile", default=None, metavar="CMD",
                    help="cProfile the first occurrence of this command")
    ap.add_argument("--jax-trace", default=None, metavar="DIR",
                    help="jax.profiler trace dir for the whole macro")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from membrane_solver_tpu import load_data, parse_geometry
    from membrane_solver_tpu.commands.context import CommandContext
    from membrane_solver_tpu.commands.executor import execute_command_line
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.minimizer import Minimizer

    if args.input.startswith("gen:"):
        data = build(args.input[4:])
    else:
        data = load_data(args.input)
    mesh = parse_geometry(data)
    ctx = CommandContext(mesh=mesh, minimizer=Minimizer(mesh, quiet=True))

    commands = [c.strip() for c in args.macro.split(";") if c.strip()]
    profiled = False

    if args.jax_trace:
        jax.profiler.start_trace(args.jax_trace)

    total = 0.0
    for cmd in commands:
        prof = None
        if args.cprofile and cmd == args.cprofile and not profiled:
            prof = cProfile.Profile()
            prof.enable()
        t0 = time.perf_counter()
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        dt = time.perf_counter() - t0
        total += dt
        print(f"{cmd:12s} {dt:9.3f}s   E={float(ctx.minimizer.compute_energy()):.10g}")
        if prof is not None:
            prof.disable()
            profiled = True
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(25)
            print(buf.getvalue())

    if args.jax_trace:
        jax.profiler.stop_trace()
        print(f"jax trace written to {args.jax_trace}")

    print(f"{'TOTAL':12s} {total:9.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
