"""Shared local shell construction for curved disk-boundary interface modules.

Parity: reference ``modules/constraints/local_interface_shells.py`` —
identifies the disk-boundary ring ("disk"), the first shell outside it
("rim"), and the second shell ("outer") by cylindrical radius, orders each by
azimuth, and matches rows across shells by nearest azimuth.

Design note: the reference rebuilds this family from live positions on
every version-keyed cache miss; here the row selection and azimuth matching
are resolved at compile time (from the compile-time positions) and the
geometric quantities (radii, slopes, bases) are recomputed live on device.
Shell membership only changes when vertices cross radial shells, which the
lanes using these modules (pinned rings, z-dominant motion) do not do between
recompiles; any mesh operation triggers a fresh compile and re-selection.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShellRows:
    disk_rows: np.ndarray
    rim_rows: np.ndarray
    outer_rows: np.ndarray
    disk_rows_matched: np.ndarray  # aligned with rim_rows
    rim_rows_matched: np.ndarray  # aligned with outer_rows
    rim_rows_for_disk: np.ndarray  # aligned with disk_rows
    outer_rows_for_rim: np.ndarray  # aligned with rim_rows
    outer_rows_for_disk: np.ndarray  # aligned with disk_rows
    disk_radius: float
    rim_radius: float
    outer_radius: float


def _collect_disk_rows(layout, group: str) -> np.ndarray:
    mesh = layout.mesh
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if (
            opts.get("rim_slope_match_group") == group
            or opts.get("tilt_thetaB_group") == group
            or opts.get("tilt_thetaB_group_in") == group
        ):
            rows.append(layout.row_of[int(vid)])
    return np.asarray(rows, dtype=int)


def _order_by_angle(positions, rows):
    phi = np.mod(np.arctan2(positions[rows, 1], positions[rows, 0]), 2.0 * np.pi)
    return np.asarray(rows[np.argsort(phi)], dtype=int)


def _match_by_azimuth(source_phi, target_rows, target_phi):
    """Match ordered rows by azimuth; cyclic-shift alignment on equal counts.

    Parity: reference local_interface_shells._match_rows_by_azimuth — when
    the ring counts agree the match is the cyclic roll minimizing the mean
    wrapped angular gap (preserves cyclic order); otherwise per-row nearest.
    """
    source_phi = np.asarray(source_phi, dtype=float)
    target_rows = np.asarray(target_rows, dtype=int)
    target_phi = np.asarray(target_phi, dtype=float)

    def wrapped(a, b):
        d = np.abs(a - b)
        return np.minimum(d, 2.0 * np.pi - d)

    if source_phi.size == target_rows.size and source_phi.size > 0:
        best_shift, best_cost = 0, float("inf")
        for shift in range(source_phi.size):
            cost = float(np.mean(wrapped(source_phi, np.roll(target_phi, -shift))))
            if cost < best_cost:
                best_cost, best_shift = cost, shift
        return np.asarray(np.roll(target_rows, -best_shift), dtype=int)

    diff = wrapped(source_phi[:, None], target_phi[None, :])
    return np.asarray(target_rows[np.argmin(diff, axis=1)], dtype=int)


def build_shell_rows(layout, *, group: str = "disk") -> ShellRows | None:
    """Compile-time analog of build_local_interface_shell_data (137-216)."""
    mesh = layout.mesh
    n = len(layout.vertex_ids)
    positions = np.array(
        [mesh.vertices[int(layout.vertex_ids[r])].position for r in range(n)]
    )
    disk_rows = _collect_disk_rows(layout, group)
    if disk_rows.size == 0:
        return None
    disk_rows = _order_by_angle(positions, disk_rows)
    radii = np.linalg.norm(positions[:, :2], axis=1)
    disk_radius = float(np.max(radii[disk_rows]))
    disk_mask = np.zeros(n, dtype=bool)
    disk_mask[disk_rows] = True

    gp = mesh.global_parameters
    trace_layer_radius = gp.get("parity_trace_layer_radius")
    rim_candidates = (~disk_mask) & (radii > (disk_radius + 1e-9))
    if not np.any(rim_candidates):
        return None
    if trace_layer_radius is None:
        rim_radius = float(np.min(radii[rim_candidates]))
    else:
        shell_radii = np.unique(np.round(radii[rim_candidates], 12))
        shell_radii = shell_radii[shell_radii >= (disk_radius + 1e-9)]
        if shell_radii.size == 0:
            return None
        idx = int(np.argmin(np.abs(shell_radii - float(trace_layer_radius))))
        rim_radius = float(shell_radii[idx])
    rim_tol = max(1e-9, 1e-5 * max(1.0, abs(rim_radius)))
    rim_rows = _order_by_angle(
        positions, np.flatnonzero((~disk_mask) & (np.abs(radii - rim_radius) <= rim_tol))
    )
    outer_mask = (~disk_mask) & (~np.isin(np.arange(n), rim_rows))
    outer_candidates = outer_mask & (radii > (rim_radius + rim_tol))
    if not np.any(outer_candidates):
        return None
    outer_radius = float(np.min(radii[outer_candidates]))
    outer_tol = max(1e-9, 1e-5 * max(1.0, abs(outer_radius)))
    outer_rows = _order_by_angle(
        positions,
        np.flatnonzero(outer_mask & (np.abs(radii - outer_radius) <= outer_tol)),
    )

    def phi_of(rows):
        return np.mod(np.arctan2(positions[rows, 1], positions[rows, 0]), 2.0 * np.pi)

    phi_rim, phi_out, phi_disk = phi_of(rim_rows), phi_of(outer_rows), phi_of(disk_rows)
    return ShellRows(
        disk_rows=disk_rows,
        rim_rows=rim_rows,
        outer_rows=outer_rows,
        disk_rows_matched=_match_by_azimuth(phi_rim, disk_rows, phi_disk),
        rim_rows_matched=_match_by_azimuth(phi_out, rim_rows, phi_rim),
        rim_rows_for_disk=_match_by_azimuth(phi_disk, rim_rows, phi_rim),
        outer_rows_for_rim=_match_by_azimuth(phi_rim, outer_rows, phi_out),
        outer_rows_for_disk=_match_by_azimuth(phi_disk, outer_rows, phi_out),
        disk_radius=disk_radius,
        rim_radius=rim_radius,
        outer_radius=outer_radius,
    )


def pack_pairs(layout, rows_a: np.ndarray, rows_b: np.ndarray) -> dict:
    """Pad aligned row pairs into capacity arrays for topo extras."""
    n = max(len(rows_a), 1)
    nc = 1
    while nc < n:
        nc *= 2
    pad = layout.pad_rows
    return {
        "rows_a": pad(np.asarray(rows_a if len(rows_a) else [0], dtype=np.int32), nc, 0),
        "rows_b": pad(np.asarray(rows_b if len(rows_b) else [0], dtype=np.int32), nc, 0),
        "valid": pad(
            np.ones(len(rows_a), dtype=bool) if len(rows_a) else np.zeros(1, dtype=bool),
            nc,
            False,
        ),
    }
