"""Geodesy + rotation-convention helpers (WGS-84 / ENU / Euler).

Standard formulas covering the capability of the reference's geoFunc
(reference dbaf/geoFunc/trans.py:7-246): ECEF<->geodetic, the
ECEF->local-ENU rotation ``Cen``, Euler (yaw-pitch-roll) conversions, and
the two-vector rotation used by gravity alignment.
"""

from __future__ import annotations

import numpy as np

# WGS-84 (geoFunc/const_value.py)
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def ecef_to_geodetic(xyz: np.ndarray) -> np.ndarray:
    """ECEF -> (lat, lon, height) radians/meters (iterative)."""
    x, y, z = xyz
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(6):
        N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * N / (N + h)))
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - N
    return np.array([lat, lon, h])


def geodetic_to_ecef(llh: np.ndarray) -> np.ndarray:
    lat, lon, h = llh
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    return np.array(
        [
            (N + h) * np.cos(lat) * np.cos(lon),
            (N + h) * np.cos(lat) * np.sin(lon),
            (N * (1.0 - WGS84_E2) + h) * np.sin(lat),
        ]
    )


def Cen(ecef_ref: np.ndarray) -> np.ndarray:
    """Rotation ECEF <- ENU at the ECEF reference point (columns = local
    East/North/Up axes in ECEF), so local = Cen.T @ (ecef - ref)."""
    lat, lon, _ = ecef_to_geodetic(np.asarray(ecef_ref, float))
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    east = np.array([-so, co, 0.0])
    north = np.array([-sl * co, -sl * so, cl])
    up = np.array([cl * co, cl * so, sl])
    return np.stack([east, north, up], axis=1)


def ypr_to_matrix(ypr: np.ndarray) -> np.ndarray:
    """(yaw, pitch, roll) degrees -> rotation matrix, Rz(y)Ry(p)Rx(r)."""
    y, p, r = np.deg2rad(np.asarray(ypr, float))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def matrix_to_ypr(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (yaw, pitch, roll) degrees."""
    yaw = np.rad2deg(np.arctan2(R[1, 0], R[0, 0]))
    pitch = np.rad2deg(np.arcsin(np.clip(-R[2, 0], -1, 1)))
    roll = np.rad2deg(np.arctan2(R[2, 1], R[2, 2]))
    return np.array([yaw, pitch, roll])


def att_to_matrix(att_rad: np.ndarray) -> np.ndarray:
    """(roll?, pitch?, heading) radians in the reference's att2m layout:
    z-rotation by att[2] composed with x/y tilts; used only with pure-yaw
    inputs in the pipeline (init_GNSS heading alignment)."""
    r, p, y = np.asarray(att_rad, float)
    return ypr_to_matrix(np.rad2deg(np.array([y, p, r])))


def from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation R with R @ a ~ b (geoFunc/trans.py:236-245)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # opposite: rotate pi about any orthogonal axis
        axis = np.array([1.0, 0.0, 0.0])
        if abs(a[0]) > 0.9:
            axis = np.array([0.0, 1.0, 0.0])
        v = np.cross(a, axis)
        v /= np.linalg.norm(v)
        K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 - c) / (np.linalg.norm(v) ** 2)
