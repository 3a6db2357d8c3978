"""TUM-format trajectory text IO, byte-compatible with the reference dumps
(the port's own copy of ``semantic_slam_tpu.io.tum``).

The reference writes ``#timestamp ,tx,ty,tz,qx,qy,qz,qw`` then space-
separated rows (``semantic_graph_slam_ros.cpp:573-659``), to hardcoded
Desktop paths; here the path is a parameter.
"""

from __future__ import annotations

import numpy as np

HEADER = "#timestamp ,tx,ty,tz,qx,qy,qz,qw"


def write_tum(path: str, stamps: np.ndarray, poses7: np.ndarray) -> None:
    """poses7 rows are [tx,ty,tz,qw,qx,qy,qz] (internal wxyz order); the file
    stores TUM order qx qy qz qw like the reference."""
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for t, p in zip(np.asarray(stamps), np.asarray(poses7)):
            tx, ty, tz, qw, qx, qy, qz = p
            f.write(f"{t} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (stamps [N], poses7 [N,7] in internal [t, q_wxyz] order)."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            stamps.append(vals[0])
            tx, ty, tz, qx, qy, qz, qw = vals[1:8]
            poses.append([tx, ty, tz, qw, qx, qy, qz])
    return np.asarray(stamps), np.asarray(poses)
