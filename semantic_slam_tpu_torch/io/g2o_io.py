"""g2o ASCII graph save/load (port of ``semantic_slam_tpu.io.g2o_io``).

``GraphSLAM::save`` dumps the optimizer in g2o's text format
(``graph_slam.cpp:236-239``); this module writes the same vertex/edge tags
(VERTEX_SE3:QUAT, VERTEX_TRACKXYZ, EDGE_SE3:QUAT, EDGE_SE3_TRACKXYZ,
PARAMS_SE3OFFSET, and with plane landmarks VERTEX_PLANE and EDGE_SE3_PLANE),
byte for byte the JAX package's text for the same graph, and loads them
back into a port ``GraphState`` (and ``PlaneNodes``).
"""

from __future__ import annotations

import numpy as np
import torch

from semantic_slam_tpu_torch.graph import planes as gp
from semantic_slam_tpu_torch.graph import state as gs


def _upper_triangular(m: np.ndarray) -> list[float]:
    n = m.shape[0]
    return [float(m[i, j]) for i in range(n) for j in range(i, n)]


def save_g2o(path: str, g: gs.GraphState, pn=None) -> None:
    """Write the graph's active prefix; with plane nodes ``pn`` also their
    VERTEX_PLANE / EDGE_SE3_PLANE records (the wire format of the
    reference's disabled custom edge, edge_se3_plane.hpp:28-47: 4 plane
    coefficients and the upper-triangular information; VERTEX_PLANE as g2o's
    slam3d_addons writes it, the coefficients and an RGB color)."""
    a = gs.graph_to_numpy(g)
    K, L, E1, E2 = (int(a[n]) for n in ("num_poses", "num_landmarks", "num_odom", "num_lme"))
    f64 = {n: a[n].astype(np.float64) for n in ("poses", "landmarks", "odom_meas", "odom_info", "lme_meas", "lme_info")}
    with open(path, "w") as f:
        # identity sensor offset, parameter id 0 (graph_slam.cpp:75-83)
        f.write("PARAMS_SE3OFFSET 0 0 0 0 0 0 0 1\n")
        # vertex ids share one counter across types, SE3 first (quirk 10:
        # ids come from vertices().size(); here keyframes precede landmarks)
        for i, p in enumerate(f64["poses"][:K]):
            tx, ty, tz, qw, qx, qy, qz = p
            f.write(f"VERTEX_SE3:QUAT {i} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")
            if i == 0:
                f.write("FIX 0\n")
        for l, x in enumerate(f64["landmarks"][:L]):
            f.write(f"VERTEX_TRACKXYZ {K + l} {x[0]} {x[1]} {x[2]}\n")
        for e in range(E1):
            tx, ty, tz, qw, qx, qy, qz = f64["odom_meas"][e]
            ut = " ".join(str(v) for v in _upper_triangular(f64["odom_info"][e]))
            f.write(f"EDGE_SE3:QUAT {a['odom_i'][e]} {a['odom_j'][e]} {tx} {ty} {tz} {qx} {qy} {qz} {qw} {ut}\n")
        for e in range(E2):
            m = f64["lme_meas"][e]
            ut = " ".join(str(v) for v in _upper_triangular(f64["lme_info"][e]))
            f.write(f"EDGE_SE3_TRACKXYZ {a['lme_k'][e]} {K + a['lme_l'][e]} 0 {m[0]} {m[1]} {m[2]} {ut}\n")
        if pn is None:
            return
        b = gp.plane_nodes_to_numpy(pn)
        P, E3 = int(b["num_planes"]), int(b["num_pe"])
        for p, n in enumerate(b["planes"][:P].astype(np.float64)):
            f.write(f"VERTEX_PLANE {K + L + p} {n[0]} {n[1]} {n[2]} {n[3]} 0 0 0\n")
        pmeas, pinfo = b["pe_meas"].astype(np.float64), b["pe_info"].astype(np.float64)
        for e in range(E3):
            ut = " ".join(str(v) for v in _upper_triangular(pinfo[e]))
            m = pmeas[e]
            f.write(f"EDGE_SE3_PLANE {b['pe_k'][e]} {K + L + b['pe_p'][e]} {m[0]} {m[1]} {m[2]} {m[3]} {ut}\n")


def _sym_from_ut(vals, n: int) -> np.ndarray:
    m = np.zeros((n, n))
    it = iter(vals)
    for i in range(n):
        for j in range(i, n):
            m[i, j] = m[j, i] = next(it)
    return m


def load_g2o(path: str, with_planes: bool = False, device=None, dtype=torch.float64):
    """Parse a graph written by ``save_g2o`` into a port ``GraphState`` on
    ``device``, at power-of-two capacities of at least 16, as the JAX loader
    sizes them; with ``with_planes=True`` a (``GraphState``, ``PlaneNodes``)
    pair."""
    poses, lms, odom, lme, planes, pedges = [], [], [], [], [], []
    pose_ids: dict[int, int] = {}
    lm_ids: dict[int, int] = {}
    plane_ids: dict[int, int] = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "VERTEX_SE3:QUAT":
                tx, ty, tz, qx, qy, qz, qw = map(float, tok[2:9])
                pose_ids[int(tok[1])] = len(poses)
                poses.append([tx, ty, tz, qw, qx, qy, qz])
            elif tag == "VERTEX_TRACKXYZ":
                lm_ids[int(tok[1])] = len(lms)
                lms.append([float(tok[2]), float(tok[3]), float(tok[4])])
            elif tag == "EDGE_SE3:QUAT":
                tx, ty, tz, qx, qy, qz, qw = map(float, tok[3:10])
                info = _sym_from_ut([float(v) for v in tok[10:31]], 6)
                odom.append((int(tok[1]), int(tok[2]), [tx, ty, tz, qw, qx, qy, qz], info))
            elif tag == "EDGE_SE3_TRACKXYZ":
                meas = [float(tok[4]), float(tok[5]), float(tok[6])]
                info = _sym_from_ut([float(v) for v in tok[7:13]], 3)
                lme.append((int(tok[1]), int(tok[2]), meas, info))
            elif tag == "VERTEX_PLANE":
                plane_ids[int(tok[1])] = len(planes)
                planes.append([float(t) for t in tok[2:6]])
            elif tag == "EDGE_SE3_PLANE":
                info = _sym_from_ut([float(v) for v in tok[7:13]], 3)
                pedges.append((int(tok[1]), int(tok[2]), [float(t) for t in tok[3:7]], info))

    K, L, E1, E2 = len(poses), len(lms), len(odom), len(lme)
    cap = gs.pow2_capacity
    g = gs.make_graph(cap(K), cap(max(L, 1)), cap(max(E1, 1)), cap(max(E2, 1)), dtype=dtype, device=device)

    def rows(dst, vals, dt=dtype):
        if not len(vals):
            return dst
        out = dst.clone()
        out[: len(vals)] = torch.as_tensor(np.asarray(vals), device=device).to(dt)
        return out

    def count(n):
        return torch.tensor(n, dtype=torch.int32, device=device)

    g = g.replace(
        poses=rows(g.poses, poses),
        num_poses=count(K),
        landmarks=rows(g.landmarks, lms),
        num_landmarks=count(L),
        odom_i=rows(g.odom_i, [pose_ids[e[0]] for e in odom], torch.int32),
        odom_j=rows(g.odom_j, [pose_ids[e[1]] for e in odom], torch.int32),
        odom_meas=rows(g.odom_meas, [e[2] for e in odom]),
        odom_info=rows(g.odom_info, [e[3] for e in odom]),
        num_odom=count(E1),
        lme_k=rows(g.lme_k, [pose_ids[e[0]] for e in lme], torch.int32),
        lme_l=rows(g.lme_l, [lm_ids[e[1]] for e in lme], torch.int32),
        lme_meas=rows(g.lme_meas, [e[2] for e in lme]),
        lme_info=rows(g.lme_info, [e[3] for e in lme]),
        num_lme=count(E2),
    )
    if not with_planes:
        return g
    P, E3 = len(planes), len(pedges)
    pn = gp.make_planes(cap(max(P, 1)), cap(max(E3, 1)), dtype=dtype, device=device)
    return g, pn.replace(
        planes=rows(pn.planes, planes),
        num_planes=count(P),
        pe_k=rows(pn.pe_k, [pose_ids[e[0]] for e in pedges], torch.int32),
        pe_p=rows(pn.pe_p, [plane_ids[e[1]] for e in pedges], torch.int32),
        pe_meas=rows(pn.pe_meas, [e[2] for e in pedges]),
        pe_info=rows(pn.pe_info, [e[3] for e in pedges]),
        num_pe=count(E3),
    )
