"""Quadric-error-metric mesh decimation (Garland-Heckbert, endpoint folds).

The port's copy of the JAX package's ``tools/_qem_decimate.py``, used by
``make_lite_mesh``. Pure numpy + heapq; the welded hand mesh is ~1.7k
vertices, so a Python event loop takes well under a second. Collapses fold
one endpoint into the other (no optimal-point solve), so kept vertices keep
their exact positions AND skinning weights: LBS stays exact for every
surviving vertex. The same inputs give the same faces as the JAX tool's,
bit for bit (``tests/test_torch_inspect_tools.py``).
"""
from __future__ import annotations

import heapq

import numpy as np


def qem_decimate(
    vertices: np.ndarray,
    faces: np.ndarray,
    weights: np.ndarray,
    target_faces: int,
    max_normal_deg: float = 60.0,
    weight_l1_max: float = 0.6,
    boundary_penalty: float = 1e3,
):
    """Collapse edges lowest-quadric-error-first until ``target_faces`` remain.

    vertices: (V, >=3) rest positions; faces: (F, 3) int; weights: (J, V).
    Returns (faces', used_vertex_ids).

    Guards per candidate collapse (v folded into u):
      - normal flip: no surviving face incident to v may rotate > max_normal_deg;
      - skinning: |w_u - w_v|_1 <= weight_l1_max (never drag across a joint);
      - boundary edges (single-face) add a large planar quadric along the edge
        so open rims (wrist) resist erosion.
    """
    pos = np.asarray(vertices[:, :3], np.float64)
    faces = np.asarray(faces, np.int64).copy()
    w = np.asarray(weights, np.float64)
    nv = pos.shape[0]
    cos_max = np.cos(np.deg2rad(max_normal_deg))

    # --- per-vertex quadrics from incident face planes (area-weighted) ---
    a, b, c = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    n = np.cross(b - a, c - a)
    area2 = np.linalg.norm(n, axis=1)  # 2*area
    n_unit = n / np.maximum(area2, 1e-12)[:, None]
    d = -(n_unit * a).sum(1)
    plane = np.concatenate([n_unit, d[:, None]], axis=1)  # (F, 4)
    K = plane[:, :, None] * plane[:, None, :] * area2[:, None, None]  # (F,4,4)

    Q = np.zeros((nv, 4, 4))
    for k in range(3):
        np.add.at(Q, faces[:, k], K)

    # --- boundary quadrics: perpendicular-plane constraint per rim edge ---
    e_all = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e_key = np.sort(e_all, axis=1)
    uniq_e, cnt = np.unique(e_key, axis=0, return_counts=True)
    rim = uniq_e[cnt == 1]
    if rim.size:
        # find the face owning each rim edge for its normal
        owner_n = np.zeros((len(rim), 3))
        lut = {tuple(ek): i for i, ek in enumerate(map(tuple, rim))}
        for fi, tri in enumerate(faces):
            for k in range(3):
                ek = tuple(sorted((tri[k], tri[(k + 1) % 3])))
                j = lut.get(ek)
                if j is not None:
                    owner_n[j] = n_unit[fi]
        ev = pos[rim[:, 1]] - pos[rim[:, 0]]
        pn = np.cross(ev, owner_n)
        pn /= np.maximum(np.linalg.norm(pn, axis=1), 1e-12)[:, None]
        pd = -(pn * pos[rim[:, 0]]).sum(1)
        bplane = np.concatenate([pn, pd[:, None]], axis=1)
        BK = bplane[:, :, None] * bplane[:, None, :] * boundary_penalty
        np.add.at(Q, rim[:, 0], BK)
        np.add.at(Q, rim[:, 1], BK)

    # --- adjacency: vertex -> set of face ids ---
    vf = [set() for _ in range(nv)]
    for fi, tri in enumerate(faces):
        for vid in tri:
            vf[int(vid)].add(fi)

    def cost(u, v):
        """Cost of folding v into u (u keeps its position)."""
        h = np.append(pos[u], 1.0)
        return float(h @ (Q[u] + Q[v]) @ h)

    heap = []
    version = np.zeros(nv, np.int64)  # bumped on every change touching a vertex

    def push(u, v):
        if np.abs(w[:, u] - w[:, v]).sum() > weight_l1_max:
            return
        for tgt, src in ((u, v), (v, u)):  # try both fold directions
            heapq.heappush(
                heap, (cost(tgt, src), int(version[u] + version[v]), tgt, src)
            )

    seen = set()
    for tri in faces:
        for k in range(3):
            p, q = int(tri[k]), int(tri[(k + 1) % 3])
            ek = (min(p, q), max(p, q))
            if ek not in seen:
                seen.add(ek)
                push(*ek)

    num_live = faces.shape[0]
    live = np.ones(faces.shape[0], bool)

    while num_live > target_faces and heap:
        _, ver, u, v = heapq.heappop(heap)
        if version[u] + version[v] != ver:
            continue  # stale entry
        if not vf[v] or not vf[u]:
            continue
        shared = vf[u] & vf[v]
        if not shared:
            continue  # no longer an edge
        # normal-flip / degeneracy guard over v's surviving faces
        changed = vf[v] - shared
        ok = True
        for fi in changed:
            tri = faces[fi]
            old = pos[tri]
            n_old = np.cross(old[1] - old[0], old[2] - old[0])
            newtri = np.where(tri == v, u, tri)
            if newtri[0] == newtri[1] or newtri[1] == newtri[2] or newtri[0] == newtri[2]:
                ok = False
                break
            new = pos[newtri]
            n_new = np.cross(new[1] - new[0], new[2] - new[0])
            nn = np.linalg.norm(n_new)
            no = np.linalg.norm(n_old)
            if nn < 1e-9 or no < 1e-9 or (n_old @ n_new) < cos_max * no * nn:
                ok = False
                break
        if not ok:
            continue
        # commit: remap v->u, kill shared faces
        for fi in shared:
            for vid in faces[fi]:
                vf[int(vid)].discard(fi)
            if live[fi]:
                live[fi] = False
                num_live -= 1
        for fi in list(vf[v]):
            faces[fi] = np.where(faces[fi] == v, u, faces[fi])
            vf[u].add(fi)
            vf[v].discard(fi)
        Q[u] = Q[u] + Q[v]
        version[u] += 1
        version[v] += 1
        # re-push u's incident edges
        nbrs = set()
        for fi in vf[u]:
            for vid in faces[fi]:
                if vid != u:
                    nbrs.add(int(vid))
        for q_ in nbrs:
            push(min(u, q_), max(u, q_))

    f = faces[live]
    # drop duplicate faces (same vertex set) that collapses can create
    key = np.sort(f, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    f = f[np.sort(first)]
    used = np.unique(f)
    return f.astype(np.int64), used
