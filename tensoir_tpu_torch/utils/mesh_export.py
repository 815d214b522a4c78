"""Mesh export: dense alpha grid -> triangle mesh -> binary PLY (the port's
own copy of tensoir_tpu.utils.mesh_export).

The iso-surface is extracted on the host by the port's marching-tetrahedra
library (``csrc/mesh_extract.cpp``, built with g++ at first use by
``kernels/build.py``). A build or extraction failure raises: unlike the
JAX package, the export never falls back to the numpy extractor, which is
the plain version the tests hold the library against.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np


def extract_mesh(alpha_grid: np.ndarray, bbox, level: float = 0.005
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulate the ``alpha > level`` iso-surface of an [nx, ny, nz]
    grid spanning the world box ``bbox`` [2, 3] (spacing size / shape,
    origin bbox[0]). Returns (verts [V, 3] float32 world coordinates,
    faces [F, 3] int32, wound as the reference winds them: reversed)."""
    alpha_grid = np.ascontiguousarray(alpha_grid, np.float32)
    bbox = np.asarray(bbox, np.float32).reshape(2, 3)
    spacing = ((bbox[1] - bbox[0]) /
               np.array(alpha_grid.shape, np.float32)).astype(np.float32)
    verts, faces = _extract_native(alpha_grid, level, bbox[0], spacing)
    return verts, faces[:, ::-1].copy()


def _extract_native(grid, level, origin, spacing):
    """The host library's marching tetrahedra (faces not yet reversed)."""
    from tensoir_tpu_torch.kernels import build
    extract, free = build.kernel("mesh_extract"), build.kernel("mesh_free")
    c = ctypes
    grid = np.ascontiguousarray(grid, np.float32)
    origin = np.ascontiguousarray(origin, np.float32)
    spacing = np.ascontiguousarray(spacing, np.float32)
    out_v, out_f = c.POINTER(c.c_float)(), c.POINTER(c.c_int32)()
    nv, nf = c.c_int64(), c.c_int64()
    rc = extract(grid.ctypes.data, *grid.shape, c.c_float(level),
                 origin.ctypes.data, spacing.ctypes.data, c.byref(out_v),
                 c.byref(nv), c.byref(out_f), c.byref(nf))
    if rc != 0:
        raise RuntimeError(f"mesh_extract failed ({rc})")
    try:
        verts = (np.ctypeslib.as_array(out_v, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(out_f, shape=(nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int32))
    finally:
        free(c.cast(out_v, c.c_void_p))
        free(c.cast(out_f, c.c_void_p))
    return verts, faces


def _extract_numpy(grid, level, origin, spacing):
    """The plain version: the same marching tetrahedra in numpy and Python,
    over the cells with a sign change only (faces not yet reversed)."""
    tets = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
            (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
    corners = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]
    nx, ny, nz = grid.shape
    inside = grid > level
    any_in = np.zeros((nx - 1, ny - 1, nz - 1), bool)
    all_in = np.ones_like(any_in)
    for dx, dy, dz in corners:
        sub = inside[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        any_in |= sub
        all_in &= sub
    cells = np.argwhere(any_in & ~all_in)

    verts = []
    faces = []
    vert_cache = {}

    def edge_vertex(pa, pb):
        key = (pa, pb) if pa <= pb else (pb, pa)
        if key in vert_cache:
            return vert_cache[key]
        va, vb = grid[pa], grid[pb]
        t = 0.5 if vb == va else np.clip((level - va) / (vb - va), 0, 1)
        p = (np.asarray(pa, np.float64)
             + t * (np.asarray(pb, np.float64) - np.asarray(pa, np.float64)))
        idx = len(verts)
        verts.append(origin + spacing * p)
        vert_cache[key] = idx
        return idx

    # inside-mask of a tet's four corners -> its triangles, each as three
    # edges (corner pairs), wound as the host library winds them
    tri_table = {
        1: [(0, 1, 0, 2, 0, 3)], 14: [(0, 2, 0, 1, 0, 3)],
        2: [(1, 0, 1, 3, 1, 2)], 13: [(1, 3, 1, 0, 1, 2)],
        4: [(2, 0, 2, 1, 2, 3)], 11: [(2, 1, 2, 0, 2, 3)],
        8: [(3, 0, 3, 2, 3, 1)], 7: [(3, 2, 3, 0, 3, 1)],
        3: [(0, 2, 0, 3, 1, 3), (0, 2, 1, 3, 1, 2)],
        12: [(0, 3, 0, 2, 1, 3), (1, 3, 0, 2, 1, 2)],
        5: [(0, 1, 2, 1, 0, 3), (2, 1, 2, 3, 0, 3)],
        10: [(2, 1, 0, 1, 0, 3), (2, 3, 2, 1, 0, 3)],
        6: [(1, 0, 2, 0, 1, 3), (2, 0, 2, 3, 1, 3)],
        9: [(2, 0, 1, 0, 1, 3), (2, 3, 2, 0, 1, 3)],
    }

    for x, y, z in cells:
        cpts = [(x + dx, y + dy, z + dz) for dx, dy, dz in corners]
        for tet in tets:
            mask = 0
            for i in range(4):
                if grid[cpts[tet[i]]] > level:
                    mask |= 1 << i
            if mask == 0 or mask == 15:
                continue
            for (a0, a1, b0, b1, c0, c1) in tri_table[mask]:
                ia = edge_vertex(cpts[tet[a0]], cpts[tet[a1]])
                ib = edge_vertex(cpts[tet[b0]], cpts[tet[b1]])
                ic = edge_vertex(cpts[tet[c0]], cpts[tet[c1]])
                if ia != ib and ib != ic and ia != ic:
                    faces.append((ia, ib, ic))

    verts = (np.asarray(verts, np.float32) if verts
             else np.zeros((0, 3), np.float32))
    faces = (np.asarray(faces, np.int32) if faces
             else np.zeros((0, 3), np.int32))
    return verts, faces


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY: float x, y, z per vertex, a uchar count
    and three int indices per face."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    face_rec = np.empty(
        len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(verts.astype("<f4").tobytes())
        fh.write(face_rec.tobytes())


def export_mesh_from_alpha(alpha_grid, bbox, path: str, level: float = 0.005):
    """Extract the ``alpha > level`` surface and write it to ``path``;
    returns (verts, faces)."""
    verts, faces = extract_mesh(np.asarray(alpha_grid), bbox, level)
    write_ply(path, verts, faces)
    return verts, faces
