"""Minimal binary-little-endian PLY reader/writer.

A copy of `scgaussian_tpu/data/ply.py` (numpy only): the subset of the
`plyfile` format the reference's point-cloud and model persistence use
(`scene/dataset_readers.py:119-142`, `scene/gaussian_model.py:565-756`):
one 'vertex' element of scalar properties, binary little-endian or ascii.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "int8": np.int8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
}
_INV_TYPES = {np.dtype(np.float32): "float", np.dtype(np.uint8): "uchar",
              np.dtype(np.float64): "double", np.dtype(np.int32): "int"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element -> {property_name: [N] array}."""
    with open(path, "rb") as f:
        header: List[str] = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        count = 0
        props: List[Tuple[str, np.dtype]] = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties not supported")
                props.append((parts[2], np.dtype(_PLY_TYPES[parts[1]])))

        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, dt) for name, dt in props])
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
            return {name: np.ascontiguousarray(data[name]) for name, _ in props}
        elif fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            return {name: rows[:, i].astype(dt) for i, (name, dt) in enumerate(props)}
        raise ValueError(f"unsupported PLY format {fmt}")


def write_ply(path: str, props: Dict[str, np.ndarray]) -> None:
    """Write a single 'vertex' element, binary little-endian."""
    names = list(props.keys())
    n = len(next(iter(props.values())))
    arrays = {k: np.asarray(v).reshape(n) for k, v in props.items()}
    dtype = np.dtype([(k, arrays[k].dtype) for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = arrays[k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode("ascii"))
        for k in names:
            f.write(f"property {_INV_TYPES[arrays[k].dtype]} {k}\n".encode("ascii"))
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """storePly equivalent (`scene/dataset_readers.py:127-142`): xyz + zero
    normals + uint8 rgb."""
    normals = np.zeros_like(xyz)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "nx": normals[:, 0].astype(np.float32),
            "ny": normals[:, 1].astype(np.float32),
            "nz": normals[:, 2].astype(np.float32),
            "red": np.clip(rgb[:, 0], 0, 255).astype(np.uint8),
            "green": np.clip(rgb[:, 1], 0, 255).astype(np.uint8),
            "blue": np.clip(rgb[:, 2], 0, 255).astype(np.uint8),
        },
    )


def fetch_point_cloud(path: str):
    """fetchPly equivalent (`scene/dataset_readers.py:119-125`)."""
    v = read_ply(path)
    points = np.stack([v["x"], v["y"], v["z"]], axis=1)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    normals = np.stack([v.get("nx", np.zeros(len(points))),
                        v.get("ny", np.zeros(len(points))),
                        v.get("nz", np.zeros(len(points)))], axis=1)
    return points, colors, normals
