"""Minimal MATLAB MAT-file (v5) reader — dependency-free (stdlib zlib).

NumPy copy of ``rapidnet_tpu/io/matio.py``.

The reference's real problem data ships as a Level-5 MAT-file:
``src/paser/dataSource/dwn.mat``, written by MATLAB R2013 and consumed
by ``load('dwn')`` in the MATLAB preprocessing scripts
(src/paser/createDwnDataJson.m).  It contains

* ``S``  — the drinking-water network as a 1x1 struct
  (A, B, E, Ed, Gd, nd/nu/nx, umin/umax, xmin/xmax);
* ``P``  — controller parameters (Hp/Hu horizons, safety level xs,
  production cost alpha1, a FULL YEAR of hourly electricity prices
  alpha2 (8760, nu), smoothing/level weights Wu/Wx);
* ``DemandData`` — a full year of measured hourly demands (8760, nd).

This module reads exactly that subset of the MAT-v5 format: numeric
matrices (all integer/float storage types), 1x1 structs, character
arrays, and zlib-compressed (miCOMPRESSED) elements.  Cell arrays,
sparse matrices, objects and v7.3/HDF5 files are out of scope.

Format reference: "MAT-File Format" (MathWorks public spec): 128-byte
header; a sequence of [uint32 type, uint32 bytes, payload] data
elements (with the 4-byte "small data element" packing); miMATRIX
elements hold array-flags / dimensions / name / data subelements;
struct arrays add a field-name-length + field-names preamble and one
miMATRIX per field per element.  All arrays are column-major.

Public API:
    read_mat(path) -> {name: ndarray | dict | str}
    load_dwn_network(path) -> DwnNetwork       (from the S/P structs)
    load_dwn_forecaster(path, N) -> ArrayForecaster  (real year series)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# MAT-v5 storage data types
_MI_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 9: np.float64,
    12: np.int64, 13: np.uint64,
}
_MI_UTF8 = 16
_MI_MATRIX = 14
_MI_COMPRESSED = 15

# mxCLASS ids (array-flags subelement)
_MX_CELL = 1
_MX_STRUCT = 2
_MX_OBJECT = 3
_MX_CHAR = 4
_MX_SPARSE = 5
_MX_NUMERIC = {6, 7, 8, 9, 10, 11, 12, 13, 14, 15}


def _elements(buf: bytes, endian: str):
    """Iterate (mi_type, payload) data elements of a buffer."""
    pos, n = 0, len(buf)
    while pos + 8 <= n:
        mi_type, nbytes = struct.unpack_from(endian + "II", buf, pos)
        if mi_type & 0xFFFF0000:        # small data element: 4B payload
            nbytes = mi_type >> 16
            mi_type &= 0xFFFF
            yield mi_type, buf[pos + 4:pos + 4 + nbytes]
            pos += 8
        else:
            yield mi_type, buf[pos + 8:pos + 8 + nbytes]
            # payloads are padded to 8-byte boundaries — except
            # miCOMPRESSED elements, which the spec exempts
            if mi_type == _MI_COMPRESSED:
                pos += 8 + nbytes
            else:
                pos += 8 + ((nbytes + 7) & ~7)


def _numeric(mi_type: int, payload: bytes, endian: str) -> np.ndarray:
    dt = np.dtype(_MI_DTYPES[mi_type]).newbyteorder(endian)
    return np.frombuffer(payload, dtype=dt)


def _parse_matrix(payload: bytes, endian: str):
    """Parse one miMATRIX payload -> ndarray | dict (struct) | str."""
    elems = _elements(payload, endian)
    _, flags_raw = next(elems)                      # array flags
    flags = _numeric(6, flags_raw, endian)
    mx_class = int(flags[0]) & 0xFF
    _, dims_raw = next(elems)                       # dimensions
    dims = _numeric(5, dims_raw, endian).tolist()
    next(elems)                                     # array name (unused)

    if mx_class == _MX_STRUCT:
        _, fl_raw = next(elems)                     # field name length
        field_len = int(_numeric(5, fl_raw, endian)[0])
        _, names_raw = next(elems)                  # field names
        n_fields = len(names_raw) // field_len
        names = [names_raw[i * field_len:(i + 1) * field_len]
                 .split(b"\0", 1)[0].decode("latin-1")
                 for i in range(n_fields)]
        n_elem = int(np.prod(dims)) if dims else 1
        values = []
        for _ in range(n_elem * n_fields):
            mi_type, sub = next(elems)
            if mi_type != _MI_MATRIX:
                raise ValueError(f"struct field is mi type {mi_type}, "
                                 "expected miMATRIX")
            values.append(_parse_matrix(sub, endian))
        if n_elem != 1:
            raise ValueError("only 1x1 struct arrays are supported "
                             f"(got dims {dims})")
        return dict(zip(names, values))

    if mx_class == _MX_CHAR:
        mi_type, data = next(elems)
        if mi_type == _MI_UTF8:
            return data.decode("utf-8")
        chars = _numeric(mi_type, data, endian).astype(np.uint32)
        return "".join(map(chr, chars.tolist()))

    if mx_class in (_MX_CELL, _MX_SPARSE, _MX_OBJECT):
        raise ValueError(f"unsupported mxCLASS {mx_class} "
                         "(cell/sparse/object)")

    # numeric array: real part (imaginary parts are out of scope)
    mi_type, data = next(elems)
    real = _numeric(mi_type, data, endian).astype(np.float64)
    return real.reshape(dims[::-1]).T if len(dims) > 1 else real


def read_mat(path) -> dict:
    """Read a Level-5 MAT-file into {variable name: value}.

    Values are float64 ndarrays (column-major dims preserved), dicts
    for 1x1 structs (recursively), or strings for char arrays.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"\x00\x01\x00\x00":
        raise ValueError("MAT-v4 files are not supported (MAT-v5 only)")
    if len(data) < 128:
        raise ValueError("file too short for a MAT-v5 header")
    magic = data[126:128]
    if magic == b"IM":
        endian = "<"
    elif magic == b"MI":
        endian = ">"
    else:
        raise ValueError(f"not a MAT-v5 file (endian tag {magic!r}; "
                         "v7.3/HDF5 files are not supported)")
    version = struct.unpack_from(endian + "H", data, 124)[0]
    if version != 0x0100:
        raise ValueError(f"unsupported MAT version 0x{version:04x}")

    out = {}
    for mi_type, payload in _elements(data[128:], endian):
        if mi_type == _MI_COMPRESSED:
            inner = zlib.decompress(payload)
            sub = list(_elements(inner, endian))
            if not sub:
                continue
            mi_type, payload = sub[0]
        if mi_type != _MI_MATRIX:
            continue                     # skip non-array top-level data
        name, value = _parse_matrix_named(payload, endian)
        out[name] = value
    return out


def _parse_matrix_named(payload: bytes, endian: str):
    """Name + value of a top-level miMATRIX element."""
    elems = _elements(payload, endian)
    next(elems)                                     # flags
    next(elems)                                     # dims
    _, name_raw = next(elems)
    name = name_raw.split(b"\0", 1)[0].decode("latin-1")
    return name, _parse_matrix(payload, endian)


# ---------------------------------------------------------------------------
# dwn.mat ingestion (the reference's real problem data)

def load_dwn_network(path):
    """Build a DwnNetwork from dwn.mat's S/P structs.

    Matches the MATLAB assembly in createDwnDataJson.m (commented-out
    DWNnetwork block + generateJsonFile): topology/bounds from S,
    safety level xs and production cost alpha1 from P.
    """
    from rapidnet_tpu_torch.model.network import DwnNetwork

    m = read_mat(path)
    S, P = m["S"], m["P"]
    nx = int(S["nx"].ravel()[0])
    nu = int(S["nu"].ravel()[0])
    nd = int(S["nd"].ravel()[0])
    ne = int(S["E"].shape[0])
    f32 = np.float32
    net = DwnNetwork(
        nx=nx, nu=nu, nd=nd, ne=ne,
        matA=np.asarray(S["A"], f32),
        matB=np.asarray(S["B"], f32),
        matGd=np.asarray(S["Gd"], f32),
        matE=np.asarray(S["E"], f32),
        matEd=np.asarray(S["Ed"], f32),
        xmin=np.asarray(S["xmin"], f32).ravel(),
        xmax=np.asarray(S["xmax"], f32).ravel(),
        xsafe=np.asarray(P["xs"], f32).ravel(),
        umin=np.asarray(S["umin"], f32).ravel(),
        umax=np.asarray(S["umax"], f32).ravel(),
        alpha1=np.asarray(P["alpha1"], f32).ravel(),
    )
    net.validate()
    return net


def load_dwn_forecaster(path, N: int, start: int = 0,
                        hours: int | None = None):
    """ArrayForecaster over dwn.mat's REAL year of hourly data.

    demand from ``DemandData`` (8760, nd); prices from ``P.alpha2``
    (8760, nu) — time-varying electricity tariffs.  ``start``/``hours``
    select a window of the year (default: all of it).
    """
    from rapidnet_tpu_torch.model.forecaster import ArrayForecaster

    m = read_mat(path)
    demand = np.asarray(m["DemandData"], np.float64)
    prices = np.asarray(m["P"]["alpha2"], np.float64)
    stop = demand.shape[0] if hours is None else start + hours
    return ArrayForecaster(demand[start:stop].astype(np.float32),
                           prices[start:stop].astype(np.float32), N)
