"""Problem files for the port's tests, written without JAX: the
writer test's problem from either package's generators, MAT-v5 bytes
(a dwn.mat-shaped file) and a dataSource directory.  Shared by
tests/test_torch_io.py and tests/test_torch_examples.py.
"""

import struct
import zlib

import numpy as np

# the JAX package's writer test sizes (tests/test_writers.py:16-19)
NX, NU, ND, NE, N = 5, 8, 3, 2, 8
BRANCHING = [2, 2]
SIM_HORIZON = 4
SEED = 1


def _problem(pkg, algorithm=None, max_iterations=50):
    """The writer test's problem from either package's generators."""
    import importlib
    m = {k: importlib.import_module(f"{pkg}.model.{k}")
         for k in ("network", "scenario_tree", "forecaster", "config")}
    net = m["network"].synthetic_network(nx=NX, nu=NU, nd=ND, ne=NE,
                                         seed=SEED)
    tree = m["scenario_tree"].generate_tree(N=N, branching=BRANCHING, nd=ND,
                                            nu=NU, seed=SEED)
    fc = m["forecaster"].synthetic_forecaster(N=N, nd=ND, nu=NU,
                                              sim_horizon=SIM_HORIZON,
                                              seed=SEED)
    cfg = m["config"].synthetic_config(net, tree,
                                       max_iterations=max_iterations,
                                       step_size=1e-3)
    if algorithm is not None:
        cfg.algorithm = algorithm
    nullspace = importlib.import_module(f"{pkg}.engine.nullspace")
    L, Lhat = nullspace.nullspace_elimination(net.matE, net.matEd)
    return net, tree, fc, cfg, L, Lhat


# -- MAT-v5 -----------------------------------------------------------
# The helpers of tests/test_matio.py:96-107, extended to a 1x1 struct
# and a char array.

def _tag(mi_type, payload):
    pad = (-len(payload)) % 8
    return struct.pack("<II", mi_type, len(payload)) + payload + b"\0" * pad


def _header():
    return (b"MATLAB 5.0 MAT-file, test".ljust(124) +
            struct.pack("<H", 0x0100) + b"IM")


def _matrix_bytes(name, arr):
    arr = np.asarray(arr, np.float64)
    if arr.ndim < 2:
        arr = arr.reshape(1, -1)
    flags = _tag(6, struct.pack("<II", 6, 0))                 # mxDOUBLE
    dims = _tag(5, struct.pack("<ii", *arr.shape))
    nm = _tag(1, name.encode())
    data = _tag(9, arr.T.tobytes())                           # col-major
    return _tag(14, flags + dims + nm + data)


def _char_bytes(name, text):
    flags = _tag(6, struct.pack("<II", 4, 0))                 # mxCHAR
    dims = _tag(5, struct.pack("<ii", 1, len(text)))
    nm = _tag(1, name.encode())
    data = _tag(4, np.frombuffer(text.encode("utf-16-le"),
                                 np.uint16).tobytes())        # miUINT16
    return _tag(14, flags + dims + nm + data)


def _struct_bytes(name, fields):
    """A 1x1 struct; ``fields`` maps a name to an array, a string or a
    dict (a nested struct)."""
    flags = _tag(6, struct.pack("<II", 2, 0))                 # mxSTRUCT
    dims = _tag(5, struct.pack("<ii", 1, 1))
    nm = _tag(1, name.encode())
    width = 32
    lens = _tag(5, struct.pack("<i", width))
    names = _tag(1, b"".join(k.encode().ljust(width, b"\0")
                             for k in fields))
    body = b"".join(_char_bytes("", v) if isinstance(v, str)
                    else _struct_bytes("", v) if isinstance(v, dict)
                    else _matrix_bytes("", v) for v in fields.values())
    return _tag(14, flags + dims + nm + lens + names + body)


def _compressed(element):
    z = zlib.compress(element)
    return struct.pack("<II", 15, len(z)) + z


def _dwn_mat(path, hours=30):
    """A file shaped like the reference's dwn.mat: the network struct S,
    the parameter struct P (a year's prices cut to ``hours``) and
    DemandData, the structs compressed as MATLAB writes them."""
    from rapidnet_tpu_torch.model.network import synthetic_network

    net = synthetic_network(nx=4, nu=6, nd=3, ne=2, seed=2)
    rng = np.random.default_rng(2)
    S = {"A": net.matA, "B": net.matB, "E": net.matE, "Ed": net.matEd,
         "Gd": net.matGd, "nd": [[3.0]], "nu": [[6.0]], "nx": [[4.0]],
         "umin": net.umin[:, None], "umax": net.umax[:, None],
         "xmin": net.xmin[:, None], "xmax": net.xmax[:, None]}
    P = {"Hp": [[24.0]], "xs": net.xsafe[:, None],
         "alpha1": net.alpha1[None, :],
         "alpha2": rng.uniform(0.02, 0.2, (hours, 6)),
         "name": "dwn"}
    demand = rng.uniform(0.0, 0.01, (hours, 3))
    path.write_bytes(_header() + _compressed(_struct_bytes("S", S)) +
                     _compressed(_struct_bytes("P", P)) +
                     _compressed(_matrix_bytes("DemandData", demand)))


def _data_source(tmp_path):
    """A dataSource directory from the port's writers: the config with
    costAlpha1/costAlpha2 added as controllerConfig32.json, the tree as
    scenarioTree32.json."""
    from rapidnet_tpu_torch.io import jsonio
    from rapidnet_tpu_torch.io.writers import config_to_json, tree_to_json

    net, tree, _, cfg, L, Lhat = _problem("rapidnet_tpu_torch")
    ds = tmp_path / "dataSource"
    ds.mkdir()
    path = ds / "controllerConfig32.json"
    config_to_json(cfg, str(path), mat_l=L, mat_lhat=Lhat)
    doc = jsonio.load_json(path)
    rng = np.random.default_rng(8)
    doc["costAlpha1"] = net.alpha1
    doc["costAlpha2"] = rng.uniform(0.02, 0.2, N * NU).astype(np.float32)
    jsonio.dump_json(path, doc)
    tree_to_json(tree, str(ds / "scenarioTree32.json"))
    return ds
