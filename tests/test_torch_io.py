"""The port's problem files against the JAX package's: the writers, the
readers (JSON, EPANET, MAT-v5, legacy .xls, the Barcelona data source),
the tree helpers and the CLI on files the port wrote.

Both packages run the same NumPy code on the same inputs, so files are
byte-equal and arrays equal (``assert_array_equal``); float32 arrays
survive JSON exactly (each float32 is a double that ``repr`` round-trips).
The CLIs' controls agree within the APG tolerance rtol/atol 1e-5
(tests/test_pallas_apg.py:45-51): two float32 solves of one problem.
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._torch_files import (N, SIM_HORIZON, _char_bytes, _compressed,
                                 _data_source, _dwn_mat, _header,
                                 _matrix_bytes, _problem, _struct_bytes)

torch.set_num_threads(2)

WRITERS = ("network", "tree", "forecaster", "config", "export")


def _write(pkg, what, directory):
    """Write one file (or, for 'export', the 4-file set) with ``pkg``'s
    writers into ``directory``; returns {name: bytes}."""
    import importlib
    w = importlib.import_module(f"{pkg}.io.writers")
    net, tree, fc, cfg, L, Lhat = _problem(pkg)
    directory.mkdir(exist_ok=True)
    if what == "export":
        paths = w.export_problem(net, tree, fc, cfg, str(directory),
                                 mat_l=L, mat_lhat=Lhat)
    else:
        path = str(directory / f"{what}.json")
        paths = {what: path}
        if what == "network":
            net.to_json(path)
        elif what == "tree":
            w.tree_to_json(tree, path)
        elif what == "forecaster":
            w.forecaster_to_json(fc, path)
        else:
            w.config_to_json(cfg, path, mat_l=L, mat_lhat=Lhat)
    return {k: Path(p).read_bytes() for k, p in paths.items()}


@pytest.mark.parametrize("what", WRITERS)
def test_writers_byte_equal_to_jax(what, tmp_path):
    """Each writer, and ``DwnNetwork.to_json``, on the port's objects and
    on the JAX package's from the same seeds: the same bytes.  Both write
    into the same directory in turn, so the config's paths agree too."""
    ref = _write("rapidnet_tpu", what, tmp_path / "p")
    got = _write("rapidnet_tpu_torch", what, tmp_path / "p")
    assert set(got) == set(ref)
    for k in ref:
        assert len(ref[k]) > 100, k
        assert got[k] == ref[k], k


def test_export_problem_round_trip(tmp_path):
    """``export_problem`` read back through the port's readers: every
    array exact."""
    from rapidnet_tpu_torch import DwnNetwork, ScenarioTree, SmpcConfig
    from rapidnet_tpu_torch.io.writers import export_problem
    from rapidnet_tpu_torch.model.forecaster import JsonForecaster

    net, tree, fc, cfg, L, Lhat = _problem("rapidnet_tpu_torch")
    paths = export_problem(net, tree, fc, cfg, str(tmp_path), mat_l=L,
                           mat_lhat=Lhat)
    net2 = DwnNetwork.from_json(paths["network"])
    for k in ("matA", "matB", "matGd", "matE", "matEd", "xmin", "xmax",
              "xsafe", "umin", "umax", "alpha1"):
        np.testing.assert_array_equal(getattr(net2, k), getattr(net, k),
                                      err_msg=k)
    tree2 = ScenarioTree.from_json(paths["tree"])
    assert (tree2.N, tree2.ns, tree2.n_nodes) == (tree.N, tree.ns,
                                                  tree.n_nodes)
    for k in ("stage", "ancestor", "leaves", "n_children", "prob",
              "err_demand", "err_price", "node_of_slot", "rep"):
        np.testing.assert_array_equal(getattr(tree2, k), getattr(tree, k),
                                      err_msg=k)
    fc2 = JsonForecaster(paths["forecaster"])
    for t in range(SIM_HORIZON):
        assert fc.predict_demand(t) and fc2.predict_demand(t)
        assert fc.predict_prices(t) and fc2.predict_prices(t)
        np.testing.assert_array_equal(fc2.nominal_demand, fc.nominal_demand)
        np.testing.assert_array_equal(fc2.nominal_prices, fc.nominal_prices)
    assert not fc2.predict_demand(SIM_HORIZON)
    cfg2 = SmpcConfig.from_json(paths["config"])
    np.testing.assert_array_equal(cfg2.mat_l, L)
    np.testing.assert_array_equal(cfg2.mat_lhat, Lhat)
    for k in ("cost_w", "diag_precnd", "current_x", "prev_u",
              "prev_demand"):
        np.testing.assert_array_equal(getattr(cfg2, k), getattr(cfg, k),
                                      err_msg=k)
    for k in ("nx", "nu", "nd", "nv", "N", "step_size", "max_iterations",
              "penalty_state", "penalty_safety", "algorithm",
              "lbfgs_buffer_size"):
        assert getattr(cfg2, k) == getattr(cfg, k), k
    assert (cfg2.path_to_network, cfg2.path_to_scenario_tree,
            cfg2.path_to_forecaster) == (paths["network"], paths["tree"],
                                         paths["forecaster"])


def test_cli_on_port_files_matches_jax_cli(tmp_path, capsys):
    """The port's CLI (``--device cpu``) on a problem the port wrote,
    against the JAX CLI (``--platform cpu``, XLA path) on the problem the
    JAX package wrote from the same seeds."""
    from rapidnet_tpu import cli as jcli
    from rapidnet_tpu.io.writers import export_problem as jexport
    from rapidnet_tpu_torch import cli
    from rapidnet_tpu_torch.io.writers import export_problem

    logs = {}
    for pkg, export, run, extra in (
            ("rapidnet_tpu_torch", export_problem, cli.main,
             ["--device", "cpu"]),
            ("rapidnet_tpu", jexport, jcli.main,
             ["--platform", "cpu", "--backend", "xla"])):
        net, tree, fc, cfg, L, Lhat = _problem(pkg, max_iterations=40)
        paths = export(net, tree, fc, cfg, str(tmp_path / pkg), mat_l=L,
                       mat_lhat=Lhat)
        out = tmp_path / f"{pkg}.json"
        assert run(["--config", paths["config"], "--steps", "3",
                    "--output", str(out)] + extra) == 0
        printed = capsys.readouterr()
        assert printed.err.count("time lapsed") == 3
        assert "network utility kpi" in printed.out
        logs[pkg] = json.loads(out.read_text())
    got, ref = logs["rapidnet_tpu_torch"], logs["rapidnet_tpu"]
    assert set(got) == set(ref)
    for t in range(3):
        np.testing.assert_allclose(got[f"control{t}"], ref[f"control{t}"],
                                   rtol=1e-5, atol=1e-5)
    for k in ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


# -- tree helpers -----------------------------------------------------

@pytest.mark.parametrize("branching", [[2], [2, 2]], ids=["b2", "b2x2"])
def test_tree_helpers_match_jax(branching):
    """``scatter_from_fan``, ``first_slot_of_node`` and ``prob_fan``."""
    from rapidnet_tpu.model.scenario_tree import generate_tree as jgen
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    kw = dict(N=6, branching=branching, nd=3, nu=6, seed=4)
    jt, tt = jgen(**kw), generate_tree(**kw)
    rng = np.random.default_rng(4)
    fan = rng.standard_normal((tt.N, tt.ns, 3)).astype(np.float32)
    got = tt.scatter_from_fan(fan)
    np.testing.assert_array_equal(got, jt.scatter_from_fan(fan))
    assert got.shape == (tt.n_nodes, 3)
    # the representative slots' values come back whole
    np.testing.assert_array_equal(tt.gather_to_fan(got)[tt.rep > 0],
                                  fan[tt.rep > 0])
    np.testing.assert_array_equal(tt.first_slot_of_node(),
                                  jt.first_slot_of_node())
    np.testing.assert_array_equal(tt.prob_fan, jt.prob_fan)
    assert tt.prob_fan.shape == (tt.N, tt.ns)


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_tree_from_samples_matches_jax(seed):
    """The weighted k-means tree from sampled error paths: the same
    NumPy RNG and order of operations, so every array is equal."""
    from rapidnet_tpu.model.scenario_tree import \
        generate_tree_from_samples as jgen
    from rapidnet_tpu_torch.model.scenario_tree import \
        generate_tree_from_samples

    rng = np.random.default_rng(100 + seed)
    dem = rng.standard_normal((40, 6, 3)).astype(np.float32)
    pri = rng.standard_normal((40, 6, 5)).astype(np.float32)
    jt = jgen(dem, pri, [3, 2], seed=seed)
    tt = generate_tree_from_samples(dem, pri, [3, 2], seed=seed)
    assert (tt.N, tt.ns, tt.n_nodes) == (jt.N, jt.ns, jt.n_nodes)
    assert tt.ns > 1
    for k in ("stage", "ancestor", "leaves", "prob", "err_demand",
              "err_price", "node_of_slot", "rep"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k),
                                      err_msg=k)


# -- EPANET -----------------------------------------------------------

EPANET_INP = """\
[TITLE]
small network ; comment
[JUNCTIONS]
;ID  Elev  Demand
10   0     1.5
11   0     2.0
12   0     0.5
[RESERVOIRS]
1    100
[TANKS]
;ID  Elev  Init  Min  Max  Diam
2    50    3     0.5  8    10
3    50    4     1.0  9    10
4    50    2     0.2  6    10
[PIPES]
;ID  N1  N2  Len
101  10  2   100
102  3   11  100
103  12  4   100
104  11  4   100
[PUMPS]
;ID  N1  N2  Params
201  3   2   HEAD 1
202  1   10  HEAD 1
203  12  3   HEAD 1
[VALVES]
;ID  N1  N2  Diam  Type
301  4   12  10    PRV
302  11  10  10    TCV
[END]
"""


def test_parse_epanet_matches_jax(tmp_path):
    """Junctions, tanks, pipes, pumps and valves (one valve between a
    tank and a junction, one between two junctions): equal networks."""
    from rapidnet_tpu.io.epanet import parse_epanet as jparse
    from rapidnet_tpu_torch.io.epanet import parse_epanet

    p = tmp_path / "net.inp"
    p.write_text(EPANET_INP)
    got, ref = parse_epanet(str(p)), jparse(str(p))
    assert (got.nx, got.nu, got.nd, got.ne) == (3, 5, 3, 3)
    assert (got.nx, got.nu, got.nd, got.ne) == (ref.nx, ref.nu, ref.nd,
                                                ref.ne)
    for k in ("matA", "matB", "matGd", "matE", "matEd", "xmin", "xmax",
              "xsafe", "umin", "umax", "alpha1"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    # valve 301 (column 3): +1 at its Node1, tank '4'
    assert got.matB[2, 3] == 1.0
    got.validate()


# -- MAT-v5 (the byte helpers are in tests/_torch_files.py) -----------

def _assert_mat_equal(got, ref):
    assert type(got) is type(ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            _assert_mat_equal(got[k], ref[k])
    elif isinstance(ref, str):
        assert got == ref
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_read_mat_matches_jax(tmp_path):
    """Plain and miCOMPRESSED elements: numeric arrays, a 1x1 struct
    holding a char array and a nested struct, and a char array: equal
    dicts, and the values written."""
    from rapidnet_tpu.io.matio import read_mat as jread
    from rapidnet_tpu_torch.io.matio import read_mat

    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3))
    k = rng.standard_normal((3, 4))
    s = {"k": k, "label": "pumps", "inner": {"v": np.arange(5.0)}}
    p = tmp_path / "t.mat"
    p.write_bytes(_header() + _matrix_bytes("a", a) +
                  _compressed(_matrix_bytes("b", [[7.0]])) +
                  _struct_bytes("s", s) +
                  _compressed(_struct_bytes("z", {"w": [[1.0, 2.0]]})) +
                  _compressed(_char_bytes("title", "dwn test")))
    got, ref = read_mat(p), jread(p)
    _assert_mat_equal(got, ref)
    assert list(got) == ["a", "b", "s", "z", "title"]
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], [[7.0]])
    np.testing.assert_array_equal(got["s"]["k"], k)
    np.testing.assert_array_equal(got["s"]["inner"]["v"],
                                  np.arange(5.0)[None, :])
    np.testing.assert_array_equal(got["z"]["w"], [[1.0, 2.0]])
    assert got["s"]["label"] == "pumps" and got["title"] == "dwn test"


def test_read_mat_rejects_non_mat_like_jax(tmp_path):
    from rapidnet_tpu.io.matio import read_mat as jread
    from rapidnet_tpu_torch.io.matio import read_mat

    for i, raw in enumerate((b"\x89HDF\r\n" + b"\0" * 200, b"short",
                             b"\x00\x01\x00\x00" + b"\0" * 200)):
        p = tmp_path / f"x{i}.mat"
        p.write_bytes(raw)
        for fn in (read_mat, jread):
            with pytest.raises(ValueError):
                fn(p)


def test_dwn_mat_loaders_match_jax(tmp_path):
    """``load_dwn_network`` and ``load_dwn_forecaster`` on a dwn.mat-shaped
    file: equal networks and forecasts."""
    from rapidnet_tpu.io import matio as jmatio
    from rapidnet_tpu_torch.io import matio

    p = tmp_path / "dwn.mat"
    _dwn_mat(p)
    got, ref = matio.load_dwn_network(p), jmatio.load_dwn_network(p)
    assert (got.nx, got.nu, got.nd, got.ne) == (4, 6, 3, 2)
    for k in ("matA", "matB", "matGd", "matE", "matEd", "xmin", "xmax",
              "xsafe", "umin", "umax", "alpha1"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    fg = matio.load_dwn_forecaster(p, N=6, start=2, hours=12)
    fr = jmatio.load_dwn_forecaster(p, N=6, start=2, hours=12)
    assert fg.sim_horizon == fr.sim_horizon == 6
    for t in range(fg.sim_horizon + 1):
        assert fg.predict_demand(t) and fr.predict_demand(t)
        assert fg.predict_prices(t) and fr.predict_prices(t)
        np.testing.assert_array_equal(fg.nominal_demand, fr.nominal_demand)
        np.testing.assert_array_equal(fg.nominal_prices, fr.nominal_prices)
    assert not fg.predict_demand(fg.sim_horizon + 1)


# -- legacy .xls (OLE2 + BIFF8) -----------------------------------------

OLE_FREE, OLE_END, OLE_FAT = 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFD


def _record(op, body):
    return struct.pack("<HH", op, len(body)) + body


def _rk_float(value):
    """RK encoding of a double whose low 32 bits are zero."""
    hi = struct.unpack("<II", struct.pack("<d", value))[1]
    assert struct.pack("<d", value)[:4] == b"\0\0\0\0"
    return hi & 0xFFFFFFFC


def _rk_int(value, div100=False):
    return ((value << 2) | 2 | int(div100)) & 0xFFFFFFFF


def _sheet(cells):
    """BOF, the cells (('num'|'rk'|'mulrk', row, col, value(s))), EOF."""
    out = [_record(0x0809, struct.pack("<HH", 0x0600, 0x0010) + b"\0" * 12)]
    for kind, r, c, v in cells:
        if kind == "num":
            out.append(_record(0x0203, struct.pack("<HHHd", r, c, 15, v)))
        elif kind == "rk":
            out.append(_record(0x027E, struct.pack("<HHHI", r, c, 15, v)))
        else:
            body = struct.pack("<HH", r, c) + b"".join(
                struct.pack("<HI", 15, rk) for rk in v) + \
                struct.pack("<H", c + len(v) - 1)
            out.append(_record(0x00BD, body))
    out.append(_record(0x000A, b""))
    return b"".join(out)


def _workbook(sheets):
    """A BIFF8 Workbook stream: globals with one BOUNDSHEET per sheet,
    then the sheets at the offsets those records give."""
    def globals_(offsets):
        recs = [_record(0x0809, struct.pack("<HH", 0x0600, 0x0005) +
                        b"\0" * 12)]
        for (name, _), off in zip(sheets, offsets):
            recs.append(_record(0x0085, struct.pack("<IBBBB", off, 0, 0,
                                                    len(name), 0) +
                                name.encode("latin-1")))
        recs.append(_record(0x000A, b""))
        return b"".join(recs)

    bodies = [_sheet(cells) for _, cells in sheets]
    start = len(globals_([0] * len(sheets)))
    offsets = list(np.cumsum([start] + [len(b) for b in bodies[:-1]]))
    return globals_([int(o) for o in offsets]) + b"".join(bodies)


def _ole2(stream, name="Workbook"):
    """A compound file of 512-byte sectors: the FAT in sector 0, the
    stream from sector 1 (regular sectors: it must be at least the
    4096-byte mini-stream cutoff), the directory last."""
    assert len(stream) >= 4096
    n_stream = -(-len(stream) // 512)
    dir_sector = 1 + n_stream
    n_sectors = dir_sector + 1
    assert n_sectors <= 128                       # one FAT sector
    fat = [OLE_FREE] * 128
    fat[0] = OLE_FAT
    for i in range(1, dir_sector):
        fat[i] = i + 1 if i + 1 < dir_sector else OLE_END
    fat[dir_sector] = OLE_END

    def entry(ename, etype, start, size):
        raw = bytearray(128)
        enc = (ename + "\0").encode("utf-16-le")
        raw[:len(enc)] = enc
        struct.pack_into("<H", raw, 64, len(enc))
        raw[66] = etype
        struct.pack_into("<III", raw, 68, OLE_FREE, OLE_FREE, OLE_FREE)
        struct.pack_into("<II", raw, 116, start, size)
        return bytes(raw)

    directory = (entry("Root Entry", 5, OLE_END, 0) +
                 entry(name, 2, 1, len(stream)) + bytes(256))
    header = bytearray(512)
    header[:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
    struct.pack_into("<HHHHHH", header, 24, 0x3E, 3, 0xFFFE, 9, 6, 0)
    struct.pack_into("<I", header, 44, 1)           # FAT sectors
    struct.pack_into("<I", header, 48, dir_sector)  # directory start
    struct.pack_into("<I", header, 56, 4096)        # mini-stream cutoff
    struct.pack_into("<II", header, 60, OLE_END, 0)  # no mini FAT
    struct.pack_into("<II", header, 68, OLE_END, 0)  # no DIFAT sectors
    struct.pack_into("<109I", header, 76, 0, *([OLE_FREE] * 108))
    body = stream + b"\0" * (n_stream * 512 - len(stream))
    return (bytes(header) + struct.pack("<128I", *fat) + body + directory)


def _price_book(tmp_path):
    """Two sheets: 'Price (EUR)', a date column 0 and 24 hourly columns
    in NUMBER, RK and MULRK cells (a DST gap at hour 3 of day 1), and a
    short 'Notes' sheet.  Every RK integer is positive: see
    test_xls_negative_rk_integer."""
    rng = np.random.default_rng(11)
    cells, prices = [], {}
    for day in range(12):
        r = day + 1
        cells.append(("num", r, 0, 42370.0 + (11 - day)))   # reversed dates
        for h in range(1, 25):
            if day == 1 and h == 3:
                continue
            v = float(np.round(rng.uniform(10, 60), 2))
            prices[(r, h)] = v
            cells.append(("num", r, h, v))
    cells += [("rk", 20, 1, _rk_int(1234)), ("rk", 20, 2,
                                              _rk_int(5678, True)),
              ("rk", 20, 3, _rk_float(1.5)),
              ("mulrk", 21, 1, [_rk_int(7), _rk_float(-2.25),
                                _rk_int(31, True)])]
    notes = [("num", 0, 0, 3.25), ("rk", 1, 0, _rk_int(9))]
    p = tmp_path / "prices.xls"
    p.write_bytes(_ole2(_workbook([("Price (EUR)", cells),
                                   ("Notes", notes)])))
    return p


def test_xls_reader_matches_jax(tmp_path):
    """``read_xls_numbers``, ``load_price_series`` and
    ``load_hourly_prices`` of both packages on one workbook: equal
    results, and the cells written."""
    from rapidnet_tpu.io import xls as jxls
    from rapidnet_tpu_torch.io import xls

    p = _price_book(tmp_path)
    assert p.stat().st_size > 4096 + 1024
    book, ref = xls.read_xls_numbers(str(p)), jxls.read_xls_numbers(str(p))
    assert book == ref
    assert list(book) == ["Price (EUR)", "Notes"]
    sheet = book["Price (EUR)"]
    assert sheet[(20, 1)] == 1234.0 and sheet[(20, 2)] == 56.78
    assert sheet[(20, 3)] == 1.5
    assert [sheet[(21, c)] for c in (1, 2, 3)] == [7.0, -2.25, 0.31]
    assert book["Notes"] == {(0, 0): 3.25, (1, 0): 9.0}
    for kw in ({}, {"column": 5}, {"sheet": "Notes"}):
        got = xls.load_price_series(str(p), **kw)
        np.testing.assert_array_equal(got,
                                      jxls.load_price_series(str(p), **kw))
        assert got.size > 0
    hourly = xls.load_hourly_prices(str(p))
    np.testing.assert_array_equal(hourly, jxls.load_hourly_prices(str(p)))
    assert hourly.shape == (12 * 24,)
    bad = tmp_path / "bad.xls"
    bad.write_bytes(b"PK\x03\x04" + b"\0" * 600)
    for fn in (xls.read_xls_numbers, jxls.read_xls_numbers):
        with pytest.raises(ValueError, match="OLE2"):
            fn(str(bad))


# -- the Barcelona data source -------------------------------------------

def test_barcelona_problem_matches_jax(tmp_path):
    """``load_barcelona_problem(ds_dir=...)`` of both packages: equal
    configs, networks, trees and forecasts; ``available`` is false on an
    empty directory; the port's functions take no default directory."""
    from rapidnet_tpu.io import datasource as jds
    from rapidnet_tpu_torch.io import datasource as ds_mod

    ds = _data_source(tmp_path)
    assert ds_mod.available(str(ds)) and jds.available(str(ds))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not ds_mod.available(str(empty))
    assert not jds.available(str(empty))
    # the port fixes no default data directory: every caller names one
    assert not hasattr(ds_mod, "DATASOURCE_DIR")
    for fn in (ds_mod.available, ds_mod.real_config,
               ds_mod.load_barcelona_problem):
        with pytest.raises(TypeError):
            fn()
    assert ds_mod.BARCELONA_PROVENANCE == jds.BARCELONA_PROVENANCE
    got = ds_mod.load_barcelona_problem(str(ds), max_iterations=7)
    ref = jds.load_barcelona_problem(str(ds), max_iterations=7)
    (gc, gn, gt, gf), (rc, rn, rt, rf) = got, ref
    assert gc.max_iterations == rc.max_iterations == 7
    for k in ("mat_l", "mat_lhat", "cost_w", "diag_precnd", "current_x",
              "prev_u", "prev_demand"):
        np.testing.assert_array_equal(getattr(gc, k), getattr(rc, k),
                                      err_msg=k)
    for k in ("matA", "matB", "matGd", "matE", "matEd", "xmin", "xmax",
              "xsafe", "umin", "umax", "alpha1"):
        np.testing.assert_array_equal(getattr(gn, k), getattr(rn, k),
                                      err_msg=k)
    gn.validate()
    for k in ("ancestor", "prob", "err_demand", "err_price",
              "node_of_slot"):
        np.testing.assert_array_equal(getattr(gt, k), getattr(rt, k),
                                      err_msg=k)
    for t in range(gf.sim_horizon + 1):
        assert gf.predict_demand(t) and rf.predict_demand(t)
        assert gf.predict_prices(t) and rf.predict_prices(t)
        np.testing.assert_array_equal(gf.nominal_demand, rf.nominal_demand)
        np.testing.assert_array_equal(gf.nominal_prices, rf.nominal_prices)


def test_xls_negative_rk_integer(tmp_path):
    """A negative RK integer (NUMBER/RK/MULRK cells) decodes to its
    value in the port.  The JAX package's ``_decode_rk`` raises
    OverflowError on it under NumPy 2 (``np.int32`` of the unsigned
    word), so it is held to the values written, not to the JAX reader."""
    from rapidnet_tpu.io import xls as jxls
    from rapidnet_tpu_torch.io import xls

    filler = [("num", r, 0, float(r)) for r in range(240)]
    cells = filler + [("rk", 300, 1, _rk_int(-5678, True)),
                      ("rk", 300, 2, _rk_int(-1)),
                      ("mulrk", 301, 1, [_rk_int(-7), _rk_float(-2.25),
                                         _rk_int(-(1 << 29))])]
    p = tmp_path / "neg.xls"
    p.write_bytes(_ole2(_workbook([("Sheet1", cells)])))
    book = xls.read_xls_numbers(str(p))
    sheet = book["Sheet1"]
    assert sheet[(300, 1)] == -56.78 and sheet[(300, 2)] == -1.0
    assert [sheet[(301, c)] for c in (1, 2, 3)] == [-7.0, -2.25,
                                                    -float(1 << 29)]
    assert len(sheet) == 245
    with pytest.raises(OverflowError):
        jxls.read_xls_numbers(str(p))
