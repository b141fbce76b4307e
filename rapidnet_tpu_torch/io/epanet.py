"""EPANET .inp -> DwnNetwork converter.

NumPy copy of ``rapidnet_tpu/io/epanet.py``.

Python port of the reference's MATLAB preprocessing
(src/paser/parserEpanet.m): extracts JUNCTIONS / TANKS / PIPES / PUMPS /
VALVES and builds the mass-balance topology matrices

  B  (tanks x actuators): +1 where actuator's Node1 is the tank,
                          -1 where Node2 is the tank
  Gd (tanks x demands):   1 where a pipe connects the junction to the tank
  E/Ed (junction flow balance): one row per junction touched by an
       actuator, +-1 for attached pumps/valves and -1 on the junction's
       own demand column

with tank levels as state bounds.  (The MATLAB version indexes valves
with the pump loop variable — src/paser/parserEpanet.m valve loops — an
obvious copy-paste bug we implement as intended instead.)
"""

from __future__ import annotations

import numpy as np

from rapidnet_tpu_torch.model.network import DwnNetwork

_SECTIONS = ("JUNCTIONS", "RESERVOIRS", "TANKS", "PIPES", "PUMPS",
             "VALVES", "TAGS", "DEMANDS")


def _parse_sections(text: str) -> dict[str, list[list[str]]]:
    sections: dict[str, list[list[str]]] = {}
    current = None
    for raw in text.splitlines():
        line = raw.split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            current = line.strip("[]").upper()
            sections.setdefault(current, [])
            continue
        if current is not None:
            sections[current].append(line.split())
    return sections


def parse_epanet(path: str) -> DwnNetwork:
    with open(path) as f:
        sections = _parse_sections(f.read())

    junctions = [(row[0], float(row[2]) if len(row) > 2 else 0.0)
                 for row in sections.get("JUNCTIONS", [])]
    tanks = [(row[0], float(row[2]), float(row[3]), float(row[4]))
             for row in sections.get("TANKS", []) if len(row) >= 5]
    pipes = [(row[1], row[2]) for row in sections.get("PIPES", [])
             if len(row) >= 3]
    pumps = [(row[1], row[2]) for row in sections.get("PUMPS", [])
             if len(row) >= 3]
    valves = [(row[1], row[2]) for row in sections.get("VALVES", [])
              if len(row) >= 3]

    tank_ids = [t[0] for t in tanks]
    junc_ids = [j[0] for j in junctions]
    actuators = pumps + valves
    nx, nu, nd = len(tanks), len(actuators), len(junctions)

    B = np.zeros((nx, nu), np.float32)
    for j, (n1, n2) in enumerate(actuators):
        for i, tid in enumerate(tank_ids):
            if n1 == tid:
                B[i, j] = 1.0
            elif n2 == tid:
                B[i, j] = -1.0

    Gd = np.zeros((nx, nd), np.float32)
    for i, tid in enumerate(tank_ids):
        connected = set()
        for n1, n2 in pipes:
            if n1 == tid:
                connected.add(n2)
            elif n2 == tid:
                connected.add(n1)
        for k, jid in enumerate(junc_ids):
            if jid in connected:
                Gd[i, k] = 1.0

    rows_e, rows_ed = [], []
    for k, jid in enumerate(junc_ids):
        row_e = np.zeros(nu, np.float32)
        row_ed = np.zeros(nd, np.float32)
        touched = False
        for j, (n1, n2) in enumerate(actuators):
            if n1 == jid:
                row_e[j] = 1.0
                row_ed[k] = -1.0
                touched = True
            if n2 == jid:
                row_e[j] = -1.0
                row_ed[k] = -1.0
                touched = True
        if touched:
            rows_e.append(row_e)
            rows_ed.append(row_ed)
    if rows_e:
        E = np.stack(rows_e)
        Ed = np.stack(rows_ed)
    else:
        E = np.zeros((1, nu), np.float32)
        Ed = np.zeros((1, nd), np.float32)

    xmin = np.asarray([t[2] for t in tanks], np.float32)
    xmax = np.asarray([t[3] for t in tanks], np.float32)
    return DwnNetwork(
        nx=nx, nu=nu, nd=nd, ne=E.shape[0],
        matA=np.eye(nx, dtype=np.float32),
        matB=B, matGd=Gd, matE=E, matEd=Ed,
        xmin=xmin, xmax=xmax,
        xsafe=(xmin + 0.1 * (xmax - xmin)).astype(np.float32),
        umin=np.zeros(nu, np.float32),
        umax=np.full(nu, 100.0, np.float32),
        alpha1=np.full(nu, 10.0, np.float32),
    )
