"""Drinking-water-network model (mass-balance linear system).

NumPy copy of ``rapidnet_tpu/model/network.py``: the reference's
``DwnNetwork`` class
(src/DwnNetwork.cu:30-117, JSON keys at src/DwnNetwork.cuh:23-37).

Dynamics:  x+ = A x + B u + Gd d   with A = I (mass balance),
input coupling E u + Ed d = 0, bounds on x and u, safety level xsafe,
and a production/price cost vector alpha1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rapidnet_tpu_torch.io import jsonio


@dataclass
class DwnNetwork:
    nx: int          # number of tanks (states)
    nu: int          # number of controls (pumps/valves)
    nd: int          # number of demands (disturbances)
    ne: int          # number of mixing (junction) nodes
    matA: np.ndarray     # (nx, nx), identity for mass balance
    matB: np.ndarray     # (nx, nu)
    matGd: np.ndarray    # (nx, nd)
    matE: np.ndarray     # (ne, nu)
    matEd: np.ndarray    # (ne, nd)
    xmin: np.ndarray     # (nx,)
    xmax: np.ndarray     # (nx,)
    xsafe: np.ndarray    # (nx,)
    umin: np.ndarray     # (nu,)
    umax: np.ndarray     # (nu,)
    alpha1: np.ndarray   # (nu,) constant production cost

    @classmethod
    def from_json(cls, path) -> "DwnNetwork":
        doc = jsonio.load_json(path)
        nx = jsonio.scalar(doc, "nx")
        nu = jsonio.scalar(doc, "nu")
        nd = jsonio.scalar(doc, "nd")
        ne = jsonio.scalar(doc, "ne")
        return cls(
            nx=nx, nu=nu, nd=nd, ne=ne,
            matA=jsonio.matrix_colmajor(doc, "matA", nx, nx),
            matB=jsonio.matrix_colmajor(doc, "matB", nx, nu),
            matGd=jsonio.matrix_colmajor(doc, "matGd", nx, nd),
            matE=jsonio.matrix_colmajor(doc, "matE", ne, nu),
            matEd=jsonio.matrix_colmajor(doc, "matEd", ne, nd),
            xmin=jsonio.vector(doc, "vecXmin"),
            xmax=jsonio.vector(doc, "vecXmax"),
            xsafe=jsonio.vector(doc, "vecXsafe"),
            umin=jsonio.vector(doc, "vecUmin"),
            umax=jsonio.vector(doc, "vecUmax"),
            alpha1=jsonio.vector(doc, "costAlpha1"),
        )

    def to_json(self, path) -> None:
        doc = {
            "nx": [self.nx], "nu": [self.nu], "ne": [self.ne],
            "nd": [self.nd], "N": [0],
            "matA": self.matA.T.reshape(-1),
            "matB": self.matB.T.reshape(-1),
            "matGd": self.matGd.T.reshape(-1),
            "matE": self.matE.T.reshape(-1),
            "matEd": self.matEd.T.reshape(-1),
            "vecXmin": self.xmin, "vecXmax": self.xmax,
            "vecXsafe": self.xsafe,
            "vecUmin": self.umin, "vecUmax": self.umax,
            "costAlpha1": self.alpha1,
        }
        jsonio.dump_json(path, doc)

    def validate(self) -> None:
        assert self.matA.shape == (self.nx, self.nx)
        assert self.matB.shape == (self.nx, self.nu)
        assert self.matGd.shape == (self.nx, self.nd)
        assert self.matE.shape == (self.ne, self.nu)
        assert self.matEd.shape == (self.ne, self.nd)
        if not np.allclose(self.matA, np.eye(self.nx)):
            raise ValueError(
                "rapidnet_tpu_torch assumes mass-balance dynamics with A = I "
                "(as the reference solve step does, "
                "src/SmpcController.cu:687-737)")


def synthetic_network(nx: int, nu: int, nd: int, ne: int,
                      seed: int = 0) -> DwnNetwork:
    """Generate a random well-posed DWN for benchmarks & tests.

    Mirrors the structure of the reference's Barcelona-style networks:
    sparse B with +/-1-ish pump gains, demands draining specific tanks,
    junction constraints E u + Ed d = 0 with full-rank E.
    """
    rng = np.random.default_rng(seed)
    B = (rng.uniform(-1, 1, (nx, nu)) *
         (rng.random((nx, nu)) < min(1.0, 3.0 / nx))).astype(np.float32)
    # ensure every control affects something
    for j in range(nu):
        if not B[:, j].any():
            B[rng.integers(nx), j] = 1.0
    Gd = np.zeros((nx, nd), dtype=np.float32)
    for k in range(nd):
        Gd[rng.integers(nx), k] = -1.0
    E = rng.standard_normal((ne, nu)).astype(np.float32)
    # orthonormal rows keep the SVD well-conditioned
    E = np.linalg.qr(E.T)[0].T[:ne].astype(np.float32)
    Ed = (rng.standard_normal((ne, nd)) *
          (rng.random((ne, nd)) < 0.3)).astype(np.float32)
    xmax = rng.uniform(500, 3000, nx).astype(np.float32)
    return DwnNetwork(
        nx=nx, nu=nu, nd=nd, ne=ne,
        matA=np.eye(nx, dtype=np.float32),
        matB=B, matGd=Gd, matE=E, matEd=Ed,
        xmin=np.zeros(nx, dtype=np.float32),
        xmax=xmax,
        xsafe=(0.1 * xmax).astype(np.float32),
        umin=np.zeros(nu, dtype=np.float32),
        umax=rng.uniform(100, 2000, nu).astype(np.float32),
        alpha1=(rng.random(nu) * 0.2).astype(np.float32),
    )
