"""Scenario tree with "fan layout" derivations.

NumPy copy of ``rapidnet_tpu/model/scenario_tree.py`` (pure-NumPy
paths only: the fan layout is always built in Python, without the JAX
package's optional C++ walk).

Reference counterpart: ``ScenarioTree`` (src/ScenarioTree.cu:32-127,
JSON keys at src/ScenarioTree.cuh:23-40).  Node ids in the JSON's
``ancestor``/``children``/``leaves`` arrays are 1-based (see the ``-1`` at
src/Utilities.cu:84); we convert to 0-based on load.

Fan layout
----------
The solver does not use the ragged node-per-stage layout of the
reference.  Instead every stage holds exactly ``ns`` (num scenarios)
slots; slot ``i`` at stage ``s`` holds the value of the tree node that
scenario ``i`` passes through at stage ``s``.  Values of a node with a
multi-scenario subtree are therefore *duplicated* across its slots.
Consequences:

* the forward sweep (parent -> child broadcast,
  src/Utilities.cu:142-155) becomes slot-identity: no gather at all;
* the backward child -> parent reduction (src/Utilities.cu:168-201) is
  the identity for every stage past the final branching stage, and a
  small dense one-hot matmul ``C_s @ (rep_s * q_s)`` for the (short)
  branching prefix — dense product work instead of scatter;
* there is no padding: every slot maps to a real node;
* reductions over *nodes* (norms, dots) use the ``rep`` mask so
  duplicated slots are counted once.

This is also the natural multi-chip layout: shard the slot axis across
devices; only the prefix aggregation and global norms need collectives.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from rapidnet_tpu_torch.io import jsonio


@dataclass
class ScenarioTree:
    N: int                      # prediction horizon (stages 0..N-1)
    ns: int                     # number of scenarios (K)
    n_nodes: int
    n_nonleaf: int
    n_children_tot: int
    stage: np.ndarray           # (n_nodes,) int32 stage of each node
    ancestor: np.ndarray        # (n_nodes,) int32, 0-based, -1 for root
    nodes_per_stage: np.ndarray      # (N,) int32
    nodes_per_stage_cumul: np.ndarray  # (N+1,) int32
    leaves: np.ndarray          # (ns,) int32, 0-based leaf node ids
    n_children: np.ndarray      # (n_nonleaf,) int32
    prob: np.ndarray            # (n_nodes,) float32 node probability
    err_demand: np.ndarray      # (n_nodes, nd) float32 demand error
    err_price: np.ndarray       # (n_nodes, nu) float32 price error
    dim_demand: int
    dim_price: int

    # ---- derived, filled by _finalize ----
    node_of_slot: np.ndarray = field(default=None)  # (N, ns) int32
    rep: np.ndarray = field(default=None)           # (N, ns) float32 0/1
    children_of: list = field(default=None)         # list of int arrays
    final_branch_stage: int = field(default=0)
    final_branch_node: int = field(default=0)
    prefix_agg: dict = field(default=None)  # stage s -> (ns, ns) float32 C_s
    # factored aggregation C_s = Bp_s @ Cp_s over the DISTINCT parent
    # nodes (communication-minimal sharded form; see solve_step.py):
    prefix_Cp: dict = field(default=None)   # s -> (Rp, ns): child-sum
    prefix_Bp: dict = field(default=None)   # s -> (ns, Rp): broadcast

    # ------------------------------------------------------------------
    @classmethod
    def from_json(cls, path) -> "ScenarioTree":
        doc = jsonio.load_json(path)
        N = jsonio.scalar(doc, "N")
        ns = jsonio.scalar(doc, "K")
        n_nodes = jsonio.scalar(doc, "nodes")
        nd = jsonio.scalar(doc, "dimDemand")
        npr = jsonio.scalar(doc, "dimPrice")
        tree = cls(
            N=N, ns=ns, n_nodes=n_nodes,
            n_nonleaf=jsonio.scalar(doc, "nNonLeafNodes"),
            n_children_tot=jsonio.scalar(doc, "nChildrenTot"),
            stage=jsonio.vector(doc, "stages", np.int32),
            ancestor=jsonio.vector(doc, "ancestor", np.int32) - 1,
            nodes_per_stage=jsonio.vector(doc, "nodesPerStage", np.int32)[:N],
            nodes_per_stage_cumul=jsonio.vector(
                doc, "nodesPerStageCumul", np.int32)[:N + 1],
            leaves=jsonio.vector(doc, "leaves", np.int32) - 1,
            n_children=jsonio.vector(doc, "nChildren", np.int32),
            prob=jsonio.vector(doc, "probNode", np.float32),
            err_demand=np.asarray(doc["errorDemandNode"],
                                  np.float32).reshape(n_nodes, nd),
            err_price=np.asarray(doc["errorPriceNode"],
                                 np.float32).reshape(n_nodes, npr),
            dim_demand=nd, dim_price=npr,
        )
        tree._finalize()
        return tree

    @classmethod
    def from_arrays(cls, *, N, ancestor, stage, prob, err_demand,
                    err_price, leaves) -> "ScenarioTree":
        """Build a tree from 0-based ancestor/stage arrays (generator path)."""
        ancestor = np.asarray(ancestor, np.int32)
        stage = np.asarray(stage, np.int32)
        n_nodes = ancestor.size
        leaves = np.asarray(leaves, np.int32)
        nodes_per_stage = np.bincount(stage, minlength=N).astype(np.int32)
        cumul = np.concatenate(
            [[0], np.cumsum(nodes_per_stage)]).astype(np.int32)
        n_nonleaf = int(n_nodes - leaves.size)
        tree = cls(
            N=int(N), ns=int(leaves.size), n_nodes=int(n_nodes),
            n_nonleaf=n_nonleaf, n_children_tot=int(n_nodes - 1),
            stage=stage, ancestor=ancestor,
            nodes_per_stage=nodes_per_stage,
            nodes_per_stage_cumul=cumul,
            leaves=leaves,
            n_children=np.bincount(
                ancestor[ancestor >= 0],
                minlength=n_nonleaf).astype(np.int32)[:n_nonleaf],
            prob=np.asarray(prob, np.float32),
            err_demand=np.asarray(err_demand, np.float32),
            err_price=np.asarray(err_price, np.float32),
            dim_demand=int(np.asarray(err_demand).shape[1]),
            dim_price=int(np.asarray(err_price).shape[1]),
        )
        tree._finalize()
        return tree

    # ------------------------------------------------------------------
    def _finalize(self) -> None:
        N, ns = self.N, self.ns
        # children lists
        self.children_of = [[] for _ in range(self.n_nodes)]
        for node in range(1, self.n_nodes):
            self.children_of[self.ancestor[node]].append(node)
        self.children_of = [np.asarray(c, np.int32) for c in self.children_of]

        # final branching stage/node (reference: src/ScenarioTree.cu:149-169)
        self.final_branch_stage = N - 1
        self.final_branch_node = self.n_nodes
        for s in range(N - 1):
            if self.nodes_per_stage[s] == self.nodes_per_stage[s + 1]:
                self.final_branch_stage = s
                self.final_branch_node = int(self.nodes_per_stage_cumul[s + 1])
                break

        # scenario paths: node_of_slot[s, i]
        node_of_slot = np.zeros((N, ns), np.int32)
        for i, leaf in enumerate(self.leaves):
            node = int(leaf)
            for s in range(N - 1, -1, -1):
                node_of_slot[s, i] = node
                node = int(self.ancestor[node])
        rep = np.zeros((N, ns), np.float32)
        rep[:, 0] = 1.0
        rep[:, 1:] = (node_of_slot[:, 1:] != node_of_slot[:, :-1])
        self.node_of_slot = node_of_slot
        self.rep = rep

        # contiguity check: each node's slots must form one contiguous run
        for s in range(N):
            segments = int(rep[s].sum())
            if segments != self.nodes_per_stage[s]:
                raise ValueError(
                    f"scenario slots of stage {s} are not contiguous per "
                    f"node ({segments} runs vs {self.nodes_per_stage[s]} "
                    "nodes); reorder leaves")

        # prefix aggregation matrices: C_s[i, j] = 1 when stage-s slot j is
        # the representative slot of a child of the node at stage s-1 slot i
        self.prefix_agg = {}
        for s in range(1, N):
            if self.nodes_per_stage[s] == self.nodes_per_stage[s - 1]:
                continue
            parent_of_slot = self.ancestor[node_of_slot[s]]
            C = ((node_of_slot[s - 1][:, None] ==
                  parent_of_slot[None, :]) &
                 (rep[s] > 0)[None, :]).astype(np.float32)
            self.prefix_agg[s] = C

        # factored form over the DISTINCT stage-(s-1) parent nodes:
        # C_s = Bp_s @ Cp_s with Cp_s (Rp, ns) summing representative
        # child slots into each parent and Bp_s (ns, Rp) broadcasting
        # parent values back to slots.  Under scenario-axis sharding
        # only the (Rp, d) parent block crosses shards (one psum) —
        # Rp = nodesPerStage[s-1] << ns at the shallow prefix stages —
        # instead of all-gathering the full (ns, d) slot block.
        self.prefix_Cp, self.prefix_Bp = {}, {}
        for s in self.prefix_agg:
            base = int(self.nodes_per_stage_cumul[s - 1])
            Rp = int(self.nodes_per_stage[s - 1])
            parent_slot = node_of_slot[s - 1] - base            # (ns,)
            Bp = np.zeros((ns, Rp), np.float32)
            Bp[np.arange(ns), parent_slot] = 1.0
            child_parent = self.ancestor[node_of_slot[s]] - base  # (ns,)
            Cp = np.zeros((Rp, ns), np.float32)
            reps = np.flatnonzero(rep[s] > 0)
            Cp[child_parent[reps], reps] = 1.0
            self.prefix_Cp[s] = Cp
            self.prefix_Bp[s] = Bp

    # ------------------------------------------------------------------
    # layout conversion helpers
    def gather_to_fan(self, node_values: np.ndarray) -> np.ndarray:
        """(n_nodes, ...) -> (N, ns, ...) by scenario-path duplication."""
        return np.asarray(node_values)[self.node_of_slot]

    def scatter_from_fan(self, fan_values: np.ndarray) -> np.ndarray:
        """(N, ns, ...) -> (n_nodes, ...) taking representative slots."""
        fan = np.asarray(fan_values)
        out_shape = (self.n_nodes,) + tuple(fan.shape[2:])
        out = np.zeros(out_shape, fan.dtype)
        s_idx, i_idx = np.nonzero(self.rep > 0)
        out[self.node_of_slot[s_idx, i_idx]] = fan[s_idx, i_idx]
        return out

    def first_slot_of_node(self) -> np.ndarray:
        """(n_nodes,) index of the representative slot of each node."""
        first = np.zeros(self.n_nodes, np.int32)
        s_idx, i_idx = np.nonzero(self.rep > 0)
        first[self.node_of_slot[s_idx, i_idx]] = i_idx
        return first

    @property
    def prob_fan(self) -> np.ndarray:
        return self.gather_to_fan(self.prob)


def generate_tree_from_samples(demand_errors: np.ndarray,
                               price_errors: np.ndarray,
                               branching: list[int] | tuple[int, ...],
                               *, N: int | None = None,
                               seed: int = 0,
                               kmeans_iters: int = 25) -> ScenarioTree:
    """Build a scenario tree from sampled forecast-error trajectories.

    The reference only *loads* pre-generated trees (MATLAB,
    src/paser/dataSource/); this is the forecaster-driven generation the
    BASELINE ladder requires: stagewise k-means scenario clustering.
    At each branching stage the surviving sample bundles are split into
    ``branching[s]`` clusters by their error at that stage; node values
    are cluster means, node probabilities are sample frequencies.

    Args:
      demand_errors: (num_samples, N, nd) sampled demand error paths.
      price_errors:  (num_samples, N, nu) sampled price error paths.
      branching: children per node at each stage (1 afterwards).
    """
    demand_errors = np.asarray(demand_errors, np.float32)
    price_errors = np.asarray(price_errors, np.float32)
    n_samples, N_data, nd = demand_errors.shape
    nu = price_errors.shape[2]
    N = N or N_data
    rng = np.random.default_rng(seed)

    def kmeans(vals, k, weights):
        """Weighted k-means over rows of vals; returns (labels, centers)."""
        k = min(k, len(np.unique(vals.round(6), axis=0)))
        idx = rng.choice(len(vals), size=k, replace=False)
        centers = vals[idx]
        labels = np.zeros(len(vals), np.int64)
        for _ in range(kmeans_iters):
            d2 = ((vals[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = d2.argmin(1)
            for j in range(k):
                m = labels == j
                if m.any():
                    w = weights[m][:, None]
                    centers[j] = (w * vals[m]).sum(0) / w.sum()
        return labels, centers

    # each tree node tracks its member sample indices
    ancestor = [-1]
    stage = [0]
    node_members = {0: np.arange(n_samples)}
    node_d = {0: np.zeros(nd, np.float32)}
    node_p = {0: np.zeros(nu, np.float32)}
    prob = [1.0]
    frontier = [0]
    next_id = 1
    w_all = np.full(n_samples, 1.0 / n_samples)
    for s in range(1, N):
        b = branching[s - 1] if s - 1 < len(branching) else 1
        new_frontier = []
        for parent in frontier:
            members = node_members[parent]
            feats = np.concatenate(
                [demand_errors[members, s], price_errors[members, s]],
                axis=1)
            if b > 1 and len(members) > 1:
                labels, _ = kmeans(feats, b, w_all[members])
            else:
                labels = np.zeros(len(members), np.int64)
            for j in np.unique(labels):
                sub = members[labels == j]
                ancestor.append(parent)
                stage.append(s)
                node_members[next_id] = sub
                node_d[next_id] = demand_errors[sub, s].mean(0)
                node_p[next_id] = price_errors[sub, s].mean(0)
                prob.append(len(sub) / n_samples)
                new_frontier.append(next_id)
                next_id += 1
        frontier = new_frontier

    n_nodes = next_id
    err_demand = np.stack([node_d[i] for i in range(n_nodes)])
    err_price = np.stack([node_p[i] for i in range(n_nodes)])
    return ScenarioTree.from_arrays(
        N=N, ancestor=np.asarray(ancestor, np.int32),
        stage=np.asarray(stage, np.int32),
        prob=np.asarray(prob, np.float32),
        err_demand=err_demand, err_price=err_price,
        leaves=np.asarray(frontier, np.int32))


def generate_tree(*, N: int, branching: list[int] | tuple[int, ...],
                  nd: int, nu: int, seed: int = 0,
                  demand_sigma: float = 0.05,
                  price_sigma: float = 0.02) -> ScenarioTree:
    """Synthetic scenario tree generator.

    The reference ships pre-generated trees only (MATLAB,
    src/paser/dataSource/); for benchmark ladders we generate
    binary/k-ary trees: ``branching[s]`` children per node at stage s
    (1 after the list is exhausted).

    Node ids are assigned BFS by stage, children contiguous — the same
    convention as the reference fixtures.
    """
    rng = np.random.default_rng(seed)
    ancestor = [-1]
    stage = [0]
    frontier = [0]
    next_id = 1
    for s in range(1, N):
        b = branching[s - 1] if s - 1 < len(branching) else 1
        new_frontier = []
        for parent in frontier:
            for _ in range(b):
                ancestor.append(parent)
                stage.append(s)
                new_frontier.append(next_id)
                next_id += 1
        frontier = new_frontier
    n_nodes = next_id
    leaves = np.asarray(frontier, np.int32)

    ancestor = np.asarray(ancestor, np.int32)
    stage = np.asarray(stage, np.int32)

    # node probabilities: random sibling weights, normalised per parent
    prob = np.zeros(n_nodes, np.float64)
    prob[0] = 1.0
    prob[1:] = rng.uniform(0.5, 1.5, size=n_nodes - 1)
    # normalise siblings then multiply down the tree
    for node in range(n_nodes):
        ch = np.flatnonzero(ancestor == node)
        if ch.size:
            prob[ch] = prob[node] * prob[ch] / prob[ch].sum()

    err_demand = (rng.standard_normal((n_nodes, nd)) *
                  demand_sigma).astype(np.float32)
    err_price = (rng.standard_normal((n_nodes, nu)) *
                 price_sigma).astype(np.float32)
    err_demand[0] = 0.0
    err_price[0] = 0.0

    return ScenarioTree.from_arrays(
        N=N, ancestor=ancestor, stage=stage, prob=prob.astype(np.float32),
        err_demand=err_demand, err_price=err_price, leaves=leaves)
