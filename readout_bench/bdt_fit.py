"""Frozen copy of the boosted-tree fitter and the operating-point search.

The benchmark fits each configuration's classifier itself, from the
tracks its own generator makes, and hands the fitted trees and the
trigger cut to the program through the program's public classes. Taken
from ``repro_torch/core/bdt.py``: binary log-loss gradient boosting with
histogram splits (Friedman MSE, Newton leaves), and the paper's
operating-point search over the discrete scores of a tree.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

LEAF = -1  # sentinel in the `feature` array


@dataclasses.dataclass
class Tree:
    """Flat binary tree. Node 0 is the root.

    feature[i] == LEAF marks a leaf; value[i] is the leaf value (logit
    contribution). Internal nodes route LEFT iff x[feature] <= threshold
    (sklearn / Conifer convention).
    """

    feature: np.ndarray       # (n_nodes,) int32
    threshold: np.ndarray     # (n_nodes,) float64
    children_left: np.ndarray   # (n_nodes,) int32
    children_right: np.ndarray  # (n_nodes,) int32
    value: np.ndarray         # (n_nodes,) float64

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    def depth(self) -> int:
        d = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes):
            if self.feature[i] != LEAF:
                d[self.children_left[i]] = d[i] + 1
                d[self.children_right[i]] = d[i] + 1
        return int(d.max()) if self.n_nodes else 0

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized float-domain traversal."""
        n = len(X)
        node = np.zeros(n, dtype=np.int32)
        for _ in range(self.depth() + 1):
            f = self.feature[node]
            is_leaf = f == LEAF
            go_left = X[np.arange(n), np.maximum(f, 0)] <= self.threshold[node]
            nxt = np.where(go_left, self.children_left[node], self.children_right[node])
            node = np.where(is_leaf, node, nxt).astype(np.int32)
        return self.value[node]


def _quantile_bin_edges(X: np.ndarray, n_bins: int) -> List[np.ndarray]:
    edges = []
    for j in range(X.shape[1]):
        qs = np.quantile(X[:, j], np.linspace(0, 1, n_bins + 1)[1:-1])
        edges.append(np.unique(qs))
    return edges


def _bin_features(X: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    binned = np.empty(X.shape, dtype=np.int16)
    for j, e in enumerate(edges):
        binned[:, j] = np.searchsorted(e, X[:, j], side="right")
    return binned


@dataclasses.dataclass
class _NodeBuild:
    node_id: int
    sample_idx: np.ndarray
    depth: int


def _fit_regression_tree(
    Xb: np.ndarray,
    edges: List[np.ndarray],
    X: np.ndarray,
    grad: np.ndarray,
    hess: np.ndarray,
    max_depth: int,
    min_samples_leaf: int,
    max_leaf_nodes: Optional[int] = None,
) -> Tree:
    """Grow one regression tree on (grad, hess) with histogram splits.

    Split criterion: Friedman variance reduction on the residuals
    (maximize S_L^2/n_L + S_R^2/n_R); leaf value: Newton step
    sum(grad)/sum(hess). Matches sklearn's GradientBoosting tree stage.
    """
    n_features = Xb.shape[1]
    feature, threshold, left, right, value = [], [], [], [], []

    def new_node() -> int:
        feature.append(LEAF)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feature) - 1

    root = new_node()
    stack = [_NodeBuild(root, np.arange(len(Xb)), 0)]
    n_leaves = 1

    while stack:
        nb = stack.pop()
        idx = nb.sample_idx
        g = grad[idx]
        h = hess[idx]
        G, H, n = g.sum(), h.sum(), len(idx)
        # Newton leaf value (set now; overwritten only by recursion bookkeeping).
        value[nb.node_id] = float(G / max(H, 1e-12))

        if nb.depth >= max_depth or n < 2 * min_samples_leaf:
            continue
        if max_leaf_nodes is not None and n_leaves >= max_leaf_nodes:
            continue

        parent_score = G * G / max(n, 1)
        best = (0.0, -1, -1)  # (gain, feature, bin)
        xb = Xb[idx]
        for j in range(n_features):
            nb_bins = len(edges[j]) + 1
            if nb_bins < 2:
                continue
            sums = np.bincount(xb[:, j], weights=g, minlength=nb_bins)
            cnts = np.bincount(xb[:, j], minlength=nb_bins)
            cs = np.cumsum(sums)[:-1]
            cc = np.cumsum(cnts)[:-1]
            nl = cc
            nr = n - cc
            ok = (nl >= min_samples_leaf) & (nr >= min_samples_leaf)
            with np.errstate(divide="ignore", invalid="ignore"):
                gain = cs * cs / np.maximum(nl, 1) + (G - cs) ** 2 / np.maximum(nr, 1)
            gain = np.where(ok, gain - parent_score, -np.inf)
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), j, b)

        gain, j, b = best
        if j < 0 or gain <= 1e-12:
            continue

        thr = float(edges[j][b])  # split: x <= thr goes left
        go_left = X[idx, j] <= thr
        li, ri = idx[go_left], idx[~go_left]
        if len(li) < min_samples_leaf or len(ri) < min_samples_leaf:
            continue

        lid, rid = new_node(), new_node()
        feature[nb.node_id] = j
        threshold[nb.node_id] = thr
        left[nb.node_id] = lid
        right[nb.node_id] = rid
        n_leaves += 1
        stack.append(_NodeBuild(lid, li, nb.depth + 1))
        stack.append(_NodeBuild(rid, ri, nb.depth + 1))

    return Tree(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float64),
        children_left=np.asarray(left, np.int32),
        children_right=np.asarray(right, np.int32),
        value=np.asarray(value, np.float64),
    )


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -60, 60)))



def fit(X: np.ndarray, y: np.ndarray, n_estimators: int = 1,
        max_depth: int = 5, learning_rate: float = 0.1,
        min_samples_leaf: int = 64, n_bins: int = 256,
        max_leaf_nodes: Optional[int] = None) -> Tuple[List[Tree], float]:
    """Fit a binary log-loss boosted ensemble; returns (trees, f0).

    The same algorithm and arithmetic as the program's
    ``GradientBoostedClassifier.fit``."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    p = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
    f0 = float(np.log(p / (1 - p)))
    F = np.full(len(y), f0)
    edges = _quantile_bin_edges(X, n_bins)
    Xb = _bin_features(X, edges)
    trees = []
    for _ in range(n_estimators):
        prob = _sigmoid(F)
        grad = y - prob
        hess = prob * (1 - prob)
        tree = _fit_regression_tree(Xb, edges, X, grad, hess, max_depth,
                                    min_samples_leaf, max_leaf_nodes)
        trees.append(tree)
        F = F + learning_rate * tree.predict(X)
    return trees, f0


def signal_eff_background_rej(
    score: np.ndarray, is_pileup: np.ndarray, thresholds: np.ndarray
) -> List[Tuple[float, float, float]]:
    """Paper convention: score = P(pileup). A track is REJECTED if score > thr.

    signal efficiency    = fraction of non-pileup (high-pT) tracks retained
    background rejection = fraction of pileup tracks rejected
    Returns [(thr, sig_eff, bkg_rej)].
    """
    is_pu = is_pileup.astype(bool)
    out = []
    for thr in np.atleast_1d(thresholds):
        keep = score <= thr
        sig_eff = float(keep[~is_pu].mean()) if (~is_pu).any() else float("nan")
        bkg_rej = float((~keep)[is_pu].mean()) if is_pu.any() else float("nan")
        out.append((float(thr), sig_eff, bkg_rej))
    return out


def operating_point_at_signal_eff(
    score: np.ndarray, is_pileup: np.ndarray, target_sig_eff: float
) -> Tuple[float, float, float]:
    """Find the threshold whose signal efficiency is closest to the target.

    A depth-5 tree emits only ~10 distinct scores (one per leaf), so the
    achievable operating points are discrete — we enumerate the unique
    score values as candidate thresholds (this is also what the paper's
    Table 1 reflects: three discrete achievable points)."""
    cands = np.unique(score)
    rows = signal_eff_background_rej(score, is_pileup, cands)
    best = min(rows, key=lambda r: (abs(r[1] - target_sig_eff), -r[2]))
    return best
