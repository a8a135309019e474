# Copy of repro/core/bdt.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""Gradient-boosted decision trees, from scratch (no sklearn in this container).

The paper trains "a single tree with a depth of 5 ... using gradient boosting
with the scikit-learn package" for the pileup classification task, then
synthesizes it with Conifer onto the 28nm eFPGA.

We reproduce the same algorithm family:

  * binary log-loss gradient boosting (sklearn ``GradientBoostingClassifier``
    semantics): F0 = prior log-odds; each stage fits a regression tree to the
    residuals ``r_i = y_i - sigmoid(F(x_i))`` with Friedman's MSE criterion,
    and leaf values take a Newton step ``sum(r) / sum(p (1-p))``;
  * histogram-based exact-greedy split search (256 quantile bins) so training
    on 500k x 14 is fast in pure numpy;
  * flat-array tree representation (feature / threshold / children / value)
    that downstream synthesis (``core/synth.py``) and the Pallas inference
    kernel (``kernels/bdt_infer``) consume directly;
  * a *quantized* evaluation path in which thresholds live on the
    ap_fixed<W,I> grid and comparisons are exact integer compares — this is
    the "golden model" the fabric must match 100%.

The ensemble generalizes beyond the paper's single tree (their limit was the
448-LUT fabric, not the algorithm); ``n_estimators`` is free.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.quantize import FixedSpec, AP_FIXED_28_19, quantize_raw

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

    @property
    def n_leaves(self) -> int:
        return int((self.feature == LEAF).sum())

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves

    def depth(self) -> int:
        d = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes):
            if self.feature[i] != LEAF:
                d[self.children_left[i]] = d[i] + 1
                d[self.children_right[i]] = d[i] + 1
        return int(d.max()) if self.n_nodes else 0

    def used_features(self) -> np.ndarray:
        return np.unique(self.feature[self.feature != LEAF])

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

    def quantized(self, spec: FixedSpec) -> "QuantizedTree":
        return QuantizedTree.from_tree(self, spec)


@dataclasses.dataclass
class QuantizedTree:
    """Tree with thresholds and leaf values on the ap_fixed grid (raw ints).

    This is the "golden model" of the paper's §5: once thresholds are raw
    integers, traversal is exact, and the fabric-executed netlist must agree
    on every event.
    """

    feature: np.ndarray
    threshold_raw: np.ndarray  # (n_nodes,) int64 on the fixed grid
    children_left: np.ndarray
    children_right: np.ndarray
    value_raw: np.ndarray      # (n_nodes,) int64 leaf logits on the fixed grid
    spec: FixedSpec

    @classmethod
    def from_tree(cls, tree: Tree, spec: FixedSpec) -> "QuantizedTree":
        return cls(
            feature=tree.feature.copy(),
            threshold_raw=quantize_raw(tree.threshold, spec),
            children_left=tree.children_left.copy(),
            children_right=tree.children_right.copy(),
            value_raw=quantize_raw(tree.value, spec),
            spec=spec,
        )

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

    def predict_raw(self, X_raw: np.ndarray) -> np.ndarray:
        """Exact integer-domain traversal: X_raw is (n, n_features) int64."""
        n = len(X_raw)
        node = np.zeros(n, dtype=np.int32)
        for _ in range(self.depth() + 1):
            f = self.feature[node]
            is_leaf = f == LEAF
            go_left = X_raw[np.arange(n), np.maximum(f, 0)] <= self.threshold_raw[node]
            nxt = np.where(go_left, self.children_left[node], self.children_right[node])
            node = np.where(is_leaf, node, nxt).astype(np.int32)
        return self.value_raw[node]


# --------------------------------------------------------------------------
# Histogram-based regression tree fitting (Friedman MSE + Newton leaves)
# --------------------------------------------------------------------------


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


# --------------------------------------------------------------------------
# Gradient boosting
# --------------------------------------------------------------------------


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -60, 60)))


@dataclasses.dataclass
class GradientBoostedClassifier:
    """Binary GBM with log loss. Paper config: n_estimators=1, max_depth=5."""

    n_estimators: int = 1
    max_depth: int = 5
    learning_rate: float = 0.1
    min_samples_leaf: int = 64
    n_bins: int = 256
    max_leaf_nodes: Optional[int] = None

    trees: List[Tree] = dataclasses.field(default_factory=list)
    f0: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedClassifier":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        p = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        self.f0 = float(np.log(p / (1 - p)))
        F = np.full(len(y), self.f0)
        edges = _quantile_bin_edges(X, self.n_bins)
        Xb = _bin_features(X, edges)
        self.trees = []
        for _ in range(self.n_estimators):
            prob = _sigmoid(F)
            grad = y - prob          # negative gradient of log loss
            hess = prob * (1 - prob)
            tree = _fit_regression_tree(
                Xb, edges, X, grad, hess,
                self.max_depth, self.min_samples_leaf, self.max_leaf_nodes,
            )
            self.trees.append(tree)
            F = F + self.learning_rate * tree.predict(X)
        return self

    # --- float ("pre-quantization") path ---
    def decision_function(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        F = np.full(len(X), self.f0)
        for t in self.trees:
            F = F + self.learning_rate * t.predict(X)
        return F

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return _sigmoid(self.decision_function(X))

    # --- quantized ("golden") path ---
    def quantized(self, spec: FixedSpec = AP_FIXED_28_19) -> "QuantizedEnsemble":
        return QuantizedEnsemble(
            trees=[t.quantized(spec) for t in self.trees],
            # fold learning rate + f0 into the quantized leaf values:
            lr=self.learning_rate,
            f0=self.f0,
            spec=spec,
        )


@dataclasses.dataclass
class QuantizedEnsemble:
    """Golden quantized model: integer thresholds, integer leaf logits.

    The learning-rate-scaled leaf values and f0 are folded into the fixed
    grid at construction so the whole decision function is integer-exact.
    """

    trees: List[QuantizedTree]
    lr: float
    f0: float
    spec: FixedSpec

    def __post_init__(self):
        # Fold lr into leaf values (re-quantize the scaled leaves).
        folded = []
        for qt in self.trees:
            scaled = qt.value_raw / qt.spec.scale * self.lr
            folded.append(
                QuantizedTree(
                    feature=qt.feature,
                    threshold_raw=qt.threshold_raw,
                    children_left=qt.children_left,
                    children_right=qt.children_right,
                    value_raw=quantize_raw(scaled, qt.spec),
                    spec=qt.spec,
                )
            )
        self.trees = folded
        self.f0_raw = int(quantize_raw(np.asarray(self.f0), self.spec))

    def quantize_features(self, X: np.ndarray) -> np.ndarray:
        return quantize_raw(np.asarray(X, np.float64), self.spec)

    def decision_function_raw(self, X_raw: np.ndarray) -> np.ndarray:
        acc = np.full(len(X_raw), self.f0_raw, dtype=np.int64)
        for qt in self.trees:
            acc = acc + qt.predict_raw(X_raw)
        return acc

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return self.decision_function_raw(self.quantize_features(X)) / self.spec.scale

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return _sigmoid(self.decision_function(X))


# --------------------------------------------------------------------------
# Metrics (paper Table 1 vocabulary)
# --------------------------------------------------------------------------


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
