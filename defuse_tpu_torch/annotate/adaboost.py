"""Adaboost fusion classifier — the ``scripts/run_adaboost.R`` equivalent.

Discrete AdaBoost over CART trees (gini, rpart-like stopping rules:
minsplit=20, minbucket=7, cp=0.01, maxdepth=30) trained at every run on
the bundled curated controls (60 TP / 61 FP, ``data/controls.txt``) using
the same 14 features (``run_adaboost.R:13-28``), emitting a
``probability`` column ``1/(1+exp(-2F))`` like the ``ada`` package's
``type="prob"``.

R's ``ada``+``rpart`` is not available in this environment; this is a
from-scratch implementation of the same published algorithms.  Scores are
behavior-compatible (same features, same training data, same boosting
scheme), not bit-identical to a particular R build.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

FEATURES = [
    "break_adj_entropy_min",
    "cdna_breakseqs_percident",
    "genome_breakseqs_percident",
    "est_breakseqs_percident",
    "splitr_span_pvalue",
    "splitr_pos_pvalue",
    "splitr_min_pvalue",
    "breakpoint_homology",
    "span_coverage_min",
    "breakseqs_estislands_percident",
    "num_splice_variants",
    "splice_score",
    "max_repeat_proportion",
    "mean_map_count",
]

CONTROLS_PATH = pathlib.Path(__file__).parent.parent / "data" / \
    "controls.txt"


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value=None, feature=None, threshold=None, left=None,
                 right=None):
        self.value = value
        self.feature = feature
        self.threshold = threshold
        self.left = left
        self.right = right


def _gini_split(x, y, w):
    """Best threshold for one feature by weighted gini decrease."""
    order = np.argsort(x, kind="stable")
    xs, ys, ws = x[order], y[order], w[order]
    total_w = ws.sum()
    total_pos = (ws * ys).sum()
    cum_w = np.cumsum(ws)
    cum_pos = np.cumsum(ws * ys)
    # candidate splits between distinct values
    distinct = np.nonzero(xs[:-1] != xs[1:])[0]
    if len(distinct) == 0:
        return None, None
    lw = cum_w[distinct]
    lp = cum_pos[distinct]
    rw = total_w - lw
    rp = total_pos - lp
    with np.errstate(divide="ignore", invalid="ignore"):
        gini_l = 1.0 - (lp / lw) ** 2 - (1 - lp / lw) ** 2
        gini_r = 1.0 - (rp / rw) ** 2 - (1 - rp / rw) ** 2
    impurity = (lw * gini_l + rw * gini_r) / total_w
    best = int(np.argmin(impurity))
    thr = 0.5 * (xs[distinct[best]] + xs[distinct[best] + 1])
    return float(impurity[best]), thr


def _build_tree(X, y, w, depth, *, minsplit=20, minbucket=7, cp=0.01,
                maxdepth=30, root_impurity=None):
    pos = (w * y).sum()
    tot = w.sum()
    p = pos / tot if tot > 0 else 0.0
    node_impurity = 1.0 - p * p - (1 - p) * (1 - p)
    if root_impurity is None:
        root_impurity = node_impurity * tot if node_impurity > 0 else 1.0

    leaf = _Node(value=1.0 if p >= 0.5 else 0.0)
    if depth >= maxdepth or len(y) < minsplit or node_impurity == 0.0:
        return leaf

    best = (None, None, None)
    for f in range(X.shape[1]):
        imp, thr = _gini_split(X[:, f], y, w)
        if imp is None:
            continue
        if best[0] is None or imp < best[0]:
            best = (imp, f, thr)
    if best[0] is None:
        return leaf
    # rpart-style cp stop: relative impurity decrease vs the root
    decrease = (node_impurity * tot - best[0] * tot)
    if decrease < cp * root_impurity:
        return leaf
    mask = X[:, best[1]] <= best[2]
    if mask.sum() < minbucket or (~mask).sum() < minbucket:
        return leaf
    left = _build_tree(X[mask], y[mask], w[mask], depth + 1,
                       minsplit=minsplit, minbucket=minbucket, cp=cp,
                       maxdepth=maxdepth, root_impurity=root_impurity)
    right = _build_tree(X[~mask], y[~mask], w[~mask], depth + 1,
                        minsplit=minsplit, minbucket=minbucket, cp=cp,
                        maxdepth=maxdepth, root_impurity=root_impurity)
    return _Node(feature=best[1], threshold=best[2], left=left, right=right)


def _predict_tree(node, X):
    if node.feature is None:
        return np.full(len(X), node.value)
    mask = X[:, node.feature] <= node.threshold
    out = np.empty(len(X))
    out[mask] = _predict_tree(node.left, X[mask])
    out[~mask] = _predict_tree(node.right, X[~mask])
    return out


class AdaBoostClassifier:
    """Stochastic discrete AdaBoost matching R ``ada()``'s DEFAULTS —
    the reference calls ``ada(controls_features, controls_class)`` with
    no arguments (``run_adaboost.R:33``), which means iter=50, nu=0.1
    (shrinkage) and bag.frac=0.5 (per-round weighted subsampling), per
    the ada package / JSS 2006 paper.  The shrunken, bagged ensemble has
    a much smoother probability surface than unshrunken AdaBoost: a
    single stump-threshold crossing moves the probability by
    ~tanh(nu*alpha) instead of cliffing from ~1.0 to ~0.1 (the round-2
    recall-decay-at-depth mechanism, see RECALL_DIAGNOSIS_r3.md).

    Deviation from the reference, documented: ``run_adaboost.R`` never
    seeds R's RNG, so the reference's probabilities differ run to run;
    we seed the subsampler (seed=11, the pipeline's srand constant) so
    results are reproducible."""

    def __init__(self, n_rounds: int = 50, nu: float = 0.1,
                 bag_frac: float = 0.5, seed: int = 11):
        self.n_rounds = n_rounds
        self.nu = nu
        self.bag_frac = bag_frac
        self.seed = seed
        self.trees: list = []
        self.alphas: list[float] = []

    def fit(self, X, y):
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        n = len(y)
        w = np.full(n, 1.0 / n)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        self.alphas = []
        for _ in range(self.n_rounds):
            if self.bag_frac < 1.0:
                m = max(2, int(n * self.bag_frac))
                idx = rng.choice(n, size=m, replace=False, p=w)
                tree = _build_tree(X[idx], y[idx],
                                   np.full(m, 1.0 / m), 0)
            else:
                tree = _build_tree(X, y, w, 0)
            pred = _predict_tree(tree, X)
            err = float(np.sum(w * (pred != y)))
            err = min(max(err, 1e-10), 1 - 1e-10)
            alpha = self.nu * 0.5 * math.log((1 - err) / err)
            if alpha <= 0.0:
                continue  # worse than chance on this subsample: drop
            self.trees.append(tree)
            self.alphas.append(alpha)
            w = w * np.exp(alpha * np.where(pred != y, 1.0, -1.0))
            w = w / w.sum()
        return self

    def decision(self, X):
        X = np.asarray(X, float)
        f = np.zeros(len(X))
        for tree, alpha in zip(self.trees, self.alphas):
            f += alpha * (2.0 * _predict_tree(tree, X) - 1.0)
        return f

    def predict_proba(self, X):
        """P(class=1) via the ada package's logistic link
        (probability = 1/(1+exp(-2F)))."""
        return 1.0 / (1.0 + np.exp(-2.0 * self.decision(X)))


def _read_table(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh if
                line.strip()]
    return header, rows


def load_controls(path=None):
    header, rows = _read_table(path or CONTROLS_PATH)
    idx = {name: header.index(name) for name in FEATURES}
    vidx = header.index("validated")
    X = np.array([[float(r[idx[f]]) for f in FEATURES] for r in rows])
    y = np.array([1.0 if r[vidx] == "Y" else 0.0 for r in rows])
    return X, y


def classify_results(results_path, out_path, controls_path=None,
                     n_rounds: int = 50, margin_seeds: int = 0):
    """Append a ``probability`` column to results.tsv
    (``run_adaboost.R``).

    ``margin_seeds > 0`` additionally appends ``probability_mean`` /
    ``probability_sd`` columns: the ensemble is refit ``margin_seeds``
    times with bagging seeds 0..N-1 (emulating the reference's
    UNSEEDED ``ada()`` bagging — ``run_adaboost.R`` never seeds R's
    RNG, so its probabilities vary run to run) and the per-row spread
    is reported.  A row whose mean sits near ``probability_threshold``
    or whose sd is large is a borderline call the reference could have
    kept or dropped depending on the run — the depth-driven filtered-
    recall band documented in RECALL_DIAGNOSIS_r4.md and MIGRATION.md
    ("classifier margins at depth").  The default (0) output is
    byte-identical to previous rounds: the ``probability`` column
    always comes from the canonical seed-11 fit.
    """
    header, rows = _read_table(results_path)
    if not rows:
        with open(out_path, "w") as out:
            out.write("\t".join(header) + "\n")
        return
    Xc, yc = load_controls(controls_path)
    model = AdaBoostClassifier(n_rounds).fit(Xc, yc)
    idx = {name: header.index(name) for name in FEATURES}
    X = np.array([[float(r[idx[f]]) for f in FEATURES] for r in rows])
    probs = model.predict_proba(X)
    extra_cols: list[str] = []
    extra_vals = None
    if margin_seeds > 0:
        sweep = np.stack([
            AdaBoostClassifier(n_rounds, seed=s).fit(Xc, yc)
            .predict_proba(X) for s in range(margin_seeds)])
        extra_cols = ["probability_mean", "probability_sd"]
        extra_vals = np.stack([sweep.mean(axis=0),
                               sweep.std(axis=0, ddof=0)], axis=1)
    with open(out_path, "w") as out:
        out.write("\t".join(header + ["probability"] + extra_cols) + "\n")
        for i, (r, p) in enumerate(zip(rows, probs)):
            cells = r + [f"{p:.15g}"]
            if extra_vals is not None:
                cells += [f"{v:.15g}" for v in extra_vals[i]]
            out.write("\t".join(cells) + "\n")
