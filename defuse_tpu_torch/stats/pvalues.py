"""Empirical p-values for spanning and split-read statistics.

Closed-form replacements for the reference's three R scripts:

* spanning p-value — z-test of per-cluster mean fragment length against
  the library mean with variance ``sigma^2/n + (n-1)/n * cov``, with the
  fat-fragment correction branch (``scripts/evaluate_fraglength_mean.R``)
* split-position / split-minimum p-values
  (``scripts/evaluate_split.R``)
* covariance of resampled same-marker pairs
  (``scripts/merge_cov_samples.pl`` — Perl's hash order is
  non-deterministic, so the canonical contract here iterates markers in
  ascending order with an exact drand48 stream, seed 11)

All math is f64; ``pnorm``/``dnorm`` use erfc, matching R to ~1 ulp.
"""

from __future__ import annotations

import math

from .crand import Drand48


def pnorm(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def dnorm_log(x: float) -> float:
    return -0.5 * x * x - 0.5 * math.log(2.0 * math.pi)


def cov_samples_merge(samples_by_marker: dict[int, list[float]],
                      seed: int = 11):
    """(mean, covariance) of two random same-marker samples
    (``merge_cov_samples.pl:23-49``)."""
    rng = Drand48(seed)
    s1 = s2 = cross = 0.0
    count = 0.0
    for marker in sorted(samples_by_marker):
        samples = samples_by_marker[marker]
        if len(samples) < 2:
            continue
        a = samples[int(rng.drand() * len(samples))]
        b = samples[int(rng.drand() * len(samples))]
        s1 += a
        s2 += b
        cross += a * b
        count += 1
    if count <= 100:
        raise ValueError("not enough concordant read samples; set "
                         "multi_exon_transcripts_stats = yes")
    mean = (s1 + s2) / (2.0 * count)
    cov = (cross - s1 * s2 / count) / count
    return mean, cov


def load_cov_samples(path):
    """Vectorized load of a cov samples file (``marker\\tvalue`` rows,
    file order) into (int64 ids, float64 values) arrays.

    Decimal→double conversion must be correctly rounded (the merge is a
    bit-exact contract), so the pandas path pins
    ``float_precision="round_trip"`` and the fallback uses numpy's text
    parser (ascii_strtod).  Compression is sniffed from the magic bytes
    (never the extension — fallback writers may leave plain text at a
    .gz-named artifact)."""
    import numpy as np
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    try:
        import pandas as pd
        df = pd.read_csv(path, sep="\t", header=None,
                         dtype={0: np.int64, 1: np.float64},
                         compression="gzip" if gz else None,
                         float_precision="round_trip")
        return df[0].to_numpy(), df[1].to_numpy()
    except ImportError:
        if gz:
            import gzip
            text = gzip.open(path, "rt").read()
        else:
            text = open(path).read()
        flat = np.array(text.split(), dtype=np.float64)
        return flat[0::2].astype(np.int64), flat[1::2]


def cov_samples_merge_arrays(ids, values, seed: int = 11):
    """``cov_samples_merge`` over parallel (marker, value) arrays in
    file order — identical drand48 draw sequence and scalar
    accumulation order to the dict form (pinned by
    ``tests/test_stats_filters.py``), but with the grouping done by a
    stable argsort instead of a per-line Python dict."""
    import numpy as np
    ids = np.asarray(ids, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(ids, kind="stable")
    svals = values[order]
    _uniq, starts, counts = np.unique(ids[order], return_index=True,
                                      return_counts=True)
    rng = Drand48(seed)
    s1 = s2 = cross = 0.0
    count = 0.0
    for i in range(len(starts)):
        n = int(counts[i])
        if n < 2:
            continue
        base = int(starts[i])
        a = float(svals[base + int(rng.drand() * n)])
        b = float(svals[base + int(rng.drand() * n)])
        s1 += a
        s2 += b
        cross += a * b
        count += 1
    if count <= 100:
        raise ValueError("not enough concordant read samples; set "
                         "multi_exon_transcripts_stats = yes")
    mean = (s1 + s2) / (2.0 * count)
    cov = (cross - s1 * s2 / count) / count
    return mean, cov


def spanning_pvalue(span_mean: float, span_count: int,
                    fraglength_mean: float, fraglength_stddev: float,
                    covariance: float, readlength_max: int) -> float:
    """``evaluate_fraglength_mean.R`` for one cluster."""
    def _sqrt_r(x):
        # R semantics: sqrt of a negative is NaN (warning, not error).
        # A negative sample variance happens when the estimated
        # covariance is negative and span_count is large — the
        # reference script has no guard and emits NaN p-values there
        # (``evaluate_fraglength_mean.R:13-15``); crashing would be a
        # deviation.
        return math.sqrt(x) if x >= 0.0 else float("nan")

    var = fraglength_stddev ** 2
    sample_var = var / span_count \
        + (span_count - 1) * covariance / span_count
    z = (span_mean - fraglength_mean) / _sqrt_r(sample_var)
    pval = 2.0 * pnorm(-abs(z))

    fraglength_test = 1.0 - pnorm(
        (fraglength_mean - 2 * readlength_max) / fraglength_stddev)
    if fraglength_test >= 0.05:
        return pval

    # fat-fragment correction branch
    mean_adj = fraglength_mean + var / (fraglength_mean
                                        - 2 * readlength_max)
    var_adj = var - var ** 2 / (fraglength_mean
                                - 2 * readlength_max) ** 2
    sample_var_adj = var_adj / span_count \
        + (span_count - 1) * covariance / span_count
    z_adj = (span_mean - mean_adj) / _sqrt_r(sample_var_adj)
    pval_adj = 2.0 * pnorm(-abs(z_adj))

    prob = dnorm_log(z)
    prob_adj = dnorm_log(z_adj)
    # NaN-faithful blend (R: pval*(prob>prob_adj) + pval_adj*(...)):
    # a NaN z poisons the comparison exactly as in R, where NaN > x is
    # NA and the arithmetic blend propagates NaN
    if math.isnan(prob) or math.isnan(prob_adj):
        pvalue = float("nan")
    else:
        pvalue = pval if prob > prob_adj else pval_adj
    # R applies the in-range override AFTER the blend, even onto NaN
    if fraglength_mean <= span_mean <= mean_adj:
        pvalue = 1.0
    return pvalue


def split_pvalues(split_pos_avg: float, split_min_avg: float,
                  split_count: int, pos_covariance: float,
                  min_covariance: float):
    """``evaluate_split.R`` for one cluster; returns
    (split_pos_pvalue, split_min_pvalue)."""
    if split_count == 0:
        return 0.0, 0.0
    pos_p = 2.0 * pnorm(-abs(split_pos_avg - 0.5)
                        / math.sqrt(pos_covariance
                                    + 1.0 / (12.0 * split_count)))
    min_p = pnorm((split_min_avg - 0.5)
                  / math.sqrt(min_covariance
                              + 1.0 / (12.0 * split_count)))
    return pos_p, min_p
