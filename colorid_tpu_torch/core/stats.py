"""Bloom false-positive statistics and the classifier's significance test.

Replicates:
- ``false_prob`` (read_id_mt_pe.rs:695-698):
  (1 - e^{-(k(n+0.5))/(m-1)})^k.
- ``not_fp_significant`` (read_id_mt_pe.rs:168-181): a color's hit count is
  NOT significant when hits < n*p, or when hits > n*p and the binomial pmf
  at ``hits`` is >= fp_correct. (hits == n*p exactly => significant.)

The binomial pmf uses log-gamma like the `probability` crate; both agree to
double precision.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln


def false_prob(m: float, k: float, n: float) -> float:
    return (1.0 - math.exp(-(k * (n + 0.5)) / (m - 1.0))) ** k


def false_prob_map(
    colors_accession: dict[int, str],
    n_ref_kmers: dict[str, int],
    bloom_size: int,
    num_hash: int,
) -> dict[int, float]:
    """Per-color Bloom FP probability (read_id_mt_pe.rs:18-38)."""
    accession_color = {a: c for c, a in colors_accession.items()}
    return {
        accession_color[acc]: false_prob(float(bloom_size), float(num_hash), float(n))
        for acc, n in n_ref_kmers.items()
        if acc in accession_color
    }


def binom_pmf(n: np.ndarray, k: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Vectorized binomial pmf via log-gamma. Handles p in {0,1} edges."""
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logpmf = (
            gammaln(n + 1)
            - gammaln(k + 1)
            - gammaln(n - k + 1)
            + k * np.log(p)
            + (n - k) * np.log1p(-p)
        )
        pmf = np.exp(logpmf)
    pmf = np.where((p == 0.0), np.where(k == 0, 1.0, 0.0), pmf)
    pmf = np.where((p == 1.0), np.where(k == n, 1.0, 0.0), pmf)
    pmf = np.where(k > n, 0.0, pmf)
    return pmf


def not_fp_significant_mask(
    observations: np.ndarray,
    p_false: np.ndarray,
    taxon_hits: np.ndarray,
    fp_correct: float,
) -> np.ndarray:
    """True where the hit count is NOT significant."""
    obs = np.asarray(observations, dtype=np.float64)
    hits = np.asarray(taxon_hits, dtype=np.float64)
    p = np.asarray(p_false, dtype=np.float64)
    critical = obs * p
    mpf = binom_pmf(obs, hits, p)
    return (hits < critical) | ((hits > critical) & (mpf >= fp_correct))
