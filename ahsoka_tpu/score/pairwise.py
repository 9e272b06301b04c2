"""Pairwise same-haplotype read scoring.

Role parity: the reference calls WhatsHap's ``ReadScoring::scoreReadsetLocal
(&sim, testset, minOverlap=1, ploidy)`` (src/alignmentstoreadset.cpp:308-311)
to fill a sparse matrix of log-likelihood-ratio scores over read pairs, from
allele agreement counts with locally estimated error/allele rates.

This module is a fresh derivation of that score with the math arranged as
*position-weighted matmuls*, so the identical formulation runs as the host
oracle (numpy) and as a device tensor program (score/device.py):

For reads i, j overlapping in o >= min_overlap positions:

    score(i,j) = sum_{p in overlap} [ agree_p * log((1-d_s)/(1-d_d(p)))
                                    + disagree_p * log(d_s/d_d(p)) ]

where d_s = P(disagree | same haplotype) = 2*eps*(1-eps) from the
per-position allele error rate eps, and d_d(p) = P(disagree | different
haplotypes) = h_p*(1-d_s) + (1-h_p)*d_s with h_p the probability two
distinct haplotypes differ at p, estimated from the local allele
frequencies: h_p = clip((1 - sum_a f_{p,a}^2) * k/(k-1)).

Positive score => likely same haplotype.  Because the per-position weights
w_agree(p), w_dis(p) depend only on p, the pair matrix factorises into two
matmuls over the (reads x positions[ x alleles]) one-hot projections:

    S = (M .* w_dis) @ M^T + sum_a (O_a .* (w_agree - w_dis)) @ O_a^T

with M the coverage mask and O the allele one-hot — plain matmuls
(SURVEY.md §7 layer 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.project.readset import ReadSet

_EPS_CLIP = 1e-4


@dataclasses.dataclass
class AlleleMatrix:
    """Dense (reads x positions) allele matrix with -1 for uncovered."""
    alleles: np.ndarray          # int16 [R, P], -1 = not covered
    positions: np.ndarray        # int32 [P] original bubble positions
    read_names: list
    # lazy covered-entry COO cache (see covered_coo)
    _coo: "tuple | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    def covered_coo(self):
        """(r_nz, p_nz, values) of the covered entries, row-major,
        computed once: the coverage cap, identical-read collapsing,
        banded scoring, and the whatshap position statistics each
        re-scanned config2's 1 GB matrix for the same nonzero set
        (~1.2 s per scan on this host)."""
        if self._coo is None:
            r, p = np.nonzero(self.alleles >= 0)
            self._coo = (r, p, self.alleles[r, p])
        return self._coo

    @property
    def num_reads(self) -> int:
        return self.alleles.shape[0]

    @property
    def num_positions(self) -> int:
        return self.alleles.shape[1]

    @property
    def num_alleles(self) -> int:
        return int(self.alleles.max(initial=-1)) + 1


def readset_to_matrix(readset: ReadSet) -> AlleleMatrix:
    positions = readset.positions()
    pos_index = {p: j for j, p in enumerate(positions)}
    mat = np.full((len(readset), len(positions)), -1, dtype=np.int16)
    for i, read in enumerate(readset):
        for p, a in zip(read.positions, read.alleles):
            mat[i, pos_index[p]] = a
    return AlleleMatrix(alleles=mat,
                        positions=np.asarray(positions, dtype=np.int32),
                        read_names=[r.name for r in readset])


def position_weights(matrix: AlleleMatrix, config: PhasingConfig,
                     error_rate: Optional[float] = None,
                     mult: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Per-position log-weights (w_agree, w_dis) and the error rate used.
    ``mult`` weights rows by multiplicity (identical-read collapsing)."""
    alleles, mask = matrix.alleles, matrix.alleles >= 0
    eps = error_rate if error_rate is not None else (
        estimate_error_rate(matrix, config, mult=mult)
        if config.estimate_error_rate else config.error_rate)
    d_same = 2.0 * eps * (1.0 - eps)
    d_same = float(np.clip(d_same, _EPS_CLIP, 0.5 - _EPS_CLIP))

    # local allele frequencies per position: O(nnz) bincount (rows are
    # position-sparse; dense per-allele passes cost seconds at [50k, 10k])
    num_alleles = max(matrix.num_alleles, 2)
    r_nz, p_nz = np.nonzero(mask)
    a_nz = alleles[r_nz, p_nz].astype(np.int64)
    w = None if mult is None else mult[r_nz].astype(np.float64)
    counts = np.bincount(
        p_nz.astype(np.int64) * num_alleles + a_nz, weights=w,
        minlength=matrix.num_positions * num_alleles
    ).reshape(matrix.num_positions, num_alleles).astype(np.float64)
    totals = np.maximum(counts.sum(axis=1), 1.0)
    freqs = counts / totals[:, None]
    k = config.ploidy
    het = (1.0 - (freqs ** 2).sum(axis=1)) * (k / max(k - 1, 1))
    het = np.clip(het, _EPS_CLIP, 1.0 - _EPS_CLIP)
    d_diff = het * (1.0 - d_same) + (1.0 - het) * d_same
    d_diff = np.clip(d_diff, _EPS_CLIP, 1.0 - _EPS_CLIP)

    w_agree = np.log((1.0 - d_same) / (1.0 - d_diff))
    w_dis = np.log(d_same / d_diff)
    return w_agree.astype(np.float64), w_dis.astype(np.float64), eps


def estimate_error_rate(matrix: AlleleMatrix,
                        config: PhasingConfig,
                        mult: Optional[np.ndarray] = None) -> float:
    """Estimate eps from the low mode of the pairwise disagreement-rate
    distribution (same-haplotype pairs disagree at rate ~2*eps*(1-eps)).

    With ``mult`` (collapsed matrices) the quantile is taken over the
    implied full pair multiset — each group pair weighted by its exact
    pair count, within-group pairs at rate 0 — matching the uncollapsed
    estimator exactly (weighted percentile with the same linear
    interpolation semantics as np.percentile)."""
    overlap, agree = overlap_and_agreement(matrix)
    if mult is None:
        iu = np.triu_indices(matrix.num_reads, k=1)
        o, a = overlap[iu], agree[iu]
        valid = o >= max(config.min_overlap, 2)
        if not valid.any():
            return config.error_rate
        rates = (o[valid] - a[valid]) / o[valid]
        d_same = float(np.percentile(rates, 25.0))
    else:
        iu = np.triu_indices(matrix.num_reads, k=0)
        o, a = overlap[iu], agree[iu]
        m_u, m_v = mult[iu[0]], mult[iu[1]]
        w = np.where(iu[0] == iu[1], m_u * (m_u - 1) // 2, m_u * m_v)
        valid = (o >= max(config.min_overlap, 2)) & (w > 0)
        if not valid.any():
            return config.error_rate
        rates = (o[valid] - a[valid]) / o[valid]
        d_same = _weighted_percentile(rates, w[valid].astype(np.int64),
                                      25.0)
    d_same = min(max(d_same, 2 * _EPS_CLIP), 0.45)
    eps = 0.5 * (1.0 - np.sqrt(max(1.0 - 2.0 * d_same, 0.0)))
    return float(np.clip(eps, 1e-3, 0.3))


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         q: float) -> float:
    """np.percentile (linear interpolation) over the expanded multiset
    where values[i] repeats weights[i] times, without materialising it."""
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    n = int(w.sum())
    pos = (n - 1) * (q / 100.0)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    cum = np.cumsum(w)
    v_lo = v[np.searchsorted(cum, lo, side="right")]
    v_hi = v[np.searchsorted(cum, hi, side="right")]
    return float(v_lo + (v_hi - v_lo) * (pos - lo))


def overlap_and_agreement(matrix: AlleleMatrix
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Pair overlap / agreement counts ([R, R] float64).

    The matmuls run in float32 and cast up afterwards: every operand is
    0/1 and every partial sum is an integer < 2^24 (counts are bounded
    by P), so float32 accumulation is EXACT and the cast reproduces the
    float64 matmul bit for bit — at 2-4x the numpy throughput (this is
    the hot term of the sampled p_s estimator on 10k-position chains)."""
    mask = (matrix.alleles >= 0).astype(np.float32)
    overlap = (mask @ mask.T).astype(np.float64)
    agree = np.zeros_like(overlap)
    for a in range(matrix.num_alleles):
        onehot = (matrix.alleles == a).astype(np.float32)
        agree += (onehot @ onehot.T).astype(np.float64)
    return overlap, agree


def score_pairs(matrix: AlleleMatrix, config: PhasingConfig,
                error_rate: Optional[float] = None,
                mult: Optional[np.ndarray] = None) -> np.ndarray:
    """Symmetric [R, R] score matrix; exactly 0 where overlap < min_overlap
    (and on the diagonal).  Dispatches on ``config.score_mode``:
    "whatshap" = the published scoreReadsetLocal algorithm
    (score/whatshap.py), "fresh" = this module's derivation.  ``mult``
    weights per-position statistics by row multiplicity (collapsed
    matrices, project/collapse.py)."""
    if config.score_mode == "whatshap":
        from ahsoka_tpu.score.whatshap import score_pairs_whatshap
        return score_pairs_whatshap(matrix, config, error_rate, mult=mult)
    w_agree, w_dis, _ = position_weights(matrix, config, error_rate,
                                         mult=mult)
    mask = (matrix.alleles >= 0).astype(np.float64)
    scores = (mask * w_dis) @ mask.T
    diff_w = w_agree - w_dis
    for a in range(matrix.num_alleles):
        onehot = (matrix.alleles == a).astype(np.float64)
        scores += (onehot * diff_w) @ onehot.T
    overlap = mask @ mask.T
    scores[overlap < config.min_overlap] = 0.0
    np.fill_diagonal(scores, 0.0)
    return scores
