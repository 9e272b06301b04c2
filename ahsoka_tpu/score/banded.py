"""Banded pairwise scoring -> sparse edge list.

Reads in a chain matrix are ordered by first covered position, and a pair
can only have nonzero score if their position ranges overlap — so the
nonzero structure of the pair matrix is a (ragged) band around the
diagonal.  This module scores the band block-by-block on the device and
emits the sparse (u, v, w) edge list the sparse cluster-editing solver
consumes, never materialising the full [R, R] matrix: chains with 50k+
reads fit easily (the dense path needs O(R^2) memory).

Same per-position LLR weights as score/pairwise.py; block pairs use the
same HIGHEST-precision matmuls restricted to the two blocks' position
span.  Parity-tested against the dense path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.score.pairwise import (AlleleMatrix, estimate_error_rate,
                                       position_weights)
from ahsoka_tpu.utils.logging import get_logger

log = get_logger(__name__)

# running pow2 capacity guess for the packed edge fetch (bounded so an
# overshoot never inflates the transfer past ~50 MB)
_EDGE_GUESS = [1 << 20]


@functools.partial(jax.jit,
                   static_argnames=("block", "num_alleles", "min_overlap"))
def _block_scores_sliced(alleles_dev, r0, c0, w_agree, w_dis, *,
                         block: int, num_alleles: int, min_overlap: int):
    """Device-resident variant: slices the [R_pad, P] allele matrix on
    device (two scalar indices per call instead of re-uploading ~MB
    blocks over the host link)."""
    P = alleles_dev.shape[1]
    rows = jax.lax.dynamic_slice(alleles_dev, (r0, 0), (block, P))
    cols = jax.lax.dynamic_slice(alleles_dev, (c0, 0), (block, P))
    return _block_scores(rows, cols, w_agree, w_dis,
                         num_alleles=num_alleles, min_overlap=min_overlap)


@functools.partial(jax.jit,
                   static_argnames=("block", "num_alleles", "min_overlap"))
def _block_scores_wh_sliced(alleles_dev, r0, c0, pd, p_s, *, block: int,
                            num_alleles: int, min_overlap: int):
    P = alleles_dev.shape[1]
    rows = jax.lax.dynamic_slice(alleles_dev, (r0, 0), (block, P))
    cols = jax.lax.dynamic_slice(alleles_dev, (c0, 0), (block, P))
    return _block_scores_wh(rows, cols, pd, p_s, num_alleles=num_alleles,
                            min_overlap=min_overlap)


@functools.partial(jax.jit,
                   static_argnames=("block", "num_alleles", "min_overlap"))
def _block_scores_multi(alleles_dev, r0s, c0s, w_agree, w_dis, *,
                        block: int, num_alleles: int, min_overlap: int):
    """Many block pairs in ONE dispatch + fetch instead of one round
    trip per pair."""
    def one(r0, c0):
        P = alleles_dev.shape[1]
        rows = jax.lax.dynamic_slice(alleles_dev, (r0, 0), (block, P))
        cols = jax.lax.dynamic_slice(alleles_dev, (c0, 0), (block, P))
        return _block_scores(rows, cols, w_agree, w_dis,
                             num_alleles=num_alleles,
                             min_overlap=min_overlap)
    return jax.vmap(one)(r0s, c0s)


def _pack_block_edges(stack, r0s, c0s, R, k: int):
    """Device-side sparsification of a scored block-pair stack: the
    nonzero edges packed into ONE int32 buffer [cnt, flat_pos(k),
    w_bits(k)] (w bitcast f32->i32; (g, i, j) decode from flat_pos on
    host).  Replaces the dense [G, block, block] download (~100 MB per
    group on config2) with ~8 bytes per real edge, and moves the
    host-side triu/crop/nonzero sweep (scoring.edges) on device via the
    O(N) cumsum+scatter compaction (project/device.
    _compact_mask_scatter — jnp.nonzero would sort all G*B*B cells).
    Selection matches the host path exactly: strictly-upper within
    diagonal blocks, rows and cols clipped to R, zero scores dropped
    (out-of-band columns score exactly 0 under the min_overlap mask)."""
    from ahsoka_tpu.project.device import _compact_mask_scatter

    G, B, _ = stack.shape
    i = jnp.arange(B, dtype=jnp.int32)
    row_ok = (r0s[:, None] + i[None, :]) < R            # [G, B]
    col_ok = (c0s[:, None] + i[None, :]) < R
    mask = (stack != 0.0) & row_ok[:, :, None] & col_ok[:, None, :]
    diag = (r0s == c0s)[:, None, None]
    upper = i[None, :, None] < i[None, None, :]
    mask = mask & jnp.where(diag, upper, True)
    flatv = jax.lax.bitcast_convert_type(stack, jnp.int32).reshape(-1)
    return _compact_mask_scatter(flatv, mask.reshape(-1), k)


@functools.partial(jax.jit,
                   static_argnames=("block", "num_alleles", "min_overlap",
                                    "k", "whatshap"))
def _block_scores_multi_packed(alleles_dev, r0s, c0s, a1, a2, R, *,
                               block: int, num_alleles: int,
                               min_overlap: int, k: int, whatshap: bool):
    """Score a group of block pairs AND compact the nonzero edges in one
    device program (one transfer).  a1/a2 = (pd, p_s) in whatshap mode,
    (w_agree, w_dis) otherwise."""
    P = alleles_dev.shape[1]

    def one(r0, c0):
        rows = jax.lax.dynamic_slice(alleles_dev, (r0, 0), (block, P))
        cols = jax.lax.dynamic_slice(alleles_dev, (c0, 0), (block, P))
        if whatshap:
            return _block_scores_wh(rows, cols, a1, a2,
                                    num_alleles=num_alleles,
                                    min_overlap=min_overlap)
        return _block_scores(rows, cols, a1, a2, num_alleles=num_alleles,
                             min_overlap=min_overlap)

    stack = jax.vmap(one)(r0s, c0s)
    return _pack_block_edges(stack, r0s, c0s, R, k)


@functools.partial(jax.jit,
                   static_argnames=("block", "num_alleles", "min_overlap"))
def _block_scores_wh_multi(alleles_dev, r0s, c0s, pd, p_s, *, block: int,
                           num_alleles: int, min_overlap: int):
    def one(r0, c0):
        P = alleles_dev.shape[1]
        rows = jax.lax.dynamic_slice(alleles_dev, (r0, 0), (block, P))
        cols = jax.lax.dynamic_slice(alleles_dev, (c0, 0), (block, P))
        return _block_scores_wh(rows, cols, pd, p_s,
                                num_alleles=num_alleles,
                                min_overlap=min_overlap)
    return jax.vmap(one)(r0s, c0s)


@functools.partial(jax.jit, static_argnames=("shape",))
def _scatter_matrix(r, c, v, *, shape):
    """Device-side allele-matrix build from COO (uncovered = -1)."""
    return jnp.full(shape, -1, jnp.int16).at[r, c].set(v)


@functools.partial(jax.jit, static_argnames=("num_alleles", "min_overlap"))
def _block_scores(rows, cols, w_agree, w_dis, num_alleles: int,
                  min_overlap: int):
    """rows [BR, P], cols [BC, P] int16 alleles -> [BR, BC] scores with
    zeros where overlap < min_overlap."""
    hi = jax.lax.Precision.HIGHEST
    rmask = (rows >= 0).astype(jnp.float32)
    cmask = (cols >= 0).astype(jnp.float32)
    scores = jax.lax.dot_general(
        rmask * w_dis[None, :], cmask.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    diff_w = (w_agree - w_dis)[None, :]
    for a in range(num_alleles):
        r1 = (rows == a).astype(jnp.float32)
        c1 = (cols == a).astype(jnp.float32)
        scores += jax.lax.dot_general(
            r1 * diff_w, c1.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=hi)
    overlap = jax.lax.dot_general(
        rmask, cmask.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    return jnp.where(overlap < min_overlap, 0.0, scores)


@functools.partial(jax.jit, static_argnames=("num_alleles", "min_overlap"))
def _block_scores_wh(rows, cols, pd, p_s, num_alleles: int,
                     min_overlap: int):
    """WhatsHap-mode block: rows [BR, P], cols [BC, P] int16 alleles plus
    the per-position different-haplotype disagreement probability pd [P]
    and scalar p_s -> [BR, BC] binomial-LLR scores (score/whatshap.py)."""
    from ahsoka_tpu.score.pairwise import _EPS_CLIP

    hi = jax.lax.Precision.HIGHEST
    dot = lambda a, b: jax.lax.dot_general(  # noqa: E731
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    rmask = (rows >= 0).astype(jnp.float32)
    cmask = (cols >= 0).astype(jnp.float32)
    overlap = dot(rmask, cmask.T)
    agree = jnp.zeros_like(overlap)
    for a in range(num_alleles):
        agree += dot((rows == a).astype(jnp.float32),
                     (cols == a).astype(jnp.float32).T)
    pd_sum = dot(rmask * pd[None, :], cmask.T)
    ov = jnp.maximum(overlap, 1.0)
    p_d = jnp.clip(pd_sum / ov, p_s, 1.0 - _EPS_CLIP)
    d = overlap - agree
    scores = (d * jnp.log(p_s / p_d)
              + agree * jnp.log((1.0 - p_s) / (1.0 - p_d)))
    return jnp.where(overlap < min_overlap, 0.0, scores)


def score_pairs_banded(matrix: AlleleMatrix, config: PhasingConfig,
                       block: int = 1024, error_rate=None, mult=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse upper-triangle edges (u, v, w) with w != 0.

    Requires rows ordered by first covered position (the pipeline's
    matrices are; collapsed matrices inherit it — groups are ordered by
    first occurrence).  ``mult`` weights per-position statistics by row
    multiplicity (collapsed matrices, project/collapse.py); the
    pairwise block scores stay per-representative-row — the caller
    scales edges by m_u * m_v."""
    from ahsoka_tpu.utils import substage

    alleles = matrix.alleles
    R, P = alleles.shape
    whatshap = config.score_mode == "whatshap"
    with substage.timed("scoring.host_stats"):
        if whatshap:
            from ahsoka_tpu.score.whatshap import chain_p_s, position_pd
            # p_s estimation pairs rows quadratically -> estimate on a
            # row sample (like estimate_error_rate_banded); pd is linear
            # in R and uses the full matrix
            sm, smult = _row_sample(matrix, mult=mult)
            p_s = chain_p_s(sm, config, error_rate, mult=smult)
            pd = jnp.asarray(position_pd(matrix, config, p_s, mult=mult),
                             dtype=jnp.float32)
        else:
            eps = error_rate if error_rate is not None else (
                estimate_error_rate_banded(matrix, config, mult=mult)
                if config.estimate_error_rate else config.error_rate)
            w_agree, w_dis, _ = position_weights(matrix, config, eps,
                                                 mult=mult)
            w_agree = jnp.asarray(w_agree, dtype=jnp.float32)
            w_dis = jnp.asarray(w_dis, dtype=jnp.float32)

    r_nz, p_nz, v_nz = matrix.covered_coo()     # row-major
    row_start = np.searchsorted(r_nz, np.arange(R))
    row_end = np.searchsorted(r_nz, np.arange(R), side="right")
    has = row_end > row_start
    firsts = np.where(has, p_nz[np.minimum(row_start,
                                           max(len(p_nz) - 1, 0))], P)
    lasts = np.where(has, p_nz[np.maximum(row_end - 1, 0)], -1)
    num_alleles = max(int(v_nz.max(initial=-1)) + 1, 2)

    # one device-side build of the whole (row-padded) matrix from its
    # COO coordinates; block-group calls then pass offset vectors and
    # slice on device.  Padding rows are fully uncovered (-1), so their
    # scores zero out under min_overlap and never reach the nonzero
    # edge list.  (The dense [50k, 10k] int16 upload is ~0.03%
    # occupied.)
    R_pad = ((R + block - 1) // block) * block
    with substage.timed("scoring.upload"):
        alleles_dev = _scatter_matrix(
            r_nz.astype(np.int32), p_nz.astype(np.int32),
            v_nz, shape=(R_pad, P))

    # enumerate the band's block pairs, then score them in groups of K
    # with ONE dispatch + fetch per group instead of one round trip per
    # pair
    pairs = []                         # (r0, r1, c0, c1)
    num_blocks = (R + block - 1) // block
    for bi in range(num_blocks):
        r0, r1 = bi * block, min((bi + 1) * block, R)
        # columns that can overlap rows of this block: first[j] <= max last
        max_last = int(lasts[r0:r1].max(initial=-1))
        j_end = int(np.searchsorted(firsts, max_last, side="right"))
        j_end = max(j_end, r1)
        for c0 in range(r0, j_end, block):
            c1 = min(c0 + block, j_end, R)
            if c0 < c1:
                pairs.append((r0, r1, c0, c1))
    group = max(1, (96 << 20) // (block * block * 4))
    log.info("banded scoring: %d reads, %d block pairs in groups of %d",
             R, len(pairs), group)

    a1, a2 = ((pd, jnp.float32(p_s)) if whatshap
              else (w_agree, w_dis))
    us, vs, ws = [], [], []
    for lo in range(0, len(pairs), group):
        batch = pairs[lo:lo + group]
        r0s = np.asarray([p[0] for p in batch], dtype=np.int32)
        c0s = np.asarray([p[2] for p in batch], dtype=np.int32)
        with substage.timed("scoring.device"):
            k = _EDGE_GUESS[0]
            arr = np.asarray(_block_scores_multi_packed(
                alleles_dev, r0s, c0s, a1, a2, jnp.int32(R),
                block=block, num_alleles=num_alleles,
                min_overlap=config.min_overlap, k=k, whatshap=whatshap))
            substage.add("scoring.fetch_calls", 1.0)
            cnt = int(arr[0])
            if cnt > k:
                k = 1 << max(cnt - 1, 1).bit_length()
                arr = np.asarray(_block_scores_multi_packed(
                    alleles_dev, r0s, c0s, a1, a2, jnp.int32(R),
                    block=block, num_alleles=num_alleles,
                    min_overlap=config.min_overlap, k=k,
                    whatshap=whatshap))
                substage.add("scoring.fetch_calls", 1.0)
            _EDGE_GUESS[0] = int(np.clip(
                1 << max(2 * cnt - 1, 1).bit_length(), 1 << 16, 1 << 22))
        with substage.timed("scoring.edges"):
            if cnt:
                pos = arr[1:1 + cnt].astype(np.int64)
                g, rem = pos // (block * block), pos % (block * block)
                us.append(r0s[g] + rem // block)
                vs.append(c0s[g] + rem % block)
                ws.append(arr[1 + k:1 + k + cnt].view(np.float32))
    if not us:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    return (np.concatenate(us),
            np.concatenate(vs),
            np.concatenate(ws).astype(np.float64))


def _row_sample(matrix: AlleleMatrix, sample: int = 2048, mult=None):
    """Evenly spaced row subset for quadratic-cost estimators.
    Returns (matrix, mult) with mult sampled consistently (or None)."""
    if matrix.num_reads <= sample:
        return matrix, mult
    idx = np.linspace(0, matrix.num_reads - 1, sample).astype(int)
    sm = AlleleMatrix(alleles=matrix.alleles[idx],
                      positions=matrix.positions,
                      read_names=[matrix.read_names[i] for i in idx])
    return sm, (mult[idx] if mult is not None else None)


def estimate_error_rate_banded(matrix: AlleleMatrix,
                               config: PhasingConfig,
                               sample: int = 2048, mult=None) -> float:
    """eps estimation on a row sample (the dense estimator builds [R, R])."""
    sm, smult = _row_sample(matrix, sample, mult=mult)
    return estimate_error_rate(sm, config, mult=smult)
