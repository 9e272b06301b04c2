"""Pairwise read scoring on the device.

Same formulation as score/pairwise.py (the host oracle), with the pair
matrix produced by two matmuls over the (reads x positions[/alleles])
projections.  Reads are padded to matmul-friendly multiples; per-position
weights are computed on device from the allele matrix.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.score.pairwise import (AlleleMatrix, estimate_error_rate,
                                       _EPS_CLIP)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _score_core(alleles, eps, num_alleles: int, ploidy: int,
                min_overlap: int, mult=None):
    """[R, P] int alleles (-1 uncovered, padded rows/cols -1) -> [R, R].
    ``mult`` [R] weights rows in the per-position statistics (collapsed
    matrices, project/collapse.py; padded rows weight 0)."""
    mask = (alleles >= 0).astype(jnp.float32)

    d_same = jnp.clip(2.0 * eps * (1.0 - eps), _EPS_CLIP, 0.5 - _EPS_CLIP)
    if mult is None:
        counts = jnp.stack(
            [(alleles == a).sum(axis=0) for a in range(num_alleles)],
            axis=1).astype(jnp.float32)                 # [P, A]
    else:
        counts = jnp.stack(
            [((alleles == a) * mult[:, None]).sum(axis=0)
             for a in range(num_alleles)],
            axis=1).astype(jnp.float32)                 # [P, A]
    totals = jnp.maximum(counts.sum(axis=1), 1.0)
    freqs = counts / totals[:, None]
    k = ploidy
    het = (1.0 - (freqs ** 2).sum(axis=1)) * (k / max(k - 1, 1))
    het = jnp.clip(het, _EPS_CLIP, 1.0 - _EPS_CLIP)
    d_diff = jnp.clip(het * (1.0 - d_same) + (1.0 - het) * d_same,
                      _EPS_CLIP, 1.0 - _EPS_CLIP)
    w_agree = jnp.log((1.0 - d_same) / (1.0 - d_diff))
    w_dis = jnp.log(d_same / d_diff)

    hi = jax.lax.Precision.HIGHEST
    scores = jax.lax.dot_general(
        mask * w_dis[None, :], mask.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    diff_w = (w_agree - w_dis)[None, :]
    for a in range(num_alleles):
        onehot = (alleles == a).astype(jnp.float32)
        scores += jax.lax.dot_general(
            onehot * diff_w, onehot.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=hi)
    overlap = jax.lax.dot_general(
        mask, mask.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    scores = jnp.where(overlap < min_overlap, 0.0, scores)
    r = scores.shape[0]
    eye = jnp.eye(r, dtype=bool)
    return jnp.where(eye, 0.0, scores)


def _score_core_wh(alleles, p_s, num_alleles: int, ploidy: int,
                   min_overlap: int, mult=None):
    """WhatsHap-published scoring (score/whatshap.py) as matmuls:
    [R, P] int alleles (-1 uncovered, padded rows/cols -1) -> [R, R].
    ``p_s`` is the host-estimated same-haplotype disagreement rate.
    ``mult`` [R] weights rows in the per-position statistics (collapsed
    matrices; padded rows weight 0)."""
    mask = (alleles >= 0).astype(jnp.float32)
    if mult is None:
        counts = jnp.stack(
            [(alleles == a).sum(axis=0) for a in range(num_alleles)],
            axis=1).astype(jnp.float32)                 # [P, A]
    else:
        counts = jnp.stack(
            [((alleles == a) * mult[:, None]).sum(axis=0)
             for a in range(num_alleles)],
            axis=1).astype(jnp.float32)                 # [P, A]

    # greedy ML slot allocation of `ploidy` haplotypes to alleles
    # (static unroll; exactly the host oracle's haplotype_multiplicities)
    c = jnp.zeros_like(counts)
    for _ in range(ploidy):
        grown = counts * jnp.log1p(1.0 / jnp.maximum(c, 1.0))
        eligible0 = (c == 0) & (counts > 0)
        gain = jnp.where(eligible0.any(axis=1)[:, None],
                         jnp.where(eligible0, counts, -jnp.inf),
                         grown)
        best = jnp.argmax(gain, axis=1)
        c = c + jax.nn.one_hot(best, num_alleles, dtype=counts.dtype)
    if ploidy >= 2:
        same = (c * (c - 1.0)).sum(axis=1) / (ploidy * (ploidy - 1.0))
        differ = jnp.clip(1.0 - same, 0.0, 1.0)
    else:
        differ = jnp.zeros((counts.shape[0],), jnp.float32)
    pd = differ * (1.0 - p_s) + (1.0 - differ) * p_s

    hi = jax.lax.Precision.HIGHEST
    dot = lambda a, b: jax.lax.dot_general(  # noqa: E731
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    overlap = dot(mask, mask.T)
    agree = jnp.zeros_like(overlap)
    for a in range(num_alleles):
        onehot = (alleles == a).astype(jnp.float32)
        agree += dot(onehot, onehot.T)
    pd_sum = dot(mask * pd[None, :], mask.T)

    ov = jnp.maximum(overlap, 1.0)
    p_d = jnp.clip(pd_sum / ov, p_s, 1.0 - _EPS_CLIP)
    d = overlap - agree
    scores = (d * jnp.log(p_s / p_d)
              + agree * jnp.log((1.0 - p_s) / (1.0 - p_d)))
    scores = jnp.where(overlap < min_overlap, 0.0, scores)
    eye = jnp.eye(scores.shape[0], dtype=bool)
    return jnp.where(eye, 0.0, scores)


def _score_rows_core(rows, full, eps, row0, num_alleles: int, ploidy: int,
                     min_overlap: int):
    """Row-block variant of _score_core for the data-sharded pair matrix
    (SURVEY.md §2c "pairwise-score partials"): scores the [Rb, R] block
    whose global rows start at ``row0``.  Per-position stats come from
    the FULL (replicated) allele matrix, so with row0=0 and rows==full
    this is exactly _score_core — row blocks only split the output
    matmuls, whose rows are independent dot products."""
    mask_r = (rows >= 0).astype(jnp.float32)
    mask_f = (full >= 0).astype(jnp.float32)

    d_same = jnp.clip(2.0 * eps * (1.0 - eps), _EPS_CLIP, 0.5 - _EPS_CLIP)
    counts = jnp.stack(
        [(full == a).sum(axis=0) for a in range(num_alleles)],
        axis=1).astype(jnp.float32)                     # [P, A]
    totals = jnp.maximum(counts.sum(axis=1), 1.0)
    freqs = counts / totals[:, None]
    k = ploidy
    het = (1.0 - (freqs ** 2).sum(axis=1)) * (k / max(k - 1, 1))
    het = jnp.clip(het, _EPS_CLIP, 1.0 - _EPS_CLIP)
    d_diff = jnp.clip(het * (1.0 - d_same) + (1.0 - het) * d_same,
                      _EPS_CLIP, 1.0 - _EPS_CLIP)
    w_agree = jnp.log((1.0 - d_same) / (1.0 - d_diff))
    w_dis = jnp.log(d_same / d_diff)

    hi = jax.lax.Precision.HIGHEST
    dot = lambda a, b: jax.lax.dot_general(  # noqa: E731
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    scores = dot(mask_r * w_dis[None, :], mask_f.T)
    diff_w = (w_agree - w_dis)[None, :]
    for a in range(num_alleles):
        oh_r = (rows == a).astype(jnp.float32)
        oh_f = (full == a).astype(jnp.float32)
        scores += dot(oh_r * diff_w, oh_f.T)
    overlap = dot(mask_r, mask_f.T)
    scores = jnp.where(overlap < min_overlap, 0.0, scores)
    eye = (row0 + jnp.arange(rows.shape[0]))[:, None] \
        == jnp.arange(full.shape[0])[None, :]
    return jnp.where(eye, 0.0, scores)


def _score_rows_core_wh(rows, full, p_s, row0, num_alleles: int,
                        ploidy: int, min_overlap: int):
    """Row-block variant of _score_core_wh (same contract as
    _score_rows_core)."""
    mask_r = (rows >= 0).astype(jnp.float32)
    mask_f = (full >= 0).astype(jnp.float32)
    counts = jnp.stack(
        [(full == a).sum(axis=0) for a in range(num_alleles)],
        axis=1).astype(jnp.float32)                     # [P, A]

    c = jnp.zeros_like(counts)
    for _ in range(ploidy):
        grown = counts * jnp.log1p(1.0 / jnp.maximum(c, 1.0))
        eligible0 = (c == 0) & (counts > 0)
        gain = jnp.where(eligible0.any(axis=1)[:, None],
                         jnp.where(eligible0, counts, -jnp.inf),
                         grown)
        best = jnp.argmax(gain, axis=1)
        c = c + jax.nn.one_hot(best, num_alleles, dtype=counts.dtype)
    if ploidy >= 2:
        same = (c * (c - 1.0)).sum(axis=1) / (ploidy * (ploidy - 1.0))
        differ = jnp.clip(1.0 - same, 0.0, 1.0)
    else:
        differ = jnp.zeros((counts.shape[0],), jnp.float32)
    pd = differ * (1.0 - p_s) + (1.0 - differ) * p_s

    hi = jax.lax.Precision.HIGHEST
    dot = lambda a, b: jax.lax.dot_general(  # noqa: E731
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=hi)
    overlap = dot(mask_r, mask_f.T)
    agree = jnp.zeros_like(overlap)
    for a in range(num_alleles):
        oh_r = (rows == a).astype(jnp.float32)
        oh_f = (full == a).astype(jnp.float32)
        agree += dot(oh_r, oh_f.T)
    pd_sum = dot(mask_r * pd[None, :], mask_f.T)

    ov = jnp.maximum(overlap, 1.0)
    p_d = jnp.clip(pd_sum / ov, p_s, 1.0 - _EPS_CLIP)
    d = overlap - agree
    scores = (d * jnp.log(p_s / p_d)
              + agree * jnp.log((1.0 - p_s) / (1.0 - p_d)))
    scores = jnp.where(overlap < min_overlap, 0.0, scores)
    eye = (row0 + jnp.arange(rows.shape[0]))[:, None] \
        == jnp.arange(full.shape[0])[None, :]
    return jnp.where(eye, 0.0, scores)


_score_kernel = functools.partial(
    jax.jit, static_argnames=("num_alleles", "ploidy", "min_overlap"))(
    _score_core)

_score_kernel_wh = functools.partial(
    jax.jit, static_argnames=("num_alleles", "ploidy", "min_overlap"))(
    _score_core_wh)


@functools.partial(jax.jit,
                   static_argnames=("num_alleles", "ploidy", "min_overlap"))
def _score_kernel_vmapped(alleles, eps, mult=None, *, num_alleles: int,
                          ploidy: int, min_overlap: int):
    """Leading chain axis on alleles [C, R, P], eps [C], mult [C, R]."""
    if mult is None:
        return jax.vmap(lambda a, e: _score_core(
            a, e, num_alleles=num_alleles, ploidy=ploidy,
            min_overlap=min_overlap))(alleles, eps)
    return jax.vmap(lambda a, e, m: _score_core(
        a, e, num_alleles=num_alleles, ploidy=ploidy,
        min_overlap=min_overlap, mult=m))(alleles, eps, mult)


@functools.partial(jax.jit,
                   static_argnames=("num_alleles", "ploidy", "min_overlap"))
def _score_kernel_wh_vmapped(alleles, p_s, mult=None, *, num_alleles: int,
                             ploidy: int, min_overlap: int):
    """Leading chain axis on alleles [C, R, P], p_s [C], mult [C, R]."""
    if mult is None:
        return jax.vmap(lambda a, e: _score_core_wh(
            a, e, num_alleles=num_alleles, ploidy=ploidy,
            min_overlap=min_overlap))(alleles, p_s)
    return jax.vmap(lambda a, e, m: _score_core_wh(
        a, e, num_alleles=num_alleles, ploidy=ploidy,
        min_overlap=min_overlap, mult=m))(alleles, p_s, mult)


def _padded_alleles(matrix: AlleleMatrix) -> np.ndarray:
    R, P = matrix.alleles.shape
    # power-of-two buckets: chains of similar size share a compiled kernel
    R_pad = 64
    while R_pad < R:
        R_pad *= 2
    P_pad = 128
    while P_pad < P:
        P_pad *= 2
    alleles = np.full((R_pad, P_pad), -1, dtype=np.int16)
    alleles[:R, :P] = matrix.alleles
    return alleles


def _padded_mult(mult: np.ndarray, R_pad: int) -> np.ndarray:
    out = np.zeros(R_pad, dtype=np.float32)
    out[:len(mult)] = mult
    return out


def _chain_eps(matrix: AlleleMatrix, config: PhasingConfig,
               error_rate=None) -> float:
    if error_rate is not None:
        return error_rate
    return (estimate_error_rate(matrix, config)
            if config.estimate_error_rate else config.error_rate)


def _chain_scalar(matrix: AlleleMatrix, config: PhasingConfig,
                  error_rate=None, mult=None) -> float:
    """The per-chain scalar the active mode's kernel takes: eps for
    "fresh", the estimated p_s for "whatshap" (both host-estimated).
    ``mult`` makes the estimation multiplicity-weighted (collapsed
    matrices) — byte-equal to estimating on the full matrix."""
    if config.score_mode == "whatshap":
        from ahsoka_tpu.score.whatshap import chain_p_s
        return chain_p_s(matrix, config, error_rate, mult=mult)
    if mult is not None and error_rate is None \
            and config.estimate_error_rate:
        from ahsoka_tpu.score.pairwise import estimate_error_rate
        return estimate_error_rate(matrix, config, mult=mult)
    return _chain_eps(matrix, config, error_rate)


def _kernels(config: PhasingConfig):
    if config.score_mode == "whatshap":
        return _score_kernel_wh, _score_kernel_wh_vmapped
    return _score_kernel, _score_kernel_vmapped


def score_pairs_device(matrix: AlleleMatrix, config: PhasingConfig,
                       error_rate=None, mult=None) -> np.ndarray:
    """Drop-in replacement for score_pairs (float32 matmuls; tests
    assert agreement with the float64 host oracle to ~1e-3).  ``mult``
    weights per-position statistics by row multiplicity (collapsed
    matrices, project/collapse.py); the sharded path does not take it
    (collapse happens upstream of sharded scoring)."""
    scalar = _chain_scalar(matrix, config, error_rate, mult=mult)
    kernel, _ = _kernels(config)
    R = matrix.alleles.shape[0]
    alleles = _padded_alleles(matrix)
    if mult is not None:
        out = kernel(alleles, jnp.float32(scalar),
                     num_alleles=max(matrix.num_alleles, 2),
                     ploidy=config.ploidy,
                     min_overlap=config.min_overlap,
                     mult=jnp.asarray(_padded_mult(mult,
                                                   alleles.shape[0])))
        return np.asarray(out[:R, :R]).astype(np.float64)
    shards = max(int(getattr(config, "data_shards", 1)), 1)
    if (shards > 1 and len(jax.devices()) >= shards
            and alleles.shape[0] % shards == 0):
        # data-parallel scoring: row blocks of the pair matrix shard
        # over the mesh (identical values; tests assert exact equality)
        from ahsoka_tpu.dist.mesh import fetch_global, make_mesh
        from ahsoka_tpu.dist.step import sharded_score_pairs

        mesh = make_mesh(data=shards, chain=1,
                         devices=jax.devices()[:shards])
        out = sharded_score_pairs(
            mesh, alleles, scalar,
            num_alleles=max(matrix.num_alleles, 2),
            ploidy=config.ploidy, min_overlap=config.min_overlap,
            mode=config.score_mode)
        return fetch_global(out)[:R, :R].astype(np.float64)
    out = kernel(alleles, jnp.float32(scalar),
                 num_alleles=max(matrix.num_alleles, 2),
                 ploidy=config.ploidy,
                 min_overlap=config.min_overlap)
    # slice on device, fetch only real rows/cols (host link = bottleneck)
    return np.asarray(out[:R, :R]).astype(np.float64)


# transfer budget per batched call (upload + download bytes); see
# project/device.py
_BATCH_TRANSFER_BUDGET = 96 * 1024 * 1024


def score_pairs_device_many(matrices, config: PhasingConfig, mults=None):
    """Score MANY chains in few device calls (grouped by padded shape +
    allele count, one vmapped kernel per group, split by transfer
    budget).  Same values as per-chain score_pairs_device.  ``mults`` is
    an optional per-chain list of row-multiplicity vectors (None entries
    = unweighted) for collapsed matrices."""
    from ahsoka_tpu.utils import substage

    shards = max(int(getattr(config, "data_shards", 1)), 1)
    if mults is None:
        mults = [None] * len(matrices)
    results = [None] * len(matrices)
    todo = range(len(matrices))
    if shards > 1 and len(jax.devices()) >= shards:
        # unweighted chains take the per-chain path, whose row sharding
        # owns the device axis; collapsed chains never shard and batch
        # exactly as on one device (same programs, same bits)
        for i in todo:
            if mults[i] is None:
                results[i] = score_pairs_device(matrices[i], config)
        todo = [i for i in todo if mults[i] is not None]
    with substage.timed("scoring.pack"):
        padded = {i: _padded_alleles(matrices[i]) for i in todo}
    kernel, kernel_vmapped = _kernels(config)
    with substage.timed("scoring.host_stats"):
        eps = {i: np.float32(_chain_scalar(matrices[i], config,
                                           mult=mults[i]))
               for i in todo}
    groups = {}
    for idx in todo:
        groups.setdefault((padded[idx].shape,
                           max(matrices[idx].num_alleles, 2),
                           mults[idx] is not None), []).append(idx)
    for ((R_pad, P_pad), num_alleles, weighted), idxs in groups.items():
        per_chain = R_pad * P_pad * 2 + R_pad * R_pad * 4
        cap = max(1, _BATCH_TRANSFER_BUDGET // per_chain)
        for lo in range(0, len(idxs), cap):
            batch = idxs[lo:lo + cap]
            if len(batch) == 1:
                i = batch[0]
                kw = ({"mult": jnp.asarray(_padded_mult(mults[i], R_pad))}
                      if weighted else {})
                with substage.timed("scoring.device"):
                    out = kernel(padded[i], jnp.float32(eps[i]),
                                 num_alleles=num_alleles,
                                 ploidy=config.ploidy,
                                 min_overlap=config.min_overlap, **kw)
                    R = matrices[i].alleles.shape[0]
                    results[i] = np.asarray(out,
                                            dtype=np.float64)[:R, :R]
                continue
            with substage.timed("scoring.pack"):
                stacked = np.stack([padded[i] for i in batch])
                mw = (np.stack([_padded_mult(mults[i], R_pad)
                                for i in batch]) if weighted else None)
            with substage.timed("scoring.device"):
                out = kernel_vmapped(
                    stacked, np.asarray([eps[i] for i in batch]), mw,
                    num_alleles=num_alleles,
                    ploidy=config.ploidy,
                    min_overlap=config.min_overlap)
                # slice to the batch's real extent ON DEVICE before the
                # fetch — at bucket boundaries the padded download
                # would be up to 4x the real bytes
                R_max = max(matrices[i].alleles.shape[0] for i in batch)
                out = np.asarray(out[:, :R_max, :R_max])
            for j, i in enumerate(batch):
                R = matrices[i].alleles.shape[0]
                results[i] = out[j, :R, :R].astype(np.float64)
    return results
