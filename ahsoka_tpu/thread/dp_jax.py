"""Haplotype-threading DP as a vectorised XLA program (lax.scan).

Same cost model as thread/dp_host.py (the oracle), restructured for an
accelerator:

- All positions share the *full-width* state enumeration (multisets over
  M = 2k slots, S = C(3k-1, k) states); states referencing an empty
  candidate slot get +inf node cost (thread/states.full_state_validity).
  One static count table, uniform shapes across positions and chains.
- Node costs for all positions are computed in one batched tensor op.
- The forward pass is a min-plus scan over positions: the [S, S] switch
  matrix is built per step from the two positions' candidate ids (multiset
  intersection via a slot-matching matmul) — no data-dependent shapes.
- Positions are padded to a bucket size with sentinel candidates (-1),
  which add a constant cost to every path and leave the argmin unchanged.

Chains are independently threadable, so the whole scan vmaps over a chain
batch.  ``select_dp_method`` is the one place that picks how a chain
group is threaded: the exact scan or the beam-pruned scan.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ahsoka_tpu.cluster.postprocess import DPInputs
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread.dp_host import assign_rows
from ahsoka_tpu.thread.states import (full_state_counts,
                                      full_state_validity, max_states,
                                      state_tuples)
# plain float, not a jnp scalar: importing this module creates no device
# array
_INF = 1e30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_positions(P: int, bucket: int = 128) -> int:
    """Padded position count: multiples of 8 up to ``bucket``, then
    multiples of ``bucket`` up to 1024, then multiples of 1024.  Bounds
    the number of distinct compile shapes on ragged whole-genome
    chain-length distributions (config5: 10..2000 bubbles -> ~12 shapes
    instead of ~260) at <= 2.4% padding overhead on long chains."""
    if P <= bucket:
        return _round_up(P, min(bucket, _round_up(P, 8)))
    if P <= 1024:
        return _round_up(P, bucket)
    return _round_up(P, 1024)


def _ordered_sum(x):
    """Sum over the last axis in index order.  Elementwise adds only, so
    every compiled program and device rounds the same way (a reduce may
    be reassociated), and the argmin tie-breaks downstream agree."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total


def node_costs_all(candidates, num_candidates, coverage, consensus,
                   genotypes, counts_table, valid_table, ploidy: int,
                   num_alleles: int, cov_w, geno_w):
    """[P, S] node costs for every position (invalid states -> +inf).

    counts_table: [S, M] full-width count matrix (states.full_state_counts)
    valid_table:  [M+1, S] validity by candidate count
    """
    k = ploidy
    countsf = counts_table.astype(jnp.float32)       # [S, M] static
    valid = valid_table[num_candidates]              # [P, S] bool

    cov_cost = _ordered_sum(jnp.abs(coverage[:, None, :]
                                    - countsf[None] / k))
    cons_oh = jax.nn.one_hot(consensus, num_alleles, dtype=jnp.float32)
    cons_oh *= (candidates >= 0).astype(jnp.float32)[:, :, None]
    # small-integer counts times 0/1: exact at full float32 precision
    allele_counts = jnp.einsum("sm,pma->psa", countsf, cons_oh,
                               precision=jax.lax.Precision.HIGHEST)
    geno_cost = 0.5 * _ordered_sum(jnp.abs(
        allele_counts - genotypes[:, None, :]))
    node = cov_w * cov_cost + geno_w * geno_cost
    return jnp.where(valid, node, _INF), countsf     # [P, S], [S, M]


def dp_forward_core(candidates, num_candidates, coverage, consensus,
                    genotypes, counts_table, valid_table, ploidy: int,
                    num_alleles: int, switch_cost, affine_cost, cov_w,
                    geno_w):
    """Returns (best_final_state, backpointers [P-1, S]).

    Pure traced function; ``group_states_core`` vmaps it over a chain
    batch (chains are embarrassingly parallel, SURVEY.md §2c "chain
    parallelism")."""
    k = ploidy
    node, countsf = node_costs_all(
        candidates, num_candidates, coverage, consensus, genotypes,
        counts_table, valid_table, ploidy, num_alleles, cov_w, geno_w)
    counts_i = countsf.astype(jnp.int32)             # [S, M] static

    def step(cost, xs):
        cand_prev, cand_cur, node_cur = xs
        match = ((cand_prev[:, None] == cand_cur[None, :])
                 & (cand_prev[:, None] >= 0)).astype(jnp.int32)
        mapped = jax.lax.dot_general(
            counts_i, match.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)        # [S, M_prev]
        inter = jnp.minimum(counts_i[:, None, :],
                            mapped[None, :, :]).sum(axis=2)
        switches = (k - inter).astype(jnp.float32)
        trans = switch_cost * switches + affine_cost * (switches > 0)
        total = cost[:, None] + trans                # [S_prev, S_cur]
        best_prev = jnp.argmin(total, axis=0)
        new_cost = jnp.min(total, axis=0) + node_cur
        return new_cost, best_prev.astype(jnp.int32)

    xs = (candidates[:-1], candidates[1:], node[1:])
    final_cost, backptrs = jax.lax.scan(step, node[0], xs)
    return jnp.argmin(final_cost).astype(jnp.int32), backptrs


def dp_forward_beam_core(candidates, num_candidates, coverage, consensus,
                         genotypes, counts_table, valid_table,
                         ploidy: int, num_alleles: int, switch_cost,
                         affine_cost, cov_w, geno_w, beam_width: int):
    """Top-B pruned forward pass — the WhatsHap ``rowLimit`` concept
    (HaploThreader ctor, src/alignmentstoreadset.cpp:320: cap retained
    states per position).  At every position only the ``beam_width``
    cheapest states survive; transitions are evaluated from the retained
    beam into the full state set, then the frontier is re-pruned with
    jax.lax.top_k (ties -> lowest state index, deterministic).

    With beam_width >= S this is exactly dp_forward_core (parity-tested);
    smaller beams make ploidy-6 tractable, where S = C(17, 6) = 12376
    puts the exact [S, S] transition tensor (~0.6 GB/position) beyond
    device memory.

    Returns (final_beam_slot, beam_states [P, B], backptrs [P-1, B])
    where backptrs[t, b] is the beam slot at position t of the best
    predecessor of beam slot b at position t+1."""
    P, M = candidates.shape
    S = counts_table.shape[0]
    B = min(beam_width, S)
    k = ploidy

    node, countsf = node_costs_all(
        candidates, num_candidates, coverage, consensus, genotypes,
        counts_table, valid_table, ploidy, num_alleles, cov_w, geno_w)
    counts_i = countsf.astype(jnp.int32)             # [S, M]

    neg0, idx0 = jax.lax.top_k(-node[0], B)
    cost0 = -neg0

    def step(carry, xs):
        cost_prev, idx_prev = carry                  # [B], [B]
        cand_prev, cand_cur, node_cur = xs
        counts_prev = counts_i[idx_prev]             # [B, M]
        match = ((cand_prev[:, None] == cand_cur[None, :])
                 & (cand_prev[:, None] >= 0)).astype(jnp.int32)
        mapped = jax.lax.dot_general(
            counts_i, match.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)        # [S_cur, M_prev]
        inter = jnp.minimum(counts_prev[:, None, :],
                            mapped[None, :, :]).sum(axis=2)   # [B, S]
        switches = (k - inter).astype(jnp.float32)
        trans = switch_cost * switches + affine_cost * (switches > 0)
        total = cost_prev[:, None] + trans           # [B, S]
        best_prev_slot = jnp.argmin(total, axis=0)   # [S]
        cost_all = jnp.min(total, axis=0) + node_cur
        neg, idx_cur = jax.lax.top_k(-cost_all, B)
        bp = best_prev_slot[idx_cur].astype(jnp.int32)
        return (-neg, idx_cur.astype(jnp.int32)), \
            (idx_cur.astype(jnp.int32), bp)

    xs = (candidates[:-1], candidates[1:], node[1:])
    (final_cost, _), (idx_tail, bps) = jax.lax.scan(
        step, (cost0, idx0.astype(jnp.int32)), xs)
    beam_states = jnp.concatenate(
        [idx0.astype(jnp.int32)[None], idx_tail], axis=0)      # [P, B]
    return jnp.argmin(final_cost).astype(jnp.int32), beam_states, bps


@jax.jit
def _backtrace_beam(final_slot, bps):
    """Beam-slot backtrace (same reverse scan as _backtrace, over beam
    slots instead of state indices)."""
    def step(slot, bp):
        return bp[slot], slot
    slot0, slots_tail = jax.lax.scan(step, final_slot, bps, reverse=True)
    return slot0, slots_tail


def _beam_states_to_path(beam_states, slot0, slots_tail, P):
    """Resolve beam slots to full state indices on the host."""
    beam_states = np.asarray(beam_states)
    slots = np.concatenate([[int(slot0)], np.asarray(slots_tail)])[:P]
    return np.array([beam_states[t, slots[t]] for t in range(P)])


def _beam_width_for(config: PhasingConfig, S: int) -> int:
    """Active beam width: configured, and the state space exceeds it."""
    bw = int(getattr(config, "dp_beam_width", 0) or 0)
    return bw if bw and S > bw else 0


@jax.jit
def _backtrace(final_state, backptrs):
    """backptrs[t] maps the state at position t+1 to the best state at t;
    the reverse scan yields state0 and states at positions 1..P-1."""
    def step(state, bp):
        prev = bp[state]
        return prev, state          # emit the state at position t+1
    state0, states_tail = jax.lax.scan(step, final_state, backptrs,
                                       reverse=True)
    return state0, states_tail


def select_dp_method(config: PhasingConfig, ploidy: int
                     ) -> Tuple[str, int]:
    """The one choice of threading-DP implementation for a chain group:
    ("beam", width) when the configured beam is narrower than the
    ploidy's state space, else ("scan", 0), the exact vmapped XLA scan,
    on every platform and at every chain count.  (A diploid GPU kernel
    was measured against the scan and removed: PERF.md, "Kernel
    decisions on the H100".)"""
    bw = _beam_width_for(config, max_states(ploidy))
    return ("beam", bw) if bw else ("scan", 0)


def group_states_core(ca, nc, co, cs, ge, counts_table, valid_table, *,
                      ploidy: int, num_alleles: int, switch_cost: float,
                      affine_cost: float, cov_w: float, geno_w: float,
                      method: str, beam_width: int = 0):
    """[C, P, ...] chain batch -> [C, P] int32 best state per position
    (full-width state indices), by ``method`` ("scan" or "beam",
    select_dp_method)."""
    kw = dict(ploidy=ploidy, num_alleles=num_alleles,
              switch_cost=switch_cost, affine_cost=affine_cost,
              cov_w=cov_w, geno_w=geno_w)
    if method == "beam":
        fwd = lambda a, b, c, d, e: dp_forward_beam_core(
            a, b, c, d, e, counts_table, valid_table,
            beam_width=beam_width, **kw)
        final_slot, beam_states, bps = jax.vmap(fwd)(ca, nc, co, cs, ge)
        slot0, tail = jax.vmap(_backtrace_beam)(final_slot, bps)
        slots = jnp.concatenate([slot0[:, None], tail], axis=1)
        return jnp.take_along_axis(beam_states, slots[:, :, None],
                                   axis=2)[:, :, 0]
    if method != "scan":
        raise ValueError(f"unknown DP method {method!r}")
    fwd = lambda a, b, c, d, e: dp_forward_core(
        a, b, c, d, e, counts_table, valid_table, **kw)
    final_state, backptrs = jax.vmap(fwd)(ca, nc, co, cs, ge)
    state0, tail = jax.vmap(_backtrace)(final_state, backptrs)
    return jnp.concatenate([state0[:, None], tail], axis=1)


_group_states = functools.partial(
    jax.jit, static_argnames=("ploidy", "num_alleles", "switch_cost",
                              "affine_cost", "cov_w", "geno_w", "method",
                              "beam_width"))(group_states_core)


def pad_chain_batch(cands, ncand, cov, cons, geno, multiple: int):
    """Pad the chain axis to a multiple of ``multiple`` with sentinel
    chains (candidates -1, one candidate, zero coverage)."""
    C = cands.shape[0]
    C_pad = _round_up(max(C, multiple), multiple)
    pad = C_pad - C
    if pad == 0:
        return cands, ncand, cov, cons, geno, C
    pad_spec = lambda x, cv: np.pad(
        x, ((0, pad),) + ((0, 0),) * (x.ndim - 1), constant_values=cv)
    return (pad_spec(cands, -1), pad_spec(ncand, 1), pad_spec(cov, 0),
            pad_spec(cons, 0), pad_spec(geno, 0), C)


def thread_chain_device(dp: DPInputs, config: PhasingConfig
                        ) -> List[Tuple[int, ...]]:
    """One chain through the batched path (a batch of one)."""
    return thread_chains_batched([dp], config)[0]


def thread_and_assign_device(dp: DPInputs, config: PhasingConfig
                             ) -> List[Tuple[int, ...]]:
    return assign_rows(thread_chain_device(dp, config), config.ploidy)


def thread_chains_batched(dps: List[DPInputs], config: PhasingConfig,
                          bucket: int = 128, chain_configs=None
                          ) -> List[List[Tuple[int, ...]]]:
    """Thread many chains with one device program per position bucket:
    chains are grouped by padded position count (and ploidy, for
    mixed-ploidy runs — ``chain_configs`` carries each dp's effective
    config), stacked, and threaded by the method ``select_dp_method``
    picks for the group.  Every method gives the same states (same
    padding semantics and argmin tie-breaks)."""
    if chain_configs is None:
        chain_configs = [config] * len(dps)

    groups: dict = {}
    for idx, dp in enumerate(dps):
        P = dp.num_positions
        if P == 0:
            continue
        P_pad = _bucket_positions(P, bucket)
        # allele-count A changes the genotype one-hot width; ploidy the
        # state space and candidate width — group by both
        groups.setdefault((P_pad, dp.genotypes.shape[1],
                           chain_configs[idx].ploidy),
                          []).append(idx)

    from ahsoka_tpu.utils import substage

    paths: List[List[Tuple[int, ...]]] = [[] for _ in dps]
    for (P_pad, A, k), members in groups.items():
        config = chain_configs[members[0]]
        counts_table = full_state_counts(k)
        valid_table = full_state_validity(k)
        tuples = state_tuples(2 * k, k)
        with substage.timed("threading.pack"):
            stacked = {"ca": [], "nc": [], "co": [], "cs": [], "ge": []}
            for idx in members:
                dp = dps[idx]
                pad = P_pad - dp.num_positions
                stacked["ca"].append(
                    np.pad(dp.candidates, ((0, pad), (0, 0)),
                           constant_values=-1))
                stacked["nc"].append(np.pad(dp.num_candidates, (0, pad),
                                            constant_values=1))
                stacked["co"].append(
                    np.pad(dp.coverage, ((0, pad), (0, 0))))
                stacked["cs"].append(
                    np.pad(dp.consensus, ((0, pad), (0, 0))))
                stacked["ge"].append(
                    np.pad(dp.genotypes, ((0, pad), (0, 0))))
            ca = np.stack(stacked["ca"])
            nc = np.stack(stacked["nc"])
            co = np.stack(stacked["co"]).astype(np.float32)
            cs = np.stack(stacked["cs"])
            ge = np.stack(stacked["ge"]).astype(np.float32)
        geno_w = (config.genotype_cost_weight if config.use_genotypes
                  else 0.0)
        method, bw = select_dp_method(config, k)
        statics = dict(
            ploidy=k, num_alleles=A,
            switch_cost=float(config.switch_cost),
            affine_cost=float(config.affine_switch_cost),
            cov_w=float(config.coverage_cost_weight),
            geno_w=float(geno_w), method=method, beam_width=bw)
        shards = max(int(getattr(config, "chain_shards", 1)), 1)
        if shards > 1 and len(jax.devices()) >= shards:
            # chain-parallel scale-out: the group's chain batch shards
            # over the mesh's chain axis and every shard runs the same
            # method.  Chains are independent, so states are identical
            # to the single-device path; tests assert byte equality.
            from ahsoka_tpu.dist import step as dstep
            from ahsoka_tpu.dist.mesh import fetch_global, make_mesh

            mesh = make_mesh(data=1, chain=shards,
                             devices=jax.devices()[:shards])
            pca, pnc, pco, pcs, pge, C0 = pad_chain_batch(
                ca, nc, co, cs, ge, multiple=shards)
            with substage.timed("threading.kernel"):
                st = dstep.sharded_thread_states(
                    mesh, pca, pnc, pco, pcs, pge, counts_table,
                    valid_table, **statics)
                jax.block_until_ready(st)
            with substage.timed("threading.fetch"):
                states = fetch_global(st)[:C0]
        else:
            with substage.timed("threading.kernel"):
                st = _group_states(
                    jnp.asarray(ca), jnp.asarray(nc), jnp.asarray(co),
                    jnp.asarray(cs), jnp.asarray(ge),
                    jnp.asarray(counts_table), jnp.asarray(valid_table),
                    **statics)
                jax.block_until_ready(st)
            with substage.timed("threading.fetch"):
                states = np.asarray(st)
        with substage.timed("threading.expand"):
            for row, idx in enumerate(members):
                dp = dps[idx]
                path = []
                for j in range(dp.num_positions):
                    slots = tuples[int(states[row, j])]
                    path.append(tuple(int(dp.candidates[j, slot])
                                      for slot in slots))
                paths[idx] = path
    return paths
