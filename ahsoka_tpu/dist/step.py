"""Sharded phase step: the multi-chip execution of the pipeline's device
stages over a ``Mesh``.

Sharding layout (SURVEY.md §2c):

- **Projection** — alignments shard over the ``data`` axis; every shard
  computes its local [bubbles, names] first-match key tables with the
  containment matmul and the shards merge with a *minimum* collective
  (the packed keys are order-encoded, so min == first match globally).
  Path tables / vocab are replicated.
- **Scoring** — read pairs tile over ``data`` (row blocks of the pair
  matrix), positions replicated.
- **Threading DP** — independent chains batch over the ``chain`` axis;
  each shard runs the method the single device would.

The same functions drive the single-device path (mesh of size 1), the
CPU dry-run (xla_force_host_platform_device_count), and several GPUs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.7 canonical location
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ahsoka_tpu.dist.mesh import CHAIN_AXIS, DATA_AXIS, put_global
from ahsoka_tpu.project.device import NO_MATCH, containment_keys_core
from ahsoka_tpu.thread.dp_jax import dp_forward_core, group_states_core


@functools.lru_cache(maxsize=64)
def _sharded_keys_fn(mesh, num_bubbles: int, num_names: int, chunk: int,
                     alleles_per_bubble: int):
    """Jitted data-sharded projection program, cached per (mesh, statics)
    so a run's per-chain calls re-trace only on a new shape."""

    def local(pf, pi, plf, pli, pb, pkb, nodes, name_id, ident, gate):
        full_k, part_k, gate_k = containment_keys_core(
            pf, pi, plf, pli, pb, pkb, nodes, name_id, ident,
            gate, num_bubbles=num_bubbles, num_names=num_names,
            chunk=chunk, alleles_per_bubble=alleles_per_bubble)
        # first-match keys merge by minimum across read shards
        merge = lambda x: jax.lax.pmin(x, DATA_AXIS)
        return merge(full_k), merge(part_k), merge(gate_k)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False))


def sharded_containment_keys(mesh, path_onehot_full, path_onehot_inner,
                             path_len_full, path_len_inner, path_bubble,
                             path_key_base, aln_vocab_nodes, aln_name_id,
                             aln_identity, gate_value, num_bubbles: int,
                             num_names: int, chunk: int,
                             alleles_per_bubble: int = 0):
    """Projection with alignments sharded over the data axis; returns
    replicated [B, N] key tables (min-merged across shards)."""
    import numpy as np
    fn = _sharded_keys_fn(mesh, num_bubbles, num_names, chunk,
                          alleles_per_bubble)
    # explicit global placement so the same call works when the mesh
    # spans multiple processes
    repl = [put_global(a, mesh, P()) for a in
            (path_onehot_full, path_onehot_inner, path_len_full,
             path_len_inner, path_bubble, path_key_base)]
    shrd = [put_global(a, mesh, P(DATA_AXIS)) for a in
            (aln_vocab_nodes, aln_name_id, aln_identity)]
    gate = put_global(np.float32(gate_value), mesh, P())
    return fn(*repl, *shrd, gate)


@functools.lru_cache(maxsize=64)
def _sharded_score_fn(mesh, num_alleles: int, ploidy: int,
                      min_overlap: int, mode: str):
    """Jitted row-sharded scoring program, cached per (mesh, statics) so
    per-chain calls re-trace only on a new shape/config."""
    from ahsoka_tpu.score.device import (_score_rows_core,
                                         _score_rows_core_wh)

    core = _score_rows_core_wh if mode == "whatshap" else _score_rows_core

    def local(rows, full, scalar):
        row0 = jax.lax.axis_index(DATA_AXIS) * rows.shape[0]
        return core(rows, full, scalar, row0, num_alleles=num_alleles,
                    ploidy=ploidy, min_overlap=min_overlap)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P()), out_specs=P(DATA_AXIS),
        check_vma=False))


def sharded_score_pairs(mesh, alleles, scalar, *, num_alleles: int,
                        ploidy: int, min_overlap: int, mode: str):
    """Pairwise scoring with the pair matrix's ROW axis sharded over the
    data axis (SURVEY.md §2c "pairwise-score partials ... over the
    mesh"): each shard holds the replicated [R, P] allele matrix and
    computes its [R/D, R] row block; the result is the data-sharded
    global [R, R] matrix.  Values are identical to the single-device
    kernel (per-position stats come from the full matrix; row blocks
    only split independent output dot products)."""
    import numpy as np
    fn = _sharded_score_fn(mesh, num_alleles, ploidy, min_overlap, mode)
    rows_g = put_global(alleles, mesh, P(DATA_AXIS))
    full_g = put_global(alleles, mesh, P())
    scalar_g = put_global(np.float32(scalar), mesh, P())
    return fn(rows_g, full_g, scalar_g)


def sharded_thread_states(mesh, candidates, num_candidates, coverage,
                          consensus, genotypes, counts_table, valid_table,
                          **statics):
    """Chain-sharded threading DP: the chain batch shards over the chain
    axis and every shard threads its chains with
    ``dp_jax.group_states_core`` under the same ``statics`` (method
    included), so a multi-device run threads exactly as a single
    device does.  Returns the [C, P] chain-sharded state matrix; the caller
    pads C to a multiple of the chain-axis size."""

    def local(ca, nc, co, cs, ge):
        # tables embed as jit constants (host np input stays mesh-agnostic)
        return group_states_core(ca, nc, co, cs, ge,
                                 jnp.asarray(counts_table),
                                 jnp.asarray(valid_table), **statics)

    spec = P(CHAIN_AXIS)
    fn = shard_map(local, mesh=mesh, in_specs=(spec,) * 5,
                   out_specs=spec, check_vma=False)
    args = [put_global(a, mesh, spec) for a in
            (candidates, num_candidates, coverage, consensus, genotypes)]
    return jax.jit(fn)(*args)


def make_fused_phase_step(num_bubbles: int, num_names: int, chunk: int,
                          ploidy: int, num_alleles: int,
                          min_overlap: int = 1):
    """Build a single-device jittable forward step over all three device
    stages (projection keys -> pair scores -> DP forward) with static
    sizes closed over.  This is the compile-check entry point
    (__graft_entry__.entry): one function exercising the containment
    matmul, the scoring matmuls, and the min-plus scan."""
    from ahsoka_tpu.score.device import _score_kernel

    def step(path_onehot_full, path_onehot_inner, path_len_full,
             path_len_inner, path_bubble, path_key_base, aln_vocab_nodes,
             aln_name_id, aln_identity, allele_matrix, eps, dp_candidates,
             dp_num_candidates, dp_coverage, dp_consensus, dp_genotypes,
             counts_table, valid_table):
        full_k, part_k, gate_k = containment_keys_core(
            path_onehot_full, path_onehot_inner, path_len_full,
            path_len_inner, path_bubble, path_key_base, aln_vocab_nodes,
            aln_name_id, aln_identity, jnp.float32(90.0),
            num_bubbles=num_bubbles, num_names=num_names, chunk=chunk)
        scores = _score_kernel(allele_matrix, eps,
                               num_alleles=num_alleles, ploidy=ploidy,
                               min_overlap=min_overlap)
        best_state, backptrs = dp_forward_core(
            dp_candidates, dp_num_candidates, dp_coverage, dp_consensus,
            dp_genotypes, counts_table, valid_table, ploidy=ploidy,
            num_alleles=num_alleles,
            switch_cost=jnp.float32(32.0), affine_cost=jnp.float32(8.0),
            cov_w=jnp.float32(1.0), geno_w=jnp.float32(1.0))
        return (full_k, part_k, gate_k), scores, (best_state, backptrs)

    return step
