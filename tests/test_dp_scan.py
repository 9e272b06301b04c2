"""The vmapped XLA scan (thread/dp_jax.group_states_core) against the host
oracle at the shapes a diploid kernel would have to handle: a single
position, position counts off the bucket grid, long chains, chain
batches of one and around a 32-chain block, and many tied states."""

import numpy as np
import pytest

import jax.numpy as jnp

from ahsoka_tpu.cluster.postprocess import DPInputs, default_genotypes
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread.dp_host import thread_chain
from ahsoka_tpu.thread.dp_jax import _group_states
from ahsoka_tpu.thread.states import (full_state_counts,
                                      full_state_validity, state_tuples)

from test_dp import random_dp_inputs


def _scan_states(dps):
    ca = np.stack([d.candidates for d in dps])
    nc = np.stack([d.num_candidates for d in dps])
    co = np.stack([d.coverage for d in dps]).astype(np.float32)
    cs = np.stack([d.consensus for d in dps])
    ge = np.stack([d.genotypes for d in dps]).astype(np.float32)
    args = [jnp.asarray(x) for x in (ca, nc, co, cs, ge,
                                     full_state_counts(2),
                                     full_state_validity(2))]
    return np.asarray(_group_states(
        *args, ploidy=2, num_alleles=ge.shape[2], switch_cost=32.0,
        affine_cost=8.0, cov_w=1.0, geno_w=1.0, method="scan"))


def _tied_inputs(P, seed):
    """Every position offers the same clusters at equal coverage, so
    many states tie on cost at every step."""
    rng = np.random.default_rng(seed)
    M = 4
    m = int(rng.integers(2, M + 1))
    cands = np.full((P, M), -1, dtype=np.int32)
    cands[:, :m] = np.arange(m)
    cov = np.zeros((P, M), dtype=np.float32)
    cov[:, :m] = 1.0 / m
    cons = np.zeros((P, M), dtype=np.int32)
    cons[:, :m] = np.arange(m) % 2
    return DPInputs(positions=np.arange(P, dtype=np.int32),
                    candidates=cands,
                    num_candidates=np.full(P, m, dtype=np.int32),
                    coverage=cov, consensus=cons,
                    genotypes=default_genotypes(P, 2))


def _check_against_oracle(dps, chains_checked=4):
    states = _scan_states(dps)
    assert states.shape == (len(dps), dps[0].num_positions)
    assert states.dtype == np.int32
    tuples = state_tuples(4, 2)
    cfg = PhasingConfig(ploidy=2)
    for i, dp in enumerate(dps[:chains_checked]):
        got = [tuple(int(dp.candidates[j, s]) for s in tuples[states[i, j]])
               for j in range(dp.num_positions)]
        assert [sorted(t) for t in got] == \
            [sorted(t) for t in thread_chain(dp, cfg)]


@pytest.mark.parametrize("P,chains,seed", [
    (1, 1, 0), (1, 33, 1), (13, 1, 2), (13, 31, 3), (13, 33, 4),
    (37, 32, 5), (300, 2, 6), (300, 33, 7)])
def test_scan_matches_oracle(P, chains, seed):
    _check_against_oracle([random_dp_inputs(P=P, ploidy=2, num_clusters=5,
                                            seed=1000 * seed + i)
                           for i in range(chains)])


@pytest.mark.parametrize("P,chains", [(9, 3), (40, 33), (129, 5)])
def test_scan_ties_break_like_oracle(P, chains):
    """Tied costs resolve to the lowest state index, as the oracle's
    argmin does."""
    _check_against_oracle([_tied_inputs(P, seed=i) for i in range(chains)])


@pytest.mark.gpu
@pytest.mark.parametrize("chains,P", [(1024, 1024), (1, 10240)])
def test_scan_on_card_matches_oracle(chains, P):
    """The scan compiled for the GPU, at bench.py's diploid cell and
    config2's chain length, against the host oracle."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from bench import make_dp_workload
    w = make_dp_workload(chains, P, 2)
    dps = [DPInputs(positions=np.arange(P, dtype=np.int32),
                    candidates=w[0][c], num_candidates=w[1][c],
                    coverage=w[2][c], consensus=w[3][c], genotypes=w[4][c])
           for c in range(min(chains, 4))]
    _check_against_oracle(dps)
