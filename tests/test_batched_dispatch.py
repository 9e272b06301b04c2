"""The batched-threading dispatch (thread_chains_batched) and its one
selection point (select_dp_method): every chain group takes the exact
vmapped XLA scan, or the beam-pruned scan when a beam narrower than the
ploidy's state space is configured."""

import json
import os

import pytest

import jax

import ahsoka_tpu.thread.dp_jax as dj
from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.thread.dp_host import thread_chain
from ahsoka_tpu.thread.dp_jax import select_dp_method, thread_chains_batched

from test_dp import random_dp_inputs

DATA = os.path.join(os.path.dirname(__file__), "data")


def _norm(paths):
    return [[tuple(sorted(t)) for t in p] for p in paths]


@pytest.mark.parametrize("ploidy,beam,expected", [
    (2, 0, ("scan", 0)), (3, 0, ("scan", 0)), (4, 0, ("scan", 0)),
    (5, 0, ("scan", 0)),
    (4, 4096, ("scan", 0)),          # beam >= S = 330: exact scan
    (5, 1024, ("beam", 1024)),       # S = 2002 > 1024
    (6, 2048, ("beam", 2048)),
    (6, 512, ("beam", 512)),
])
def test_select_dp_method(ploidy, beam, expected):
    cfg = PhasingConfig(ploidy=ploidy, dp_beam_width=beam)
    assert select_dp_method(cfg, ploidy) == expected


@pytest.mark.parametrize("ploidy,P,clusters", [(2, 12, 5), (4, 10, 9),
                                               (3, 9, 7)])
def test_batched_dispatch_matches_oracle(ploidy, P, clusters):
    cfg = PhasingConfig(ploidy=ploidy, use_genotypes=(ploidy == 2))
    dps = [random_dp_inputs(P=P, ploidy=ploidy, num_clusters=clusters,
                            seed=50 + i) for i in range(3)]
    got = thread_chains_batched(dps, cfg)
    assert _norm(got) == _norm([thread_chain(dp, cfg) for dp in dps])


@pytest.mark.parametrize("keep_going", [False, True])
def test_dp_error_propagates(keep_going, monkeypatch, tmp_path):
    """A device DP error is not papered over by another path: the
    batched DP raises, and under keep_going every chain it hit is
    counted in chains_failed."""
    def boom(*a, **k):
        raise RuntimeError("synthetic DP failure")

    monkeypatch.setattr(dj, "_group_states", boom)
    if not keep_going:
        dps = [random_dp_inputs(P=10, ploidy=2, num_clusters=5, seed=3)]
        with pytest.raises(RuntimeError, match="synthetic DP"):
            thread_chains_batched(dps, PhasingConfig(ploidy=2))
        return
    from ahsoka_tpu.pipeline import run_phase
    gaf = tmp_path / "golden_diploid.gaf"
    gaf.write_bytes(open(os.path.join(DATA, "golden_diploid.gaf"),
                         "rb").read())
    out = str(tmp_path / "o")
    run_phase(os.path.join(DATA, "golden_diploid.gfa"), str(gaf), out,
              PhasingConfig(debug_readset_files=False), keep_going=True)
    m = json.load(open(out + "-metrics.json"))
    assert m["chains_phased"] == 0
    assert m["chains_failed"] > 0


@pytest.mark.parametrize("ploidy", [2, 4])
def test_chain_sharded_dispatch_matches_single(ploidy):
    """With chain_shards > 1 every shard runs the method the single
    device would; states equal the single-device run."""
    if len(jax.devices()) < 2:
        pytest.skip("need 2 devices")
    cfg1 = PhasingConfig(ploidy=ploidy, use_genotypes=(ploidy == 2))
    cfg2 = PhasingConfig(ploidy=ploidy, use_genotypes=(ploidy == 2),
                         chain_shards=2)
    dps = [random_dp_inputs(P=10, ploidy=ploidy, num_clusters=2 * ploidy,
                            seed=70 + i) for i in range(3)]
    assert thread_chains_batched(dps, cfg2) == \
        thread_chains_batched(dps, cfg1)


def test_ploidy_ceiling_guard():
    """Unsupported ploidies fail fast with the state-space math instead
    of OOMing mid-run."""
    with pytest.raises(ValueError, match="12376"):
        PhasingConfig(ploidy=6)
    with pytest.raises(ValueError, match="supported range"):
        PhasingConfig(ploidy=0)
    PhasingConfig(ploidy=5)          # boundary: allowed


def test_dispatch_covers_every_position():
    # ragged chain lengths land in different position buckets; each
    # bucket dispatches independently
    cfg = PhasingConfig(ploidy=4, use_genotypes=False)
    dps = [random_dp_inputs(P=p, ploidy=4, num_clusters=8, seed=p)
           for p in (5, 9, 17)]
    got = thread_chains_batched(dps, cfg)
    assert _norm(got) == _norm([thread_chain(dp, cfg) for dp in dps])
    assert all(len(p) == dp.num_positions
               for p, dp in zip(got, dps))


def test_single_chain_path_matches_batched():
    """thread_chain_device is a batch of one through the same path."""
    cfg = PhasingConfig(ploidy=2)
    dps = [random_dp_inputs(P=14, ploidy=2, num_clusters=5, seed=s)
           for s in range(3)]
    batched = thread_chains_batched(dps, cfg)
    assert batched == [dj.thread_chain_device(dp, cfg) for dp in dps]
