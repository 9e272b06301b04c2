"""Quantify the approximate fast paths against the exact pipeline.

The round-1 verdict (VERDICT.md "What's weak" #6) asked for measured
accuracy bounds on the three parity-breaking fast paths:

  1. banded scoring  -> sparse edge list (score/banded.py)
  2. sparse cluster editing, approximate lazy-heap refresh
     (native/cluster_editing_sparse.cpp default mode)
  3. per-position coverage capping (--max-coverage, project/subsample.py)

This script runs each path against the exact pipeline (dense scoring +
dense cluster editing, no cap) on mid-size noisy synthetic diploid
chains and reports, per (path, num_reads):

  - speedup of scoring+clustering over the exact path;
  - cluster divergence: Adjusted Rand Index vs the exact path's clusters;
  - haplotype divergence: fraction of (position, haplotype) consensus
    alleles differing from the exact path's phased output (min over
    haplotype permutations), and the planted-truth switch-error rate of
    both for calibration.

Usage: python scripts/quantify_fastpaths.py [--reads 2000 4000 8000]
       [--bubbles 500] [--error-rate 0.05] [--markdown]

The `--markdown` table is what README.md's "approximate fast paths"
section records.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

# standalone `python scripts/quantify_fastpaths.py` puts scripts/ (not
# the repo root) on sys.path; bootstrap so it works without pip install
try:
    import ahsoka_tpu  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "ahsoka_tpu":
        raise                      # a real missing dependency, not us
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def ari(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand Index between two integer label vectors."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = len(a)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(cont, (ai, bi), 1)
    comb = lambda x: x * (x - 1) // 2
    sum_ij = comb(cont).sum()
    sum_a = comb(cont.sum(axis=1)).sum()
    sum_b = comb(cont.sum(axis=0)).sum()
    total = comb(n)
    exp = sum_a * sum_b / total if total else 0.0
    mx = (sum_a + sum_b) / 2.0
    return float((sum_ij - exp) / (mx - exp)) if mx != exp else 1.0


def hap_alleles(dp, path) -> np.ndarray:
    """[P, ploidy] consensus alleles of the threaded haplotypes."""
    from ahsoka_tpu.cluster.postprocess import consensus_lookup

    cons = consensus_lookup(dp)
    P = dp.num_positions
    k = len(path[0])
    out = np.zeros((P, k), dtype=np.int32)
    for j in range(P):
        for i in range(k):
            out[j, i] = cons[j].get(int(path[j][i]), -1)
    return out


def hap_divergence(a: np.ndarray, b: np.ndarray) -> float:
    """min over haplotype permutations of mean allele mismatch (global
    permutation — switch errors inside count as mismatches)."""
    k = a.shape[1]
    best = 1.0
    for perm in itertools.permutations(range(k)):
        best = min(best, float(np.mean(a[:, list(perm)] != b)))
    return best


def switch_error(haps: np.ndarray, truth: np.ndarray) -> float:
    """Per-position-pair switch error of phased haplotypes vs planted
    truth (standard phasing metric: best local pairing per position,
    count pairing changes between consecutive positions)."""
    P, k = haps.shape
    pairings = []
    for j in range(P):
        best, bperm = None, None
        for perm in itertools.permutations(range(k)):
            err = int(np.sum(haps[j, list(perm)] != truth[j]))
            if best is None or err < best:
                best, bperm = err, perm
        pairings.append(bperm)
    switches = sum(1 for j in range(1, P) if pairings[j] != pairings[j - 1])
    return switches / max(P - 1, 1)


def run_variant(matrix, config, variant: str, cap: int = 32):
    """scoring+clustering for one path; returns (clusters assignment,
    dp inputs, threaded path, seconds)."""
    import numpy as _np

    from ahsoka_tpu.cluster._native_ce import cluster_editing_sparse
    from ahsoka_tpu.cluster.editing import (assignment_from_clusters,
                                            cluster_editing)
    from ahsoka_tpu.cluster.postprocess import build_dp_inputs_from_matrix
    from ahsoka_tpu.project.collapse import collapse_reads, expand_clusters
    from ahsoka_tpu.project.subsample import subsample_matrix
    from ahsoka_tpu.score.banded import score_pairs_banded
    from ahsoka_tpu.score.device import score_pairs_device
    from ahsoka_tpu.thread.dp_jax import thread_chain_device

    t0 = time.perf_counter()
    if variant.startswith("maxcov"):
        matrix, _ = subsample_matrix(matrix, cap)
    if variant == "exact" or variant == "maxcov":
        scores = score_pairs_device(matrix, config)
        clusters = cluster_editing(scores, mode=config.ce_mode)
    elif variant in ("collapsed", "maxcov+collapsed"):
        # the round-4 production path for dense-width chains
        cm = collapse_reads(matrix)
        s_grp = score_pairs_device(cm.matrix, config,
                                   mult=cm.mult.astype(float))
        w = s_grp * _np.outer(cm.mult, cm.mult)
        _np.fill_diagonal(w, 0.0)
        clusters = expand_clusters(
            cluster_editing(w, mode=config.ce_mode), cm.inverse)
    elif variant == "banded-collapsed":
        # the round-4 production path for banded-width chains
        cm = collapse_reads(matrix)
        eu, ev, ew = score_pairs_banded(cm.matrix, config, mult=cm.mult)
        ew = ew * cm.mult[eu] * cm.mult[ev]
        clusters = expand_clusters(
            cluster_editing_sparse(cm.num_groups, eu, ev, ew,
                                   mode=config.ce_mode), cm.inverse)
    elif variant in ("banded", "banded+sparse-approx",
                     "maxcov+banded+sparse"):
        eu, ev, ew = score_pairs_banded(matrix, config)
        exact = variant == "banded"
        clusters = cluster_editing_sparse(
            matrix.num_reads, eu, ev, ew, exact_priorities=exact,
            mode=config.ce_mode)
    else:
        raise ValueError(variant)
    seconds = time.perf_counter() - t0
    cluster_of = assignment_from_clusters(clusters, matrix.num_reads)
    dp = build_dp_inputs_from_matrix(matrix.alleles, matrix.positions,
                                     cluster_of, config)
    from ahsoka_tpu.thread.dp_host import assign_rows
    path = assign_rows(thread_chain_device(dp, config), config.ploidy)
    return np.asarray(cluster_of), dp, path, seconds, matrix


# divergence regimes (VERDICT r2 item 6): conditions under which the
# approximate paths can genuinely depart from exact — high switch error,
# skewed haplotype coverage, low read overlap — plus the clean baseline
REGIMES = {
    "baseline": dict(error_rate=0.05, span=3, hap_weights=None),
    "high-error": dict(error_rate=0.15, span=3, hap_weights=None),
    "skewed-3to1": dict(error_rate=0.10, span=3, hap_weights=(3.0, 1.0)),
    "low-overlap": dict(error_rate=0.10, span=2, hap_weights=None),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, nargs="+",
                    default=[2000, 4000, 8000])
    ap.add_argument("--bubbles", type=int, default=500)
    ap.add_argument("--regimes", nargs="+", default=list(REGIMES),
                    choices=list(REGIMES))
    ap.add_argument("--cap", type=int, default=32,
                    help="max_coverage for the maxcov variants")
    ap.add_argument("--exact-limit", type=int, default=10_000,
                    help="above this read count the dense-exact "
                         "reference is infeasible ([R,R] matrix); the "
                         "exact-priority sparse path becomes the "
                         "reference instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--platform", default="cpu",
                    choices=["cpu", "default"],
                    help="cpu (default) keeps the study off the GPU — "
                         "it measures algorithmic divergence, and must "
                         "not contend with benchmark runs")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")

    import os
    import tempfile

    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.phase import ChainPhasingResult, _chain_matrix_stage
    from ahsoka_tpu.pipeline import prepare_phase_inputs
    from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic

    config = PhasingConfig(debug_readset_files=False)
    rows = []
    for regime, R in itertools.product(args.regimes, args.reads):
        rg = REGIMES[regime]
        spec = SynthSpec(num_chains=1, bubbles_per_chain=args.bubbles,
                         reads_per_hap=R // 2, span=rg["span"],
                         error_rate=rg["error_rate"],
                         hap_weights=rg["hap_weights"], seed=args.seed)
        with tempfile.TemporaryDirectory() as td:
            gfa = os.path.join(td, "g.gfa")
            gaf = os.path.join(td, "g.gaf")
            truth_path = os.path.join(td, "truth.txt")
            write_synthetic(gfa, gaf, spec, truth_path=truth_path)
            art = prepare_phase_inputs(gfa, gaf, os.path.join(td, "o"),
                                       config, columnar=True)
            truth_branches = {}
            for line in open(truth_path):
                c, h, nodes = line.split()
                truth_branches.setdefault(int(c), []).append(
                    [int(x) for x in nodes.split(",")])
            (size, chain_id), = art.size_sorting
            res = ChainPhasingResult(chain_id=chain_id, num_bubbles=size,
                                     skipped=True)
            matrix = _chain_matrix_stage(
                chain_id, art.allele_paths[chain_id], None,
                os.path.join(td, "o"), config, res,
                columns=art.gaf_columns,
                bucket=art.chain_buckets[chain_id])
            # planted truth alleles: inner branch node ids are unique per
            # chain, so map node -> (bubble position, allele index) from
            # the allele-path table (bubble numbering direction is a
            # detection artifact; going through node ids sidesteps it)
            bp = art.allele_paths[chain_id]
            node_to_pos_allele = {}
            for pos, paths in bp.items():
                for a_idx, path_nodes in enumerate(paths):
                    for n in list(path_nodes)[1:-1]:
                        node_to_pos_allele[int(n)] = (int(pos), a_idx)

        if R > args.exact_limit:
            # the dense [R, R] reference is infeasible here; the exact-
            # priority sparse solver is the reference (same decision rule
            # as dense on the banded edge list), isolating the lazy-heap
            # approximation and the coverage cap at production scale
            reference = "banded"
            variants = ["banded", "collapsed", "banded-collapsed",
                        "banded+sparse-approx", "maxcov+banded+sparse"]
        else:
            reference = "exact"
            variants = ["exact", "collapsed", "banded-collapsed",
                        "banded", "banded+sparse-approx",
                        "maxcov", "maxcov+collapsed",
                        "maxcov+banded+sparse"]
        out = {}
        for v in variants:
            cl, dp, path, secs, mtx = run_variant(matrix, config, v,
                                                  cap=args.cap)
            haps = hap_alleles(dp, path)
            truth = np.full_like(haps, -1)
            pos_to_jj = {int(p): jj
                         for jj, p in enumerate(dp.positions)}
            (tchain,) = truth_branches        # single-chain study
            for h in range(config.ploidy):
                for node in truth_branches[tchain][h]:
                    hit = node_to_pos_allele.get(node)
                    if hit is None or hit[0] not in pos_to_jj:
                        continue
                    truth[pos_to_jj[hit[0]], h] = hit[1]
            out[v] = dict(cl=cl, dp=dp, haps=haps, secs=secs,
                          truth=truth, reads=mtx.num_reads)
        ex = out[reference]
        for v in variants:
            o = out[v]
            same_reads = o["reads"] == ex["reads"]
            rows.append({
                "regime": regime, "path": v, "reads": R,
                "reference": reference,
                "seconds": round(o["secs"], 3),
                "speedup": round(ex["secs"] / o["secs"], 2),
                "ari_vs_exact": (round(ari(o["cl"], ex["cl"]), 4)
                                 if same_reads else None),
                "hap_div_vs_exact": round(
                    hap_divergence(o["haps"], ex["haps"]), 4),
                "switch_err_vs_truth": round(
                    switch_error(o["haps"], o["truth"]), 4),
                "hamming_vs_truth": round(
                    hap_divergence(o["haps"], o["truth"]), 4),
            })
            print(json.dumps(rows[-1]), flush=True)

    if args.markdown:
        print("\n| regime | path | reads | scoring+CE s | speedup | "
              "ARI vs ref | hap divergence vs ref | switch err vs truth "
              "| hamming vs truth |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            ari_s = "n/a (subsampled)" if r["ari_vs_exact"] is None \
                else f"{r['ari_vs_exact']:.4f}"
            print(f"| {r['regime']} | {r['path']} | {r['reads']} | "
                  f"{r['seconds']} | {r['speedup']}x | {ari_s} | "
                  f"{r['hap_div_vs_exact']:.4f} | "
                  f"{r['switch_err_vs_truth']:.4f} | "
                  f"{r['hamming_vs_truth']:.4f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
