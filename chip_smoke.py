#!/usr/bin/env python3
"""Smoke run of ahsoka-tpu's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 0-5
    python chip_smoke.py --four-cards   # phase 6 only, on four cards

Phases, in order; the first failure stops the run with a non-zero exit
and no result line:

0. identity: the card's name and power limit (nvidia-smi), the jax
   version and devices, XLA_FLAGS, the compile-cache directory and the
   native C++ helpers that loaded.  Any platform but "gpu" is refused.
1. goldens: ``ahsoka-tpu phase`` on tests/data/golden_{diploid,tetra},
   byte-compared with the committed outputs.
2. parity at real widths, on the card: the DP scan at 1024 chains x 1024
   positions (diploid) and 128 x 1024 (tetraploid, S = 330) against the
   host oracle (16 chains each), projection against a numpy reference
   (exact), scoring against the numpy oracle (rtol = atol = 1e-4).
3. config4 through the CLI: 1000 chains x 50 bubbles, 1M GAF records.
4. config2 through the CLI: one chain of 10k bubbles, 50k reads.
5. config5s through the CLI: 300 ragged chains of ploidy 2/4/6.
6. (--four-cards) config4 on one card, then over four: --chain-shards 4,
   --data-shards 4, --data-shards 2 --chain-shards 2, and four processes
   with --process-sharding chains; every output byte-equal.

Inputs are generated from their seeds into benchdata/ (gitignored);
generation counts as set-up.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(REPO, "benchdata")
WORKDIR = os.path.join(INPUTS, "smoke")
SWITCH_ERR_BAR = 0.02      # PhasingConfig.fastpath_accept_floor


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def _threads() -> int:
    return min(os.cpu_count() or 1, 8)


# ---------------------------------------------------------------- phase 0

def phase_identity():
    import jax

    from ahsoka_tpu.utils.xla_cache import enable_persistent_compilation_cache

    try:
        smi = nvidia_smi()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"unavailable ({type(exc).__name__})"
    log(f"nvidia-smi name, power.limit: {smi}")
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_persistent_compilation_cache()}")
    log(f"native helpers: {native_helpers()}")
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"platform {dev.platform!r}: this smoke runs on a GPU only")
    check(not smi.startswith("unavailable"), "nvidia-smi failed")
    return dev


def native_helpers() -> dict:
    """Which C++ helpers built and loaded (a failed one means the Python
    fallback, or no large-chain clustering at all)."""
    from ahsoka_tpu.cluster import _native_ce
    from ahsoka_tpu.compat import _native
    from ahsoka_tpu.io import _native_io
    from ahsoka_tpu.project import _native_covcap
    from ahsoka_tpu.thread import _native_dp

    loaders = {"compat": _native._ensure_built, "io": _native_io._load,
               "cluster_editing": _native_ce._load,
               "covcap": _native_covcap._load, "dp_baseline": _native_dp._load}
    return {name: ("loaded" if fn() is not None else "FAILED")
            for name, fn in loaders.items()}


# ---------------------------------------------------------------- phase 1

def run_cli(argv) -> None:
    from ahsoka_tpu.cli.main import main
    check(main([str(a) for a in argv]) == 0, f"cli failed: {argv}")


def read_metrics(outstem: str, suffix: str = "-metrics.json") -> dict:
    with open(outstem + suffix) as fh:
        m = json.load(fh)
    check(m.get("platform") == "gpu",
          f"{outstem}: metrics platform {m.get('platform')!r}")
    return m


def phase_goldens(work: str) -> None:
    data = os.path.join(REPO, "tests", "data")
    cases = [("golden_diploid", [],
              ["-result.txt", "-bubbleinfo.txt"]),
             ("golden_tetra", ["--ploidy", "4", "--no-genotypes"],
              ["-result.txt"])]
    for name, extra, suffixes in cases:
        gaf = os.path.join(work, f"{name}.gaf")
        shutil.copy(os.path.join(data, f"{name}.gaf"), gaf)
        out = os.path.join(work, name)
        run_cli(["phase", "-g", os.path.join(data, f"{name}.gfa"),
                 "-a", gaf, "-o", out] + extra)
        read_metrics(out)
        for suffix in suffixes:
            with open(out + suffix, "rb") as a, \
                    open(os.path.join(data, name + suffix), "rb") as b:
                check(a.read() == b.read(), f"{name}{suffix} != golden")
        log(f"  {name}: byte-equal ({', '.join(suffixes)})")


# ---------------------------------------------------------------- phase 2

def _dp_inputs(w, c):
    import numpy as np

    from ahsoka_tpu.cluster.postprocess import DPInputs
    ca, nc, co, cs, ge = w[:5]
    return DPInputs(positions=np.arange(ca.shape[1], dtype=np.int32),
                    candidates=ca[c], num_candidates=nc[c], coverage=co[c],
                    consensus=cs[c], genotypes=ge[c])


def _path_cost(dp, path, cfg) -> float:
    """Cost of a cluster-tuple path under the oracle's cost model."""
    from collections import Counter

    from ahsoka_tpu.thread.dp_host import node_costs
    from ahsoka_tpu.thread.states import full_state_validity, state_tuples

    k = cfg.ploidy
    tuples = state_tuples(2 * k, k)
    valid = full_state_validity(k)
    total = 0.0
    for j, tup in enumerate(path):
        m = int(dp.num_candidates[j])
        target = sorted(tup)
        s = next(s for s, slots in enumerate(tuples) if valid[m, s]
                 and sorted(int(dp.candidates[j, x]) for x in slots)
                 == target)
        total += float(node_costs(dp, j, cfg)[s])
        if j:
            sw = k - sum((Counter(path[j - 1]) & Counter(tup)).values())
            total += cfg.switch_cost * sw + cfg.affine_switch_cost * (sw > 0)
    return total


def _against_oracle(label, w, states, ploidy, chains=16) -> None:
    """Device states of the first ``chains`` chains against dp_host:
    equal paths, or equal path costs within 1e-4 relative."""
    from concurrent.futures import ThreadPoolExecutor

    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.thread.dp_host import thread_chain
    from ahsoka_tpu.thread.states import state_tuples

    cfg = PhasingConfig(ploidy=ploidy)
    tuples = state_tuples(2 * ploidy, ploidy)

    def one(c):
        dp = _dp_inputs(w, c)
        host = thread_chain(dp, cfg)
        dev = [tuple(int(dp.candidates[j, x]) for x in tuples[s])
               for j, s in enumerate(states[c])]
        if [sorted(t) for t in host] == [sorted(t) for t in dev]:
            return 0.0, False
        ch, cd = _path_cost(dp, host, cfg), _path_cost(dp, dev, cfg)
        return abs(cd - ch) / max(abs(ch), 1.0), True

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        res = list(pool.map(one, range(chains)))
    worst = max(r for r, _ in res)
    differ = sum(d for _, d in res)
    log(f"  {label} vs oracle ({chains} chains): {differ} paths differ, "
        f"largest relative path-cost deviation {worst:.3g}")
    check(worst <= 1e-4, f"{label}: path cost off the oracle by {worst}")


def _timed(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_dp_parity(chains2=1024, chains4=128, positions=1024,
                    oracle_chains=16) -> None:
    import jax.numpy as jnp
    import numpy as np

    from bench import make_dp_workload
    from ahsoka_tpu.thread.dp_jax import _group_states

    for ploidy, C in ((2, chains2), (4, chains4)):
        w = make_dp_workload(C, positions, ploidy)
        args = [jnp.asarray(x) for x in w[:7]]
        run = lambda: _group_states(
            *args, ploidy=ploidy, num_alleles=2, switch_cost=32.0,
            affine_cost=8.0, cov_w=1.0, geno_w=1.0, method="scan")
        states = np.asarray(run())
        log(f"  DP k={ploidy} {C}x{positions} scan: "
            f"{_timed(run) * 1e3:.3f} ms per call")
        _against_oracle(f"DP k={ploidy} scan", w, states, ploidy,
                        oracle_chains)


def _projection_reference(pf, pi, plf, pli, pkb, nodes, name_id, ident,
                          B, APB, N):
    """numpy containment keys (float32 BLAS products of 0/1 matrices
    with at most L ones per row: exact)."""
    import numpy as np

    from ahsoka_tpu.project.device import NO_MATCH

    A = nodes.shape[0]
    V = pf.shape[1]
    member = np.zeros((A, V), dtype=np.float32)
    member[np.repeat(np.arange(A), nodes.shape[1]), nodes.ravel()] = 1.0
    order = np.argsort(name_id, kind="stable")
    names, starts = np.unique(name_id[order], return_index=True)
    key = pkb[:, None].astype(np.int64) + np.arange(A)[None, :]
    gate = (ident.astype(np.float32) * np.float32(100.0)
            > np.float32(90.0))[None, :]
    out = []
    for p, plen, mask in ((pf, plf, True), (pi, pli, True),
                          (pi, pli, gate)):
        hits = p.astype(np.float32) @ member.T                  # [S, A]
        k = np.where((hits == plen[:, None]) & mask, key, NO_MATCH)
        k = k.reshape(B, APB, A).min(axis=1)[:, order]
        table = np.full((B, N), NO_MATCH, dtype=np.int64)
        table[:, names] = np.minimum.reduceat(k, starts, axis=1)
        out.append(table.astype(np.int32))
    return out


def phase_projection_parity(B=512, V=2048, A=1 << 15, N=1 << 13,
                            CHUNK=2048) -> None:
    """containment_keys_core at bench.py's projection shapes, with every
    alignment planted over four paths so containment really happens."""
    import jax.numpy as jnp
    import numpy as np

    from ahsoka_tpu.project.device import _containment_keys

    rng = np.random.default_rng(0)
    APB, L = 2, 12
    S = B * APB
    path_nodes = np.stack([rng.choice(V, size=3, replace=False)
                           for _ in range(S)])
    pf = np.zeros((S, V), dtype=np.int8)
    pf[np.repeat(np.arange(S), 3), path_nodes.ravel()] = 1
    pi = np.zeros_like(pf)
    pi[np.arange(S), path_nodes[:, 1]] = 1
    plf = pf.sum(axis=1).astype(np.int32)
    pli = pi.sum(axis=1).astype(np.int32)
    pb = np.repeat(np.arange(B, dtype=np.int32), APB)
    pkb = np.tile((np.arange(APB, dtype=np.int32) << 23), B)
    nodes = path_nodes[rng.integers(0, S, size=(A, 4))].reshape(A, L)
    nodes = nodes.astype(np.int32)
    name_id = rng.integers(0, N, size=A, dtype=np.int32)
    ident = rng.uniform(0.85, 1.0, size=A).astype(np.float32)

    dev = _containment_keys(
        *[jnp.asarray(x) for x in (pf, pi, plf, pli, pb, pkb, nodes,
                                   name_id, ident)],
        jnp.float32(90.0), num_bubbles=B, num_names=N, chunk=CHUNK,
        alleles_per_bubble=APB)
    ref = _projection_reference(pf, pi, plf, pli, pkb, nodes, name_id,
                                ident, B, APB, N)
    for tag, d, r in zip(("full", "partial", "gated"), dev, ref):
        d = np.asarray(d)
        bad = int((d != r).sum())
        log(f"  projection {tag} keys [{B}, {N}]: {bad} differ, "
            f"{int((r != r.max()).sum())} matched")
        check(bad == 0, f"projection {tag} keys differ from numpy")


def phase_scoring_parity(work: str, bubbles=300,
                         reads_per_hap=1000) -> None:
    """Dense device scoring and banded scoring against the numpy oracle
    on one 2000-read chain: at most banded.py's 2048-row sample, so the
    banded path estimates its error rate from the same rows."""
    import numpy as np

    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.pipeline import prepare_phase_inputs
    from ahsoka_tpu.project.readset import build_chain_readsets
    from ahsoka_tpu.score.banded import score_pairs_banded
    from ahsoka_tpu.score.device import score_pairs_device
    from ahsoka_tpu.score.pairwise import readset_to_matrix, score_pairs
    from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic

    gfa, gaf = os.path.join(work, "score.gfa"), os.path.join(work,
                                                             "score.gaf")
    write_synthetic(gfa, gaf, SynthSpec(
        num_chains=1, bubbles_per_chain=bubbles,
        reads_per_hap=reads_per_hap, span=3,
        error_rate=0.02, seed=3))
    cfg = PhasingConfig()
    art = prepare_phase_inputs(gfa, gaf, os.path.join(work, "score"), cfg)
    cid = art.size_sorting[0][1]
    rs = build_chain_readsets(art.allele_paths[cid],
                              art.alignments.chain_alignments(cid), cfg)
    m = readset_to_matrix(rs.partial_filtered)
    host = score_pairs(m, cfg)
    dev = score_pairs_device(m, cfg)
    dev_max = float(np.max(np.abs(dev - host)))
    log(f"  scoring dense [{m.num_reads}, {m.num_reads}]: largest "
        f"deviation {dev_max:.3g}")
    np.testing.assert_allclose(dev, host, rtol=1e-4, atol=1e-4)
    iu = np.triu_indices(host.shape[0], k=1)
    keep = host[iu] != 0
    bu, bv, bw = score_pairs_banded(m, cfg)
    order = np.lexsort((bv, bu))
    check(np.array_equal(bu[order], iu[0][keep])
          and np.array_equal(bv[order], iu[1][keep]),
          "banded edge set != dense edge set")
    band_max = float(np.max(np.abs(bw[order] - host[iu][keep])))
    log(f"  scoring banded: {len(bw)} edges, largest deviation "
        f"{band_max:.3g}")
    np.testing.assert_allclose(bw[order], host[iu][keep], rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------ phases 3-5

def _inputs(config_name: str):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_e2e import ensure_inputs
    t0 = time.perf_counter()
    gfa, gaf, truth, _spec, pmap = ensure_inputs(config_name, INPUTS)
    log(f"  inputs ready in {time.perf_counter() - t0:.1f} s (set-up)")
    return gfa, gaf, truth, pmap


def cli_argv(gfa: str, gaf: str, out: str, pmap: str | None = None):
    """The ``phase`` command line of phases 3-6 (bench_e2e.py's settings).
    No --keep-going: a failure of any batched device stage fails the
    run instead of falling back to a per-chain path."""
    argv = ["phase", "-g", gfa, "-a", gaf, "-o", out, "--max-coverage",
            "64", "-t", str(_threads()), "--no-debug-readsets"]
    if pmap:
        argv += ["--ploidy-map", pmap, "--dp-beam-width", "2048",
                 "--genotype-prior", "balanced"]
    return argv


def phase_config(name: str, work: str, bar: float | None) -> None:
    import jax

    from ahsoka_tpu.utils.accuracy import score_phased_output

    gfa, gaf, truth, pmap = _inputs(name)
    out = os.path.join(work, name, "run")
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    os.makedirs(os.path.dirname(out))
    argv = cli_argv(gfa, gaf, out, os.path.join(INPUTS, f"{name}.pmap.json")
                    if pmap else None)
    t0 = time.perf_counter()
    run_cli(argv)
    wall = time.perf_counter() - t0
    m = read_metrics(out)
    acc = score_phased_output(out, truth)
    split: dict = {}
    for c in m["chains"]:
        for k, v in c["stage_seconds"].items():
            split[k] = round(split.get(k, 0.0) + v, 3)
    st = m["stage_seconds"]
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0)
    log(f"  {name}: cli wall {wall:.2f} s, phase {st['phase']:.2f} s, "
        f"parse_gaf {st['parse_gaf']:.2f} s, records {m['gaf_records']}")
    log(f"  {name} stage split (summed over chains): {split}")
    log(f"  {name} threading substages: "
        f"{ {k: v for k, v in st.get('substages', {}).items() if k.startswith('threading')} }")
    log(f"  {name}: chains {m['num_chains']}, phased {m['chains_phased']},"
        f" failed {m['chains_failed']}; switch error "
        f"{acc['switch_err_vs_truth']}, phased fraction "
        f"{acc['phased_bubble_frac']}; process peak device memory "
        f"{peak / 2**30:.2f} GiB")
    check(m["chains_failed"] == 0, f"{name}: {m['chains_failed']} failed")
    if bar is not None:
        check(acc["switch_err_vs_truth"] <= bar,
              f"{name}: switch error {acc['switch_err_vs_truth']} > {bar}")


# ---------------------------------------------------------------- phase 6

_LAYOUTS = {"chain4": ["--chain-shards", "4"],
            "data4": ["--data-shards", "4"],
            "data2chain2": ["--data-shards", "2", "--chain-shards", "2"]}


def _outputs(outstem: str) -> dict:
    d, base = os.path.split(outstem)
    return {f[len(base):]: os.path.join(d, f) for f in os.listdir(d)
            if f.startswith(base) and (f.endswith("-result.txt")
                                       or f.endswith("-bubbleinfo.txt"))}


def _same_outputs(ref: str, other: str) -> None:
    a, b = _outputs(ref), _outputs(other)
    check(sorted(a) == sorted(b), f"{other}: output files differ")
    for suffix, path in a.items():
        with open(path, "rb") as x, open(b[suffix], "rb") as y:
            check(x.read() == y.read(), f"{other}{suffix} differs")
    log(f"  {os.path.basename(os.path.dirname(other))}: {len(a)} output "
        f"files byte-equal to the one-card run")


def mesh_child(work: str, gfa: str, gaf: str) -> int:
    """Runs in its own process: the one-card run and the three
    one-process four-device layouts; prints the device line last."""
    import jax
    phase_identity()
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices < 4")
    ref = os.path.join(work, "one", "run")
    for tag, extra in [("one", [])] + list(_LAYOUTS.items()):
        out = os.path.join(work, tag, "run")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        t0 = time.perf_counter()
        run_cli(cli_argv(gfa, gaf, out) + extra)
        m = read_metrics(out)
        log(f"  config4 {tag}: cli wall {time.perf_counter() - t0:.2f} s, "
            f"phase {m['stage_seconds']['phase']:.2f} s, failed "
            f"{m['chains_failed']}")
        check(m["chains_failed"] == 0, f"{tag}: chains failed")
        if tag != "one":
            _same_outputs(ref, out)
    dev = jax.devices()[0]
    log(result_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


def phase_four_cards(work: str) -> str:
    """The driver's process stays off jax: every run is a child."""
    gfa, gaf, _truth, _pmap = _inputs("config4")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child",
         "--workdir", work, "--gfa", gfa, "--gaf", gaf],
        stdout=subprocess.PIPE, text=True)
    device_line = ""
    try:
        for line in child.stdout:          # relay progress as it comes
            if line.startswith("{"):
                device_line = line.strip()
            else:
                log(line.rstrip())
        rc = child.wait(timeout=1800)
    finally:
        if child.poll() is None:
            child.kill()
    check(rc == 0 and device_line, "four-device child failed")

    out = os.path.join(work, "procs", "run")
    os.makedirs(os.path.dirname(out))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ahsoka_tpu"] + cli_argv(gfa, gaf, out)
        + ["--process-sharding", "chains", "--num-processes", "4",
           "--process-id", str(i), "--coordinator", f"localhost:{port}"],
        cwd=REPO) for i in range(4)]
    deadline = time.monotonic() + 600
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1))
               for p in procs]
    except subprocess.TimeoutExpired:
        raise SmokeFailure("process-sharded run exceeded 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(rcs == [0] * 4, f"process-sharded children exit codes {rcs}")
    log(f"  config4 procs (4 processes): wall "
        f"{time.perf_counter() - t0:.2f} s")
    cards = [read_metrics(out, f"-metrics.rank{i}.json" if i else
                          "-metrics.json")["local_device_ids"]
             for i in range(4)]
    log(f"  local device ids per process: {cards}")
    check(all(len(c) == 1 for c in cards)
          and len({c[0] for c in cards}) == 4,
          f"processes do not hold one card each: {cards}")
    _same_outputs(os.path.join(work, "one", "run"), out)
    return device_line


# ------------------------------------------------------------------ main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 6 (config4 on 1 vs 4 cards)")
    ap.add_argument("--workdir", default=WORKDIR)
    ap.add_argument("--mesh-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--gfa", help=argparse.SUPPRESS)
    ap.add_argument("--gaf", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "ahsoka_tpu")):
        log("FAIL: chip_smoke.py must sit at the root of an ahsoka-tpu "
            "checkout")
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    try:
        if args.mesh_child:
            return mesh_child(args.workdir, args.gfa, args.gaf)
        if args.four_cards:
            log("phase 6: config4 on one card vs four")
            try:
                log(f"nvidia-smi name, power.limit: {nvidia_smi()}")
            except (OSError, subprocess.SubprocessError) as exc:
                raise SmokeFailure(f"nvidia-smi failed: {exc}")
            line = phase_four_cards(os.path.join(args.workdir, "four"))
            check(json.loads(line)["device"]["count"] == 4,
                  f"not a four-device run: {line}")
            log(f"total {time.perf_counter() - t_start:.1f} s")
            print(line, flush=True)
            return 0
        os.makedirs(args.workdir, exist_ok=True)
        log("phase 0: identity")
        dev = phase_identity()
        phases = [
            ("phase 1: goldens through the CLI",
             lambda: phase_goldens(args.workdir)),
            ("phase 2: DP parity", phase_dp_parity),
            ("phase 2: projection parity", phase_projection_parity),
            ("phase 2: scoring parity",
             lambda: phase_scoring_parity(args.workdir)),
            ("phase 3: config4 through the CLI",
             lambda: phase_config("config4", args.workdir, SWITCH_ERR_BAR)),
            ("phase 4: config2 through the CLI",
             lambda: phase_config("config2", args.workdir, SWITCH_ERR_BAR)),
            ("phase 5: config5s through the CLI",
             lambda: phase_config("config5s", args.workdir, None)),
        ]
        for title, fn in phases:
            log(title)
            t0 = time.perf_counter()
            fn()
            log(f"  ({time.perf_counter() - t0:.1f} s)")
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        return 1
    import jax
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
