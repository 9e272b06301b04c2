"""Multi-process distributed execution of the full phase pipeline (CPU
simulation of a multi-host run; SURVEY.md §4 item 3).

Two layouts:

``--mode mesh`` (default; what tests/test_multiprocess.py drives):
N jax.distributed processes share an 8-device global mesh; the device
stages (sharded projection with its min-merge collective, the
chain-sharded threading DP) run over the GLOBAL mesh — real cross-
process collectives — while host stages replicate per process.  Every
process writes complete outputs; byte-compared to single-process.

``--mode chains`` (the config-5 scaling stand-in, VERDICT r3 item 5):
chains partition round-robin across processes
(config.process_chain_sharding); device calls stay process-local, every
owner writes its per-chain files into ONE shared outstem, rank 0 merges
the aggregate after a barrier.  ``--sweep 1 2 4`` runs a config-shaped
slice (--shape config5: 100 chains x 50 bubbles, 100k GAF records) at
several process counts, byte-compares every merged output against the
single-process golden, and prints the per-process host/device stage
table BASELINE.md records.

Usage:
    python scripts/multiproc_sim.py [--workdir DIR] [--nproc 2]
    python scripts/multiproc_sim.py --mode chains --shape config5 \
        --sweep 1 2 4
    python scripts/multiproc_sim.py --child ...   (internal)
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

try:
    import ahsoka_tpu  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "ahsoka_tpu":
        raise                      # a real missing dependency, not us
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEVICES = 8                       # global device count in every layout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_child(args) -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ahsoka_tpu.dist.mesh import initialize_distributed
    if args.nproc > 1:
        initialize_distributed(coordinator=f"localhost:{args.port}",
                               num_processes=args.nproc,
                               process_id=args.pid)

    from ahsoka_tpu.config import PhasingConfig
    from ahsoka_tpu.pipeline import run_phase
    if args.mode == "chains":
        pmap = None
        if args.ploidy_map:
            with open(args.ploidy_map) as fh:
                pmap = {int(c): int(k)
                        for c, k in json.load(fh).items()}
        max_k = max([2] + list((pmap or {}).values()))
        cfg = PhasingConfig(backend="jax", debug_readset_files=False,
                            process_chain_sharding=True,
                            max_coverage=64, threads=1,
                            ploidy_map=pmap,
                            dp_beam_width=(2048 if max_k >= 6 else 0),
                            genotype_prior=("balanced" if max_k > 2
                                            else "reference"))
    else:
        assert len(jax.devices()) == _DEVICES, jax.devices()
        cfg = PhasingConfig(backend="jax", debug_readset_files=False,
                            data_shards=_DEVICES, chain_shards=_DEVICES)
    run_phase(args.gfa, args.gaf, args.outstem, cfg)
    return 0


def _gen_inputs(workdir: str):
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    from util import simulate_multichain

    glines, gaf = simulate_multichain(num_chains=4, bubbles_per_chain=8,
                                      reads_per_hap=12, error_rate=0.05,
                                      seed=11)
    gfa = os.path.join(workdir, "g.gfa")
    with open(gfa, "w") as fh:
        fh.writelines(glines)
    gafs = []
    for tag in ("s", "p0", "p1"):
        # per-process GAF copy: the identities side file is written next
        # to the input, and concurrent processes must not race on it
        path = os.path.join(workdir, f"r_{tag}.gaf")
        with open(path, "w") as fh:
            fh.writelines(gaf)
        gafs.append(path)
    return gfa, gafs


def _spawn(pid: int, nproc: int, port: int, gfa: str, gaf: str,
           outstem: str, mode: str = "mesh",
           local_devices: int = 0,
           ploidy_map: str | None = None) -> subprocess.Popen:
    if local_devices <= 0:
        local_devices = _DEVICES // nproc
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--pid", str(pid), "--nproc", str(nproc), "--port", str(port),
           "--local-devices", str(local_devices), "--mode", mode,
           "--gfa", gfa, "--gaf", gaf, "--outstem", outstem]
    if ploidy_map:
        cmd += ["--ploidy-map", ploidy_map]
    return subprocess.Popen(
        cmd, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _stage_summary(outstem: str) -> dict:
    with open(f"{outstem}-metrics.json") as fh:
        m = json.load(fh)
    device = sum(sum(c["stage_seconds"].get(k, 0.0)
                     for k in ("projection", "threading"))
                 for c in m["chains"])
    # the phase timer starts after the device handshake (run_phase warms
    # up first), so no warmup subtraction is needed here
    return {"device_stage_seconds": round(device, 3),
            "phase_seconds": round(m["stage_seconds"]["phase"], 3),
            "chains_failed": m["chains_failed"]}


def _gen_shaped_inputs(workdir: str, shape: str):
    """Config-shaped inputs for the chains-mode sweep (+ planted truth).
    Returns (gfa, gaf, truth, ploidy_map_path-or-None)."""
    from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic

    if shape in ("config5full", "config5s"):
        # the REAL mixed-ploidy config5 (3000 ragged chains, ~3.9M
        # records) or its 1/10-scale ragged slice: reuse bench_e2e's
        # generator + cached chain-id ploidy map so the bench and the
        # sweep share one input set
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from bench_e2e import ensure_inputs
        name = "config5" if shape == "config5full" else shape
        gfa, gaf, truth, _spec, _pmap = ensure_inputs(name, workdir)
        return gfa, gaf, truth, os.path.join(workdir,
                                             f"{name}.pmap.json")
    spec = (SynthSpec(num_chains=100, bubbles_per_chain=50,
                      reads_per_hap=500, span=3, error_rate=0.02, seed=7)
            if shape == "config5" else
            SynthSpec(num_chains=12, bubbles_per_chain=20,
                      reads_per_hap=50, span=3, error_rate=0.02, seed=7))
    gfa = os.path.join(workdir, f"{shape}.gfa")
    gaf = os.path.join(workdir, f"{shape}.gaf")
    truth = os.path.join(workdir, f"{shape}.truth")
    if not (os.path.exists(gfa) and os.path.exists(gaf)
            and os.path.exists(truth)):
        write_synthetic(gfa, gaf, spec, truth_path=truth)
    return gfa, gaf, truth, None


def _rank_metrics(outstem: str, rank: int) -> dict:
    path = (f"{outstem}-metrics.json" if rank == 0
            else f"{outstem}-metrics.rank{rank}.json")
    with open(path) as fh:
        m = json.load(fh)
    totals: dict = {}
    for c in m["chains"]:
        for k, v in c.get("stage_seconds", {}).items():
            totals[k] = totals.get(k, 0.0) + v
    host = sum(totals.get(k, 0.0)
               for k in ("prepare", "matrix", "collapse", "clustering"))
    device = sum(totals.get(k, 0.0)
                 for k in ("projection", "scoring", "threading"))
    return {"phase_s": round(m["stage_seconds"]["phase"], 2),
            "parse_gaf_s": round(m["stage_seconds"]["parse_gaf"], 2),
            "host_stage_s": round(host, 2),
            "device_stage_s": round(device, 2),
            "chains_owned": sum(1 for c in m["chains"]
                                if c.get("reason")
                                != "owned by another process"),
            "chains_failed": m["chains_failed"]}


def run_chains_sweep(args) -> int:
    """nproc sweep of the chain-sharded layout on a config-shaped slice:
    the config-5 scaling stand-in (VERDICT r3 item 5)."""
    workdir = args.workdir
    os.makedirs(workdir, exist_ok=True)
    gfa, gaf, truth, pmap_path = _gen_shaped_inputs(workdir, args.shape)

    sys.path.insert(0, _REPO)
    from ahsoka_tpu.utils.accuracy import score_phased_output

    rows = []
    golden_dir = None
    for nproc in args.sweep:
        outdir = os.path.join(workdir, f"np{nproc}")
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        outstem = os.path.join(outdir, "run")
        port = _free_port()
        t0 = time.perf_counter()
        procs = [_spawn(i, nproc, port, gfa, gaf, outstem,
                        mode="chains", local_devices=1,
                        ploidy_map=pmap_path)
                 for i in range(nproc)]
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=3600)
            if p.returncode != 0:
                sys.stderr.write(f"proc{i} failed:\n" + err[-3000:])
                return 1
        wall = time.perf_counter() - t0

        ranks = [_rank_metrics(outstem, r) for r in range(nproc)]
        acc = score_phased_output(outstem, truth)
        mismatches = []
        if golden_dir is None:
            golden_dir = outdir
        else:
            names = sorted(f for f in os.listdir(golden_dir)
                           if f.endswith("-result.txt")
                           or f.endswith("-bubbleinfo.txt"))
            for name in names:
                with open(os.path.join(golden_dir, name), "rb") as fh:
                    g = fh.read()
                cand = os.path.join(outdir, name)
                if not os.path.exists(cand):
                    mismatches.append((name, "missing"))
                elif open(cand, "rb").read() != g:
                    mismatches.append((name, "differs"))
        row = {"nproc": nproc, "wall_s": round(wall, 2),
               "per_rank": ranks,
               "max_phase_s": max(r["phase_s"] for r in ranks),
               "byte_equal_vs_nproc1": (not mismatches
                                        if golden_dir != outdir
                                        else None),
               "mismatches": mismatches[:5],
               "accuracy": acc}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"shape": args.shape, "sweep": rows}))
    return 0 if all(not r["mismatches"] for r in rows) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=_DEVICES)
    ap.add_argument("--mode", choices=["mesh", "chains"], default="mesh")
    ap.add_argument("--shape",
                    choices=["small", "config5", "config5s",
                             "config5full"],
                    default="small")
    ap.add_argument("--ploidy-map", default=None,
                    help="JSON chain-id -> ploidy (config5full children)")
    ap.add_argument("--sweep", type=int, nargs="+", default=None,
                    help="chains mode: process counts to measure")
    ap.add_argument("--gfa")
    ap.add_argument("--gaf")
    ap.add_argument("--outstem")
    ap.add_argument("--workdir",
                    default=os.path.join(_REPO, "benchdata", "multiproc"))
    args = ap.parse_args()
    if args.child:
        return run_child(args)
    if args.mode == "chains":
        if not args.sweep:
            args.sweep = [1, 2]
        return run_chains_sweep(args)

    workdir = args.workdir
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    gfa, (gaf_s, gaf_0, gaf_1) = _gen_inputs(workdir)

    # single-process golden: same global device count, one process
    t0 = time.perf_counter()
    p = _spawn(0, 1, 0, gfa, gaf_s, os.path.join(workdir, "single"))
    out, err = p.communicate(timeout=900)
    t_single = time.perf_counter() - t0
    if p.returncode != 0:
        sys.stderr.write(err[-2000:])
        return 1

    # two jax.distributed processes, 4 local devices each
    port = _free_port()
    t0 = time.perf_counter()
    procs = [_spawn(i, args.nproc, port, gfa, [gaf_0, gaf_1][i],
                    os.path.join(workdir, f"proc{i}"))
             for i in range(args.nproc)]
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            sys.stderr.write(f"proc{i} failed:\n" + err[-2000:])
            return 1
    t_multi = time.perf_counter() - t0

    # every process must emit complete, byte-identical outputs
    def read(stem, suffix):
        with open(os.path.join(workdir, stem + suffix), "rb") as fh:
            return fh.read()

    mismatches = []
    suffixes = ["-result.txt", "-bubbleinfo.txt"] + sorted(
        f[len("single"):] for f in os.listdir(workdir)
        if f.startswith("single-chain") and f.endswith("-result.txt"))
    for suffix in suffixes:
        golden = read("single", suffix)
        for i in range(args.nproc):
            if read(f"proc{i}", suffix) != golden:
                mismatches.append((suffix, i))
    summary = {
        "nproc": args.nproc,
        "global_devices": _DEVICES,
        "files_compared": len(suffixes) * args.nproc,
        "byte_equal": not mismatches,
        "mismatches": mismatches,
        "single": _stage_summary(os.path.join(workdir, "single")),
        "multi": _stage_summary(os.path.join(workdir, "proc0")),
        "wall_seconds": {"single": round(t_single, 2),
                         "multi": round(t_multi, 2)},
    }
    print(json.dumps(summary))
    return 0 if not mismatches else 1


if __name__ == "__main__":
    sys.exit(main())
